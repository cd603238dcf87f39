"""Build and load the CUDA kernels under ``repro_torch/csrc``.

Each ``csrc/*.cu`` is compiled by its own ``nvcc`` process, all started
together, for ``sm_90a``; the objects are linked into one shared library
with a plain C interface, which is loaded with ``ctypes`` (pointers and the
stream travel as ``c_void_p``). The library goes into ``repro_torch/build/``
(git-ignored) under a name that hashes the sources and flags, so a changed
source is rebuilt and an unchanged one is reused. Nothing is built at
import: the first kernel launch builds.

Every C entry point launches one kernel on the given stream and returns
``cudaGetLastError()``; :func:`launch` raises if that is not 0. A launch
takes its threads per CTA and per-thread depth from a
``kernels.tile.KernelTile``. Each kernel is instantiated for float32,
bfloat16 and float64 operands (:data:`KERNEL_DTYPES`), each summed in its
own accumulator (float32 for the first two, float64 for the third), and
for float32 and bfloat16 operands summed in float64 (:data:`VARIANTS`),
with one C entry point per element type and accumulator (:func:`entry`);
all but the float32 ones have sources of their own (``csrc/*_bf16.cu``,
``csrc/*_f64.cu``, ``csrc/*_f32_acc64.cu``, ``csrc/*_bf16_acc64.cu``), so
nvcc builds them in parallel.
:func:`operand_dtype` checks that a launch's floating operands share one
of those types. :func:`resource_usage` reads the compiler's
registers and spills per instantiation from the build log, and
:func:`kernel_attributes` asks the card (``cudaFuncGetAttributes`` and the
occupancy calculator) for the same instantiation.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"

ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-O3", "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              *ARCH_FLAGS)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_PTRS = ctypes.POINTER(ctypes.c_void_p)

# the element types the kernels are instantiated for, and the suffix of their
# C entry points in their own accumulator
KERNEL_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16",
                 torch.float64: "f64"}
# (element type, accumulator) of every instantiation: the suffix of its C
# entry points and source files, and the dtype code of
# repro_kernel_attributes
VARIANTS = {(torch.float32, torch.float32): ("f32", 0),
            (torch.bfloat16, torch.float32): ("bf16", 1),
            (torch.float64, torch.float64): ("f64", 2),
            (torch.float32, torch.float64): ("f32_acc64", 3),
            (torch.bfloat16, torch.float64): ("bf16_acc64", 4)}
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}
# the name the build log's mangled template argument gives
_MANGLED_DTYPES = {"f": "float32", "__nv_bfloat16": "bfloat16",
                   "d": "float64"}

# C signatures of csrc/*.cu; every launcher returns a cudaError_t as int
_TTTP = (_P, _P, _P, _L, _I, _PTRS, _I, _I, _P, _I, _I, _P)
_BUCKETED = (_P, _P, _P, _P, _L, _L, _I, _I, _PTRS, _P, _L, _I, _I, _I, _P,
             _I, _I, _P)
SIGNATURES = {
    # values, indices, valid, m, nd, factors[nd], R, RS (padded row
    # stride, in elements), out, threads, per_thread, stream
    **{f"repro_tttp_{sfx}": _TTTP for sfx, _ in VARIANTS.values()},
    # values (ω for the matvec), indices, local_row, valid, nb, C, nd, mode,
    # factors[nd], x, x_rows, R, RS (padded row stride, in elements),
    # block_rows, out, threads, per_thread, stream; the MTTKRP ignores x
    # and x_rows
    **{f"repro_{k}_bucketed_{sfx}": _BUCKETED
       for k in ("mttkrp", "cg_matvec") for sfx, _ in VARIANTS.values()},
    # family, variant (NP or RMAX), per_thread, threads, dynamic shared
    # bytes, dtype code, out[5] (csrc/attributes.cu)
    "repro_kernel_attributes": (_I, _I, _I, _I, _L, _I,
                                ctypes.POINTER(ctypes.c_int)),
}
# the family codes of repro_kernel_attributes
FAMILY_CODES = {"tttp": 0, "mttkrp": 1, "cg_matvec": 2}


def dtype_name(dtype: torch.dtype) -> str:
    """``"float32"`` for ``torch.float32``."""
    return str(dtype).removeprefix("torch.")


def natural_accumulator(dtype: torch.dtype) -> torch.dtype:
    """The accumulator an instantiation on ``dtype`` operands uses unless a
    tile asks for float64: float64 for float64, float32 otherwise."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def variant_name(dtype: torch.dtype, acc: torch.dtype) -> str:
    """The key of the kernel modules' ``launches_by_dtype`` for operands of
    ``dtype`` summed in ``acc``: the element type's name (``"float32"``) in
    its own accumulator, ``"float32/float64"`` in a wider one."""
    if acc == natural_accumulator(dtype):
        return dtype_name(dtype)
    return f"{dtype_name(dtype)}/{dtype_name(acc)}"


# every launches_by_dtype key, in VARIANTS' order
VARIANT_NAMES = tuple(variant_name(dt, acc) for dt, acc in VARIANTS)


def entry(name: str, dtype: torch.dtype,
          acc: Optional[torch.dtype] = None) -> str:
    """The C launcher of kernel ``name`` (``tttp``, ``mttkrp_bucketed``,
    ``cg_matvec_bucketed``) for operands of ``dtype`` summed in ``acc``
    (default: :func:`natural_accumulator`)."""
    acc = natural_accumulator(dtype) if acc is None else acc
    return f"repro_{name}_{VARIANTS[(dtype, acc)][0]}"

_lock = threading.Lock()
_lib = None


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found on PATH or under /usr/local/cuda: the "
                       "CUDA kernels cannot be built on this machine")


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")), sorted(CSRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sum(_sources(), []):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"librepro_torch_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile and link the kernels unless the current build exists.
    Raises ``RuntimeError`` with nvcc's output if a step fails. The
    compiler's resource report (``-Xptxas -v``) is kept beside the library
    as ``<library>.log``."""
    out = library_path()
    if out.exists():
        return out
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu, _ = _sources()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (src.stem + ".o") for src in cu]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(src), "-o",
                                   str(obj)],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(cu, objs)]
        logs = []
        for src, proc in zip(cu, procs):
            text, _ = proc.communicate()
            logs.append(f"== {src.name}\n{text}")
            if proc.returncode != 0:
                for other in procs:
                    other.wait()
                raise RuntimeError(f"nvcc failed on {src.name}:\n{text}")
        lib_tmp = Path(tmp) / out.name
        link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o",
                               str(lib_tmp), *map(str, objs)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        Path(str(out) + ".log").write_text("\n".join(logs))
        os.replace(lib_tmp, out)
    return out


def build_log() -> str:
    """The compiler's resource report of the current build ('' if the
    library was built elsewhere)."""
    log = Path(str(library_path()) + ".log")
    return log.read_text() if log.exists() else ""


Instantiation = Tuple[str, Tuple]


def kernel_name(mangled: str) -> Optional[Instantiation]:
    """``("tttp_kernel", (3, 2, "float32"))`` or ``("bucket_rows_kernel",
    (16, 1, 2, "bfloat16"))`` (a bool argument as 0 or 1, then the element
    type) from a mangled entry-function name, None for any other function.
    The accumulator follows the element type only where it is wider than
    :func:`natural_accumulator`'s: ``("tttp_kernel", (3, 2, "float32",
    "float64"))``. A name with integer template arguments only gives those
    alone."""
    m = re.search(r"([a-z_]+_kernel)I((?:L[a-z]\d+E)+)", mangled)
    if m is None:
        return None
    args = tuple(int(a) for a in re.findall(r"L[a-z](\d+)E", m.group(2)))
    rest = mangled[m.end():]
    types = []
    # the type arguments up to the list's end: a builtin type is one
    # letter; a class type its name's length, then the name
    while rest and rest[0] != "E":
        t = re.match(r"(?:([a-z])|(\d+))", rest)
        if t is None:
            break
        if t.group(1):
            name, rest = t.group(1), rest[t.end():]
        else:
            end = t.end() + int(t.group(2))
            name, rest = rest[t.end():end], rest[end:]
        types.append(_MANGLED_DTYPES.get(name, name))
    if types:
        dtype = getattr(torch, types[0], None)
        acc = getattr(torch, types[1], None) if len(types) > 1 else None
        keep_acc = (isinstance(dtype, torch.dtype)
                    and isinstance(acc, torch.dtype)
                    and acc != natural_accumulator(dtype))
        args += tuple(types[:2] if keep_acc else types[:1])
    return m.group(1), args


def resource_usage(log: Optional[str] = None
                   ) -> Dict[Instantiation, Dict[str, int]]:
    """Per kernel instantiation, what ``-Xptxas -v`` reported in ``log``
    (default: the current build's, :func:`build_log`): ``registers`` per
    thread, static ``smem`` bytes, ``stack`` (local bytes per thread),
    ``spill_stores`` and ``spill_loads`` bytes. Empty when there is no
    build log."""
    text = build_log() if log is None else log
    usage: Dict[Instantiation, Dict[str, int]] = {}
    cur = None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties "
                      r"for )(\S+?)'?(?: for |$)", line.strip())
        if m is not None:
            cur = kernel_name(m.group(1))
            if cur is not None:
                usage.setdefault(cur, {"registers": 0, "smem": 0, "stack": 0,
                                       "spill_stores": 0, "spill_loads": 0})
            continue
        if cur is None:
            continue
        rec = usage[cur]
        for key, pat in (("stack", r"(\d+) bytes stack frame"),
                         ("spill_stores", r"(\d+) bytes spill stores"),
                         ("spill_loads", r"(\d+) bytes spill loads"),
                         ("registers", r"Used (\d+) registers"),
                         ("smem", r"(\d+) bytes smem")):
            found = re.search(pat, line)
            if found:
                rec[key] = int(found.group(1))
    return usage


def kernel_attributes(family: str, variant: int, per_thread: int,
                      threads: int, smem: int = 0,
                      dtype: torch.dtype = torch.float32,
                      acc: Optional[torch.dtype] = None) -> Dict[str, int]:
    """What the card says of one instantiation (``variant`` is TTTP's NP or
    the bucketed body's RMAX, ``dtype`` its element type, ``acc`` its
    accumulator, default :func:`natural_accumulator`): ``registers``,
    ``local_bytes`` and ``static_smem`` per ``cudaFuncGetAttributes``,
    ``max_threads``, and ``blocks_per_sm``, the CTAs of ``threads`` threads
    and ``smem`` bytes of dynamic shared memory one SM holds. Raises if the
    instantiation does not exist."""
    out = (ctypes.c_int * 5)()
    handle = lib()
    acc = natural_accumulator(dtype) if acc is None else acc
    code = VARIANTS.get((dtype, acc), (None, -1))[1]
    err = handle.repro_kernel_attributes(FAMILY_CODES[family], variant,
                                         per_thread, threads, smem, code,
                                         out)
    if err != 0:
        msg = handle.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"kernel attributes of {family} <{variant}, "
                           f"{per_thread}, {dtype}, {acc}>: CUDA error "
                           f"{err} ({msg})")
    return dict(zip(("registers", "local_bytes", "static_smem",
                     "max_threads", "blocks_per_sm"), out))


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            handle.repro_cuda_error_string.argtypes = (ctypes.c_int,)
            handle.repro_cuda_error_string.restype = ctypes.c_char_p
            _lib = handle
    return _lib


def operand_dtype(**operands) -> torch.dtype:
    """The one element type of a launch's floating operands (name ->
    tensor or None): ``TypeError`` unless they share a type the kernels are
    instantiated for (:data:`KERNEL_DTYPES`). ``kernels.ops`` promotes mixed
    inputs before it calls a launcher."""
    dtypes = {n: t.dtype for n, t in operands.items() if t is not None}
    found = set(dtypes.values())
    if len(found) > 1:
        raise TypeError(f"the CUDA kernel takes one element type across its "
                        f"operands, got {dtypes}")
    dtype = found.pop()
    if dtype not in KERNEL_DTYPES:
        raise TypeError(f"operands of dtype {dtype}; the CUDA kernels take "
                        f"{', '.join(map(str, KERNEL_DTYPES))}")
    return dtype


def check_operand(name: str, t, dtype, device, shape=None) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor on ``device``
    (and of ``shape`` if given): what the C launchers take."""
    if t.device.type != "cuda" or t.device != device:
        raise ValueError(f"{name} is on {t.device}; the CUDA kernel takes "
                         f"tensors on one CUDA device ({device})")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}; the CUDA kernel takes "
                        f"{dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")


def check_factors(factors, r: int, dtype, device) -> None:
    """:func:`check_operand` on every present factor, each (rows, ``r``)."""
    for d, f in enumerate(factors):
        if f is not None:
            check_operand(f"factor {d}", f, dtype, device, (f.shape[0], r))


def pointer_table(tensors) -> ctypes.Array:
    """Host array of device pointers, NULL where a tensor is ``None``. The
    caller keeps the tensors alive across the launch."""
    return (ctypes.c_void_p * len(tensors))(
        *[None if t is None else t.data_ptr() for t in tensors])


def launch(name: str, *args) -> None:
    """Call the C launcher ``name`` and raise if the launch failed."""
    handle = lib()
    err = getattr(handle, name)(*args)
    if err != 0:
        msg = handle.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err} ({msg})")
