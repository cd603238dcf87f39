"""Build and load the CUDA kernels under ``repro_torch/csrc``.

Each ``csrc/*.cu`` is compiled by its own ``nvcc`` process, all started
together, for ``sm_90a``; the objects are linked into one shared library
with a plain C interface, which is loaded with ``ctypes`` (pointers and the
stream travel as ``c_void_p``). The library goes into ``repro_torch/build/``
(git-ignored) under a name that hashes the sources and flags, so a changed
source is rebuilt and an unchanged one is reused. Nothing is built at
import: the first kernel launch builds.

Every C entry point launches one kernel on the given stream and returns
``cudaGetLastError()``; :func:`launch` raises if that is not 0.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"

ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-O3", "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              *ARCH_FLAGS)

# threads per CTA of every launch; the bucketed kernels are compiled for at
# most this many (MAX_THREADS in csrc/common.cuh) and take SLOTS
# (csrc/bucket_rows.cuh) times this many bucket slots per step
THREADS = 256

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_PTRS = ctypes.POINTER(ctypes.c_void_p)

# C signatures of csrc/*.cu; every launcher returns a cudaError_t as int
_BUCKETED = (_P, _P, _P, _P, _L, _L, _I, _I, _PTRS, _P, _L, _I, _I, _I, _P,
             _I, _P)
SIGNATURES = {
    # values, indices, m, nd, factors[nd], R, out, threads, stream
    "repro_tttp_f32": (_P, _P, _L, _I, _PTRS, _I, _P, _I, _P),
    # values (ω for the matvec), indices, local_row, valid, nb, C, nd, mode,
    # factors[nd], x, x_rows, R, RS (padded row stride), block_rows, out,
    # threads, stream; the MTTKRP ignores x and x_rows
    "repro_mttkrp_bucketed_f32": _BUCKETED,
    "repro_cg_matvec_bucketed_f32": _BUCKETED,
}

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
