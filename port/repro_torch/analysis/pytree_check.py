"""Pass 3 — pytree registrations and static-argument aliasing.

The JAX package's pass has two halves; the port keeps the one with a torch
meaning and guards the other:

* **PT001, pytree registrations.** In the JAX package every registered
  pytree crosses jit boundaries, and its aux data keys the compilation
  cache, so the pass round-trips an exemplar of each. The port registers
  no pytrees: nothing of it is traced, and ``torch.utils._pytree`` is only
  read (``obs/profile.py``, ``launch/roofline.py`` flatten arguments to
  count bytes). So there is nothing to round-trip; instead the pass scans
  the port's source (AST, nothing imported) and reports any pytree
  registration (``register_pytree_node``, ``register_pytree_node_class``,
  ``register_dataclass``, ...) as a finding: one that appears needs an
  exemplar check written for it before it is trusted.

* **PT002, static-argument aliasing.** The types that key the port's caches
  — the plan cache (``DistInfo``, ``PlannerConfig``, ``AxisCtx``,
  ``OperandInfo``) and the tile table and on-disk plan cache
  (``KernelTile``) — are compared by ``__eq__``/``__hash__``. If equality
  ignores a meaningful field, two configurations alias one cached plan:
  the JAX package's mesh-aliasing bug (same axis names, other sizes, one
  shared plan). For each type the pass varies one field of a base instance
  at a time (for ``AxisCtx`` its axis sizes as well as its names) and
  requires every variant to compare unequal to the base and to the other
  variants, and equal instances to hash alike.
"""
from __future__ import annotations

import ast
import dataclasses as dc
import os
from typing import List, Optional, Tuple

from repro_torch.analysis.lint import Finding, iter_py_files

# the names that register a pytree with torch.utils._pytree or jax
_REGISTRATIONS = {"register_pytree_node", "register_pytree_node_class",
                  "register_pytree_with_keys", "register_dataclass",
                  "_register_pytree_node", "register_constant",
                  "register_static"}


def _called_name(node: ast.AST):
    fn = node.func if isinstance(node, ast.Call) else node
    if isinstance(fn, ast.Attribute):
        return fn.attr
    if isinstance(fn, ast.Name):
        return fn.id
    return None


def find_registrations(src_root: str) -> List[Tuple[str, int, str]]:
    """(file, line, name) of every pytree registration under ``src_root``:
    a call or a decorator naming one of the registration functions."""
    out: List[Tuple[str, int, str]] = []
    for path in iter_py_files(src_root):
        with open(path) as fh:
            try:
                tree = ast.parse(fh.read(), filename=path)
            except SyntaxError:
                continue
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
                for dec in node.decorator_list:
                    name = _called_name(dec)
                    if name in _REGISTRATIONS:
                        out.append((path, dec.lineno, name))
            elif isinstance(node, ast.Call):
                name = _called_name(node)
                if name in _REGISTRATIONS:
                    out.append((path, node.lineno, name))
    return sorted(set(out))


def check_pytrees(src_root: str) -> List[Finding]:
    """PT001 for each pytree registration in the port (there are none)."""
    return [Finding(path, line, 0, "PT001",
                    f"{name}: the port registers no pytrees, and this pass "
                    f"has no exemplar check for one; write its round-trip "
                    f"and aux-hygiene check before relying on it")
            for path, line, name in find_registrations(src_root)]


# ---------------------------------------------------------------------------
# static-argument aliasing (PT002)
# ---------------------------------------------------------------------------

def _static_type_grids():
    """(typename, base instance, [(field, variant), ...]) for every type
    that keys a cache of the port. Each variant differs from its base in
    exactly one meaningful field."""
    from repro_torch.core.distributed import AxisCtx
    from repro_torch.kernels.tile import KernelTile
    from repro_torch.planner.config import PlannerConfig
    from repro_torch.planner.ir import DistInfo, OperandInfo

    grids = []

    base = DistInfo()
    grids.append(("planner.ir.DistInfo", base, [
        ("data_size", dc.replace(base, data_size=2)),
        ("data_size", dc.replace(base, data_size=4)),   # sizes, not
        ("model_size", dc.replace(base, model_size=2)),  # just names
        ("rowsharded", dc.replace(base, rowsharded=True)),
    ]))

    base = PlannerConfig()
    grids.append(("planner.config.PlannerConfig", base, [
        ("block_rows", dc.replace(base, block_rows=16)),
        ("h_slices", dc.replace(base, h_slices=2)),
    ]))

    base = AxisCtx()
    grids.append(("core.distributed.AxisCtx", base, [
        ("data", dc.replace(base, data="data", sizes=(("data", 2),))),
        ("data", dc.replace(base, data=("data", "expert"),
                            sizes=(("data", 2), ("expert", 2)))),
        ("model", dc.replace(base, model="model", sizes=(("model", 2),))),
        # the same axis name over another group size
        ("sizes", dc.replace(base, data="data", sizes=(("data", 4),))),
    ]))

    base = OperandInfo("ijk", True, (6, 4, 8), 8, 8, "float32", None, None)
    grids.append(("planner.ir.OperandInfo", base, [
        ("term", dc.replace(base, term="jik")),
        ("is_sparse", dc.replace(base, is_sparse=False)),
        ("shape", dc.replace(base, shape=(6, 4, 10))),
        ("cap", dc.replace(base, cap=16)),
        ("nnz", dc.replace(base, nnz=4)),
        ("dtype", dc.replace(base, dtype="bfloat16")),
        ("dense_dim", dc.replace(base, dense_dim=4)),
        ("nnz_rows", dc.replace(base, nnz_rows=(3, 4, 5))),
    ]))

    base = KernelTile()
    grids.append(("kernels.tile.KernelTile", base, [
        ("block_rows", dc.replace(base, block_rows=16)),
        ("threads", dc.replace(base, threads=128)),
        ("per_thread", dc.replace(base, per_thread=4)),
        # the accumulator picks the instantiation a launch takes
        ("accum_dtype", dc.replace(base, accum_dtype="float64")),
    ]))
    return grids


def check_static_args(grids=None) -> List[Finding]:
    """PT002 over ``grids`` (default: the port's cache-key types)."""
    findings: List[Finding] = []

    def bad(msg):
        findings.append(Finding("static-args", 0, 0, "PT002", msg))

    for name, base, variants in (_static_type_grids() if grids is None
                                 else grids):
        try:
            h0 = hash(base)
        except TypeError as e:
            bad(f"{name} is unhashable — unusable as a cache-key "
                f"component: {e}")
            continue
        if hash(base) != h0 or base != base:
            bad(f"{name} hash/eq is unstable on the same instance")
        if dc.replace(base) != base or hash(dc.replace(base)) != h0:
            bad(f"{name}: an equal copy compares or hashes differently")
        seen = {base: "base"}
        for field, variant in variants:
            try:
                hash(variant)
            except TypeError as e:
                bad(f"{name} variant ({field}) is unhashable: {e}")
                continue
            if variant == base:
                bad(f"{name}: changing {field!r} produces an instance that "
                    f"compares EQUAL to the base — distinct configurations "
                    f"would alias one cached plan")
            for other, olabel in seen.items():
                if variant == other and olabel != "base":
                    bad(f"{name}: variants {field!r} and {olabel!r} alias")
            seen[variant] = field
    return findings


def check_module(name: str) -> List[Finding]:
    """The pass over one importable module (``--pytree-module``, the
    reference's extra module of exemplars): PT001 for any pytree
    registration in its source, and PT002 over the cache-key types it
    declares in ``CACHE_KEY_GRIDS`` (``(typename, base, [(field,
    variant), ...])``, as :func:`_static_type_grids` gives the port's)."""
    import importlib
    mod = importlib.import_module(name)
    path = getattr(mod, "__file__", None)
    findings: List[Finding] = []
    if path is not None:
        findings += check_pytrees(path)
    grids = getattr(mod, "CACHE_KEY_GRIDS", None)
    if grids:
        findings += check_static_args(list(grids))
    return findings


def run(repo_root: str = ".",
        extra_module: Optional[str] = None) -> List[Finding]:
    src_root = os.path.join(repo_root, "port", "repro_torch")
    findings = check_pytrees(src_root) + check_static_args()
    if extra_module is not None:
        findings += check_module(extra_module)
    return findings
