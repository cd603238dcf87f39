"""SPMD pass 2 — the collective-matching lint over the port's
``torch.distributed`` code.

Collectives are rendezvous points: every rank of a group must issue the
SAME collectives, in the same order, on the same groups, or the run
deadlocks (gloo and nccl both wait for the missing peer). This AST pass
covers every port module that imports ``torch.distributed`` or
``core.collectives`` (found by its imports, not by a list) and reads the
collective sequence of each control-flow path. A collective is a call of
the port's one wrapper (``core/collectives.py``: ``coll.all_reduce``,
``all_gather``, ``reduce_scatter``, ``broadcast``, ``exchange``,
``barrier``, ``all_reduce_ints``), of a helper that issues them
(``AxisCtx.psum_data``/``psum_model``, the butterfly, the row-sharded pair,
``DistLayout.barrier``), or of ``torch.distributed`` itself. The rules,
with their torch meaning:

* ``SP101`` collective-divergence — an ``if`` or ternary whose test varies
  by rank (``dist.get_rank()``, an ``AxisCtx``'s coordinates
  ``data_index()``/``model_index()``/``coords``, a ``.rank``, or a
  rank-local tensor value not all-reduced first) and whose branches issue
  different collective sequences: ranks taking different branches
  rendezvous on different collectives and deadlock. Tests on
  configuration (``ctx.data is not None``, a path string) branch alike on
  every rank and are never flagged.
* ``SP102`` collective-under-unreduced-predicate — a ``while`` loop whose
  test reads a tensor value that was not all-reduced first, and whose body
  issues a collective: each rank's own value sets its trip count, so the
  ranks issue different numbers of collectives (torch's counterpart of a
  collective under a traced ``lax.cond``/``while_loop`` predicate).
  Reduce the predicate's value over the group first.
* ``SP103`` collective-outside-ctx — a collective whose group is not
  threaded from the ``AxisCtx`` (no group, i.e. the world; a literal such
  as ``None``; ``dist.group.WORLD``; or a ``dist.new_group(...)`` made on
  the spot), or any ``torch.distributed`` collective called outside
  ``core/collectives.py``, the one place collectives are made (and
  counted).

Inline suppressions follow ``lint.py`` (SP101–SP103 take a reason); a
suppression naming an SP rule that no longer fires is reported stale
(``JS006``) by this pass.
"""
from __future__ import annotations

import ast
import os
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis.lint import (Finding, _contains_tensor_call,
                                       _dotted, apply_suppressions,
                                       iter_py_files, package_relpath,
                                       parse_suppressions,
                                       stale_suppressions)

# the wrapper's collectives (core/collectives.py) and where each takes its
# group, positionally
WRAPPER_GROUP_ARG = {"all_reduce": 1, "all_reduce_ints": 1,
                     "all_gather": 1, "reduce_scatter": 1, "broadcast": 2,
                     "exchange": 2, "barrier": 0}
_WRAPPER_ROOTS = {"coll", "collectives"}
# helpers that issue collectives (core/distributed.py): calling one IS a
# collective on that control-flow path
CTX_HELPERS = {"psum_data", "psum_model", "sparse_allreduce_butterfly",
               "multilinear_rowsharded", "mttkrp_rowsharded",
               "_mttkrp_rowsharded_impl", "barrier"}
# torch.distributed calls that are collectives
TORCH_COLLECTIVES = {"all_reduce", "all_gather", "all_gather_into_tensor",
                     "all_gather_object", "reduce_scatter",
                     "reduce_scatter_tensor", "broadcast",
                     "broadcast_object_list", "barrier", "batch_isend_irecv",
                     "isend", "irecv", "send", "recv", "all_to_all",
                     "all_to_all_single", "scatter", "gather", "reduce",
                     "monitored_barrier"}
_DIST_ROOTS = {"dist", "torch.distributed"}
# calls and attributes whose value differs from rank to rank
_RANK_CALLS = {"get_rank", "get_global_rank", "data_index", "model_index",
               "get_group_rank"}
_RANK_ATTRS = {"rank", "coords", "global_rank"}
# where collectives may be made
COLLECTIVES_MODULE = "core/collectives.py"
# reading a tensor value on the host
_HOST_READS = {"item", "tolist", "cpu", "numpy"}


def _is_dist_call(d: Optional[Tuple[str, ...]]) -> bool:
    return (d is not None and len(d) >= 2
            and (d[0] == "dist" or d[:2] == ("torch", "distributed")))


def collective_name(call: ast.Call) -> Optional[str]:
    """The collective this call issues, or None."""
    d = _dotted(call.func)
    if d is None:
        if isinstance(call.func, ast.Attribute) \
                and call.func.attr in CTX_HELPERS:
            return call.func.attr
        return None
    if _is_dist_call(d) and d[-1] in TORCH_COLLECTIVES:
        return f"dist.{d[-1]}"
    if len(d) >= 2 and d[-2] in _WRAPPER_ROOTS and d[-1] in WRAPPER_GROUP_ARG:
        return d[-1]
    if d[-1] in CTX_HELPERS:
        return d[-1]
    return None


def _sequence(nodes: Sequence[ast.AST]) -> Tuple[str, ...]:
    """The collectives a list of statements (or one expression) issues, in
    source order."""
    seq: List[Tuple[int, int, str]] = []
    for stmt in nodes:
        for node in ast.walk(stmt):
            if isinstance(node, ast.Call):
                name = collective_name(node)
                if name is not None:
                    seq.append((node.lineno, node.col_offset, name))
    return tuple(n for _, _, n in sorted(seq))


def _reads_rank(test: ast.AST) -> bool:
    for n in ast.walk(test):
        if isinstance(n, ast.Call):
            d = _dotted(n.func)
            name = d[-1] if d else (n.func.attr if isinstance(
                n.func, ast.Attribute) else None)
            if name in _RANK_CALLS:
                return True
        elif isinstance(n, ast.Attribute) and n.attr in _RANK_ATTRS:
            return True
    return False


class _Function:
    """What the pass knows of one function body: the names bound to a
    tensor expression, and those bound to a collective's result."""

    def __init__(self):
        self.tensor_names: Set[str] = set()
        self.reduced_names: Set[str] = set()


def _assigned_names(node: ast.AST) -> List[str]:
    targets = node.targets if isinstance(node, ast.Assign) else [node.target]
    out = []
    for t in targets:
        for n in ast.walk(t):
            if isinstance(n, ast.Name):
                out.append(n.id)
    return out


class _Visitor(ast.NodeVisitor):
    def __init__(self, path: str):
        self.path = path
        self.rel = package_relpath(path)
        self.raw: List[Finding] = []
        self.fns: List[_Function] = [_Function()]

    def _emit(self, rule: str, node: ast.AST, msg: str) -> None:
        self.raw.append(Finding(self.path, node.lineno, node.col_offset,
                                rule, msg))

    # -- the value a test reads ---------------------------------------------
    def _reads_tensor(self, test: ast.AST) -> bool:
        if _contains_tensor_call(test):
            return True
        for n in ast.walk(test):
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute) \
                    and n.func.attr in _HOST_READS:
                return True
            if isinstance(n, ast.Name) and n.id in self.fns[-1].tensor_names:
                return True
        return False

    def _reduced(self, test: ast.AST) -> bool:
        """The test reads only values all-reduced first: a collective in
        the test itself, or names bound to a collective's result."""
        if _sequence([test]):
            return True
        fn = self.fns[-1]
        names = {n.id for n in ast.walk(test) if isinstance(n, ast.Name)}
        tensor_names = names & fn.tensor_names
        return bool(tensor_names) and tensor_names <= fn.reduced_names

    def _rank_local(self, test: ast.AST) -> bool:
        return self._reads_tensor(test) and not self._reduced(test)

    # -- scopes and bindings -------------------------------------------------
    def _visit_fn(self, node):
        self.fns.append(_Function())
        self.generic_visit(node)
        self.fns.pop()

    visit_FunctionDef = _visit_fn
    visit_AsyncFunctionDef = _visit_fn

    def _bind(self, node):
        value = node.value
        if value is None:
            return
        fn = self.fns[-1]
        names = _assigned_names(node)
        tensor = _contains_tensor_call(value) or any(
            isinstance(n, ast.Name) and n.id in fn.tensor_names
            for n in ast.walk(value))
        reduced = bool(_sequence([value]))
        for name in names:
            if tensor or reduced:
                fn.tensor_names.add(name)
            if reduced:
                fn.reduced_names.add(name)
            else:
                fn.reduced_names.discard(name)

    def visit_Assign(self, node):
        self.generic_visit(node)
        self._bind(node)

    visit_AnnAssign = visit_Assign
    visit_AugAssign = visit_Assign

    # -- SP101 ---------------------------------------------------------------
    def _check_divergence(self, node, body, orelse, kind: str) -> None:
        if not (_reads_rank(node.test) or self._rank_local(node.test)):
            return
        a, b = _sequence(body), _sequence(orelse)
        if a != b:
            self._emit(
                "SP101", node,
                f"collective sequences diverge across a rank-varying "
                f"{kind}: {list(a)} against {list(b)} — ranks taking "
                f"different branches rendezvous on different collectives "
                f"and deadlock")

    def visit_If(self, node):
        self._check_divergence(node, node.body, node.orelse, "`if`")
        self.generic_visit(node)

    def visit_IfExp(self, node):
        self._check_divergence(node, [node.body], [node.orelse], "ternary")
        self.generic_visit(node)

    # -- SP102 ---------------------------------------------------------------
    def visit_While(self, node):
        if self._rank_local(node.test):
            seq = _sequence(node.body)
            if seq:
                self._emit(
                    "SP102", node,
                    f"`while` on a tensor value that was not all-reduced "
                    f"first, around collectives {list(seq)} — each rank's "
                    f"own value sets its trip count, so the ranks issue "
                    f"different numbers of collectives; all-reduce the "
                    f"predicate's value over the group first")
        self.generic_visit(node)

    # -- SP103 ---------------------------------------------------------------
    def visit_Call(self, node):
        d = _dotted(node.func)
        if _is_dist_call(d) and d[-1] in TORCH_COLLECTIVES \
                and self.rel != COLLECTIVES_MODULE:
            self._emit(
                "SP103", node,
                f"torch.distributed.{d[-1]} outside core/collectives.py — "
                f"every collective goes through the port's one wrapper, "
                f"where it is counted and staged; call coll.{d[-1]}")
        elif (d is not None and len(d) >= 2 and d[-2] in _WRAPPER_ROOTS
              and d[-1] in WRAPPER_GROUP_ARG):
            why = self._unthreaded_group(node, WRAPPER_GROUP_ARG[d[-1]])
            if why:
                self._emit(
                    "SP103", node,
                    f"coll.{d[-1]} over {why} — a collective's group comes "
                    f"from the AxisCtx (ctx.data_group, ctx.model_group) "
                    f"or is threaded in by the caller")
        self.generic_visit(node)

    @staticmethod
    def _unthreaded_group(call: ast.Call, pos: int) -> Optional[str]:
        group = call.args[pos] if len(call.args) > pos else None
        for kw in call.keywords:
            if kw.arg == "group":
                group = kw.value
        if group is None:
            return "the default group (the world)"
        if isinstance(group, ast.Constant):
            return f"the literal {group.value!r}"
        d = _dotted(group)
        if d is not None and d[-1] == "WORLD":
            return "dist.group.WORLD"
        if isinstance(group, ast.Call):
            gd = _dotted(group.func)
            if gd is not None and gd[-1] == "new_group":
                return "a group made on the spot"
        return None


def imports_distributed(tree: ast.AST) -> bool:
    """Does the module import ``torch.distributed`` or the port's
    ``core.collectives``?"""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            if any(a.name.startswith("torch.distributed")
                   or a.name == "repro_torch.core.collectives"
                   for a in node.names):
                return True
        elif isinstance(node, ast.ImportFrom) and node.module:
            if node.module.startswith("torch.distributed") or (
                    node.module == "torch"
                    and any(a.name == "distributed" for a in node.names)):
                return True
            if node.module == "repro_torch.core.collectives" or (
                    node.module == "repro_torch.core"
                    and any(a.name == "collectives" for a in node.names)):
                return True
    return False


def lint_source(source: str, path: str, *,
                require_import: bool = False) -> List[Finding]:
    """The collective-matching lint of one file, with ``lint.py``'s
    suppression and SP-stale (JS006) discipline. ``require_import`` skips
    a file that imports neither ``torch.distributed`` nor the wrapper."""
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [Finding(path, e.lineno or 0, e.offset or 0, "SP000",
                        f"file does not parse: {e.msg}")]
    if require_import and not imports_distributed(tree):
        return []
    visitor = _Visitor(path)
    visitor.visit(tree)
    supp, _bad, records = parse_suppressions(source, path)
    findings = apply_suppressions(visitor.raw, supp)
    findings += stale_suppressions(path, visitor.raw, records,
                                   lambda r: r.startswith("SP"))
    return sorted(findings, key=lambda f: (f.line, f.col, f.rule))


def lint_file(path: str, require_import: bool = False) -> List[Finding]:
    with open(path) as fh:
        return lint_source(fh.read(), path, require_import=require_import)


def covered_files(root: str) -> List[str]:
    """The port modules this pass covers: those that import
    ``torch.distributed`` or ``core.collectives``."""
    out = []
    for path in iter_py_files(os.path.join(root, "port", "repro_torch")):
        if "/analysis/" in path.replace(os.sep, "/"):
            continue
        with open(path) as fh:
            try:
                tree = ast.parse(fh.read(), filename=path)
            except SyntaxError:
                out.append(path)
                continue
        if imports_distributed(tree):
            out.append(path)
    return out


def run(root: str) -> List[Finding]:
    """Lint every covered module of the port under the repo root."""
    findings: List[Finding] = []
    for path in covered_files(root):
        findings.extend(lint_file(path))
    return findings


def covered_modules(root: str) -> Dict[str, str]:
    """{package-relative path: absolute path} of the covered modules."""
    return {package_relpath(p): p for p in covered_files(root)}
