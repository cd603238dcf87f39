"""Pass 1 — the port's lint: AST rules over ``port/repro_torch`` that catch
host syncs, unfenced timing and irreproducible randomness before a run does.

The sweep layers (``core/ kernels/ planner/ sparse/``) run inside the
solvers' sweeps and, in serving, inside CUDA-graph capture. There a Python
branch on a tensor value or a host coercion waits for the device (a host
sync per call, which serialises the stream), and under capture it raises:
the graph cannot read a value it has not computed yet. Timing with the
host clock measures the enqueue, not the work, unless the device is
synchronised first.

Rules (which apply depends on the file's scope, :func:`scope_rules`); the
rule ids, the suppression syntax, the :class:`Finding` record and the exit
codes are the JAX package's (``repro.analysis.lint``), each rule with its
torch meaning:

* ``JS001`` tensor-branch     — a Python ``if``/``while``/ternary or
  ``assert`` on a tensor expression (one that calls a ``torch.`` function
  returning a tensor): a host sync, and an error under CUDA-graph capture.
  Keep the value on the device (``torch.where``) or branch on host data.
* ``JS002`` host-coercion     — ``.item()``, ``.tolist()``, ``.cpu()``,
  ``.numpy()``, or ``float()``/``int()``/``bool()``/``np.asarray()`` of a
  tensor expression: each copies to the host and waits for the device.
* ``JS003`` unfenced-timing   — ``time.perf_counter``/``time.time``/... in a
  function with no ``torch.cuda.synchronize``, event ``synchronize``/
  ``elapsed_time`` or ``.fence(`` (an ``obs`` span's fence): launches
  return before the card finishes, so the clock reads the enqueue.
  ``obs/trace.py`` and ``planner/tuner.py`` time by charter.
* ``JS004`` host-io-in-loop   — ``print``/``logging`` calls inside loop
  bodies of the sweep layers; emit ``obs`` counters and spans instead.
* ``JS005`` nondeterminism    — stdlib ``random.*``, legacy global
  ``np.random.*``, a seedless ``np.random.default_rng()``, torch's global
  RNG draws (``torch.rand*``, ``randperm``, ``normal``, ``bernoulli``,
  ``multinomial``, ``poisson`` without ``generator=``) and
  ``torch.manual_seed``/``torch.seed``/``torch.cuda.manual_seed*`` in
  library code; ``data/`` is exempt (every generator there is seeded by
  construction).
* ``JS000`` bad-suppression   — a suppression comment with no reason string
  or an unknown rule id. Never suppressible.
* ``JS006`` stale-suppression — a reasoned suppression whose rule no longer
  fires on the covered line(s). Advisory in the CLI, an error under
  ``--strict-suppressions``.

The JAX package has no rule for nondeterministic atomics, and the port adds
none: its kernels use no atomics (each warp of a bucketed CTA sums into a
shared slab of its own, ``csrc/scatter_rows.cuh``), and the aten reductions
that do (``index_add_``) follow PyTorch's determinism switch.

Suppression syntax (requires a reason after ``--``)::

    n = int(t.sum())  # repro-lint: disable=JS002 -- sizes the output, once

A comment-only suppression line applies to the next line as well.
"""
from __future__ import annotations

import ast
import dataclasses
import io
import os
import re
import tokenize
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

RULES: Dict[str, str] = {
    "JS000": "bad-suppression",
    "JS001": "tensor-branch",
    "JS002": "host-coercion",
    "JS003": "unfenced-timing",
    "JS004": "host-io-in-loop",
    "JS005": "nondeterminism",
    "JS006": "stale-suppression",
    # the other passes report through the same Finding record; these rule
    # ids are NOT inline-suppressible (they describe structural contracts)
    "CT001": "path-output-disagreement",
    "CT002": "cost-invariant",
    "CT003": "cache-key",
    "PT001": "pytree-registration",
    "PT002": "static-arg-aliasing",
    "DC001": "dead-code",
    # the SPMD passes (repro_torch.analysis.spmd): the sharding interpreter
    # (SP0xx), the collective-matching AST lint (SP1xx) and the
    # shared-memory certifier (SP2xx)
    "SP000": "spmd-analysis-error",
    "SP001": "partial-sum-escape",
    "SP002": "redundant-psum",
    "SP003": "wrong-replication-state",
    "SP004": "sharded-dim-gather",
    "SP101": "collective-divergence",
    "SP102": "collective-under-unreduced-predicate",
    "SP103": "collective-outside-ctx",
    "SP201": "smem-over-budget",
}

# rules an inline disable comment may name: the per-line source rules.
# Structural contracts (CT/PT/DC, SP2xx) are properties of the program, not
# of a source line — never suppressible.
SUPPRESSIBLE: Set[str] = {"JS001", "JS002", "JS003", "JS004", "JS005",
                          "SP101", "SP102", "SP103"}

# the sweep layers: run inside the solvers' sweeps and CUDA-graph capture
SWEEP_PREFIXES = ("core/", "kernels/", "planner/", "sparse/")
# host-side layers: eager by design (CLI drivers, ingest, checkpoint I/O,
# serving's host packing)
_HOST_PREFIXES = ("launch/", "runtime/", "checkpoint/", "optim/", "obs/",
                  "analysis/", "data/", "serve/")
# the sanctioned timing primitives: span measures wall time by design, and
# the tile tuner's charter is fenced host timing of kernel candidates
_TIMING_EXEMPT = ("obs/trace.py", "planner/tuner.py")
PACKAGE = "repro_torch"

_SUPPRESS_RE = re.compile(
    r"#\s*repro-lint:\s*disable=([A-Za-z0-9_,\s]+?)\s*(?:--\s*(.*\S))?\s*$")
# a line that *looks* like a suppression comment but fails _SUPPRESS_RE is
# malformed; requiring the comment-start form keeps prose mentions inert
_HINT_RE = re.compile(r"#\s*repro-lint:")

_STDLIB_RANDOM = {"random", "randint", "randrange", "choice", "choices",
                  "shuffle", "sample", "uniform", "gauss", "seed",
                  "getrandbits", "betavariate", "normalvariate"}
_NP_RANDOM_LEGACY = {"rand", "randn", "randint", "random", "random_sample",
                     "ranf", "choice", "shuffle", "permutation", "uniform",
                     "normal", "seed", "poisson", "binomial", "standard_normal"}
# torch draws from its global generator unless given ``generator=``
_TORCH_RANDOM = {"rand", "randn", "randint", "rand_like", "randn_like",
                 "randint_like", "randperm", "normal", "bernoulli",
                 "multinomial", "poisson"}
_TORCH_SEEDING = {("torch", "manual_seed"), ("torch", "seed"),
                  ("torch", "random", "manual_seed"),
                  ("torch", "cuda", "manual_seed"),
                  ("torch", "cuda", "manual_seed_all")}
_LOG_METHODS = {"debug", "info", "warning", "warn", "error", "critical",
                "exception", "log"}
_LOG_ROOTS = {"log", "logger", "logging"}
_TIME_FNS = {"perf_counter", "time", "monotonic", "process_time"}
# torch.cuda.synchronize, Event.synchronize / elapsed_time, span.fence
_FENCE_NAMES = {"synchronize", "elapsed_time", "fence"}
# tensor methods that reduce to a tensor a Python test would read
_TENSOR_METHODS = {"sum", "max", "min", "any", "all", "mean", "amax", "amin",
                   "count_nonzero", "norm", "prod", "argmax", "argmin",
                   "isfinite", "isnan", "equal", "allclose"}
# modules whose functions share those names and return host values
_HOST_MODULES = {"math", "np", "numpy", "statistics", "builtins"}
# host-copying tensor methods (JS002)
_HOST_METHODS = {"item", "tolist", "cpu", "numpy"}
# torch.<name> calls that return no tensor: configuration, dtypes, devices,
# the distributed and CUDA runtimes; a branch on them is no host sync
_TORCH_NON_TENSOR = {
    "cuda", "distributed", "backends", "utils", "device", "Size", "finfo",
    "iinfo", "dtype", "Generator", "is_tensor", "is_grad_enabled",
    "is_floating_point", "is_complex", "result_type", "promote_types",
    "get_default_dtype", "are_deterministic_algorithms_enabled", "no_grad",
    "enable_grad", "inference_mode", "set_grad_enabled", "jit", "compiler",
    "profiler", "autograd", "library", "version", "get_num_threads",
    "set_num_threads", "is_inference_mode_enabled", "testing", "_C", "ops",
    "can_cast", "get_device", "is_storage", "overrides"}


@dataclasses.dataclass(frozen=True)
class Finding:
    file: str
    line: int
    col: int
    rule: str
    message: str
    suppressed: bool = False
    reason: str = ""
    # advisory findings (JS006) warn in the CLI and only block under
    # --strict-suppressions
    advisory: bool = False

    def format(self) -> str:
        tag = f" [suppressed: {self.reason}]" if self.suppressed else ""
        return (f"{self.file}:{self.line}:{self.col}: {self.rule} "
                f"({RULES[self.rule]}) {self.message}{tag}")


def package_relpath(path: str) -> str:
    """``path`` relative to the ``repro_torch`` package ('' outside it)."""
    norm = path.replace(os.sep, "/")
    marker = f"{PACKAGE}/"
    if f"/{marker}" in norm:
        return norm.split(f"/{marker}", 1)[1]
    if norm.startswith(marker):
        return norm[len(marker):]
    return ""


def scope_rules(path: str) -> Set[str]:
    """Rules applicable to ``path`` (see the module docstring). Unknown
    files get the host-side set: timing and determinism hold everywhere."""
    rel = package_relpath(path)
    if any(rel.startswith(p) for p in _TIMING_EXEMPT):
        return {"JS005"}
    if any(rel.startswith(p) for p in SWEEP_PREFIXES):
        return {"JS001", "JS002", "JS003", "JS004", "JS005"}
    if rel.startswith("data/"):
        # seeded host RNG lives here by charter; JS005 exempt
        return {"JS003", "JS004"}
    return {"JS003", "JS005"}


# ---------------------------------------------------------------------------
# expression classification helpers
# ---------------------------------------------------------------------------

def _dotted(node: ast.AST) -> Optional[Tuple[str, ...]]:
    """('torch', 'cuda', 'synchronize') for ``torch.cuda.synchronize`` —
    None when the chain is not a pure Name/Attribute path."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return tuple(reversed(parts))
    return None


def _is_tensor_call(call: ast.Call) -> bool:
    """A call that returns a tensor in idiomatic port code: rooted at
    ``torch`` (``torch.where``, ``torch.nn.functional.pad``), but not at its
    configuration, dtype, device or runtime namespaces; or a reduction
    method (``x.sum()``, ``(a == b).all()``), whose receiver in the sweep
    layers is a tensor."""
    if (isinstance(call.func, ast.Attribute)
            and call.func.attr in _TENSOR_METHODS):
        recv = call.func.value
        return not (isinstance(recv, ast.Name) and recv.id in _HOST_MODULES)
    d = _dotted(call.func)
    if d is None or d[0] != "torch" or len(d) < 2:
        return False
    return d[1] not in _TORCH_NON_TENSOR


def _contains_tensor_call(node: ast.AST) -> bool:
    return any(isinstance(n, ast.Call) and _is_tensor_call(n)
               for n in ast.walk(node))


# ---------------------------------------------------------------------------
# the visitor
# ---------------------------------------------------------------------------

class _Visitor(ast.NodeVisitor):
    def __init__(self, path: str, rules: Set[str]):
        self.path = path
        self.rules = rules
        self.raw: List[Finding] = []
        self.loop_depth = 0
        # stack of per-function state: the timing calls, and whether a
        # fence call was seen in that function body
        self.fn_stack: List[Dict] = [{"timing": [], "fenced": False}]

    def _emit(self, rule: str, node: ast.AST, msg: str) -> None:
        if rule in self.rules:
            self.raw.append(Finding(self.path, node.lineno, node.col_offset,
                                    rule, msg))

    # -- function scopes (JS003 is resolved per function) -------------------
    def _visit_fn(self, node):
        self.fn_stack.append({"timing": [], "fenced": False})
        outer_loops, self.loop_depth = self.loop_depth, 0
        self.generic_visit(node)
        self.loop_depth = outer_loops
        st = self.fn_stack.pop()
        if st["fenced"]:
            # a fenced nested closure fences its enclosing timing scope (the
            # idiomatic `def run(): ...; torch.cuda.synchronize()` wrapper)
            self.fn_stack[-1]["fenced"] = True
        if not st["fenced"]:
            for line, col, name in st["timing"]:
                self.raw.append(Finding(
                    self.path, line, col, "JS003",
                    f"time.{name}() with no torch.cuda.synchronize, event "
                    f"elapsed_time or fence in this function — launches "
                    f"return before the card finishes, so the clock reads "
                    f"the enqueue; use repro_torch.obs.span + sp.fence"))

    visit_FunctionDef = _visit_fn
    visit_AsyncFunctionDef = _visit_fn

    # -- branches (JS001) ---------------------------------------------------
    def _check_branch(self, node, kind: str):
        if _contains_tensor_call(node.test):
            self._emit("JS001", node,
                       f"Python {kind} branches on a tensor expression — a "
                       f"host sync, and an error under CUDA-graph capture; "
                       f"keep it on the device (torch.where) or branch on "
                       f"host data")

    def visit_If(self, node):
        self._check_branch(node, "`if`")
        self.generic_visit(node)

    def visit_IfExp(self, node):
        self._check_branch(node, "ternary")
        self.generic_visit(node)

    def visit_While(self, node):
        self._check_branch(node, "`while`")
        self.visit(node.test)
        self.loop_depth += 1
        for child in node.body + node.orelse:
            self.visit(child)
        self.loop_depth -= 1

    def visit_For(self, node):
        self.visit(node.iter)
        self.loop_depth += 1
        for child in node.body + node.orelse:
            self.visit(child)
        self.loop_depth -= 1

    def visit_Assert(self, node):
        if _contains_tensor_call(node.test):
            self._emit("JS001", node,
                       "`assert` on a tensor expression — a host sync (and "
                       "gone under -O); check fetched values at the host "
                       "boundary")
        self.generic_visit(node)

    # -- calls (JS002/JS003/JS004/JS005) ------------------------------------
    def visit_Call(self, node):
        d = _dotted(node.func)

        # JS002: host copies of tensor values
        if (isinstance(node.func, ast.Attribute)
                and node.func.attr in _HOST_METHODS
                and not node.args and not node.keywords):
            self._emit("JS002", node,
                       f".{node.func.attr}() copies to the host and waits "
                       f"for the device (an error under CUDA-graph "
                       f"capture); keep the value on the device or fetch "
                       f"it once at the host boundary")
        elif (isinstance(node.func, ast.Name)
              and node.func.id in ("float", "int", "bool")
              and len(node.args) == 1
              and _contains_tensor_call(node.args[0])):
            self._emit("JS002", node,
                       f"{node.func.id}() of a tensor expression — a host "
                       f"sync; keep the value as a tensor or coerce at the "
                       f"host boundary only")
        elif (d is not None and len(d) >= 2 and d[0] in ("np", "numpy")
              and d[-1] in ("asarray", "array") and node.args
              and _contains_tensor_call(node.args[0])):
            self._emit("JS002", node,
                       "np.asarray of a tensor expression copies it to the "
                       "host and waits for the device")

        # JS003: timing calls collected per enclosing function
        if (d is not None and len(d) == 2 and d[0] == "time"
                and d[1] in _TIME_FNS and "JS003" in self.rules):
            self.fn_stack[-1]["timing"].append(
                (node.lineno, node.col_offset, d[1]))
        if (d is not None and d[-1] in _FENCE_NAMES) or (
                isinstance(node.func, ast.Attribute)
                and node.func.attr in _FENCE_NAMES):
            self.fn_stack[-1]["fenced"] = True

        # JS004: host I/O inside loop bodies
        if self.loop_depth > 0:
            if isinstance(node.func, ast.Name) and node.func.id == "print":
                self._emit("JS004", node,
                           "print() inside a loop body in library code — "
                           "host I/O every iteration; emit repro_torch.obs "
                           "counters/spans instead")
            elif (d is not None and len(d) == 2 and d[0] in _LOG_ROOTS
                  and d[1] in _LOG_METHODS):
                self._emit("JS004", node,
                           f"{'.'.join(d)}() inside a loop body in library "
                           f"code; emit repro_torch.obs counters/spans "
                           f"instead")

        # JS005: nondeterminism sources
        if d is not None:
            self._check_random(node, d)

        self.generic_visit(node)

    def _check_random(self, node: ast.Call, d: Tuple[str, ...]) -> None:
        if len(d) == 2 and d[0] == "random" and d[1] in _STDLIB_RANDOM:
            self._emit("JS005", node,
                       f"stdlib random.{d[1]}() is unseeded global state — "
                       f"results are irreproducible; pass a "
                       f"torch.Generator or np.random.default_rng(seed)")
        elif (len(d) == 3 and d[0] in ("np", "numpy") and d[1] == "random"
              and d[2] in _NP_RANDOM_LEGACY):
            self._emit("JS005", node,
                       f"legacy global np.random.{d[2]}() — global-state RNG "
                       f"breaks reproducibility and shard invariance; use "
                       f"np.random.default_rng(seed)")
        elif (len(d) == 3 and d[0] in ("np", "numpy") and d[1] == "random"
              and d[2] == "default_rng" and not node.args
              and not node.keywords):
            self._emit("JS005", node,
                       "np.random.default_rng() without a seed is "
                       "entropy-seeded; pass a seed or SeedSequence")
        elif (len(d) == 2 and d[0] == "torch" and d[1] in _TORCH_RANDOM
              and not any(k.arg == "generator" for k in node.keywords)):
            self._emit("JS005", node,
                       f"torch.{d[1]}() without generator= draws from "
                       f"torch's global generator — any other draw in the "
                       f"process changes it; pass a seeded torch.Generator")
        elif d in _TORCH_SEEDING:
            self._emit("JS005", node,
                       f"{'.'.join(d)}() reseeds the process-wide generator "
                       f"from library code, under every other caller; seed "
                       f"a torch.Generator of your own")


# ---------------------------------------------------------------------------
# suppression handling
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Suppression:
    """One well-formed reasoned suppression comment (for stale tracking)."""
    line: int
    rules: Tuple[str, ...]
    reason: str
    covered: Tuple[int, ...]


def _iter_comments(source: str) -> Iterator[Tuple[int, int, str]]:
    """(line, col, text) of every real COMMENT token. Tokenizing (rather
    than line-scanning) keeps suppression examples inside docstrings inert
    — they are STRING tokens, not comments."""
    try:
        tokens = list(tokenize.generate_tokens(io.StringIO(source).readline))
    except (tokenize.TokenError, IndentationError, SyntaxError):
        # unparsable tail: fall back to the plain line scan
        for i, text in enumerate(source.splitlines(), start=1):
            pos = text.find("#")
            if pos >= 0:
                yield i, pos, text[pos:]
        return
    for tok in tokens:
        if tok.type == tokenize.COMMENT:
            yield tok.start[0], tok.start[1], tok.string


def parse_suppressions(source: str, path: str):
    """({line: (rules, reason)}, JS000 findings for malformed comments,
    [Suppression] records of the well-formed ones for stale detection)."""
    supp: Dict[int, Tuple[Set[str], str]] = {}
    bad: List[Finding] = []
    records: List[Suppression] = []
    lines = source.splitlines()
    for i, col, text in _iter_comments(source):
        m = _SUPPRESS_RE.search(text)
        if not m:
            if _HINT_RE.search(text):
                bad.append(Finding(path, i, 0, "JS000",
                                   "malformed repro-lint suppression "
                                   "(syntax: `# repro-lint"
                                   ": disable=JSxxx -- reason`)"))
            continue
        rules = {r.strip().upper() for r in m.group(1).split(",") if r.strip()}
        reason = (m.group(2) or "").strip()
        unknown = sorted(r for r in rules if r not in SUPPRESSIBLE)
        if unknown:
            bad.append(Finding(path, i, 0, "JS000",
                               f"suppression names unknown/unsuppressible "
                               f"rule(s) {unknown}"))
            rules -= set(unknown)
        if not reason:
            bad.append(Finding(path, i, 0, "JS000",
                               "suppression without a reason string — every "
                               "disable must say why (`-- <reason>`)"))
            continue  # a reasonless suppression does not suppress
        if rules:
            covered = [i]
            # a comment-only line covers the following statement line too
            before = lines[i - 1][:col] if i - 1 < len(lines) else ""
            if not before.strip():
                covered.append(i + 1)
            records.append(Suppression(i, tuple(sorted(rules)), reason,
                                       tuple(covered)))
            for ln in covered:
                prev = supp.get(ln, (set(), ""))
                supp[ln] = (prev[0] | rules, reason or prev[1])
    return supp, bad, records


def apply_suppressions(raw: Sequence[Finding], supp) -> List[Finding]:
    """``raw`` with each finding on a suppressed line marked suppressed."""
    out: List[Finding] = []
    for f in raw:
        s = supp.get(f.line)
        if s and f.rule in s[0]:
            out.append(dataclasses.replace(f, suppressed=True, reason=s[1]))
        else:
            out.append(f)
    return out


def stale_suppressions(path: str, raw: Sequence[Finding], records,
                       judged) -> List[Finding]:
    """JS006 for each reasoned suppression of a rule ``judged(rule)``
    accepts that fired on none of its covered lines: the code was fixed
    (or moved) and the disable rotted."""
    fired = {(f.line, f.rule) for f in raw}
    out: List[Finding] = []
    for rec in records:
        for r in rec.rules:
            if judged(r) and not any((ln, r) in fired for ln in rec.covered):
                out.append(Finding(
                    path, rec.line, 0, "JS006",
                    f"stale suppression: {r} no longer fires on "
                    f"line(s) {list(rec.covered)} — remove the disable "
                    f"comment (reason was: {rec.reason!r})",
                    advisory=True))
    return out


def lint_source(source: str, path: str,
                rules: Optional[Set[str]] = None) -> List[Finding]:
    """Lint one file's source. ``rules`` overrides the path-derived scope
    (the tests force the sweep-layer rule set on their snippets)."""
    rules = rules if rules is not None else scope_rules(path)
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [Finding(path, e.lineno or 0, e.offset or 0, "JS000",
                        f"file does not parse: {e.msg}")]
    visitor = _Visitor(path, rules)
    visitor.visit(tree)
    supp, findings, records = parse_suppressions(source, path)
    findings += apply_suppressions(visitor.raw, supp)
    # only JS rules in this file's active scope are judged stale here;
    # SP1xx suppressions are the spmd collectives pass's to verify
    findings += stale_suppressions(
        path, visitor.raw, records,
        lambda r: r.startswith("JS") and r in rules)
    return sorted(findings, key=lambda f: (f.line, f.col, f.rule))


def lint_file(path: str, rules: Optional[Set[str]] = None) -> List[Finding]:
    with open(path, "r") as fh:
        return lint_source(fh.read(), path, rules)


def iter_py_files(root: str) -> Iterator[str]:
    """Every ``.py`` under ``root`` (a file or a directory), sorted."""
    if os.path.isfile(root):
        yield root
        return
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames
                             if d not in ("__pycache__", ".git", "build"))
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                yield os.path.join(dirpath, fn)


def lint_paths(paths: Sequence[str]) -> List[Finding]:
    """Lint every ``.py`` under the given files/directories."""
    findings: List[Finding] = []
    for root in paths:
        for path in iter_py_files(root):
            findings.extend(lint_file(path))
    return findings
