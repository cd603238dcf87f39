"""Import-graph dead-code report over ``port/repro_torch``.

Builds the static import graph of the port (AST-level: absolute
``repro_torch.*`` imports and relative imports, symbol imports resolved to
a module when one exists) and classifies every module by reachability:

* **product** — reachable from the port's entry points (``DEFAULT_ROOTS``:
  the completion, serving, experiment and report CLIs, the ``ctf`` facade
  and this analysis package, plus every ``__main__``);
* **test-only** — reachable only through ``tests/`` or ``chip_smoke.py``
  (listed with the files that import them: candidates for deletion with
  their tests, or for wiring into a product path);
* **unreachable** — imported by nothing at all. These BLOCK ``--all``.

Importing a submodule executes its parent packages, so ``repro_torch.a.b``
implies an edge to ``repro_torch.a``.
"""
from __future__ import annotations

import ast
import dataclasses
import os
from typing import Dict, Optional, Sequence, Set

PACKAGE = "repro_torch"

DEFAULT_ROOTS = (
    "repro_torch.launch.complete",        # completion CLI (every algorithm)
    "repro_torch.launch.serve_complete",  # serving CLI on dumped factors
    "repro_torch.launch.experiment",      # named experiment specs
    "repro_torch.launch.report",          # the perf report
    "repro_torch.core.api",               # the ctf facade
    "repro_torch.analysis",               # this package (the gates' CLI)
)


@dataclasses.dataclass
class Report:
    modules: Dict[str, Set[str]]          # module -> direct port imports
    product: Set[str]
    test_only: Dict[str, Set[str]]        # module -> files touching it
    unreachable: Set[str]

    def format(self) -> str:
        lines = [f"import graph: {len(self.modules)} modules, "
                 f"{len(self.product)} reachable from product roots"]
        if self.test_only:
            lines.append("test-only modules (delete with their tests, or "
                         "wire into a product path):")
            for m in sorted(self.test_only):
                vias = ", ".join(sorted(self.test_only[m]))
                lines.append(f"  {m}  (via {vias})")
        if self.unreachable:
            lines.append("UNREACHABLE modules (imported by nothing):")
            lines += [f"  {m}" for m in sorted(self.unreachable)]
        return "\n".join(lines)


def _module_name(path: str, src_root: str) -> str:
    rel = os.path.relpath(path, src_root)
    parts = rel[:-3].split(os.sep)           # strip .py
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def _imports_of(path: str, module: str, known: Set[str]) -> Set[str]:
    """Direct port-module imports of one file, resolved against
    ``known``."""
    with open(path) as fh:
        try:
            tree = ast.parse(fh.read(), filename=path)
        except SyntaxError:
            return set()
    out: Set[str] = set()

    def add(name: str) -> None:
        # resolve to the deepest known module prefix (symbol imports from a
        # package resolve to the package)
        parts = name.split(".")
        for i in range(len(parts), 0, -1):
            cand = ".".join(parts[:i])
            if cand in known:
                out.add(cand)
                return

    pkg_parts = module.split(".")
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name.split(".")[0] == PACKAGE:
                    add(a.name)
        elif isinstance(node, ast.ImportFrom):
            if node.level:                    # relative import
                base = pkg_parts[:len(pkg_parts) - node.level + 1] \
                    if path.endswith("__init__.py") else \
                    pkg_parts[:len(pkg_parts) - node.level]
                mod = ".".join(base + ([node.module] if node.module else []))
            else:
                mod = node.module or ""
            if mod.split(".")[0] == PACKAGE:
                add(mod)
                for a in node.names:
                    add(f"{mod}.{a.name}")
    return out


def build_graph(src_root: str) -> Dict[str, Set[str]]:
    """Module -> the port modules it imports, for every module of the
    package under ``src_root`` (the directory that holds ``repro_torch``)."""
    paths: Dict[str, str] = {}
    for dirpath, dirnames, filenames in os.walk(
            os.path.join(src_root, PACKAGE)):
        dirnames[:] = [d for d in dirnames
                       if d not in ("__pycache__", "build")]
        for fn in filenames:
            if fn.endswith(".py"):
                p = os.path.join(dirpath, fn)
                paths[_module_name(p, src_root)] = p
    known = set(paths)
    graph: Dict[str, Set[str]] = {}
    for mod, p in paths.items():
        deps = _imports_of(p, mod, known)
        # importing a submodule executes its parents
        parts = mod.split(".")
        for i in range(1, len(parts)):
            parent = ".".join(parts[:i])
            if parent in known:
                deps.add(parent)
        graph[mod] = deps - {mod}
    return graph


def _reach(graph: Dict[str, Set[str]], roots: Sequence[str]) -> Set[str]:
    seen: Set[str] = set()
    stack = [r for r in roots if r in graph]
    while stack:
        m = stack.pop()
        if m in seen:
            continue
        seen.add(m)
        stack.extend(graph.get(m, ()))
    return seen


def _external_imports(paths: Sequence[str], known: Set[str],
                      repo_root: str) -> Dict[str, Set[str]]:
    """{module: files importing it} over the ``.py`` files under
    ``paths`` (files or directories outside the package)."""
    out: Dict[str, Set[str]] = {}
    for top in paths:
        if os.path.isfile(top):
            files = [top]
        elif os.path.isdir(top):
            files = [os.path.join(d, f) for d, dirs, fs in os.walk(top)
                     for f in fs if f.endswith(".py")]
        else:
            continue
        for p in files:
            for mod in _imports_of(p, "", known):
                out.setdefault(mod, set()).add(os.path.relpath(p, repo_root))
    return out


def analyze(repo_root: str = ".",
            roots: Optional[Sequence[str]] = None) -> Report:
    src_root = os.path.join(repo_root, "port")
    graph = build_graph(src_root)
    known = set(graph)
    roots = tuple(roots) if roots else DEFAULT_ROOTS
    # ``python -m pkg`` entry points are roots by construction
    roots += tuple(m for m in graph if m.endswith(".__main__"))
    product = _reach(graph, roots)
    tests = _external_imports(
        [os.path.join(repo_root, "tests"),
         os.path.join(repo_root, "chip_smoke.py")], known, repo_root)
    test_reach = _reach(graph, list(tests))

    test_only: Dict[str, Set[str]] = {}
    unreachable: Set[str] = set()
    for mod in known:
        if mod in product or mod == PACKAGE:
            continue
        if mod in test_reach:
            vias: Set[str] = set()
            for t_mod, files in tests.items():
                if mod == t_mod or mod in _reach(graph, [t_mod]):
                    vias |= files
            test_only[mod] = vias
        else:
            unreachable.add(mod)
    return Report(graph, product, test_only, unreachable)
