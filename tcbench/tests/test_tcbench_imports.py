"""Nothing the benchmark runs loads JAX, the JAX package or
``benchmarks``, and the references load nothing of the program: each
compared by whole top-level module names (``repro_torch`` begins with
``repro`` and is not it)."""
import subprocess
import sys
import types

from tcbench import ROOT, run

EVERY_CELL = r"""
import importlib, json, pkgutil, sys
sys.path.insert(0, sys.argv[1])
import tcbench
from tcbench import run, spec
from tcbench.tests.small import SMALL
for m in pkgutil.walk_packages(tcbench.__path__, "tcbench."):
    if ".tests" not in m.name:
        importlib.import_module(m.name)
b = spec.load()
run.use_program()
for m in b["per_layer"]:
    spec.load_reader(m["name"])
for w in b["workloads"]:
    r = run.execute(b, spec.resolve(b, w["name"]), 5, 0.1, False, "cpu",
                    SMALL[w["name"]])
    assert r["correct"], r
print(json.dumps(run.forbidden_modules()))
"""

REFERENCES_ONLY = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
from tcbench import gen
from tcbench.reference import als, common, foldin, ggn, topk
idx, vals = gen.function_tensor((20, 15, 10), 400, torch.Generator(),
                                torch.Generator())
fs = gen.normal_factors((20, 15, 10), 3, torch.Generator())
p = common.Problem(idx, vals.double(), fs, (20, 15, 10))
als.follow(p, {"lam": 1e-5, "cg_tol": 1e-4, "cg_iters": 5}, 1,
           common.REFERENCE)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _run(code):
    p = subprocess.run([sys.executable, "-c", code, str(ROOT)], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    return p.stdout.strip().splitlines()[-1]


def test_no_cell_loads_jax_the_jax_package_or_benchmarks():
    assert _run(EVERY_CELL) == "[]"


def test_the_references_load_nothing_of_the_program():
    tops = _run(REFERENCES_ONLY)
    assert '"repro_torch"' not in tops and '"repro"' not in tops
    assert '"jax"' not in tops


def test_the_guard_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_like", types.ModuleType(
        "repro_torch_like"))
    assert run.forbidden_modules() == []
    for name in ("repro", "jax.numpy", "benchmarks.run", "flax"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert run.forbidden_modules() == ["benchmarks", "flax", "jax", "repro"]
