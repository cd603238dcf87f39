"""A cell joins the benchmark through new files and new entries in
``BENCHMARK.json`` alone: in a copy of the harness (the program linked in,
as a checkout holds it), a new traffic file and the new cell's entries are
added, and the copy's spec, its CPU tests' sizes and a CPU run take the
cell, while no file that the copy already had changes."""
import hashlib
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from tcbench import HERE, ROOT

BASE = "function-312m.als"
NEW = "function-312m.als-twin"

# run with the copy first on the path, since ``ROOT`` and ``HERE`` follow
# where ``tcbench`` is imported from
IN_THE_COPY = r"""
import json, sys
from pathlib import Path
sys.path.insert(0, sys.argv[1])
import torch
torch.set_num_threads(2)
import tcbench
assert tcbench.ROOT == Path(sys.argv[1]).resolve(), tcbench.ROOT
from tcbench import run, spec
from tcbench.tests import small, test_tcbench_spec
name, execute = sys.argv[2], sys.argv[3] == "1"
b = spec.load()
assert name in small.CELLS, small.CELLS
test_tcbench_spec.test_every_cell_configuration_and_metric_resolves_by_name()
test_tcbench_spec.test_every_cell_brings_its_small_size()
test_tcbench_spec.test_contract_limits_hold()
out = {"cells": small.CELLS}
if execute:
    run.use_program()
    r = run.execute(b, spec.resolve(b, name), 20241017, 0.3, False, "cpu",
                    small.small(name))
    out.update(correct=r["correct"], checks=r["checks"],
               metrics=sorted(r["metrics"]))
print(json.dumps(out))
"""


def _files(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def _with_new_cell(bench, chips):
    """``bench`` with the new cell's entries added: its workload, and its
    name beside ``BASE``'s in every metric that lists ``BASE``."""
    bench = json.loads(json.dumps(bench))
    base = next(w for w in bench["workloads"] if w["name"] == BASE)
    bench["workloads"].append(dict(base, name=NEW, traffic=NEW, chips=chips))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if BASE in m.get("workloads", []):
            m["workloads"].append(NEW)
    return bench


@pytest.mark.parametrize("chips", [1, 4])
def test_a_cell_joins_through_new_files_alone(tmp_path, chips):
    copy = tmp_path / "checkout"
    copy.mkdir()
    shutil.copy(ROOT / "BENCHMARK.json", copy)
    shutil.copytree(HERE, copy / "tcbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (copy / "port").symlink_to(ROOT / "port", target_is_directory=True)
    before = _files(copy / "tcbench")
    original = json.loads((ROOT / "BENCHMARK.json").read_text())

    # the new cell's files and entries: a traffic file with its own size
    # for the CPU tests, and the cell in BENCHMARK.json
    traffic = json.loads((HERE / "traffic" / f"{BASE}.json").read_text())
    traffic["small"] = {"config": {"shape": [1000, 1000, 1000],
                                   "nnz": 300000}}
    (copy / "tcbench" / "traffic" / f"{NEW}.json").write_text(
        json.dumps(traffic, indent=1) + "\n")
    bench = _with_new_cell(original, chips)
    (copy / "BENCHMARK.json").write_text(json.dumps(bench, indent=1) + "\n")

    # a four-chip cell's CPU run is its own entry's to test
    p = subprocess.run([sys.executable, "-c", IN_THE_COPY, str(copy), NEW,
                        str(int(chips == 1))], cwd=copy, capture_output=True,
                       text=True, timeout=60)
    assert p.returncode == 0, p.stderr[-3000:]
    got = json.loads(p.stdout.strip().splitlines()[-1])
    assert NEW in got["cells"] and BASE in got["cells"]
    if chips == 1:
        assert got["correct"], got["checks"]
        assert got["metrics"] == ["setup_s", "sweep_ms"]

    # nothing the copy had changed: its files are the harness's, byte for
    # byte, and BENCHMARK.json only gained the new cell's entries
    after = _files(copy / "tcbench")
    assert set(after) - set(before) == {Path("traffic") / f"{NEW}.json"}
    for rel, digest in before.items():
        assert after[rel] == digest, rel
        assert hashlib.sha256((HERE / rel).read_bytes()).hexdigest() == \
            digest, rel
    assert json.loads((copy / "BENCHMARK.json").read_text()) == \
        _with_new_cell(original, chips)
