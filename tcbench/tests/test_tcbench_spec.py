"""The spec and the files it names: every name resolves, and mistakes are
refused before any run."""
import json
import os
import shutil
import subprocess
import sys

import pytest

from tcbench import ROOT, spec


def test_every_cell_configuration_and_metric_resolves_by_name():
    b = spec.load()
    for c in b["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
    for w in b["workloads"]:
        cell = spec.resolve(b, w["name"])
        assert (ROOT / "tcbench" / "traffic" / f"{w['name']}.json").is_file()
        assert cell.entry.Entry and cell.reference.CHECKS
        assert set(cell.reference.CHECKS) <= set(cell.traffic["limits"])
        reported = spec.e2e_metrics(b, w["name"])
        assert "setup_s" in reported and len(reported) >= 2
        layer = spec.per_layer_metrics(b, w["name"])
        assert layer
        moves = {m["name"]: m["moves"] for m in b["per_layer"]}
        assert all(moves[m] in reported for m in layer)
    for m in b["per_layer"]:
        reader = spec.load_reader(m["name"])
        assert (reader.LAYER, reader.UNIT, reader.MOVES, reader.SOURCE) == \
            (m["layer"], m["unit"], m["moves"], m["source"])


def test_every_cell_brings_its_small_size():
    """Each cell's traffic file gives the CPU tests' size under ``small``:
    only ``config`` and ``traffic``, each replacing keys that the cell's
    configuration or traffic file has."""
    b = spec.load()
    for w in b["workloads"]:
        cell = spec.resolve(b, w["name"])
        own = {"config": cell.config,
               "traffic": {k: v for k, v in cell.traffic.items()
                           if k != "small"}}
        small = cell.traffic.get("small")
        assert isinstance(small, dict) and small, \
            f"{w['name']}: its traffic file has no small object"
        assert set(small) <= set(own), \
            f"{w['name']}: small has keys {sorted(set(small) - set(own))}"
        for part, keys in small.items():
            assert isinstance(keys, dict) and set(keys) <= set(own[part]), \
                f"{w['name']}: small {part} names keys the cell's " \
                f"{part} lacks: {sorted(set(keys) - set(own[part]))}"


def test_contract_limits_hold():
    b = spec.load()
    assert len(json.dumps(b)) <= 64 * 1024
    assert b["command"][:3] == ["python3", "-m", "tcbench.run"]
    assert b["paths"] == ["tcbench"]
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    four = [w for w in b["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(b["workloads"]) // 4)
    for c in b["configs"]:
        assert len(c["source"]) <= 200 and len(c["reduced"]) <= 16


def _refused(bench, match):
    with pytest.raises(spec.Refusal, match=match):
        spec.check(bench)


@pytest.mark.parametrize("where,key,value,match", [
    ("workloads", "name", "a cell", "not a name"),
    ("workloads", "name", "x/y", "not a name"),
    ("end_to_end", "unit", "tokens per second", "unit"),
    ("end_to_end", "unit", "µs", "unit"),
    ("per_layer", "name", "has,comma", "not a name"),
    ("per_layer", "unit", "a" * 17, "unit"),
])
def test_bad_name_or_unit_is_refused(where, key, value, match):
    b = spec.load()
    b[where][0][key] = value
    _refused(b, match)


def test_metric_without_reader_or_declaration_is_refused(tmp_path,
                                                         monkeypatch):
    b = spec.load()
    b["per_layer"][0]["name"] = "no_such_metric"
    _refused(b, "no reader")
    b = spec.load()
    name = b["per_layer"][0]["name"]
    src = spec.reader_path(name).read_text()
    for attr in ("LAYER", "UNIT", "MOVES"):
        text = "\n".join(l for l in src.splitlines()
                         if not l.startswith(f"{attr} ="))
        path = tmp_path / f"{attr}.py"
        path.write_text(text)
        monkeypatch.setattr(spec, "reader_path", lambda m, p=path: p)
        _refused(b, f"declares no {attr}")


def test_metric_declaring_another_layer_is_refused():
    b = spec.load()
    b["per_layer"][0]["layer"] = "somewhere else"
    _refused(b, "declares LAYER")


def test_unknown_workload_is_refused_with_one_message():
    p = subprocess.run([sys.executable, "-m", "tcbench.run", "--workload",
                        "no-such-cell", "--seed", "1", "--seconds", "1"],
                       cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert p.returncode == 2 and p.stdout == ""
    assert "unknown workload" in p.stderr


def test_without_a_card_the_run_exits_nonzero_with_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "-m", "tcbench.run", "--workload",
                        "function-312m.als", "--seed", "1", "--seconds", "1"],
                       cwd=ROOT, capture_output=True, text=True, timeout=300,
                       env=env)
    assert p.returncode == 3 and p.stdout == ""
    assert "needs 1 CUDA card" in p.stderr


def test_a_checkout_of_only_the_benchmark_is_refused(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "tcbench", tmp_path / "tcbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "-m", "tcbench.run", "--workload",
                        "function-312m.als", "--seed", "1", "--seconds", "1"],
                       cwd=tmp_path, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode == 2 and p.stdout == ""
    assert "port/repro_torch" in p.stderr
