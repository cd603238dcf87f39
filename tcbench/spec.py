"""``BENCHMARK.json`` and the files it names, read and checked before any
run: a mistake is refused with one message (:class:`Refusal`), never
discovered half-way through a run on the chip."""
from __future__ import annotations

import importlib
import importlib.util
import json
import re
import types
from pathlib import Path
from typing import Dict, List

from tcbench import HERE, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MODULE = re.compile(r"^[a-z_][a-z0-9_]*$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
E2E_SOURCES = ("host_clock", "device_trace")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
# what a per-layer reader declares, and the BENCHMARK.json key it matches
READER_KEYS = {"LAYER": "layer", "UNIT": "unit", "MOVES": "moves",
               "SOURCE": "source"}


class Refusal(ValueError):
    """A spec or a file it names that the harness will not run."""


def _name(kind: str, value) -> str:
    if not isinstance(value, str) or not NAME.match(value):
        raise Refusal(f"{kind} {value!r} is not a name (at most 64 letters, "
                      f"digits, '_', '.' and '-', not starting with '.' or "
                      f"'-')")
    return value


def _line(kind: str, value) -> str:
    if not isinstance(value, str) or not 1 <= len(value) <= 200 or \
            "\n" in value or "\t" in value:
        raise Refusal(f"{kind} must be one line of 1 to 200 characters")
    return value


def _unit(kind: str, value) -> str:
    if not isinstance(value, str) or not UNIT.match(value):
        raise Refusal(f"{kind}: unit {value!r} is not 1 to 16 letters, "
                      f"digits, '_', '/', '%', '.' or '-'")
    return value


def load_json(path: Path) -> Dict:
    try:
        return json.loads(path.read_text())
    except FileNotFoundError:
        raise Refusal(f"{path.relative_to(ROOT)} is missing") from None
    except json.JSONDecodeError as e:
        raise Refusal(f"{path.relative_to(ROOT)} is not JSON: {e}") from None


def reader_path(metric: str) -> Path:
    return HERE / "metrics" / f"{metric}.py"


def load_reader(metric: str) -> types.ModuleType:
    """The per-layer reader of ``metric`` (its file's name is the
    metric's, dots and all, so it is loaded by path)."""
    path = reader_path(metric)
    if not path.is_file():
        raise Refusal(f"per-layer metric {metric}: no reader "
                      f"{path.relative_to(ROOT)}")
    mod_name = "tcbench_metric_" + re.sub(r"[^A-Za-z0-9_]", "_", metric)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _module(package: str, name) -> types.ModuleType:
    if not isinstance(name, str) or not MODULE.match(name) or \
            not (HERE / package / f"{name}.py").is_file():
        raise Refusal(f"no tcbench/{package}/{name}.py")
    return importlib.import_module(f"tcbench.{package}.{name}")


def check(bench: Dict) -> None:
    """Refuse a spec that breaks the benchmark's rules, or names a file
    that is missing or does not declare what the spec says."""
    if set(bench) != TOP_KEYS:
        raise Refusal(f"BENCHMARK.json has keys {sorted(bench)}, not "
                      f"{sorted(TOP_KEYS)}")
    rs = bench["run_seconds"]
    if not isinstance(rs, int) or not 1 <= rs <= 51:
        raise Refusal(f"run_seconds {rs!r} is not a whole number in 1..51")
    configs = {}
    for c in bench["configs"]:
        name = _name("configuration", c.get("name"))
        if name in configs:
            raise Refusal(f"configuration {name} appears twice")
        path = ROOT / c.get("file", "")
        if HERE not in path.resolve().parents or not path.is_file():
            raise Refusal(f"configuration {name}: file {c.get('file')!r} "
                          f"is not a file under tcbench/")
        for key in c.get("reduced", []):
            _name(f"configuration {name}: reduced key", key)
        configs[name] = c
    e2e = {}
    for m in bench["end_to_end"]:
        name = _name("end-to-end metric", m.get("name"))
        _unit(name, m.get("unit"))
        if m.get("better") not in ("lower", "higher") or \
                m.get("source") not in E2E_SOURCES:
            raise Refusal(f"end-to-end metric {name}: better must be lower "
                          f"or higher and source one of {E2E_SOURCES}")
        e2e[name] = m
    if "setup_s" not in e2e:
        raise Refusal("the end-to-end metrics lack setup_s")
    cells = {}
    for w in bench["workloads"]:
        name = _name("workload", w.get("name"))
        _name(f"workload {name}: traffic", w.get("traffic"))
        _line(f"workload {name}: why", w.get("why"))
        if name in cells:
            raise Refusal(f"workload {name} appears twice")
        if w.get("config") not in configs:
            raise Refusal(f"workload {name}: unknown configuration "
                          f"{w.get('config')!r}")
        if w.get("chips") not in (1, 4):
            raise Refusal(f"workload {name}: chips must be 1 or 4")
        cells[name] = w
    seen = set(e2e)
    for m in bench["per_layer"]:
        name = _name("per-layer metric", m.get("name"))
        if name in seen:
            raise Refusal(f"metric {name} appears twice")
        seen.add(name)
        _unit(name, m.get("unit"))
        _line(f"per-layer metric {name}: layer", m.get("layer"))
        if m.get("moves") not in e2e or m.get("source") not in SOURCES or \
                m.get("better") not in ("lower", "higher"):
            raise Refusal(f"per-layer metric {name}: moves must name an "
                          f"end-to-end metric, source be one of {SOURCES}, "
                          f"better lower or higher")
        for cell in m.get("workloads", []):
            if cell not in cells:
                raise Refusal(f"per-layer metric {name}: unknown workload "
                              f"{cell}")
        reader = load_reader(name)
        for attr, key in READER_KEYS.items():
            if not hasattr(reader, attr):
                raise Refusal(f"tcbench/metrics/{name}.py declares no "
                              f"{attr}")
            if getattr(reader, attr) != m[key]:
                raise Refusal(f"tcbench/metrics/{name}.py declares {attr} "
                              f"{getattr(reader, attr)!r}, BENCHMARK.json "
                              f"{key} {m[key]!r}")
        if not callable(getattr(reader, "read", None)):
            raise Refusal(f"tcbench/metrics/{name}.py has no read(view)")
    for name in cells:
        traffic(bench, name)


def traffic(bench: Dict, cell: str) -> Dict:
    """The cell's traffic file, checked against its entry and reference:
    every end-to-end metric the spec asks of the cell is one the entry
    reports, and every number the reference compares has a limit."""
    path = HERE / "traffic" / f"{cell}.json"
    t = load_json(path)
    entry = _module("entries", t.get("entry"))
    ref = _module("reference", t.get("reference"))
    missing = [m for m in e2e_metrics(bench, cell)
               if m != "setup_s" and m not in entry.Entry.END_TO_END]
    if missing:
        raise Refusal(f"workload {cell}: entry {t['entry']} does not report "
                      f"{missing}")
    limits = t.get("limits", {})
    unlimited = [c for c in ref.CHECKS if not isinstance(
        limits.get(c), (int, float))]
    if unlimited:
        raise Refusal(f"tcbench/traffic/{cell}.json gives no limit for "
                      f"{unlimited}")
    return t


def e2e_metrics(bench: Dict, cell: str) -> List[str]:
    return [m["name"] for m in bench["end_to_end"]
            if "workloads" not in m or cell in m["workloads"]]


def per_layer_metrics(bench: Dict, cell: str) -> List[str]:
    """The per-layer metrics read in ``cell``: those that list it, and
    those without a list whose end-to-end metric the cell reports."""
    reported = set(e2e_metrics(bench, cell))
    return [m["name"] for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in reported)]


def units(bench: Dict) -> Dict[str, str]:
    return {m["name"]: m["unit"]
            for m in bench["end_to_end"] + bench["per_layer"]}


def load() -> Dict:
    bench = load_json(ROOT / "BENCHMARK.json")
    if not isinstance(bench, dict):
        raise Refusal("BENCHMARK.json is not an object")
    check(bench)
    return bench


def resolve(bench: Dict, cell: str) -> types.SimpleNamespace:
    """The configuration, traffic, entry and reference of a cell."""
    w = {c["name"]: c for c in bench["workloads"]}.get(cell)
    if w is None:
        raise Refusal(f"unknown workload {cell!r}; the workloads are "
                      f"{sorted(c['name'] for c in bench['workloads'])}")
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    t = traffic(bench, cell)
    return types.SimpleNamespace(
        name=cell, chips=w["chips"], config=load_json(ROOT / cfg["file"]),
        traffic=t, entry=_module("entries", t["entry"]),
        reference=_module("reference", t["reference"]))
