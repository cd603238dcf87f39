"""The port's performance report: the planner's predicted-against-measured
table, the kernels' rooflines and launch shapes, and the committed perf
trajectory. The counterpart of the reference's ``launch/report.py``
(``--perf``):

    python -m repro_torch.launch.report --spec netflix-ci [--device cpu] \\
        [--repeats 5] [--out FILE]
    python -m repro_torch.launch.report --dir DIR [--section dryrun] \\
        [--out FILE]

:func:`collect_perf` ingests the named experiment spec, runs the planned
MTTKRP, TTTP and fused Gram matvec eagerly with tracing on (the planner's
``PlanRecord`` table), and profiles the three kernels against the machine
roofline (``obs.profile_fn``, terms from ``launch.roofline.kernel_terms``)
in the tiles installed (``planner.tuner``; the tuner's own ``PlanRecord``
rows, ``autotune/<family>|...``, join the table when it tuned in the same
process). The report goes to ``--out``,
or to stdout without it: it never writes ``PERF.md``, which is kept by
hand. Times from a CPU run describe the CPU, not the card.

``--dir`` renders the reference's two record tables instead: every
``*.json`` dry-run record in DIR (:func:`load`, sorted by file name) as
:func:`dryrun_table` (memory, HLO flops and collective bytes per device
and the collective mix, every mesh) and :func:`roofline_table` (the
compute, memory and collective terms of the 16x16 pod records, the
dominant term and a note on it); ``--section`` picks one or both. The
records are the JAX package's pod dry runs, written by its launcher: the
tables word them as the reference does, and no number in them is the
port's. :func:`trajectory_tables` reads the port's own
``BENCH_torch_*.json`` only (the reference's ``BENCH_*.json`` hold CPU and
TPU times).
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List


def _fmt_us(seconds: float) -> str:
    return f"{seconds * 1e6:.1f}"


def _bucket_terms(family: str, buckets, rank: int, valid: int) -> Dict:
    from repro_torch.launch.roofline import kernel_terms
    nb, c, nd = buckets.indices.shape
    other = [s for d, s in enumerate(buckets.shape) if d != buckets.mode]
    return kernel_terms(family, slots=nb * c, nd=nd, rank=rank, valid=valid,
                        factor_rows=other, out_rows=nb * buckets.block_rows,
                        x_rows=buckets.shape[buckets.mode])


def collect_perf(spec_name: str = "netflix-ci", repeats: int = 5,
                 device: str = "cuda") -> Dict:
    """Run the planned kernels on the named experiment spec with tracing
    on; returns ``{"spec", "device", "plans", "rooflines", "tiles",
    "machine"}``.

    One warm-up round pays for planning and for the bucket views, then the
    registry is reset, so the plan table reports steady-state eager
    dispatch. The rooflines time each kernel's ``kernels.ops`` wrapper on
    the spec's mode-0 views in the current tiles."""
    import torch

    from repro_torch import obs, planner
    from repro_torch.kernels import ops as kops
    from repro_torch.launch.experiment import SPECS, ingest_spec
    from repro_torch.launch.roofline import kernel_terms
    from repro_torch.planner import tuner

    spec = SPECS[spec_name]
    ds, _ = ingest_spec(spec, device=device)
    st, omega = ds.tensor, ds.omega
    gen = torch.Generator(device=st.device).manual_seed(spec.seed)
    factors = [torch.randn(d, spec.rank, generator=gen, device=st.device)
               / spec.rank ** 0.5 for d in spec.shape]
    x = torch.randn(spec.shape[0], spec.rank, generator=gen,
                    device=st.device)

    def planned_round():
        planner.planned_mttkrp(st, [None] + factors[1:], mode=0)
        planner.planned_tttp(st, factors)
        planner.planned_cg_matvec(omega, factors, 0, x)

    was_enabled = obs.enabled()
    if not was_enabled:
        obs.enable()
    try:
        planned_round()
        obs.get_registry().reset()
        for _ in range(repeats):
            planned_round()
        plans = obs.get_registry().summary()["plans"]
    finally:
        if not was_enabled:
            obs.disable()

    rows = spec.shape[0]
    fs = [None] + factors[1:]
    bk = st.row_buckets(0, ds.block_rows)
    bo = omega.row_buckets(0, ds.block_rows)
    valid = int(st.valid.sum())
    tttp_terms = kernel_terms("tttp", slots=st.cap, nd=st.ndim,
                              rank=spec.rank, valid=valid,
                              factor_rows=spec.shape)
    rooflines = [
        obs.profile_fn(lambda: kops.mttkrp_bucketed(bk, fs, num_rows=rows),
                       name="mttkrp_bucketed", iters=repeats,
                       terms=_bucket_terms("mttkrp", bk, spec.rank,
                                           int(bk.valid.sum()))),
        obs.profile_fn(lambda: kops.tttp_values(st, factors), name="tttp",
                       iters=repeats, terms=tttp_terms),
        obs.profile_fn(lambda: kops.cg_matvec_bucketed(bo, factors, x,
                                                       num_rows=rows),
                       name="cg_matvec_bucketed", iters=repeats,
                       terms=_bucket_terms("cg_matvec", bo, spec.rank,
                                           int(bo.valid.sum()))),
    ]
    tiles = tuner.tiles_summary()
    for r, family in zip(rooflines, ("mttkrp", "tttp", "cg_matvec")):
        r["tile"] = tiles[family]
    dev = st.device
    return {"spec": spec_name,
            "device": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu"),
            "plans": plans, "rooflines": rooflines, "tiles": tiles,
            "machine": rooflines[0]["machine"]}


def load(dir_: str) -> List[Dict]:
    """The JSON records in ``dir_``, in file-name order."""
    recs = []
    for f in sorted(os.listdir(dir_)):
        if f.endswith(".json"):
            with open(os.path.join(dir_, f)) as fh:
                recs.append(json.load(fh))
    return recs


def _fmt_bytes(b):
    return f"{b / 2**30:.2f}"


def _note(r) -> str:
    """The reference's note on a record's dominant term."""
    dom = r["dominant"]
    if r["arch"].startswith("completion/"):
        if dom == "collective":
            return ("psum(model) of TTTP partials dominates; H-slice or "
                    "row-shard factors to shrink payloads")
        return ("gather/segment traffic dominates; fuse via the bucketed "
                "Pallas kernels (no (m,R) intermediates)")
    kinds = r.get("collective_by_kind", {})
    top = max(kinds, key=kinds.get) if kinds else "none"
    if dom == "collective":
        return (f"{top} dominates wire bytes; overlap with compute or move "
                "to reduce-scatter/seq-parallel residual")
    if dom == "memory":
        return ("HBM traffic bound; fuse elementwise chains / cast "
                "accumulators bf16 / chunk the LM-head loss")
    return "near compute roofline; improve MXU utilization (layout/fusion)"


def dryrun_table(recs: List[Dict]) -> str:
    """One row per dry-run record: arch, shape, mesh, GiB, HLO GFLOP and
    collective GB per device, and the collective mix."""
    lines = ["| arch | shape | mesh | GiB/dev | HLO GFLOP/dev | coll GB/dev "
             "| collective mix |",
             "|---|---|---|---|---|---|---|"]
    for r in recs:
        mix = ", ".join(f"{k.replace('all-', 'a')}×{v}"
                        for k, v in sorted(
                            r.get("collective_counts", {}).items()))
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
            f"{_fmt_bytes(r['bytes_per_device'])} | "
            f"{r['hlo_flops_per_device'] / 1e9:.1f} | "
            f"{r['collective_bytes_per_device'] / 1e9:.2f} | {mix} |")
    return "\n".join(lines)


def roofline_table(recs: List[Dict]) -> str:
    """One row per 16x16 record: the three terms in seconds, the dominant
    one, the useful-flops ratio (n/a where it is meaningless: gather and
    segment workloads have almost no dot flops), the roofline fraction and
    :func:`_note`."""
    lines = ["| arch | shape | compute s | memory s | collective s | "
             "dominant | useful-flops ratio | roofline frac | note |",
             "|---|---|---|---|---|---|---|---|---|"]
    for r in recs:
        if r["mesh"] != "16x16":
            continue
        uf = r.get("useful_flops_ratio")
        uf_s = f"{uf:.3f}" if uf is not None and uf < 50 else "n/a"
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['compute_s']:.4f} | "
            f"{r['memory_s']:.4f} | {r['collective_s']:.4f} | "
            f"{r['dominant']} | {uf_s} | "
            f"{r['roofline_fraction']:.3f} | {_note(r)} |")
    return "\n".join(lines)


def render_records(recs: List[Dict], section: str = "both") -> str:
    """The ``--dir`` output: the dry-run and roofline sections, as the
    reference prints them."""
    parts = []
    if section in ("dryrun", "both"):
        parts.append("### Dry-run records (both meshes)\n\n"
                     + dryrun_table(recs) + "\n")
    if section in ("roofline", "both"):
        parts.append("### Roofline (single pod, 16×16 = 256 chips)\n\n"
                     + roofline_table(recs))
    return "\n".join(parts)


def plan_table(plans: Dict[str, Dict]) -> str:
    lines = ["| plan (expr \\| path \\| size) | kind | predicted s | "
             "measured mean s | measured min s | meas/pred |",
             "|---|---|---|---|---|---|"]
    for key in sorted(plans):
        p = plans[key]
        meas = p["measured"]
        cell = key.replace("|", "\\|")
        lines.append(
            f"| `{cell}` | {p['kind']} | {p['predicted']['seconds']:.2e} | "
            f"{meas['mean_s']:.2e} | {meas['min_s']:.2e} | "
            f"{p['measured_over_predicted']:.1f} |")
    return "\n".join(lines)


def kernel_roofline_table(rooflines: List[Dict]) -> str:
    lines = ["| kernel | tile | measured µs | GFLOP | MiB | dominant | "
             "frac peak compute | frac peak memory | roofline frac |",
             "|---|---|---|---|---|---|---|---|---|"]
    for r in rooflines:
        lines.append(
            f"| {r['name']} | {r.get('tile', '-')} | "
            f"{_fmt_us(r['measured_s'])} | {r['flops'] / 1e9:.4f} | "
            f"{r['bytes'] / 2**20:.2f} | {r['dominant']} | "
            f"{r['frac_peak_compute']:.2e} | {r['frac_peak_memory']:.2e} | "
            f"{r['frac_roofline']:.2e} |")
    return "\n".join(lines)


def trajectory_tables(bench_dir: str) -> str:
    """One table per committed ``BENCH_torch_*.json`` (the port's perf
    trajectory)."""
    parts = []
    for path in sorted(glob.glob(os.path.join(bench_dir,
                                              "BENCH_torch_*.json"))):
        group = os.path.basename(path)[len("BENCH_torch_"):-len(".json")]
        with open(path) as f:
            entries = json.load(f)
        lines = [f"#### {group}", "", "| benchmark | µs/call |", "|---|---|"]
        for name in sorted(entries):
            v = entries[name]
            lines.append(f"| {name} | "
                         f"{'skipped' if v < 0 else f'{v:.1f}'} |")
        parts.append("\n".join(lines))
    return ("\n\n".join(parts) if parts
            else "_no committed BENCH_torch_*.json_")


def render_report(perf: Dict, bench_dir: str) -> str:
    m = perf["machine"]
    return f"""# Performance report

Generated by `python -m repro_torch.launch.report` on the `{perf['spec']}`
spec, on {perf['device']}. Times describe that device.

Machine model (override via `REPRO_PEAK_FLOPS` / `REPRO_HBM_BW` /
`REPRO_LINK_BW`): peak {m['peak_flops']:.3g} FLOP/s, memory
{m['hbm_bw']:.3g} B/s, link {m['link_bw']:.3g} B/s.

## Planner: predicted vs measured

The cost model's prediction per plan next to the measured eager wall time
(fenced), after one warm-up round; `autotune/` rows are the tile tuner's
candidates.

{plan_table(perf['plans'])}

## Kernels: achieved vs roofline

Terms from shapes (`launch.roofline.kernel_terms`: inputs read once,
outputs written once) against the machine model; `roofline frac` is the
bound's time over the measured time, in the tile each kernel launched with.

{kernel_roofline_table(perf['rooflines'])}

## Benchmark trajectory (committed baselines)

{trajectory_tables(bench_dir)}
"""


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.report",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--spec", default="netflix-ci",
                    help="experiment spec to measure on")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--repeats", type=int, default=5,
                    help="eager planned runs per kernel")
    ap.add_argument("--out", default=None, metavar="FILE",
                    help="write the report here (no default: stdout)")
    ap.add_argument("--bench-dir", default=".",
                    help="directory holding committed BENCH_torch_*.json")
    ap.add_argument("--dir", default=None, metavar="DIR",
                    help="render the dry-run records (*.json) in DIR "
                         "instead of measuring")
    ap.add_argument("--section", default="both",
                    choices=["dryrun", "roofline", "both"],
                    help="which record table --dir renders")
    args = ap.parse_args(argv)
    if args.dir is not None:
        text = render_records(load(args.dir), args.section)
        if args.out is None:
            print(text)
        else:
            with open(args.out, "w") as f:
                f.write(text + "\n")
            print(f"wrote {args.out}")
        return text
    perf = collect_perf(args.spec, repeats=args.repeats, device=args.device)
    text = render_report(perf, args.bench_dir)
    if args.out is None:
        print(text)
    else:
        with open(args.out, "w") as f:
            f.write(text)
        print(f"wrote {args.out}: {len(perf['plans'])} plan rows, "
              f"{len(perf['rooflines'])} kernel rooflines")
    return perf


if __name__ == "__main__":
    main()
