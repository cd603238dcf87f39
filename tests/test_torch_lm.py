"""The reference's last public names, ported: the LM token helpers
(``data.synthetic.token_stream``, ``data.pipeline.lm_batches``), the LM
accounting of ``launch.roofline`` (``model_flops``, ``active_params``), the
dry-run record tables of ``launch.report`` (``load``, ``dryrun_table``,
``roofline_table``, the CLI's ``--dir``) and the three completion examples
under ``port/examples`` (run here with ``--device cpu`` at small sizes).

The tables and the accounting are held identical to the JAX package's on
the same records and configs. The token streams draw from different
generators (``jax.random`` against a ``torch.Generator``), so they are held
to the same shapes, dtypes and label shift, and each to the Zipf law
(a = 1.05) within five standard deviations of a binomial count for the
ten most frequent tokens. The per-rank slices are held against the rows
the reference's ``NamedSharding`` gives each device of a 2 x 2 host mesh
(a subprocess with four forced host devices)."""
import importlib.util
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from repro.data import pipeline as jpipeline
from repro.data import synthetic as jsynthetic
from repro.launch import report as jreport
from repro.launch import roofline as jroofline

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
PORT = os.path.join(ROOT, "port")
sys.path.insert(0, PORT)

from repro_torch.core.distributed import AxisCtx  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.launch import report  # noqa: E402
from repro_torch.launch import roofline  # noqa: E402

ZIPF_A = 1.05


# ---------------------------------------------------------------------------
# token_stream and lm_batches
# ---------------------------------------------------------------------------

def _zipf_top(tokens, vocab, k=10):
    """(observed counts, expected counts, binomial sigmas) of ranks 0..k-1
    under the Zipf law over ``vocab`` ranks."""
    tokens = np.asarray(tokens).ravel()
    w = np.arange(1, vocab + 1, dtype=np.float64) ** -ZIPF_A
    p = w[:k] / w.sum()
    n = tokens.size
    seen = np.bincount(tokens, minlength=vocab)[:k]
    return seen, n * p, np.sqrt(n * p * (1 - p))


def test_token_stream_shapes_shift_and_zipf_law():
    vocab, batch, seq = 1000, 64, 127
    gen = torch.Generator().manual_seed(0)
    port = list(synthetic.token_stream(gen, vocab, batch, seq, 2))
    ref = list(jsynthetic.token_stream(jax.random.PRNGKey(0), vocab, batch,
                                       seq, 2))
    assert len(port) == len(ref) == 2
    for p, r in zip(port, ref):
        assert set(p) == set(r) == {"tokens", "labels"}
        for k in p:
            assert tuple(p[k].shape) == tuple(r[k].shape) == (batch, seq)
            assert p[k].dtype == torch.int32 and r[k].dtype == np.int32
            assert int(p[k].min()) >= 0 and int(p[k].max()) < vocab
        # labels are the tokens shifted by one
        assert torch.equal(p["labels"][:, :-1], p["tokens"][:, 1:])
        np.testing.assert_array_equal(np.asarray(r["labels"])[:, :-1],
                                      np.asarray(r["tokens"])[:, 1:])
    # the two batches differ (the generator advances)
    assert not torch.equal(port[0]["tokens"], port[1]["tokens"])
    for toks in (torch.cat([b["tokens"] for b in port]).numpy(),
                 np.concatenate([np.asarray(b["tokens"]) for b in ref])):
        seen, want, sigma = _zipf_top(toks, vocab)
        assert (np.abs(seen - want) < 5 * sigma).all(), (seen, want)


def test_token_stream_defaults_to_a_generator_on_the_device():
    a = next(synthetic.token_stream(None, 50, 2, 8, device="cpu"))
    b = next(synthetic.token_stream(None, 50, 2, 8, device="cpu"))
    assert a["tokens"].device.type == "cpu"
    assert torch.equal(a["tokens"], b["tokens"])   # seeded 0 by default


_MESH_SCRIPT = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax, numpy as np
from repro.data import pipeline
mesh = jax.make_mesh((2, 2), ("data", "model"))
out = {}
for axes in (("data",), ("data", "model")):
    b = next(pipeline.lm_batches(jax.random.PRNGKey(0), 100, 8, 6, 1,
                                 mesh=mesh, batch_axes=axes))
    rows = {}
    for sh in b["tokens"].addressable_shards:
        (i, j), = zip(*np.nonzero(mesh.devices == sh.device))
        sl = sh.index[0]
        rows[f"{int(i)},{int(j)}"] = [sl.start or 0, sl.stop or 8]
    out[",".join(axes)] = rows
print(json.dumps(out))
"""


@pytest.fixture(scope="module", autouse=True)
def mesh_rows():
    """Started before the file's first test, so the reference's 2 x 2 host
    mesh comes up while the other tests run; the last test of the file
    reads it."""
    proc = subprocess.Popen(
        [sys.executable, "-c", _MESH_SCRIPT],
        env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def rows():
        out, err = proc.communicate(timeout=120)
        assert proc.returncode == 0, err
        return json.loads(out.strip().splitlines()[-1])

    yield rows
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


# ---------------------------------------------------------------------------
# model_flops and active_params
# ---------------------------------------------------------------------------

def _cfg(**kw):
    base = dict(d_model=512, d_ff=2048, vocab=32000, n_heads=8,
                n_kv_heads=2, attn_kind="mha", q_lora_rank=0,
                qk_nope_dim=0, qk_rope_dim=0, kv_lora_rank=0, v_head_dim=0,
                n_experts=0, top_k=0, n_shared_experts=0, ffn_kind="swiglu",
                ssm_expand=2, ssm_state=64, n_groups=6, tie_embeddings=False,
                encoder_layers=0, n_layers=6,
                group=[SimpleNamespace(kind="attn")])
    base.update(kw)
    cfg = SimpleNamespace(**base)
    cfg.head_dim_ = lambda: cfg.d_model // cfg.n_heads
    return cfg


CONFIGS = {
    "dense": _cfg(),
    "tied": _cfg(tie_embeddings=True),
    "mla": _cfg(attn_kind="mla", q_lora_rank=384, qk_nope_dim=64,
                qk_rope_dim=32, kv_lora_rank=256, v_head_dim=64),
    "moe": _cfg(n_experts=64, top_k=6, n_shared_experts=2, d_ff=1408),
    "no-ffn": _cfg(ffn_kind="none"),
    "hybrid": _cfg(group=[SimpleNamespace(kind=k) for k in
                          ("attn", "mamba2", "mlstm", "slstm")], n_groups=3),
    "encdec": _cfg(encoder_layers=4, n_layers=4),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_active_params_and_model_flops_match_the_reference(name):
    cfg = CONFIGS[name]
    assert roofline.active_params(cfg) == jroofline.active_params(cfg)
    for kind in ("train", "prefill", "decode"):
        cell = SimpleNamespace(kind=kind, global_batch=256, seq_len=4096)
        got = roofline.model_flops(cfg, cell)
        assert got == jroofline.model_flops(cfg, cell) and got > 0


# ---------------------------------------------------------------------------
# the dry-run record tables and --dir
# ---------------------------------------------------------------------------

RECORDS = [
    dict(arch="completion/als", shape="20000^3 nnz 80M", mesh="16x16",
         bytes_per_device=3.5 * 2**30, hlo_flops_per_device=2.5e11,
         collective_bytes_per_device=4.2e9,
         collective_counts={"all-reduce": 66, "all-gather": 3},
         compute_s=0.0031, memory_s=0.0125, collective_s=0.0291,
         dominant="collective", useful_flops_ratio=None,
         roofline_fraction=0.412),
    dict(arch="completion/ggn", shape="paper-netflix", mesh="16x16",
         bytes_per_device=1.25 * 2**30, hlo_flops_per_device=1e10,
         collective_bytes_per_device=1e8, collective_counts={},
         compute_s=0.001, memory_s=0.02, collective_s=0.005,
         dominant="memory", useful_flops_ratio=812.0,
         roofline_fraction=0.9),
    dict(arch="lm/dense-1b", shape="train 256x4096", mesh="16x16",
         bytes_per_device=20 * 2**30, hlo_flops_per_device=9.9e13,
         collective_bytes_per_device=2.2e10,
         collective_counts={"all-gather": 96, "reduce-scatter": 48},
         collective_by_kind={"all-gather": 1.5e10, "reduce-scatter": 7e9},
         compute_s=0.51, memory_s=0.2, collective_s=0.6,
         dominant="collective", useful_flops_ratio=0.873,
         roofline_fraction=0.66),
    dict(arch="lm/moe", shape="decode 64", mesh="2x16x16",
         bytes_per_device=2**30, hlo_flops_per_device=1e9,
         collective_bytes_per_device=1e7, collective_counts={"all-to-all": 4},
         compute_s=0.1, memory_s=0.3, collective_s=0.01, dominant="memory",
         useful_flops_ratio=0.5, roofline_fraction=0.3),
    dict(arch="lm/dense-7b", shape="prefill 32x8192", mesh="16x16",
         bytes_per_device=30 * 2**30, hlo_flops_per_device=5e14,
         collective_bytes_per_device=1e9, collective_counts={},
         compute_s=2.0, memory_s=0.5, collective_s=0.1, dominant="compute",
         useful_flops_ratio=0.95, roofline_fraction=0.8),
]


def test_record_tables_match_the_reference(tmp_path):
    for i, r in enumerate(RECORDS):
        (tmp_path / f"{i:02d}.json").write_text(json.dumps(r))
    (tmp_path / "notes.txt").write_text("not a record")
    recs = report.load(str(tmp_path))
    assert recs == jreport.load(str(tmp_path)) == RECORDS
    assert report.dryrun_table(recs) == jreport.dryrun_table(recs)
    assert report.roofline_table(recs) == jreport.roofline_table(recs)
    for r in recs:
        assert report._note(r) == jreport._note(r)
    # the roofline table keeps the 16x16 records only
    assert report.roofline_table(recs).count("\n") == 2 + 4 - 1


def test_report_dir_mode_prints_both_sections(tmp_path, capsys):
    d = tmp_path / "records"
    d.mkdir()
    for i, r in enumerate(RECORDS[:2]):
        (d / f"{i}.json").write_text(json.dumps(r))
    text = report.main(["--dir", str(d)])
    out = capsys.readouterr().out
    assert out.strip() == text.strip()
    recs = jreport.load(str(d))
    assert jreport.dryrun_table(recs) in text
    assert jreport.roofline_table(recs) in text
    assert text.index("### Dry-run records") < text.index("### Roofline")
    only = report.main(["--dir", str(d), "--section", "roofline",
                        "--out", str(tmp_path / "r.md")])
    assert "Dry-run" not in only and (tmp_path / "r.md").read_text() \
        == only + "\n"


# ---------------------------------------------------------------------------
# the three completion examples, on the CPU
# ---------------------------------------------------------------------------

def _example(name):
    path = os.path.join(PORT, "examples", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"port_example_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_example_runs_on_the_cpu(capsys):
    errs = _example("quickstart").main(
        ["--device", "cpu", "--dims", "30,20,10", "--nnz", "2000",
         "--rank", "4", "--sweeps", "3"])
    assert len(errs) == 3 and all(np.isfinite(errs)) and errs[-1] < errs[0]
    assert "MTTKRP row0" in capsys.readouterr().out


def test_poisson_completion_example_runs_on_the_cpu():
    losses = _example("poisson_completion").main(
        ["--device", "cpu", "--dims", "20,15,10", "--nnz", "1500",
         "--rank", "4", "--iters", "41"])
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


def test_function_tensor_als_example_runs_on_the_cpu(tmp_path, capsys):
    runs = _example("function_tensor_als").main(
        ["--device", "cpu", "--dims", "20,15,10", "--nnz", "800",
         "--rank", "3", "--sweeps", "2", "--ckpt-root", str(tmp_path)])
    out = capsys.readouterr().out
    assert set(runs) == {"als", "ccd_tttp", "sgd"}
    for algo, run in runs.items():
        assert f"=== {algo} ===" in out
        assert (tmp_path / algo).is_dir()
        errs = [e for _, _, e in run.history]
        assert len(errs) == 2 and all(np.isfinite(errs))
    assert out.count("final rmse=") == 3


# ---------------------------------------------------------------------------
# per-rank slices (last: reads the subprocess the module fixture started)
# ---------------------------------------------------------------------------

def test_lm_batches_slices_each_rank_as_the_reference_shards(mesh_rows):
    """Last in the file: the reference's shards come from the subprocess
    the module fixture started."""
    ref = mesh_rows()
    full = next(pipeline.lm_batches(torch.Generator().manual_seed(3), 100,
                                    8, 6, 1))
    for axes, rows in ref.items():
        axes = tuple(axes.split(","))
        for coord, (lo, hi) in rows.items():
            i, j = map(int, coord.split(","))
            ctx = AxisCtx(data="data", model="model",
                          sizes=(("data", 2), ("model", 2)),
                          coords=(("data", i), ("model", j)))
            mine = next(pipeline.lm_batches(
                torch.Generator().manual_seed(3), 100, 8, 6, 1, ctx=ctx,
                batch_axes=axes))
            for k in ("tokens", "labels"):
                assert torch.equal(mine[k], full[k][lo:hi]), (axes, coord)
    # without a mesh the reference yields whole batches, as the port does
    whole = next(jpipeline.lm_batches(jax.random.PRNGKey(0), 100, 8, 6, 1))
    assert np.asarray(whole["tokens"]).shape == tuple(full["tokens"].shape)
    with pytest.raises(ValueError, match="does not split"):
        next(pipeline.lm_batches(None, 100, 6, 4, 1, ctx=AxisCtx(
            data="data", sizes=(("data", 4),), coords=(("data", 0),)),
            device="cpu"))
