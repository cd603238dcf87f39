"""Roofline terms of the port's work: the flops and bytes a call needs,
against which ``obs.profile_fn`` reads a measured time.

The reference derives its terms from compiled XLA HLO; the port has no HLO,
so the terms come from two places:

* :func:`kernel_terms`, for the three CUDA kernel families, from shapes
  alone (no tensors): each input read once, each output written once, and
  for skewed or serving layouts only the valid entries and the distinct
  factor rows they gather. This is the count behind ``PERF.md``'s bound
  column; ``chip_smoke.py`` phase 4 and ``launch.report`` read it.
* :func:`profiler_terms`, for any PyTorch callable: matrix-product flops
  from ``torch.profiler`` (``record_shapes=True, with_flops=True``), and
  the operand plus output bytes of each aten operation the call
  dispatches (views move nothing), the counterpart of the reference's
  ``HloModule.totals()``.

:func:`bound` turns bytes and operations into the least time (ms) the card
could take, and what sets it. The machine constants are the NVIDIA H100
SXM data sheet's (``obs.profile.Machine`` reads them, overridable by
``REPRO_PEAK_FLOPS``, ``REPRO_PEAK_FLOPS_F64``, ``REPRO_HBM_BW`` and
``REPRO_LINK_BW``): a float64 kernel's operations go over the FP64 peak,
every other kernel's over the fp32 one (bf16 operands are summed in
float32), and a float64 accumulator's over the FP64 one.

:func:`model_flops` and :func:`active_params` are the reference's LM
accounting (its dry-run cells): plain arithmetic over a config object and
a cell, the same formulas.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch

from repro_torch.obs.profile import Machine

# NVIDIA H100 SXM data sheet: fp32 and FP64 outside the tensor cores,
# HBM3, NVLink per direction
PEAK_FLOPS = 67e12
PEAK_FLOPS_F64 = 34e12
HBM_BW = 3.35e12
LINK_BW = 450e9

# what one slot of each layout reads beside its value (one element of the
# operands' type): valid (1), nd int32 indices, and for the bucketed layouts
# local_row (4)
_VALID, _INDEX, _LOCAL_ROW = 1, 4, 4
_FAMILIES = ("tttp", "mttkrp", "cg_matvec")
# the aten products whose profiler flops count as matrix-product flops
MATMUL_OPS = ("aten::mm", "aten::bmm", "aten::addmm", "aten::baddbmm")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(n_bytes: float, n_ops: float, machine: Machine = None,
          elem_bytes: int = 4, acc_bytes: Optional[int] = None):
    """Least time (ms) for the work and what sets it: bytes over the memory
    rate or operations over the peak rate for the type they are summed in
    (``acc_bytes``, default ``elem_bytes``: the FP64 peak for 8 bytes, as
    for float64 operands or a float64 accumulator over float32 or bf16
    ones, the fp32 one otherwise), the larger."""
    machine = machine or Machine.from_env()
    wide = (elem_bytes if acc_bytes is None else acc_bytes) == 8
    peak = machine.peak_flops_f64 if wide else machine.peak_flops
    t_bytes = n_bytes / machine.hbm_bw * 1e3
    t_ops = n_ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def gather_sector_bytes(n_rows: int, r: int, elem_bytes: int = 4) -> float:
    """L2 sector bytes that gathering ``n_rows`` factor rows takes when each
    row is read whole at the kernels' padded stride (R rounded up to a
    16-byte vector of ``elem_bytes`` elements: 4 floats, 8 bf16 values, 2
    doubles):
    the 32-byte sectors a row spans, averaged over the row offsets, which
    repeat every 8 rows."""
    per_vec = 16 // elem_bytes
    stride = elem_bytes * (-(-r // per_vec) * per_vec)
    spans = [(i * stride + stride - 1) // 32 - i * stride // 32 + 1
             for i in range(8)]
    return n_rows * 32 * sum(spans) / len(spans)


def kernel_terms(family: str, *, slots: int, nd: int, rank: int,
                 valid: int, factor_rows: Sequence[int], out_rows: int = 0,
                 x_rows: int = 0, valid_only: bool = False,
                 elem_bytes: int = 4) -> Dict[str, float]:
    """Flops and bytes one call of a kernel family needs, from shapes.

    ``slots`` are the entries the kernel walks (the COO's m, or a bucket
    view's nb·C), ``valid`` those that hold a nonzero; ``factor_rows`` the
    rows of each factor it gathers (the present factors for TTTP, the
    non-target ones for the bucketed kernels; distinct rows where only
    those are read); ``out_rows`` the bucketed kernels' output rows
    (nb·block_rows) and ``x_rows`` the fused matvec's rows of x. TTTP reads
    value, valid and indices per slot (a bucket view as flat slots) and
    writes one value per slot; the bucketed kernels also read local_row and
    write (out_rows, R). Values, factors, x and the output are priced at
    ``elem_bytes`` an element (4 float32, 2 bfloat16, 8 float64: the
    kernels read and write their operands' type); indices, valid and
    local_row as they are.
    ``valid_only`` counts the valid entries' bytes alone (the function
    needs no more; skewed and serving layouts pad heavily). Operations
    count, per valid entry, R multiplies per factor (TTTP), plus R
    accumulations (the MTTKRP), plus the dot product with x (the fused
    matvec)."""
    if family not in _FAMILIES:
        raise KeyError(f"unknown kernel family {family!r}")
    n = valid if valid_only else slots
    e = elem_bytes
    per_slot = e + _VALID + _INDEX * nd
    factor_bytes = e * rank * sum(factor_rows)
    if family == "tttp":
        moved = n * (per_slot + e) + factor_bytes
        ops = valid * rank * len(factor_rows)
    else:
        moved = (n * (per_slot + _LOCAL_ROW) + factor_bytes
                 + e * rank * out_rows)
        ops = valid * rank * (len(factor_rows) + 1)
        if family == "cg_matvec":
            moved += e * rank * x_rows
            ops = valid * rank * (len(factor_rows) + 3)
    return {"flops": float(ops), "bytes": float(moved),
            "collective_bytes": 0.0}


def profiler_terms(fn: Callable, *args) -> Dict[str, float]:
    """Roofline terms of ``fn(*args)``: ``flops`` (matrix products, from
    ``torch.profiler``), ``profiler_flops`` (every flop the profiler
    counts, elementwise ones too: the cross-check the reference gets from
    XLA's cost analysis), ``bytes`` (operand plus output bytes of each aten
    operation the call dispatches; views move nothing) and
    ``collective_bytes`` (0: one device). ``fn`` runs twice, once under the
    profiler and once under a dispatch mode that counts the bytes: under
    the mode the profiler would see each operation twice."""
    from torch.profiler import ProfilerActivity, profile
    from torch.utils import _pytree as pytree
    from torch.utils._python_dispatch import TorchDispatchMode

    class _Traffic(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.bytes = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if not func.is_view:
                seen = [t for t in pytree.tree_leaves((args, kwargs, out))
                        if isinstance(t, torch.Tensor)]
                self.bytes += nbytes(*seen)
            return out

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, record_shapes=True,
                 with_flops=True) as prof:
        fn(*args)
    traffic = _Traffic()
    with traffic:
        fn(*args)
    events = [e for e in prof.events() if e.flops]
    return {"flops": float(sum(e.flops for e in events
                               if e.name in MATMUL_OPS)),
            "profiler_flops": float(sum(e.flops for e in events)),
            "bytes": float(traffic.bytes), "collective_bytes": 0.0}


def model_flops(cfg, cell) -> float:
    """MODEL_FLOPS = 6·N·D (dense) / 6·N_active·D (MoE); decode counts one
    token per sequence."""
    n_active = active_params(cfg)
    if cell.kind == "train":
        tokens = cell.global_batch * cell.seq_len
        return 6.0 * n_active * tokens
    if cell.kind == "prefill":
        tokens = cell.global_batch * cell.seq_len
        return 2.0 * n_active * tokens
    return 2.0 * n_active * cell.global_batch  # decode: 1 token/seq


def active_params(cfg) -> float:
    """Per-token active parameter count from the config (embeddings included
    once; MoE counts top_k + shared experts)."""
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab
    hd = cfg.head_dim_()
    per_attn = d * hd * (cfg.n_heads * 2 + cfg.n_kv_heads * 2)
    if cfg.attn_kind == "mla":
        qd = cfg.qk_nope_dim + cfg.qk_rope_dim
        per_attn = (d * cfg.q_lora_rank + cfg.q_lora_rank * cfg.n_heads * qd
                    + d * (cfg.kv_lora_rank + cfg.qk_rope_dim)
                    + cfg.kv_lora_rank * cfg.n_heads
                    * (cfg.qk_nope_dim + cfg.v_head_dim)
                    + cfg.n_heads * cfg.v_head_dim * d)
    ffn_active = 3 * d * f
    if cfg.n_experts:
        ffn_active = 3 * d * f * (cfg.top_k + cfg.n_shared_experts)
    n = 0.0
    for spec in cfg.group:
        if spec.kind == "attn":
            n += per_attn + (ffn_active if cfg.ffn_kind != "none" and f
                             else 0)
        elif spec.kind == "mamba2":
            d_in = cfg.ssm_expand * d
            n += d * (2 * d_in + 2 * cfg.ssm_state) + d_in * d
        elif spec.kind == "mlstm":
            n += 3 * d * hd * cfg.n_heads + cfg.n_heads * hd * d
        elif spec.kind == "slstm":
            n += 9 * d * d
    n *= cfg.n_groups
    n += 2 * d * v if not cfg.tie_embeddings else d * v
    if cfg.encoder_layers:
        # encoder blocks, and the decoder's cross-attention
        n += cfg.encoder_layers * (per_attn + 3 * d * f) + \
            cfg.n_layers * per_attn
    return n
