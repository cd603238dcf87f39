"""Einsum IR — typed contraction nodes over mixed sparse/dense operands.

Parses an einsum expression plus the concrete operand list into a
:class:`ContractionIR`, classifying it into one of the contraction families
the paper's kernels cover (DESIGN.md §5.1):

* ``DENSE``  — no sparse operand; delegated to ``torch.einsum`` untouched;
* ``REDUCE`` — one sparse operand, output indices an arbitrary ordered subset
  of the sparse term (``"ijkl->li"``, ``"ijk->"``);
* ``TTTP``   — output equals the sparse term: the sampled multilinear form
  ``t_n · Σ_r Π_d A_d[i_d, r]`` (SDDMM is the order-2 case);
* ``TTM``    — one dense matrix contracting one sparse mode, dense output
  (``"ijk,kr->ijr"``, any output order, any tensor order);
* ``MTTKRP`` — ≥2 rank-sharing factor matrices contracting a subset of the
  sparse modes; covers the classic single-output-mode MTTKRP and the partial
  / multi-output-mode generalization (``"ijkl,kr,lr->ijr"``);
* ``CG_MATVEC`` — the implicit-CG weighted Gram matvec (paper §2.2 + eq. 3):
  TWO rank indices, one contracted (the TTTP half) and one kept (the MTTKRP
  half), with factors covering every mode on the contracted-rank side and
  every non-output mode on the kept-rank side
  (``"ijk,jr,kr,iy,jy,ky->ir"``). This is the one multi-stage composition
  the planner fuses: the kernel-level single-pass path reuses the Khatri-Rao
  gather across both halves.

The IR is built from *static* metadata only (terms, shapes, capacities, nnz
hints, dtypes): Python values, never tensor data, so building it makes no
device work and no host synchronisation.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

from repro_torch.core.sparse_tensor import SparseTensor

DENSE = "dense"
REDUCE = "reduce"
TTTP = "tttp"
TTM = "ttm"
MTTKRP = "mttkrp"
CG_MATVEC = "cg_matvec"

KINDS = (DENSE, REDUCE, TTTP, TTM, MTTKRP, CG_MATVEC)


@dataclasses.dataclass(frozen=True)
class DistInfo:
    """Static distribution signature of a contraction call (DESIGN.md §9).

    Built from the :class:`~repro_torch.core.distributed.AxisCtx` the caller
    runs under. The port runs LOCAL only (every size 1), so a non-local
    ``DistInfo`` reaches only the cost model, never dispatch:

    * ``data_size``  — product of the data-axis sizes: nonzeros sharded,
      factor rows replicated; outputs on factor rows need a psum(data);
    * ``model_size`` — model-axis size: factor COLUMNS sharded (the paper's
      H-slicing of R as a mesh axis); inner products over R need a
      psum(model);
    * ``rowsharded`` — factor ROWS sharded over the data axes instead
      (the paper's Fig. 2 memory-scalable distribution): contractions must
      all-gather column slices and reduce-scatter row outputs.

    Operand shapes in the IR are the *local* (per-shard) shapes — flop and
    memory terms are per-device automatically; ``DistInfo`` is what the
    communication terms of the cost model key off.
    """
    data_size: int = 1
    model_size: int = 1
    rowsharded: bool = False

    @property
    def is_local(self) -> bool:
        return (self.data_size == 1 and self.model_size == 1
                and not self.rowsharded)


LOCAL_DIST = DistInfo()


@dataclasses.dataclass(frozen=True)
class OperandInfo:
    """Static description of one einsum operand."""
    term: str                  # its index string
    is_sparse: bool
    shape: Tuple[int, ...]
    cap: Optional[int]         # padded capacity (sparse only)
    nnz: Optional[int]         # static nonzero hint (sparse only; ≤ cap)
    dtype: str
    dense_dim: Optional[int] = None  # trailing dense axis size (sparse only)
    # per-mode nonzero-row-count hint from streamed ingest metadata
    # (data.streaming.IngestStats → SparseTensor.nnz_rows): lets the cost
    # model bound segment/bucket output traffic hypersparsely
    nnz_rows: Optional[Tuple[int, ...]] = None


@dataclasses.dataclass(frozen=True)
class ContractionIR:
    """A classified contraction. ``sizes`` maps index letters to extents."""
    expr: str
    kind: str
    operands: Tuple[OperandInfo, ...]
    out: str
    sizes: Tuple[Tuple[str, int], ...]
    sparse_pos: Optional[int] = None
    # sparse-pattern metadata (unused fields left at defaults):
    keep_modes: Tuple[int, ...] = ()        # REDUCE/MTTKRP: kept sparse modes,
                                            #   ordered as they appear in out
    rank_index: Optional[str] = None        # TTTP/TTM/MTTKRP rank letter
                                            #   (CG_MATVEC: the KEPT rank)
    factor_modes: Tuple[int, ...] = ()      # sparse mode matched by each
                                            #   dense factor, in operand order
    contract_mode: Optional[int] = None     # TTM: the contracted sparse mode
    rank2_index: Optional[str] = None       # CG_MATVEC: the contracted rank
                                            #   letter (the TTTP half)
    dist: Optional[DistInfo] = None         # distribution signature (None =
                                            #   local single-device run)

    # -- helpers -----------------------------------------------------------
    def size_of(self, idx: str) -> int:
        return dict(self.sizes)[idx]

    @property
    def sparse(self) -> Optional[OperandInfo]:
        return None if self.sparse_pos is None else self.operands[self.sparse_pos]

    @property
    def sparse_term(self) -> str:
        return self.operands[self.sparse_pos].term

    @property
    def nnz(self) -> int:
        """Best static nonzero estimate: the nnz hint, else the capacity.
        Clamped to the capacity — a sharded SparseTensor carries the GLOBAL nnz
        hint while its cap is the per-shard bound, and cost terms here are
        per-device."""
        sp = self.sparse
        return sp.cap if sp.nnz is None else min(sp.nnz, sp.cap)

    @property
    def rank_size(self) -> int:
        return 1 if self.rank_index is None else self.size_of(self.rank_index)

    def out_cells(self, modes: Tuple[int, ...]) -> int:
        """Hypersparse bound on the kept-mode output cells actually carrying
        data: the full extent product, tightened by the per-mode
        nonzero-row hints (streamed ingest metadata) and by nnz (each
        nonzero lands in exactly one output cell). Dense extents are the
        fallback when no hint is attached."""
        sp = self.sparse
        cells = 1
        for d in modes:
            e = sp.shape[d]
            if sp.nnz_rows is not None:
                e = min(e, sp.nnz_rows[d])
            cells *= e
        return max(1, min(cells, self.nnz) if modes else 1)

    @property
    def dense_positions(self) -> Tuple[int, ...]:
        return tuple(i for i, op in enumerate(self.operands)
                     if not op.is_sparse)


def dtype_name(dtype) -> str:
    """``torch.float32`` -> ``"float32"``, the reference's spelling."""
    return str(dtype).removeprefix("torch.")


def _operand_info(term: str, op) -> OperandInfo:
    if isinstance(op, SparseTensor):
        nnz_rows = (None if op.nnz_rows is None
                    else tuple(int(r) for r in op.nnz_rows))
        return OperandInfo(term, True, tuple(op.shape), op.cap, op.nnz,
                           dtype_name(op.values.dtype), op.dense_dim,
                           nnz_rows=nnz_rows)
    return OperandInfo(term, False, tuple(op.shape), None, None,
                       dtype_name(op.dtype))


def normalize(expr: str) -> str:
    return expr.replace(" ", "")


def build_ir(expr: str, operands: Sequence,
             dist: Optional[DistInfo] = None) -> ContractionIR:
    """Parse + classify. Raises ``ValueError`` on malformed expressions and
    ``NotImplementedError`` on patterns outside the supported families.

    ``dist`` attaches the static distribution signature; with
    ``dist.rowsharded`` the dense factors carry *local* row counts
    (rows sharded over the data axes), so their mode extent is validated
    against ``local_rows * data_size``."""
    ir = _build_ir(expr, operands, dist)
    return ir if dist is None else dataclasses.replace(ir, dist=dist)


def _build_ir(expr: str, operands: Sequence,
              dist: Optional[DistInfo]) -> ContractionIR:
    expr = normalize(expr)
    if "->" not in expr:
        raise ValueError(f"einsum expression must be explicit (have '->'): {expr!r}")
    lhs, out = expr.split("->")
    terms = lhs.split(",")
    if len(terms) != len(operands):
        raise ValueError(f"{expr!r}: {len(terms)} terms but "
                         f"{len(operands)} operands")
    infos = tuple(_operand_info(t, op) for t, op in zip(terms, operands))

    rowsharded = dist is not None and dist.rowsharded
    sizes: Dict[str, int] = {}
    for info in infos:
        if len(info.term) != len(info.shape):
            raise ValueError(f"term {info.term!r} has {len(info.term)} indices "
                             f"but operand has shape {info.shape}")
        if len(set(info.term)) != len(info.term):
            raise NotImplementedError(
                f"repeated index within a term is unsupported: {info.term!r}")
        shape = info.shape
        if rowsharded and not info.is_sparse and len(info.term) == 2:
            # factor rows are sharded over the data axes: the logical mode
            # extent is local_rows * data_size (sparse indices stay global)
            shape = (shape[0] * dist.data_size, shape[1])
        for c, s in zip(info.term, shape):
            if sizes.setdefault(c, int(s)) != int(s):
                raise ValueError(f"index {c!r} has conflicting sizes "
                                 f"{sizes[c]} and {s} in {expr!r}")
    for c in out:
        if c not in sizes:
            raise ValueError(f"output index {c!r} not in any input term")
    if len(set(out)) != len(out):
        raise NotImplementedError(f"repeated output index unsupported: {out!r}")
    size_items = tuple(sorted(sizes.items()))

    sparse_positions = [i for i, info in enumerate(infos) if info.is_sparse]
    if not sparse_positions:
        return ContractionIR(expr, DENSE, infos, out, size_items)
    if len(sparse_positions) > 1:
        raise NotImplementedError(
            "contractions with multiple sparse operands are not supported "
            "yet (the planner handles a single sparse operand)")
    spos = sparse_positions[0]
    s_term = infos[spos].term
    dense_infos = [(i, info) for i, info in enumerate(infos) if i != spos]

    if infos[spos].dense_dim is not None and dense_infos:
        raise NotImplementedError(
            "a SparseTensor with a trailing dense axis is only supported in "
            "reductions (the trailing axis rides along unreduced)")

    # ---- single sparse operand, no dense: mode-subset reduction ----------
    if not dense_infos:
        if not set(out) <= set(s_term):
            raise ValueError(f"output {out!r} not a subset of {s_term!r}")
        keep = tuple(s_term.index(c) for c in out)
        return ContractionIR(expr, REDUCE, infos, out, size_items,
                             sparse_pos=spos, keep_modes=keep)

    # ---- factor-matrix families: every dense term is (mode, rank) --------
    new_idx = {c for _, info in dense_infos for c in info.term
               if c not in s_term}
    if len(new_idx) == 2:
        return _classify_cg_matvec(expr, infos, out, size_items, spos,
                                   s_term, dense_infos, new_idx)
    if len(new_idx) != 1:
        raise NotImplementedError(
            f"expected exactly one rank index shared by the dense factors "
            f"(or two for the Gram-matvec family), "
            f"got {sorted(new_idx)} in {expr!r}")
    (r_idx,) = new_idx
    factor_modes = []
    for _, info in dense_infos:
        t = info.term
        if len(t) != 2 or t[1] != r_idx or t[0] not in s_term:
            raise NotImplementedError(
                f"dense operand term {t!r} is not a ({{sparse mode}}, "
                f"{r_idx!r}) factor matrix in {expr!r}")
        factor_modes.append(s_term.index(t[0]))
    if len(set(factor_modes)) != len(factor_modes):
        raise NotImplementedError(
            f"two factors contract the same sparse mode in {expr!r}")
    factor_modes = tuple(factor_modes)

    # TTTP / SDDMM: output pattern equals the sparse pattern
    if out == s_term:
        return ContractionIR(expr, TTTP, infos, out, size_items,
                             sparse_pos=spos, rank_index=r_idx,
                             factor_modes=factor_modes)

    # TTM / MTTKRP: rank index appears in the output, contracted sparse
    # modes are exactly the factor-covered ones
    if r_idx not in out:
        raise NotImplementedError(
            f"rank index {r_idx!r} neither reduced as TTTP nor kept in the "
            f"output in {expr!r}")
    out_sparse = out.replace(r_idx, "")
    if not set(out_sparse) <= set(s_term):
        raise ValueError(f"output indices {out_sparse!r} not all in sparse "
                         f"term {s_term!r}")
    contracted = set(s_term) - set(out_sparse)
    covered = {s_term[m] for m in factor_modes}
    if covered != contracted:
        raise NotImplementedError(
            f"factors cover modes {sorted(covered)} but the contracted "
            f"sparse modes are {sorted(contracted)} in {expr!r}")
    keep = tuple(s_term.index(c) for c in out_sparse)
    if len(dense_infos) == 1:
        return ContractionIR(expr, TTM, infos, out, size_items,
                             sparse_pos=spos, keep_modes=keep,
                             rank_index=r_idx, factor_modes=factor_modes,
                             contract_mode=factor_modes[0])
    return ContractionIR(expr, MTTKRP, infos, out, size_items,
                         sparse_pos=spos, keep_modes=keep,
                         rank_index=r_idx, factor_modes=factor_modes)


def _classify_cg_matvec(expr, infos, out, size_items, spos, s_term,
                        dense_infos, new_idx) -> ContractionIR:
    """Classify the two-rank-index weighted Gram matvec (paper eq. 3):

        y[i, r] = Σ_n ω_n · (Π_{d≠mode} A_d[i_d, r]) · Σ_s x[i_mode, s] ·
                  Π_{d≠mode} A_d[i_d, s]

    i.e. one rank index (``rank2_index``) fully contracted over factors
    covering EVERY sparse mode (the TTTP half, with the target-mode factor
    playing x), and one rank index kept in the output over factors covering
    every non-target mode (the MTTKRP half)."""
    kept = [c for c in new_idx if c in out]
    if len(kept) != 1:
        raise NotImplementedError(
            f"two rank indices require exactly one kept in the output "
            f"(the Gram-matvec family), got {sorted(kept)} kept in {expr!r}")
    r_idx = kept[0]
    (s_idx,) = new_idx - {r_idx}
    out_modes = [c for c in out if c != r_idx]
    if len(out_modes) != 1 or out_modes[0] not in s_term:
        raise NotImplementedError(
            f"Gram-matvec output must be one sparse mode plus the kept rank, "
            f"got {out!r} in {expr!r}")
    keep = s_term.index(out_modes[0])
    factor_modes, r_modes, s_modes = [], [], []
    for _, info in dense_infos:
        t = info.term
        if len(t) != 2 or t[1] not in (r_idx, s_idx) or t[0] not in s_term:
            raise NotImplementedError(
                f"dense operand term {t!r} is not a ({{sparse mode}}, rank) "
                f"factor matrix in {expr!r}")
        m = s_term.index(t[0])
        factor_modes.append(m)
        (r_modes if t[1] == r_idx else s_modes).append(m)
    nd = len(s_term)
    if (sorted(r_modes) != [d for d in range(nd) if d != keep]
            or sorted(s_modes) != list(range(nd))):
        raise NotImplementedError(
            f"Gram matvec needs kept-rank factors on every non-output mode "
            f"and contracted-rank factors on every mode; got kept-rank modes "
            f"{sorted(r_modes)}, contracted-rank modes {sorted(s_modes)} "
            f"in {expr!r}")
    return ContractionIR(expr, CG_MATVEC, infos, out, size_items,
                         sparse_pos=spos, keep_modes=(keep,),
                         rank_index=r_idx, factor_modes=tuple(factor_modes),
                         rank2_index=s_idx)


def is_classic_mttkrp(ir: ContractionIR) -> bool:
    """True for the paper's MTTKRP: one kept mode, factors on all others —
    the only shape the pairwise and bucketed kernels implement."""
    return (ir.kind == MTTKRP and len(ir.keep_modes) == 1 and
            len(ir.factor_modes) == len(ir.sparse.shape) - 1)
