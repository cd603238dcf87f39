"""ServingModel: frozen CP factors and a link, restored from a checkpoint.

The serving layer reads the two on-disk formats that
``launch/complete.py --dump-factors`` writes (in either package):

* a checkpoint step directory (``repro_torch.checkpoint``): state
  ``{"factor_<d>": A_d}`` with the fit's metadata (rank, shape, loss, link)
  in the manifest. The restore goes through
  :func:`repro_torch.checkpoint.restore`, so every leaf is checked against
  the manifest's shape and dtype, and a drifted checkpoint fails naming the
  factor;
* a legacy ``.npz`` with keys ``factor_0..factor_{N-1}`` (no metadata: the
  caller gives the link).

Scoring is the CP model itself, m(i1..iN) = Σ_r Π_d A_d[i_d, r]: a TTTP with
unit values, so on the card it runs the TTTP kernel (``csrc/tttp.cu``) and
on the CPU that kernel's plain version (``kernels.ref.tttp_ref``, the
gather chain). ``link="log"`` maps to rate space as exp(clip(m, ±LOG_CLIP)),
the clamp of ``data.streaming.heldout_metrics``, so a served score equals
what the fit's held-out metrics evaluated.
"""
from __future__ import annotations

import dataclasses
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import checkpoint as ckpt
from repro_torch.core.losses import LOG_CLIP
from repro_torch.core.sparse_tensor import SparseTensor
from repro_torch.kernels import ops as kops

LINKS = ("identity", "log")


def apply_link(m: torch.Tensor, link: str) -> torch.Tensor:
    """Model space to prediction space: ``log`` predicts rates exp(m) under
    the held-out metrics' clamp; ``identity`` returns ``m``."""
    if link == "identity":
        return m
    if link == "log":
        return torch.exp(torch.clamp(m, -LOG_CLIP, LOG_CLIP))
    raise ValueError(f"unknown link {link!r}; choices: {LINKS}")


def multilinear_scores(factors: Sequence[torch.Tensor],
                       indices: torch.Tensor) -> torch.Tensor:
    """Batched CP entry scores: (B, ndim) int indices to (B,) model values,
    as TTTP over the batch with unit values and every slot valid."""
    idx = indices.to(torch.int32).contiguous()
    b = idx.shape[0]
    ones = torch.ones(b, dtype=factors[0].dtype, device=idx.device)
    valid = torch.ones(b, dtype=torch.bool, device=idx.device)
    shape = tuple(int(f.shape[0]) for f in factors)
    return kops.tttp_values(SparseTensor(idx, ones, valid, shape, b),
                            list(factors))


@dataclasses.dataclass
class ServingModel:
    """Frozen factors, a link and the fit's metadata. The serving layer
    never writes to the factors; fold-in returns new rows."""

    factors: List[torch.Tensor]
    link: str = "identity"
    meta: Dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if not self.factors:
            raise ValueError("ServingModel needs at least one factor")
        ranks = {int(f.shape[1]) for f in self.factors}
        if len(ranks) != 1:
            raise ValueError(f"factors disagree on rank: {sorted(ranks)}")
        if self.link not in LINKS:
            raise ValueError(f"unknown link {self.link!r}; choices: {LINKS}")

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(int(f.shape[0]) for f in self.factors)

    @property
    def rank(self) -> int:
        return int(self.factors[0].shape[1])

    @property
    def ndim(self) -> int:
        return len(self.factors)

    def raw_scores(self, indices: torch.Tensor) -> torch.Tensor:
        """(B,) model-space values at the given (B, ndim) entries."""
        return multilinear_scores(self.factors, indices)

    def predict(self, indices: torch.Tensor) -> torch.Tensor:
        """(B,) predictions with the link applied (rates under ``log``)."""
        return apply_link(self.raw_scores(indices), self.link)


def _factors_from_arrays(arrays: Dict[int, np.ndarray],
                         device) -> List[torch.Tensor]:
    modes = sorted(arrays)
    if modes != list(range(len(modes))):
        raise ValueError(f"factor modes not contiguous from 0: {modes}")
    return [torch.as_tensor(arrays[d], device=device).contiguous()
            for d in modes]


def _load_npz(path: str, device) -> List[torch.Tensor]:
    with np.load(path) as z:
        arrays = {}
        for key in z.files:
            m = re.fullmatch(r"factor_(\d+)", key)
            if m:
                arrays[int(m.group(1))] = z[key]
    if not arrays:
        raise ValueError(f"{path}: no factor_<d> arrays found")
    return _factors_from_arrays(arrays, device)


def _load_checkpoint(path: str, step: Optional[int], device):
    if step is None:
        step = ckpt.latest_step(path)
        if step is None:
            raise ValueError(f"{path}: no committed checkpoint steps found")
    manifest = ckpt.read_manifest(path, step)
    # the restore target comes from the manifest alone: the serving process
    # knows nothing of the fit's rank or shape until it reads it
    shapes: Dict[int, tuple] = {}
    for key, ent in manifest.get("leaves", {}).items():
        m = re.search(r"factor_(\d+)", key)
        if m:
            shapes[int(m.group(1))] = (tuple(ent["shape"]),
                                       np.dtype(ent["dtype"]))
    if not shapes:
        raise ValueError(
            f"{path} step {step}: manifest has no factor_<d> leaves "
            f"(records {sorted(manifest.get('leaves', {}))}) — not a "
            f"factor checkpoint")
    like = {f"factor_{d}": torch.empty(
        sh, dtype=torch.from_numpy(np.empty(0, dt)).dtype, device=device)
        for d, (sh, dt) in shapes.items()}
    state, manifest = ckpt.restore(path, step, like)
    arrays = {d: state[f"factor_{d}"] for d in shapes}
    return (_factors_from_arrays(arrays, device),
            manifest.get("metadata", {}) or {})


def load_factors(path: str, link: Optional[str] = None,
                 step: Optional[int] = None,
                 device="cuda") -> ServingModel:
    """Restore a :class:`ServingModel` from ``path`` onto ``device``.

    A directory is a checkpoint root (its newest step unless ``step`` is
    given; its metadata gives the link unless ``link`` does); a file is the
    legacy ``.npz`` (link identity unless ``link`` says otherwise)."""
    if os.path.isdir(path):
        factors, meta = _load_checkpoint(path, step, device)
    else:
        factors, meta = _load_npz(path, device), {}
    resolved = link or meta.get("link") or "identity"
    return ServingModel(factors, link=resolved, meta=meta)
