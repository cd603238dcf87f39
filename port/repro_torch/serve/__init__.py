"""Serving on frozen factors.

The training side fits CP factor matrices; this package uses them: restore
a frozen-factor checkpoint and answer

* batched entry scoring: predict (i, j, k) by the CP model (``link="log"``
  evaluates in rate space, matching the ``*_log`` losses);
* per-user fold-in for cold requests: one damped one-row ALS solve against
  the frozen factors, batched CG on the paper's eq.-3 weighted Gram matvec,
  no retraining;
* top-k item retrieval: blocked matmul over the item factor with a
  streaming top-k merge, never forming the full score row.

Layering::

    model.py    ServingModel: frozen factors and link, checkpoint/npz load
    foldin.py   history packing and batched one-row ALS fold-in
    topk.py     query vectors and blocked streaming top-k
    engine.py   ServeEngine: batched endpoints, one CUDA graph per bucket
"""
from repro_torch.serve.engine import ServeEngine, percentiles
from repro_torch.serve.foldin import fold_in, fold_in_single, pack_histories
from repro_torch.serve.model import ServingModel, apply_link, load_factors
from repro_torch.serve.topk import query_rows, topk_over_mode

__all__ = [
    "ServeEngine", "ServingModel", "apply_link", "fold_in",
    "fold_in_single", "load_factors", "pack_histories", "percentiles",
    "query_rows", "topk_over_mode",
]
