"""CCSR views (the doubly compressed row view and the row-block buckets)
and the all-at-once sparse contractions."""
from repro_torch.sparse.ccsr import (BucketPattern, CCSRView, RowBlockBuckets,
                                     bucket_pattern, bucketize, build_ccsr)
from repro_torch.sparse import ops

__all__ = ["BucketPattern", "CCSRView", "RowBlockBuckets", "bucket_pattern",
           "bucketize", "build_ccsr", "ops"]
