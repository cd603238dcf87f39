"""CCSR views (the doubly compressed row view and the row-block buckets),
the all-at-once sparse contractions and the redistribution between rank
layouts."""
from repro_torch.sparse.ccsr import (BucketPattern, CCSRView, RowBlockBuckets,
                                     bucket_pattern, bucketize, build_ccsr)
from repro_torch.sparse import ops, redistribute

__all__ = ["BucketPattern", "CCSRView", "RowBlockBuckets", "bucket_pattern",
           "bucketize", "build_ccsr", "ops", "redistribute"]
