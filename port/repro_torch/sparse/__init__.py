"""CCSR row-block buckets and the all-at-once sparse contractions."""
