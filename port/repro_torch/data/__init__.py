"""Synthetic datasets and single-device ingest."""
