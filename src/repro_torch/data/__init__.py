"""Data substrate: synthetic corpora and serving workload generators."""
