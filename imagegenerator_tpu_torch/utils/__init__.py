"""Utilities: a standard-library PNG writer and reader, the entry points' device rule, metrics, seeded generators."""
