"""Utilities: a standard-library PNG writer and the entry points' device rule."""
