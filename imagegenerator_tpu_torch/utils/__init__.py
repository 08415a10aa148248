"""Utilities: a standard-library PNG writer."""
