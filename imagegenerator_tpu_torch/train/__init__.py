"""Stage-1/2 systems (the sampling subset) and the sampling CLI."""
