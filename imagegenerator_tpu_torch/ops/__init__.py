"""Core ops: torch-layout convs, torch-init layers and blocks, and the
hand-written kernels under ``ops/kernels/``."""
