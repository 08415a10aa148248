"""``conv_ms.<kind>``: device ms per step of the convolution kernels (the
class ``cuDNN convolutions`` of the frozen table)."""

from portbench.tracing import class_ms_per_step


def read(ctx):
    return class_ms_per_step(ctx["trace"], "cuDNN convolutions")
