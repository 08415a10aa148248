"""``layout_copy_ms.<kind>``: device ms per step of copies and layout
transforms (NCHW <-> NHWC, cuDNN's tensor transforms, casts through the
copy kernel; the class ``copies and layout transforms`` of the frozen
table)."""

from portbench.tracing import class_ms_per_step


def read(ctx):
    return class_ms_per_step(ctx["trace"], "copies and layout transforms")
