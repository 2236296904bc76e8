"""mfu.serve: model FLOPs of the traced window (the plain reference's, counted on the
meta device) over its length, % of the H100's 989 TFLOP/s bf16 peak."""

from benchmark import readers


def read(run):
    return readers.mfu(run) if run.kind == "serve" else None
