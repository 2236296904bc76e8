"""flash_roofline.train: the least time of the attention calls the flash kernels
served in the traced window (FLOPs at 989 TFLOP/s or bytes at 3.35 TB/s, whichever
is larger) over the device time of the kernels built from csrc/, %."""

from benchmark import readers


def read(run):
    return readers.flash_roofline(run) if run.kind == "train" else None
