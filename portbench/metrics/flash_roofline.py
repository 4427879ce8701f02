"""Percent: the least time of the model's attention work (the frozen
flash counts over the visible pairs) over the device time of the flash
kernels in the traced rounds."""
from portbench.work import roofline


def read(reading):
    return roofline.kernel_share(reading, "flash")
