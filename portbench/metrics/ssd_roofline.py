"""Percent: the least time of the model's SSD work (the frozen SSD counts
over each chunk's causal half) over the device time of the SSD kernels
in the traced rounds."""
from portbench.work import roofline


def read(reading):
    return roofline.kernel_share(reading, "ssd")
