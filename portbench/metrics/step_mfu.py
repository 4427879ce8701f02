"""Percent of the card's fp32-equivalent peak that the model FLOPs of the
traced rounds (counted from the configuration) reach over the device's
busy time there (from the trace)."""
from portbench.work import roofline


def read(reading):
    return roofline.step_mfu(reading)
