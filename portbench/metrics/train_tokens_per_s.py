"""Client tokens trained per second: every round of the window, over the
window's whole time on the host clock (the call to its last round's
sync)."""
from portbench.work import roofline


def read(reading):
    return roofline.tokens_per_s(reading)
