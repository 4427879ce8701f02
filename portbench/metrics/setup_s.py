"""Process start to the window's start: imports, data and weights, kernel
loads (and builds, in a checkout's first run) and the checked rounds."""


def read(reading):
    return reading.setup_s
