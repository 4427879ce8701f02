"""The device memory's peak over the window
(``torch.cuda.max_memory_allocated`` after a reset at its start), GiB."""


def read(reading):
    return reading.peak_bytes / 2 ** 30 if reading.peak_bytes else None
