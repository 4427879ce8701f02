"""Frozen yardsticks: the kernels' written counts (``counts.py``) and the
card's peaks (``peaks.json``)."""
