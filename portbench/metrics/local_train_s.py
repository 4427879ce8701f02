"""The engine's ``run_round`` (every client's local steps through the
split program) a round, host clock with a sync at each edge, mean over
the window's rounds."""
import statistics


def read(reading):
    spans = reading.spans
    return statistics.fmean(spans.local) if spans and spans.local else None
