"""The federated loop's own time a round (planning, flattening the client
rows into deltas, unflattening the global, the eval and the host's
work): each round's wall minus its engine and server-step spans, mean
over the window's rounds."""
import statistics


def read(reading):
    spans = reading.spans
    if not spans or len(spans.local) != reading.rounds \
            or len(spans.server) != reading.rounds:
        return None
    return statistics.fmean(w - a - b for w, a, b in zip(
        reading.round_walls, spans.local, spans.server))
