"""The fused ``ServerStep`` call a round (top-k with error feedback and
the int8 wire where the deployment has them, the weighted reduce, the
apply), host clock with a sync at each edge, mean over the window's
rounds, ms."""
import statistics


def read(reading):
    spans = reading.spans
    return 1e3 * statistics.fmean(spans.server) \
        if spans and spans.server else None
