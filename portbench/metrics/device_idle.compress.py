"""device_idle.compress: % of the traced span (images (one pass over the corpus)) in which no kernel ran on
the card: 1 - (union of the trace's kernel intervals) / (span)."""


def read(ctx):
    tr = ctx["trace"]
    if ctx["driver"] != "compress" or tr is None:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["span_s"])
