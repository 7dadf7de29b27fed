"""device_idle.train: % of the traced span (solves (2 B images a step, antithetic)) in which no kernel ran on
the card: 1 - (union of the trace's kernel intervals) / (span)."""


def read(ctx):
    tr = ctx["trace"]
    if ctx["driver"] != "rl" or tr is None:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["span_s"])
