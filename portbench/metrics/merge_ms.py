"""merge_ms: merge refinement (ops/merge_refine.py) per batch in ms, from the program's stage clock
(`pipeline.compress_directory(timings=)`, key "merge") over the traced run's window; it
synchronizes the device at each stage boundary."""


def read(ctx):
    if ctx["driver"] != "compress" or "merge" not in ctx["timings"]:
        return None
    return 1e3 * ctx["timings"]["merge"] / ctx["timed_batches"]
