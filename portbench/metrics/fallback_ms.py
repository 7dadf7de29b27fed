"""fallback_ms: the single-slice fallback (pipeline.fallback_single_slice -> ops/rewards.py -> ops/png_estimator.py) per batch in ms, from the program's stage clock
(`pipeline.compress_directory(timings=)`, key "fallback") over the traced run's window; it
synchronizes the device at each stage boundary."""


def read(ctx):
    if ctx["driver"] != "compress" or "fallback" not in ctx["timings"]:
        return None
    return 1e3 * ctx["timings"]["fallback"] / ctx["timed_batches"]
