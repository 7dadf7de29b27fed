"""solver_ms: the multicut solve (ops/multicut.py -> multicut_hier.py, leaf kernel) per batch in ms, from the program's stage clock
(`pipeline.compress_directory(timings=)`, key "solver") over the traced run's window; it
synchronizes the device at each stage boundary."""


def read(ctx):
    if ctx["driver"] != "compress" or "solver" not in ctx["timings"]:
        return None
    return 1e3 * ctx["timings"]["solver"] / ctx["timed_batches"]
