"""write_ms: the host writer (io/slicer.py -> csrc/pngio.cpp) in its worker thread, overlapping the device stages, per batch in ms, from the program's stage clock
(`pipeline.compress_directory(timings=)`, key "write") over the traced run's window; it
synchronizes the device at each stage boundary."""


def read(ctx):
    if ctx["driver"] != "compress" or "write" not in ctx["timings"]:
        return None
    return 1e3 * ctx["timings"]["write"] / ctx["timed_batches"]
