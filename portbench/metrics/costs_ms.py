"""costs_ms: the U-Net's learned costs (models/unet.py + ops/edges.squash_mu) per batch in ms, from the program's stage clock
(`pipeline.compress_directory(timings=)`, key "costs") over the traced run's window; it
synchronizes the device at each stage boundary."""


def read(ctx):
    if ctx["driver"] != "compress" or "costs" not in ctx["timings"]:
        return None
    return 1e3 * ctx["timings"]["costs"] / ctx["timed_batches"]
