"""kernels_per_batch.compress: kernel events in the traced span (one pass
over the corpus) divided by its batches."""


def read(ctx):
    tr = ctx["trace"]
    if ctx["driver"] != "compress" or tr is None:
        return None
    return len(tr["kernels"]) / ctx["traced_batches"]
