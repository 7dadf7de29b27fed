"""syncs_per_batch.compress: synchronizing CUDA operations (torch's sync debug mode: `.item()`,
`nonzero`, copies to the host, ...) inside the program's `compress.batch` spans, a batch, in the
traced job; None off the card."""

from portbench import program


def read(ctx):
    got = program.per_unit(ctx, "compress")
    if got is None or not program.on_card(got[0], "compress"):
        return None
    spans, _, batches = got
    return spans["compress.batch"]["syncs"] / batches
