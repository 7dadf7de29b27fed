"""write_wait_ms: the main thread's wait for the writer thread's previous batch, in ms a batch:
the program's `write_wait` spans' host seconds over its `compress.batch` spans in the traced
job."""

from portbench import program


def read(ctx):
    got = program.per_unit(ctx, "compress")
    if got is None or "write_wait" not in got[0]:
        return None
    spans, _, batches = got
    return 1e3 * spans["write_wait"]["host_s"] / batches
