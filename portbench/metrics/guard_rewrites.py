"""guard_rewrites: kept slicings that the writer's never-expand guard rewrote as the source's
passthrough, having written more than the original + 49 bytes (pipeline._write_batch) a batch:
the program's `compress.guard_rewrites` counter over its `compress.batch` spans in the traced
job; None where the program does not count it."""

from portbench import program


def read(ctx):
    got = program.per_unit(ctx, "compress")
    if got is None or "compress.guard_rewrites" not in got[1]:
        return None
    _, counters, batches = got
    return counters["compress.guard_rewrites"] / batches
