"""kept_images: images whose slicing the fallback kept (pipeline._write_batch, from the wire's host
single-slice flags; the guard's rewrites among them) a batch: the program's
`compress.kept_images` counter over its `compress.batch` spans in the traced job; None where the
program does not count it."""

from portbench import program


def read(ctx):
    got = program.per_unit(ctx, "compress")
    if got is None or "compress.kept_images" not in got[1]:
        return None
    _, counters, batches = got
    return counters["compress.kept_images"] / batches
