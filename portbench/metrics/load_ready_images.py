"""load_ready_images: a compress batch's images whose decode had finished when the main thread came
to take them (`pipeline.compress_directory` decodes each batch on a thread pool, queued one batch
ahead) a batch: the program's `load.ready_images` counter over its `compress.batch` spans in the
traced job; None where the program does not count it."""

from portbench import program


def read(ctx):
    got = program.per_unit(ctx, "compress")
    if got is None or "load.ready_images" not in got[1]:
        return None
    _, counters, batches = got
    return counters["load.ready_images"] / batches
