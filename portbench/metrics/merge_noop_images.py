"""merge_noop_images: images that enter merge refinement with one region (declined: nothing to
merge) a batch: the program's `merge.noop_images` counter over its `compress.batch` spans in the
traced job."""

from portbench import program


def read(ctx):
    got = program.per_unit(ctx, "compress")
    if got is None or "merge.noop_images" not in got[1]:
        return None
    _, counters, batches = got
    return counters["merge.noop_images"] / batches
