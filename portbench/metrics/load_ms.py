"""load_ms: the host's PNG decode of a compress batch (`io/image_io.load_image`, the card idle
meanwhile) in ms: the program's `load` spans' host seconds over its `compress.batch` spans in the
traced job."""

from portbench import program


def read(ctx):
    got = program.per_unit(ctx, "compress")
    if got is None or "load" not in got[0]:
        return None
    spans, _, batches = got
    return 1e3 * spans["load"]["host_s"] / batches
