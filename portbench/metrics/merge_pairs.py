"""merge_pairs: region pairs that merge refinement merged (ops/merge_refine._merge_round: the sum
of its accepted merges, on the device while traced) a batch: the program's `merge.pairs` counter
over its `compress.batch` spans in the traced job; None where the program does not count it."""

from portbench import program


def read(ctx):
    got = program.per_unit(ctx, "compress")
    if got is None or "merge.pairs" not in got[1]:
        return None
    _, counters, batches = got
    return counters["merge.pairs"] / batches
