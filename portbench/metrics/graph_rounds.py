"""graph_rounds: rounds of the Felzenszwalb-Huttenlocher extractor that end at a host fixpoint test
(ops/graph_based_hier._run_rounds_adaptive: the adaptive levels, the global stage and the
min_size absorption; ops/graph_based.py's two phases) a batch: the program's `graph.rounds`
counter over its `compress.batch` spans in the traced job; None where the program does not count
it."""

from portbench import program


def read(ctx):
    got = program.per_unit(ctx, "compress")
    if got is None or "graph.rounds" not in got[1]:
        return None
    _, counters, batches = got
    return counters["graph.rounds"] / batches
