"""rl_solve_ms: the RL step's multicut solve in ms a step on the device's timeline: the program's
`multicut` spans' device seconds (CUDA events at each end) over its `rl.step` spans in the traced
steps; None off the card."""

from portbench import program


def read(ctx):
    got = program.per_unit(ctx, "rl")
    if got is None or (got[0].get("multicut") or {}).get("device_s") is None:
        return None
    spans, _, steps = got
    return 1e3 * spans["multicut"]["device_s"] / steps
