"""syncs_per_step.train: synchronizing CUDA operations (torch's sync debug mode) inside the
program's `rl.step` spans, a step, over the traced steps; None off the card."""

from portbench import program


def read(ctx):
    got = program.per_unit(ctx, "rl")
    if got is None or not program.on_card(got[0], "rl"):
        return None
    spans, _, steps = got
    return spans["rl.step"]["syncs"] / steps
