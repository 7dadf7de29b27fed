"""rl_reward_ms: the RL step's estimator reward (`ops/rewards.compute_rewards_batched`) in ms a
step on the device's timeline: the program's `reward` spans' device seconds over its `rl.step`
spans in the traced steps; None off the card."""

from portbench import program


def read(ctx):
    got = program.per_unit(ctx, "rl")
    if got is None or (got[0].get("reward") or {}).get("device_s") is None:
        return None
    spans, _, steps = got
    return 1e3 * spans["reward"]["device_s"] / steps
