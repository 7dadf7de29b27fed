"""rl_solve_reward_ms: the antithetic sample, multicut and compute_rewards_batched (RLStep.solve_reward) per step in ms, from the program's stage clock
(`train.steps.RLStep.__call__(timings=)`, key "solve_reward") over the traced run's window; it
synchronizes the device at each stage boundary."""


def read(ctx):
    if ctx["driver"] != "rl" or "solve_reward" not in ctx["timings"]:
        return None
    return 1e3 * ctx["timings"]["solve_reward"] / ctx["timed_steps"]
