"""rl_forward_ms: the policy forward without grad (RLStep.forward) per step in ms, from the program's stage clock
(`train.steps.RLStep.__call__(timings=)`, key "forward") over the traced run's window; it
synchronizes the device at each stage boundary."""


def read(ctx):
    if ctx["driver"] != "rl" or "forward" not in ctx["timings"]:
        return None
    return 1e3 * ctx["timings"]["forward"] / ctx["timed_steps"]
