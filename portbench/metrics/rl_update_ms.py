"""rl_update_ms: the forward with grad, backward and Adam (RLStep.update) per step in ms, from the program's stage clock
(`train.steps.RLStep.__call__(timings=)`, key "update") over the traced run's window; it
synchronizes the device at each stage boundary."""


def read(ctx):
    if ctx["driver"] != "rl" or "update" not in ctx["timings"]:
        return None
    return 1e3 * ctx["timings"]["update"] / ctx["timed_steps"]
