"""train_mfu: the whole REINFORCE step's share of the H100 SXM's published
dense bf16 peak (989 TFLOP/s, cost/peaks.json), in %: per step the policy
forward on B images plus the update's forward and backward (taken as 3x a
forward on B images), from the layer table (cost/model.unet_forward_flops),
x the traced span's steps / the span's seconds / the peak."""


def read(ctx):
    tr = ctx["trace"]
    if ctx["driver"] != "rl" or tr is None:
        return None
    m = ctx["config"]["model"]
    per_step = 4 * ctx["batch_size"] * ctx["cost"].unet_forward_flops(
        ctx["height"], ctx["width"], m["base"], m["edge_channels"])
    return 100.0 * per_step * ctx["traced_steps"] / tr["span_s"] / ctx[
        "cost"].PEAKS["bf16_flops_per_s"]
