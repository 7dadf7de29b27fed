"""compress_mfu: the whole compress step's share of the H100 SXM's
published dense bf16 peak (989 TFLOP/s, cost/peaks.json), in %: the
EdgeUNet forward's FLOPs (cost/model.unet_forward_flops, from the layer
table) x the images of the traced span / the span's seconds / the peak."""


def read(ctx):
    tr = ctx["trace"]
    if ctx["driver"] != "compress" or tr is None:
        return None
    m = ctx["config"]["model"]
    flops = ctx["traced_images"] * ctx["cost"].unet_forward_flops(
        ctx["height"], ctx["width"], m["base"], m["edge_channels"])
    return 100.0 * flops / tr["span_s"] / ctx["cost"].PEAKS[
        "bf16_flops_per_s"]
