"""fused_norm_share: the share of the U-Net's norm sites (each DoubleConv's GroupNorm, ReLU and bf16
cast) that ran the hand-written kernel (`csrc/group_norm_relu.cu`), in %: 100 x the program's
`unet.norms_fused` over its `unet.norms`, counted over the `compress.batch` spans of the traced job;
None where the program does not count them (a program without the kernel) or ran no U-Net."""

from portbench import program


def read(ctx):
    got = program.per_unit(ctx, "compress")
    if got is None or not got[1].get("unet.norms"):
        return None
    counters = got[1]
    return 100.0 * counters.get("unet.norms_fused", 0) / counters["unet.norms"]
