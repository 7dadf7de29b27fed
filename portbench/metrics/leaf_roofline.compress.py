"""leaf_roofline.compress: the multicut leaf kernel's share of its roofline, in
% of the H100 SXM's published peaks (cost/peaks.json). The least time is
cost/model.leaf_bound_s over the level-1 supertiles that the traced span's
images (one pass over the corpus) need (never counted per launch, so fusing or splitting launches moves
the time and not the work); the kernel time is the summed duration of the
trace's kernels named *leaf_kernel* in the span. No such kernel: nothing."""


def read(ctx):
    tr = ctx["trace"]
    if ctx["driver"] != "compress" or tr is None:
        return None
    spent = sum(d for name, d in tr["kernels"] if "leaf_kernel" in name)
    if spent <= 0:
        return None
    leaf = ctx["config"]["leaf"]
    t1 = ctx["cost"].supertiles(ctx["traced_images"], ctx["height"], ctx["width"])
    bound, _ = ctx["cost"].leaf_bound_s(t1, leaf["s1"], leaf["r0"],
                                        leaf["r1"])
    return 100.0 * bound / spent
