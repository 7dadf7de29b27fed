"""The program's own spans and counters, as the `program_span` and
`program_counter` readers take them: `snapshot()` of the program's tracing
module (`image_compression_torch.utils.profiling`) after the traced run,
which holds what the program recorded under the benchmark's profiler (one
compress job, or the RL driver's traced steps). Each reader divides by the
unit spans of its driver: `compress.batch` or `rl.step`. A program without
that function, or a snapshot without those spans, gives None: there is
nothing to read."""

UNIT = {"compress": "compress.batch", "rl": "rl.step"}


def per_unit(ctx: dict, driver: str):
    """(the snapshot's spans, its counters, the number of unit spans), or
    None for another driver's cell or where the program recorded none."""
    if ctx["driver"] != driver:
        return None
    try:
        from image_compression_torch.utils.profiling import snapshot
    except ImportError:
        return None
    snap = snapshot()
    units = snap["spans"].get(UNIT[driver], {}).get("count", 0)
    if not units:
        return None
    return snap["spans"], snap["counters"], units


def on_card(spans: dict, driver: str) -> bool:
    """Whether the unit spans ran on a CUDA device (they carry device
    time): syncs are counted only there."""
    return spans[UNIT[driver]]["device_s"] is not None
