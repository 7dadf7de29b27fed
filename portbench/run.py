"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout on a machine with the cards the cell asks
for. Set-up (the corpus from the seed, the weights, one warm-up job or
the first training steps) counts as `setup_s`; then the window measures
for --seconds; then the correctness check holds what the window produced
against the plain reference under portbench/reference/. The last line of
standard output is one JSON object (correct, attempted, failed, metrics,
device, [breakdown], checks); each compared number is also printed, with
its limit, as the last lines of standard error. With --trace 1 the window
runs with the program's stage clocks and a short span runs under
torch.profiler, and the metrics are the cell's per-layer ones. Exits 2,
printing no result, without the cards, and 3 where the program or the
benchmark's files are missing or a module of JAX was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    from portbench import harness
    harness.set_cache_dirs()
    try:
        import image_compression_torch  # noqa: F401
    except ImportError as exc:
        print(f"portbench: the program is not importable: {exc}",
              file=sys.stderr)
        return 3
    try:
        result = harness.run_cell(args.workload, args.seed, args.seconds,
                                  bool(args.trace), t_start=T_START)
    except harness.NoDevice as exc:
        print(f"portbench: {exc}", file=sys.stderr)
        return 2
    except (KeyError, FileNotFoundError, RuntimeError) as exc:
        print(f"portbench: {type(exc).__name__}: {exc}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(f"correct {result['correct']}", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
