"""The control of the checkpoint-free graph cells (drivers/compress_graph):
the FH reference run on its smoothed images rounded to bfloat16, in the
program's place, compared with the float32 reference by the cell's own
costs_diff at the cell's own sizes. It has to come out as not correct.

    python3 portbench/control_graph.py --workload graph.mixed256 \
        --seeds <n> [<n> ...]

Prints one JSON line per seed, as control.py does for the other cells.
The benchmark's runs do not run it; portbench/tests/test_portbench_graph.py
runs it on a card.
"""

import argparse
import json
import pathlib
import shutil
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def control(name: str, seed: int, device: str = "cuda",
            spec: dict | None = None) -> dict:
    """The control's numbers on one seed, beside the cell's limits."""
    from portbench import harness
    from portbench.reference import compress_graph as ref
    from portbench.traffic import generator
    spec = spec or harness.cell_spec(name)
    work = pathlib.Path(tempfile.mkdtemp(prefix="portbench-control-"))
    try:
        corpus = generator.make(spec["traffic"], seed, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    numbers = {k: harness.check(v, spec["limits"][k])
               for k, v in ref.control(spec, corpus, device).items()}
    return {"workload": name, "seed": seed,
            "correct": all(c["ok"] for c in numbers.values()),
            "numbers": {k: [c["value"], c["limit"]]
                        for k, c in numbers.items()}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    for seed in args.seeds:
        print(json.dumps(control(args.workload, seed)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
