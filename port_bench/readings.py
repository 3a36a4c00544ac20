"""The readings a cell's limits are set from, in one process on the card:
the served program on a dozen seeds or more and the control (the reference
in the program's place at int4 where the configuration serves int8) on
three or more, each a run of the cell at its own sizes and load.

    python3 -m port_bench.readings --workload <cell> --seeds 1,2,3 \
        --control-seeds 4,5,6 --seconds 3

Prints one JSON line a run (``who``, ``seed``, the numbers compared) and a
last line with, for each number, the largest program
reading (the lower end of its limit) and the smallest control reading (the
upper end).
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def control_system(config, weights, calibration, device):
    from port_bench.lib.control import Control

    return Control(config, weights, calibration, device)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds of the program")
    p.add_argument("--control-seeds", default="", help="comma-separated seeds of the control")
    p.add_argument("--fault-seeds", default="",
                   help="comma-separated seeds at which each fault of lib/faults.py runs")
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)

    import torch

    from port_bench.lib import check, runner, spec
    from port_bench.lib.faults import FAULTS

    if not torch.cuda.is_available():
        print("port_bench.readings: no CUDA device", file=sys.stderr)
        return 2
    cell = dict(spec.cell(args.workload), end_to_end=[], per_layer=[])
    runs = [("program", int(s), runner.port_system) for s in args.seeds.split(",") if s]
    runs += [("control", int(s), control_system) for s in args.control_seeds.split(",") if s]
    runs += [(name, int(s), make) for name, make in FAULTS.items()
             for s in args.fault_seeds.split(",") if s]
    found = {"program": [], "control": [], **{name: [] for name in FAULTS}}
    for who, seed, make in runs:
        t0 = time.perf_counter()
        result, _ = runner.run(cell, seed, args.seconds, False, "cuda:0", t0, make_system=make)
        numbers = {k: v["value"] for k, v in result["checks"].items()}
        found[who].append(numbers)
        print(json.dumps({"who": who, "seed": seed, "numbers": numbers,
                          "correct": result["correct"], "attempted": result["attempted"],
                          "seconds": time.perf_counter() - t0}), flush=True)
    summary = {k: {"program_max": max((n[k] for n in found["program"]), default=None),
                   **{f"{who}_min": min((n[k] for n in runs_), default=None)
                      for who, runs_ in found.items() if who != "program"}}
               for k in check.NUMBERS}
    print(json.dumps({"workload": args.workload, "summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
