"""Run one cell of ``BENCHMARK.json`` once on the CUDA device.

    python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the card's name and power limit, then each number compared with the
reference beside its limit as the last lines of standard error, and one
JSON object as the last line of standard output. Without CUDA, or with
fewer devices than the cell asks for, it exits with code 2 and prints no
result. Kernel and compiler caches are kept under ``build/`` in the
checkout, at fixed paths.
"""

import time

T0 = time.perf_counter()  # set-up is measured from here, before any import

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_extensions",
          "CUDA_CACHE_PATH": "nv_compute_cache"}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / "build" / "port_bench" / sub)

    import torch

    from port_bench.lib import guard, peaks, runner, spec

    cell = spec.cell(args.workload)
    chips = int(cell["workload"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"port_bench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    print(f"card: {peaks.card_line()}", file=sys.stderr)
    result, lines = runner.run(cell, args.seed, args.seconds, bool(args.trace), "cuda:0", T0)
    bad = guard.loaded()
    if bad:
        print(f"port_bench: the process loaded {bad}", file=sys.stderr)
        return 3
    sys.stderr.write("".join(line + "\n" for line in lines))
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
