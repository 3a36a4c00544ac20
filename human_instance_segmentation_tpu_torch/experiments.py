"""Sequential multi-config experiment runner + comparison report.

Counterpart of the JAX package's ``experiments.py`` (:1-74), the
equivalent of the reference's run_experiments.py: runs a list of named
configs through the port's training loop and writes the same
``results.json`` and ``comparison.md`` (a plain markdown table). The JAX
runner's ``platform=`` is ``device=`` here; the runs are on the GPU unless
``device="cpu"`` / ``--device cpu``.

    python -m human_instance_segmentation_tpu_torch.experiments CONFIG [CONFIG ...] \\
        [--steps N] [--epochs N] [--synthetic] [--tiny] [--output_dir DIR] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Dict, List, Optional


def run_experiments(
    config_names: List[str],
    steps: int = 0,
    epochs: Optional[int] = None,
    synthetic: bool = False,
    tiny: bool = False,
    output_dir: str = "experiments/comparison",
    device: str = "cuda",
) -> Dict[str, Dict[str, float]]:
    """Train each config in turn; a config that fails is recorded with
    ``status`` 0 and its error, and the sweep goes on."""
    from .training.loop import run_training

    results: Dict[str, Dict[str, float]] = {}
    for name in config_names:
        t0 = time.time()
        try:
            metrics = run_training(name, steps=steps, epochs=epochs,
                                   synthetic=synthetic, tiny=tiny,
                                   output_dir=f"{output_dir}/{name}",
                                   device=device)
            metrics["wall_s"] = time.time() - t0
            metrics["status"] = 1.0
        except Exception as e:  # keep the sweep alive (reference does too)
            metrics = {"status": 0.0, "error": str(e)[:200], "wall_s": time.time() - t0}
        results[name] = metrics

    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    (out / "results.json").write_text(json.dumps(results, indent=2, default=str))

    keys = ["total_loss", "eval_miou", "wall_s"]
    lines = ["| config | " + " | ".join(keys) + " |",
             "|---|" + "---|" * len(keys)]
    for name, m in results.items():
        row = " | ".join(f"{m.get(k, float('nan')):.4f}" if isinstance(m.get(k), float)
                         else str(m.get(k, "-")) for k in keys)
        lines.append(f"| {name} | {row} |")
    (out / "comparison.md").write_text("\n".join(lines) + "\n")
    return results


def main():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("configs", nargs="+")
    p.add_argument("--steps", type=int, default=0)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--output_dir", default="experiments/comparison")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args()
    results = run_experiments(args.configs, args.steps, args.epochs, args.synthetic,
                              args.tiny, args.output_dir, args.device)
    print(json.dumps({k: v.get("status") for k, v in results.items()}, indent=2))


if __name__ == "__main__":
    main()
