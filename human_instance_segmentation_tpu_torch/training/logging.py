"""Structured training logs: a text log, JSON-lines metrics and, when it
imports, TensorBoard.

Counterpart of the JAX package's ``training/logging.py``: the same
namespace grouping of metric names, an append-only JSONL file as the
primary sink, TensorBoard scalars through ``torch.utils.tensorboard`` only
if it imports.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Dict

# Metric-name -> namespace grouping
_GROUPS = [
    ("01_primary", {"total_loss", "ce_loss", "dice_loss", "miou", "target_iou"}),
    ("02_hierarchical", {"bg_fg_loss", "target_nontarget_loss", "consistency_loss",
                         "aux_fg_bg_loss", "aux_fg_accuracy", "aux_fg_iou"}),
    ("03_refinement", {"active_contour", "boundary_aware", "contour",
                       "contour_weight", "distance_transform"}),
    ("04_weights", {"bg_weight", "fg_weight", "target_weight", "nontarget_weight",
                    "temperature", "alpha", "task_weight"}),
]


def group_of(name: str) -> str:
    for g, names in _GROUPS:
        if name in names:
            return g
    return "05_other"


class TrainLogger:
    def __init__(self, log_dir: str, name: str = "train"):
        self.dir = Path(log_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        stamp = time.strftime("%Y%m%d_%H%M%S")
        self.text_path = self.dir / f"{name}_{stamp}.log"
        self.jsonl_path = self.dir / f"{name}_{stamp}.jsonl"
        self._tb = None
        try:  # optional TensorBoard
            from torch.utils.tensorboard import SummaryWriter  # type: ignore

            self._tb = SummaryWriter(str(self.dir / "tb"))
        except Exception:
            self._tb = None

    def text(self, msg: str) -> None:
        line = f"[{time.strftime('%Y-%m-%d %H:%M:%S')}] {msg}"
        with open(self.text_path, "a") as f:
            f.write(line + "\n")
        print(line, flush=True)

    def metrics(self, step: int, metrics: Dict[str, Any], prefix: str = "train") -> None:
        clean = {}
        for k, v in metrics.items():
            try:
                clean[k] = float(v)
            except (TypeError, ValueError):
                continue
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps({"step": step, "prefix": prefix, **clean}) + "\n")
        if self._tb is not None:
            for k, v in clean.items():
                self._tb.add_scalar(f"{prefix}/{group_of(k)}/{k}", v, step)

    def config(self, cfg: Dict[str, Any]) -> None:
        (self.dir / "config.json").write_text(json.dumps(cfg, indent=2, default=str))

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()


class NullLogger:
    """A :class:`TrainLogger` that writes nothing: the logger of every rank
    but rank 0 of a data-parallel run."""

    def text(self, msg: str) -> None:
        pass

    def metrics(self, step: int, metrics: Dict[str, Any], prefix: str = "train") -> None:
        pass

    def config(self, cfg: Dict[str, Any]) -> None:
        pass

    def close(self) -> None:
        pass
