"""The card's published peaks and the least time a piece of work can take.

NVIDIA H100 SXM data sheet, dense rates without sparsity, at the full power
limit of 700 W: 989 TFLOP/s in bf16, 1,979 TOP/s in int8, 67 TFLOP/s in
float32 outside the tensor cores, 3.35 TB/s of HBM. A card set below 700 W
runs slower under load; :func:`card_line` gives its name and power limit,
printed beside every measurement.
"""

from __future__ import annotations

import subprocess

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}


def bound(nbytes: float, ops: dict) -> dict:
    """The least time the card could take: bytes moved once over the HBM
    rate against operations of each type over that type's peak, whichever
    is larger. ``ops`` is ``{kind: operations}``."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = sum(n / PEAK_OPS[kind] for kind, n in ops.items())
    return {"bound_s": max(t_bytes, t_ops), "compute_s": t_ops, "bytes_s": t_bytes,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the first card."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]
