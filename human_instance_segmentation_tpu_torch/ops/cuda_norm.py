"""LayerNorm2d with its epilogue in one hand-written kernel pair.

``act(norm(x) [+ residual])``, optionally quantized to int8 for the next
conv, is what every stage-2 unit outside the fused unit
(:mod:`.cuda_head`) runs after its conv. In plain PyTorch that is 12 to 19
kernels, each reading and writing the whole map; the CUDA kernels
(``csrc/layernorm_act.cu``) do it in two launches, one for the statistics
and one that normalises, applies the affine, the residual and the ReLU and
writes x's dtype or int8 codes. They replace no TPU kernel (XLA fuses the
chain in the JAX package).

* :func:`ln_act_plain` is today's chain, op for op: :func:`.norms.
  layer_norm_2d`, the residual add, the activation, :func:`.s2d.
  quantize_static`. It is the kernel's oracle and the path of CPU tensors.
* :func:`ln_act` is the entry point: a CPU tensor takes the plain chain, a
  CUDA tensor launches the kernels or raises. ``ln_act.launches`` counts its
  kernel calls (two launches each).
* :func:`norm_act` is what the modules call with their norm and activation.
  It takes the kernel only where it computes what the modules computed:
  x on CUDA in bf16 or float32, autograd not recording (serving runs under
  ``inference_mode``; training keeps the chain, whose backward it needs), a
  :class:`.norms.LayerNorm2d` in x's dtype, ReLU or the identity, a residual
  of x's shape and dtype, and no ``torch.export`` or ``torch.compile``
  tracing (the kernels are bound through ``ctypes``, opaque to a tracer).
  Everything else runs the modules' own chain.

The kernel's outputs differ from the plain chain's only by the order of the
statistics' sums (float32 in both); every later step rounds where the chain
rounds.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import _build
from .activations import _identity
from .norms import LayerNorm2d, layer_norm_2d
from .s2d import quantize_static

__all__ = ["ln_act", "ln_act_plain", "norm_act", "engages", "plan"]

_SMS = 132              # the H100's streaming multiprocessors
_BLOCKS_AN_SM = 8       # 256-thread blocks an SM holds
_MIN_BLOCK = 4096       # values a block at least
_MAX_SLICES = 1024      # blocks a sample at most (each apply block merges them all)
_MAX_SAMPLES = 65535    # gridDim.y
_VEC = 8                # values a vector
_KERNEL_DEVICE = "cuda"  # the device whose tensors norm_act sends to the kernel
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_RELU = {F.relu: True, _identity: False}  # the activations the kernel applies


def ln_act_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5,
                 residual: Optional[torch.Tensor] = None, relu: bool = True,
                 qscale: Optional[float] = None) -> torch.Tensor:
    """``LayerNorm2d`` (statistics in float32, normalised map cast to x's
    dtype, then the affine) -> ``+ residual`` -> ReLU or identity ->
    ``quantize_static(., qscale)`` when a scale is given: the modules'
    chain, op for op."""
    y = layer_norm_2d(x, weight, bias, eps)
    if residual is not None:
        y = y + residual
    if relu:
        y = F.relu(y)
    return y if qscale is None else quantize_static(y, qscale)


def plan(n: int, per_sample: int, vec: bool) -> Tuple[int, int]:
    """``(P, chunk)``: the blocks a sample and the values a block, so that
    ``n * P`` blocks fill the card about twice over, each block at least
    :data:`_MIN_BLOCK` values (one block for a smaller sample), no block
    empty, and the chunk a multiple of a vector in the vector form."""
    want = -(-2 * _SMS * _BLOCKS_AN_SM // n)
    p = max(1, min(want, per_sample // _MIN_BLOCK, _MAX_SLICES))
    chunk = -(-per_sample // p)
    if vec:
        chunk = -(-chunk // _VEC) * _VEC
    return -(-per_sample // chunk), chunk


def _aligned(*ts) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


def ln_act(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5,
           residual: Optional[torch.Tensor] = None, relu: bool = True,
           qscale: Optional[float] = None, *,
           stats: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`ln_act_plain`'s function on (N, C, H, W) x. A CPU tensor takes
    the plain chain; a CUDA tensor launches the two kernels or raises. x is
    read in NCHW or channels-last memory (any other layout is made NCHW
    first) and the output keeps x's layout; channels-last x with C % 8 == 0
    is read 8 channels a vector, anything else value by value. The residual
    is read through its own strides. ``stats``, a (N, 2) float32 CUDA
    tensor, receives each sample's mean and biased variance."""
    if x.device.type == "cpu":
        return ln_act_plain(x, weight, bias, eps, residual, relu, qscale)
    if x.device.type != "cuda":
        raise RuntimeError(f"ln_act: no kernel for device {x.device}")
    if x.dim() != 4 or x.dtype not in _DTYPES:
        raise TypeError(f"ln_act: expected (N, C, H, W) float32 or bfloat16, got "
                        f"{tuple(x.shape)} {x.dtype}")
    n, c, h, w = x.shape
    if weight.shape != (c,) or bias.shape != (c,) or weight.dtype != x.dtype \
            or bias.dtype != x.dtype:
        raise ValueError(f"ln_act: weight and bias must be ({c},) {x.dtype}")
    if residual is not None and (residual.shape != x.shape or residual.dtype != x.dtype):
        raise ValueError("ln_act: the residual must have x's shape and dtype")
    if n > _MAX_SAMPLES:
        raise ValueError(f"ln_act: at most {_MAX_SAMPLES} samples a launch")
    if x.is_contiguous():
        channels_last = False
    elif x.is_contiguous(memory_format=torch.channels_last):
        channels_last = True
    else:
        x, channels_last = x.contiguous(), False
    weight, bias = weight.contiguous(), bias.contiguous()
    out = torch.empty_like(x, dtype=torch.int8 if qscale is not None else x.dtype)
    if x.numel() == 0:
        return out
    per_sample = c * h * w
    res_same = residual is not None and residual.stride() == x.stride()
    vec = (channels_last and c % _VEC == 0 and _aligned(x, out, weight, bias)
           and (not res_same or _aligned(residual)))
    if stats is not None and (stats.shape != (n, 2) or stats.dtype != torch.float32
                              or stats.device != x.device or not stats.is_contiguous()):
        raise ValueError(f"ln_act: stats must be a contiguous ({n}, 2) float32 tensor on "
                         f"{x.device}")
    p, chunk = plan(n, per_sample, vec)
    partial = torch.empty((n, p, 4), dtype=torch.float32, device=x.device)
    inv = float(np.float32(1.0 / qscale)) if qscale is not None else 1.0
    rs = residual.stride() if residual is not None else (0, 0, 0, 0)
    err = _build.library().ln_act_launch(
        x.data_ptr(), residual.data_ptr() if residual is not None else None, *rs, int(res_same),
        weight.data_ptr(), bias.data_ptr(), out.data_ptr(), partial.data_ptr(),
        stats.data_ptr() if stats is not None else None, n, c, h, w, int(channels_last), p,
        chunk, 0 if vec else 1, _DTYPES[x.dtype], int(qscale is not None), eps, int(relu), inv,
        _build.current_stream(x.device))
    ln_act.launches += 1
    ln_act.last_vec = vec
    _build.check(err, "ln_act")
    return out


ln_act.launches = 0
ln_act.last_vec = None  # the latest call's form: True 8-channel vectors, False scalar


def engages(x: torch.Tensor, norm: torch.nn.Module, act: Callable,
            residual: Optional[torch.Tensor] = None) -> bool:
    """Whether :func:`norm_act` takes the kernel for these operands."""
    if x.device.type != _KERNEL_DEVICE or x.dim() != 4 or x.dtype not in _DTYPES:
        return False
    if not isinstance(norm, LayerNorm2d) or act not in _RELU:
        return False
    if norm.weight.dtype != x.dtype or norm.bias.dtype != x.dtype:
        return False
    if residual is not None and (residual.shape != x.shape or residual.dtype != x.dtype):
        return False
    if torch.is_grad_enabled():
        tensors = (x, norm.weight, norm.bias) + ((residual,) if residual is not None else ())
        if any(t.requires_grad for t in tensors):
            return False
    return not torch.compiler.is_compiling()


def norm_act(x: torch.Tensor, norm: torch.nn.Module, act: Callable,
             residual: Optional[torch.Tensor] = None,
             qscale: Optional[float] = None) -> torch.Tensor:
    """``act(norm(x) [+ residual])``, quantized to int8 at ``qscale`` when
    one is given: through :func:`ln_act` where :func:`engages` allows, else
    through the modules themselves."""
    if engages(x, norm, act, residual):
        return ln_act(x, norm.weight, norm.bias, norm.eps, residual, _RELU[act], qscale)
    y = norm(x)
    if residual is not None:
        y = y + residual
    y = act(y)
    return y if qscale is None else quantize_static(y, qscale)
