"""Fused stage-1 tail: the last decoder block of the people-seg UNet plus
its 3x3 seg head as one kernel. Counterpart of the JAX package's
``ops/pallas_tail.py::tail_with_borders``.

    2x half-pixel bilinear upsample (edge-clamped) -> conv3x3 -> BN -> ReLU
    -> conv3x3 -> BN -> ReLU -> conv3x3 + bias -> dense (B, H, W) logits

The CUDA kernel is ``csrc/tail.cu`` (one launch for the whole map: the
upsample is clamped at the image edge and each conv zero-padded inside the
kernel, so there are no border strips to recompute and no space-to-depth
input). :func:`tail_plain` is the same function in plain PyTorch: the path
for CPU tensors and the oracle the kernel is held against.

Layout: ``x`` is the logical NHWC ``(B, h, w, Ci)`` decoder output with any
strides; the kernel reads through them, so the NCHW tensor of the port's
modules is passed as ``x.permute(0, 2, 3, 1)`` without a copy.

Rounding rule (kernel and plain version alike): the input, the conv
weights and the BN parameters are taken in their dtype (float32 or
bfloat16) and widened to float32; BN (eval, eps 1e-5) is folded to one
float32 scale and shift per channel, applied to the float32 conv sum;
every intermediate stays float32; the logit is rounded once to ``x``'s
dtype. In bfloat16 this is closer to the float32 result than the unfused
chain the model runs with ``pallas_tail=False``, which rounds to bfloat16
after the upsample, each conv and each BN.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from . import _build
from .sampling import upsample_2x_bilinear

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_IC = 8    # csrc/tail.cu: input channels per chunk
_OC = 16   # csrc/tail.cu: output channels per thread
_SMEM_LIMIT = 227 * 1024
BN_EPS = 1e-5

BatchNormParams = Sequence[torch.Tensor]  # (scale, bias, mean, var), each (C,)

__all__ = ["tail", "tail_plain", "fold_bn"]


def fold_bn(bn: BatchNormParams, eps: float = BN_EPS) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scale, bias, mean, var) -> float32 (s, t) with ``bn(y) = y * s + t``."""
    scale, bias, mean, var = (v.to(torch.float32) for v in bn)
    s = scale * torch.rsqrt(var + eps)
    return s, bias - mean * s


def _check(x, k0, bn0, k1, bn1, kh, bh) -> Tuple[int, int]:
    if x.dim() != 4:
        raise ValueError(f"tail: x must be (B, h, w, Ci), got {tuple(x.shape)}")
    ci = x.shape[3]
    if k0.dim() != 4 or tuple(k0.shape[:3]) != (3, 3, ci):
        raise ValueError(f"tail: k0 must be (3, 3, {ci}, C), got {tuple(k0.shape)}")
    c = k0.shape[3]
    if tuple(k1.shape) != (3, 3, c, c):
        raise ValueError(f"tail: k1 must be (3, 3, {c}, {c}), got {tuple(k1.shape)}")
    if tuple(kh.shape) != (3, 3, c, 1) or bh.numel() != 1:
        raise ValueError(f"tail: the head must be (3, 3, {c}, 1) with one bias, got "
                         f"{tuple(kh.shape)}, {tuple(bh.shape)}")
    for name, bn in (("bn0", bn0), ("bn1", bn1)):
        if len(bn) != 4 or any(tuple(v.shape) != (c,) for v in bn):
            raise ValueError(f"tail: {name} must be four ({c},) tensors (scale, bias, mean, var)")
    return ci, c


def _conv(x: torch.Tensor, k_hwio: torch.Tensor) -> torch.Tensor:
    """SAME float32 3x3 conv, NCHW activations, HWIO weights, no TF32."""
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        return F.conv2d(x, k_hwio.to(torch.float32).permute(3, 2, 0, 1), padding=1)


def tail_plain(x: torch.Tensor, k0: torch.Tensor, bn0: BatchNormParams, k1: torch.Tensor,
               bn1: BatchNormParams, kh: torch.Tensor, bh: torch.Tensor) -> torch.Tensor:
    """x (B, h, w, Ci); k0 (3, 3, Ci, C), k1 (3, 3, C, C), kh (3, 3, C, 1)
    HWIO; bn0/bn1 (scale, bias, mean, var); bh (1,) -> (B, 2h, 2w) logits in
    x's dtype, by the module's rounding rule."""
    _check(x, k0, bn0, k1, bn1, kh, bh)
    s0, t0 = fold_bn(bn0)
    s1, t1 = fold_bn(bn1)
    y = upsample_2x_bilinear(x.to(torch.float32).permute(0, 3, 1, 2), axes=(2, 3))
    y = F.relu(_conv(y, k0) * s0[:, None, None] + t0[:, None, None])
    y = F.relu(_conv(y, k1) * s1[:, None, None] + t1[:, None, None])
    y = _conv(y, kh)[:, 0] + bh.to(torch.float32).reshape(())
    return y.to(x.dtype)


def _pad_to(t: torch.Tensor, shape) -> torch.Tensor:
    out = torch.zeros(shape, dtype=torch.float32, device=t.device)
    out[tuple(slice(0, n) for n in t.shape)] = t
    return out


def tail(x: torch.Tensor, k0: torch.Tensor, bn0: BatchNormParams, k1: torch.Tensor,
         bn1: BatchNormParams, kh: torch.Tensor, bh: torch.Tensor) -> torch.Tensor:
    """:func:`tail_plain`'s function. A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel or raises. ``x`` may have any strides."""
    ci, c = _check(x, k0, bn0, k1, bn1, kh, bh)
    if x.device.type == "cpu":
        return tail_plain(x, k0, bn0, k1, bn1, kh, bh)
    if x.device.type != "cuda":
        raise RuntimeError(f"tail: no kernel for device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"tail kernel takes float32 or bfloat16, got {x.dtype}")
    b, h, w, _ = x.shape
    cip = -(-ci // _IC) * _IC
    cp = -(-c // _OC) * _OC
    lib = _build.library()
    need = lib.tail_smem_bytes_for(cp)
    if need > _SMEM_LIMIT:
        raise ValueError(f"tail: C={c} needs {need} bytes of shared memory per block, more than "
                         f"the {_SMEM_LIMIT} a block can have")
    # float32 operands, zero beyond the real channels: padded channels come
    # out as relu(0 * 0 + 0) = 0 and meet zero weights downstream
    w0 = _pad_to(k0.reshape(9, ci, c), (9, cip, cp))
    w1 = _pad_to(k1.reshape(9, c, c), (9, cp, cp))
    wh = _pad_to(kh.reshape(9, c), (9, cp))
    st0 = _pad_to(torch.stack(fold_bn(bn0)), (2, cp))
    st1 = _pad_to(torch.stack(fold_bn(bn1)), (2, cp))
    bias = bh.to(torch.float32).reshape(1).contiguous()
    out = torch.empty((b, 2 * h, 2 * w), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.tail_launch(x.data_ptr(), *x.stride(), w0.data_ptr(), st0.data_ptr(),
                          w1.data_ptr(), st1.data_ptr(), wh.data_ptr(), bias.data_ptr(),
                          out.data_ptr(), b, h, w, ci, cip, cp, _DTYPES[x.dtype], stream)
    tail.launches += 1
    _build.check(err, "tail")
    return out


tail.launches = 0
