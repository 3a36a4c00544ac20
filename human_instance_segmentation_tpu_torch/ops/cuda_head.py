"""Fused conv (k in {1, 3}) + LayerNorm2d + residual + ReLU for stage 2.

Counterpart of the JAX package's ``ops/pallas_head.py::conv_ln_act``. The
CUDA kernel is ``csrc/conv_ln_act.cu`` (an implicit-GEMM conv into a
float32 scratch buffer, then a cluster of LayerNorm2d blocks per ROI; the
source note says why it takes two launches). :func:`conv_ln_act_plain` is
the same function in plain PyTorch: the path for CPU tensors and the oracle
the kernel is held against.

In bf16 the conv runs on wgmma when Ci and Co divide by 8 and x's rows are
16-byte aligned (the served shapes), on weights packed K-major once
(:func:`prepare_bf16`; the blocks make them once per weight and hand them in
as ``prepared`` with the float32 bias and norm parameters); other bf16 shapes
take a scalar-staged WMMA kernel on the HWIO weights, float32 an FMA kernel.

With ``xscale`` (a calibrated activation scale) the unit runs its int8
form (pallas_head.py:178-187): weights quantized per output channel and
packed K-major (:func:`prepare_s8`; the blocks make them once per weight and
scale and hand them in as ``prepared``), activations quantized once by the
kernel as ``round(x * float32(1 / xscale))``, s8 x s8 -> s32 with wgmma
(``csrc/s8_igemm.cuh``), ``float(acc) * (xscale * sw) + b`` into the float32
scratch, then the same LayerNorm epilogue.

The gate constants are the JAX package's (pallas_head.py:39-58): the
fused unit serves only tiny-spatial, high-channel maps (the EnhancedUNet
bottleneck, 16x12 at 384 channels in the flagship). Do not widen them.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Union

import torch
import torch.nn.functional as F

from . import _build
from .quant import (nchw_strides, pack_weight_kmajor, quantize_weight, s8_conv_plain,
                    staging_buffer)

_MIN_FUSED_CH = 256
_MAX_FUSED_PIXELS = 512

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def fusable_shape(h: int, w: int, ci: int, co: int) -> bool:
    if ci < _MIN_FUSED_CH or co < _MIN_FUSED_CH:
        return False
    return h * w <= _MAX_FUSED_PIXELS


class FusedS8Operands(NamedTuple):
    """What the int8 form needs besides x and the residual; depends only on
    the parameters and the calibrated scale."""

    wq: torch.Tensor      # int8 HWIO codes (the plain version's operand)
    packed: torch.Tensor  # pack_weight_kmajor(wq) (the kernel's operand)
    qscale: torch.Tensor  # (Co,) float32 xscale * sw
    inv: torch.Tensor     # (1,) float32(1 / xscale)
    b: torch.Tensor       # float32 conv bias, LayerNorm weight and bias
    gamma: torch.Tensor
    beta: torch.Tensor


def prepare_s8(w: torch.Tensor, xscale: float, b: torch.Tensor, gamma: torch.Tensor,
               beta: torch.Tensor) -> FusedS8Operands:
    """The int8 form's operands as the JAX wrapper makes them
    (pallas_head.py:179-184): w (k, k, Ci, Co) in the activations' dtype
    (any strides), quantized per output channel; ``qscale = xscale * sw``."""
    wq, sw = quantize_weight(w)
    wq = wq.contiguous()
    qscale = (torch.full((1,), xscale, dtype=torch.float32, device=w.device) * sw).contiguous()
    inv = torch.full((1,), 1.0 / xscale, dtype=torch.float32, device=w.device)
    b, gamma, beta = (t.detach().to(device=w.device, dtype=torch.float32).contiguous()
                      for t in (b, gamma, beta))
    return FusedS8Operands(wq, pack_weight_kmajor(wq), qscale, inv, b, gamma, beta)


class FusedBF16Operands(NamedTuple):
    """What the bf16 form needs besides x and the residual; depends only on
    the parameters."""

    packed: torch.Tensor  # (Co, Kp) bf16: pack_weight_bf16(w) (the wgmma kernel's operand)
    b: torch.Tensor       # float32 conv bias, LayerNorm weight and bias
    gamma: torch.Tensor
    beta: torch.Tensor


def wgmma_shape(ci: int, co: int) -> bool:
    """Whether the bf16 conv takes the wgmma kernel (with aligned rows)."""
    return ci % 8 == 0 and co % 8 == 0


def pack_weight_bf16(w: torch.Tensor) -> torch.Tensor:
    """(k, k, Ci, Co) weights (any strides) -> (Co, Kp) bf16, the wgmma
    kernel's K-major B operand: row co holds, tap after tap, that tap's Ci
    weights (K = tap * Ci + c), zero-padded to a multiple of 64 values (128
    bytes)."""
    k, k2, ci, co = w.shape
    rows = w.detach().to(torch.bfloat16).permute(3, 0, 1, 2).reshape(co, k * k2 * ci)
    return F.pad(rows, (0, -(-rows.shape[1] // 64) * 64 - rows.shape[1])).contiguous()


def prepare_bf16(w: torch.Tensor, b: torch.Tensor, gamma: torch.Tensor,
                 beta: torch.Tensor) -> FusedBF16Operands:
    """The bf16 form's operands, made once: w (k, k, Ci, Co), any strides and
    dtype (rounded to bf16), packed K-major; b, gamma, beta as float32."""
    b, gamma, beta = (t.detach().to(device=w.device, dtype=torch.float32).contiguous()
                      for t in (b, gamma, beta))
    return FusedBF16Operands(pack_weight_bf16(w), b, gamma, beta)


def conv_ln_act_plain(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    residual: Optional[torch.Tensor] = None,
    *,
    kernel: int = 3,
    eps: float = 1e-5,
    act: str = "relu",
    xscale: Optional[float] = None,
    prepared: Optional[FusedS8Operands] = None,
) -> torch.Tensor:
    """SAME conv + bias, LayerNorm2d over all of (H, W, C) per sample,
    affine, residual, activation; every step in float32, cast to x's dtype
    at the end (the Pallas kernel's arithmetic). With ``xscale`` the conv is
    the int8 form: ``round(x * (1 / xscale))`` clipped to +-127, per-channel
    int8 weights, an exact integer conv, ``float(acc) * qscale + b``;
    ``prepared`` (:func:`prepare_s8` of the same w, xscale, b, gamma, beta,
    made earlier) stands for those five, which are then not read.

    The LayerNorm statistics are the kernel's: float64 sums rounded to
    float32 once (order-independent), ``rstd = 1 / sqrt(var + eps)`` in
    float64, divisions by a device tensor. So the int8 form of the kernel
    equals this bit for bit.

    x (N, H, W, Ci); w (k, k, Ci, Co); b/gamma/beta (Co,);
    residual (N, H, W, Co). Returns (N, H, W, Co), contiguous like the
    kernel's output.
    """
    f32, f64 = torch.float32, torch.float64
    if xscale is not None:
        ops = prepared if prepared is not None else prepare_s8(w, xscale, b, gamma, beta)
        xq = torch.round(x.to(f32) * ops.inv).clamp(-127.0, 127.0).to(torch.int8)
        acc = s8_conv_plain(xq, ops.wq, padding=kernel // 2)
        y = acc.to(f32) * ops.qscale + ops.b
        gamma, beta = ops.gamma, ops.beta
    else:
        xc = x.to(f32).permute(0, 3, 1, 2)
        wc = w.to(f32).permute(3, 2, 0, 1)
        y = F.conv2d(xc, wc, b.to(f32), padding=kernel // 2).permute(0, 2, 3, 1).contiguous()
    size = torch.full((1,), y[0].numel(), dtype=f64, device=y.device)
    m = (y.to(f64).sum(dim=(1, 2, 3), keepdim=True) / size).to(f32)
    d = y - m
    v = d.to(f64).square().sum(dim=(1, 2, 3), keepdim=True) / size
    rstd = torch.sqrt(v + eps).reciprocal().to(f32)
    y = d * rstd * gamma.to(f32) + beta.to(f32)
    if residual is not None:
        y = y + residual.to(f32)
    if act == "relu":
        y = torch.relu(y)
    return y.to(x.dtype)


def conv_ln_act(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    residual: Optional[torch.Tensor] = None,
    *,
    height: int,
    width: int,
    kernel: int = 3,
    eps: float = 1e-5,
    act: str = "relu",
    xscale: Optional[float] = None,
    prepared: Optional[Union[FusedS8Operands, FusedBF16Operands]] = None,
) -> torch.Tensor:
    """Fused SAME conv (k in {1, 3}) + LayerNorm2d + optional residual + act.

    Same contract as the JAX wrapper: x (N, H, W, Ci); w (k, k, Ci, Co) in
    x's dtype; b/gamma/beta (Co,); residual (N, H, W, Co) added after the
    norm, before the activation; ``xscale`` switches to the int8 form.
    Returns (N, H, W, Co) in x's dtype. ``prepared``, made once by the caller
    from the same parameters, spares preparing them at every call: with
    ``xscale``, :func:`prepare_s8`'s result; in bf16, :func:`prepare_bf16`'s.
    Where the kernel reads it (the int8 form, and bf16 at a wgmma shape), w
    is then only checked for its shape and may be any view.

    A CPU tensor takes :func:`conv_ln_act_plain`. A CUDA tensor launches
    the kernel (:func:`conv_ln_act_s8` for the int8 form) or raises.
    """
    if xscale is not None and not (math.isfinite(xscale) and xscale > 0):
        raise ValueError(f"xscale must be a positive finite scale, got {xscale}")
    if kernel not in (1, 3):
        raise ValueError(f"kernel must be 1 or 3, got {kernel}")
    if act not in ("relu", "identity"):
        raise ValueError(f"unsupported activation {act!r}")
    if x.dim() != 4 or tuple(x.shape[1:3]) != (height, width):
        raise ValueError(f"x must be (N, {height}, {width}, Ci), got {tuple(x.shape)}")
    n, h, wd, ci = x.shape
    co = w.shape[-1]
    if tuple(w.shape) != (kernel, kernel, ci, co):
        raise ValueError(f"w must be ({kernel}, {kernel}, {ci}, Co), got {tuple(w.shape)}")
    for name, t in (("b", b), ("gamma", gamma), ("beta", beta)):
        if tuple(t.shape) != (co,):
            raise ValueError(f"{name} must be ({co},), got {tuple(t.shape)}")
    if residual is not None and tuple(residual.shape) != (n, h, wd, co):
        raise ValueError(f"residual must be {(n, h, wd, co)}, got {tuple(residual.shape)}")
    s8 = xscale is not None
    if prepared is not None and not isinstance(prepared, FusedS8Operands if s8
                                               else FusedBF16Operands):
        raise TypeError("prepared must be prepare_s8's result with xscale, prepare_bf16's "
                        "without")

    if x.device.type == "cpu":
        return conv_ln_act_plain(x, w, b, gamma, beta, residual, kernel=kernel, eps=eps, act=act,
                                 xscale=xscale, prepared=prepared if s8 else None)
    if x.device.type != "cuda":
        raise RuntimeError(f"conv_ln_act: no kernel for device {x.device}")

    if x.dtype not in _DTYPES:
        raise TypeError(f"conv_ln_act kernel takes float32 or bfloat16, got {x.dtype}")
    dev = x.device
    wgmma = (not s8 and x.dtype == torch.bfloat16 and wgmma_shape(ci, co)
             and x.is_contiguous() and x.data_ptr() % 16 == 0)
    reads_w = not (s8 and prepared is not None) and not (wgmma and prepared is not None)
    operands = [x] + ([w] if reads_w else []) + ([residual] if residual is not None else [])
    for t in operands:
        if t.device != dev or t.dtype != x.dtype:
            raise TypeError("x, w and residual must share x's device and dtype")
        if not t.is_contiguous() and not (wgmma and t is w):
            raise ValueError("x, w and residual must be contiguous (NHWC / HWIO)")
    out = torch.empty((n, h, wd, co), device=dev, dtype=x.dtype)
    scratch = torch.empty((n, h * wd, co), device=dev, dtype=torch.float32)
    if s8:
        ops = prepared if prepared is not None else prepare_s8(w, xscale, b, gamma, beta)
        conv_ln_act_s8(x, ops, residual, out, scratch, kernel=kernel, eps=eps, act=act)
        return out
    lib = _build.library()
    if wgmma:
        ops = prepared if prepared is not None else prepare_bf16(w, b, gamma, beta)
        kp = -(-kernel * kernel * ci // 64) * 64
        if tuple(ops.packed.shape) != (co, kp) or ops.packed.dtype != torch.bfloat16 or any(
                t.device != dev or not t.is_contiguous() for t in ops):
            raise ValueError(f"conv_ln_act: prepared operands must be contiguous on x's device, "
                             f"the packed weights ({co}, {kp}) bf16")
        wptr, wpp, params = None, ops.packed.data_ptr(), (ops.b, ops.gamma, ops.beta)
        kp_bytes = 2 * kp
    else:
        params = ((prepared.b, prepared.gamma, prepared.beta) if prepared is not None else
                  tuple(p.to(device=dev, dtype=torch.float32).contiguous()
                        for p in (b, gamma, beta)))
        wptr, wpp, kp_bytes = w.data_ptr(), None, 0
    err = lib.conv_ln_act_launch(
        x.data_ptr(), wptr, wpp, kp_bytes, *(p.data_ptr() for p in params),
        residual.data_ptr() if residual is not None else None, out.data_ptr(), scratch.data_ptr(),
        n, h, wd, ci, co, kernel, float(eps), int(act == "relu"), _DTYPES[x.dtype],
        _build.current_stream(dev))
    conv_ln_act.launches += 1
    _build.check(err, "conv_ln_act")
    return out


conv_ln_act.launches = 0


def conv_ln_act_s8(x, ops: FusedS8Operands, residual, out, scratch, *, kernel, eps, act):
    """Launch the int8 form (``conv_ln_act_s8_launch``) on checked CUDA
    operands: x (N, H, W, Ci) float, the prepared int8 operands; writes
    ``out``."""
    n, h, wd, ci = x.shape
    co = ops.packed.shape[0]
    for t in ops:
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("conv_ln_act_s8: prepared operands must be contiguous on x's device")
    ws = staging_buffer(x)
    err = _build.library().conv_ln_act_s8_launch(
        x.data_ptr(), *nchw_strides(x.permute(0, 3, 1, 2)), ops.packed.data_ptr(),
        ops.inv.data_ptr(), ops.qscale.data_ptr(), ops.b.data_ptr(), ops.gamma.data_ptr(),
        ops.beta.data_ptr(), residual.data_ptr() if residual is not None else None,
        out.data_ptr(), scratch.data_ptr(), ws.data_ptr(), n, h, wd, ci, co, kernel, float(eps),
        int(act == "relu"), _DTYPES[x.dtype], _build.current_stream(x.device))
    conv_ln_act_s8.launches += 1
    _build.check(err, "conv_ln_act_s8")


conv_ln_act_s8.launches = 0
