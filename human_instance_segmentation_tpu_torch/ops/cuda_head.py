"""Fused conv (k in {1, 3}) + LayerNorm2d + residual + ReLU for stage 2.

Counterpart of the JAX package's ``ops/pallas_head.py::conv_ln_act``. The
CUDA kernel is ``csrc/conv_ln_act.cu`` (an implicit-GEMM conv into a
float32 scratch buffer, then one LayerNorm2d block per ROI; the source
note says why it takes two launches). :func:`conv_ln_act_plain` is the
same function in plain PyTorch: the path for CPU tensors and the oracle
the kernel is held against.

The gate constants are the JAX package's (pallas_head.py:39-58): the
fused unit serves only tiny-spatial, high-channel maps (the EnhancedUNet
bottleneck, 16x12 at 384 channels in the flagship). Do not widen them.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import _build

_MIN_FUSED_CH = 256
_MAX_FUSED_PIXELS = 512

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def fusable_shape(h: int, w: int, ci: int, co: int) -> bool:
    if ci < _MIN_FUSED_CH or co < _MIN_FUSED_CH:
        return False
    return h * w <= _MAX_FUSED_PIXELS


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
) -> torch.Tensor:
    """SAME conv + bias, LayerNorm2d over all of (H, W, C) per sample,
    affine, residual, activation; every step in float32, cast to x's dtype
    at the end (the Pallas kernel's arithmetic).

    x (N, H, W, Ci); w (k, k, Ci, Co); b/gamma/beta (Co,);
    residual (N, H, W, Co). Returns (N, H, W, Co).
    """
    f32 = torch.float32
    xc = x.to(f32).permute(0, 3, 1, 2)
    wc = w.to(f32).permute(3, 2, 0, 1)
    y = F.conv2d(xc, wc, b.to(f32), padding=kernel // 2).permute(0, 2, 3, 1)
    m = y.mean(dim=(1, 2, 3), keepdim=True)
    v = (y - m).square().mean(dim=(1, 2, 3), keepdim=True)
    y = (y - m) * torch.rsqrt(v + eps) * gamma.to(f32) + beta.to(f32)
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
) -> torch.Tensor:
    """Fused SAME conv (k in {1, 3}) + LayerNorm2d + optional residual + act.

    Same contract as the JAX wrapper (bf16/f32 form): x (N, H, W, Ci);
    w (k, k, Ci, Co) in x's dtype; b/gamma/beta (Co,); residual
    (N, H, W, Co) added after the norm, before the activation. Returns
    (N, H, W, Co) in x's dtype.

    A CPU tensor takes :func:`conv_ln_act_plain`. A CUDA tensor launches
    the kernel or raises.
    """
    if xscale is not None:
        raise NotImplementedError("the int8 (xscale) form of conv_ln_act is not ported yet")
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

    if x.device.type == "cpu":
        return conv_ln_act_plain(x, w, b, gamma, beta, residual, kernel=kernel, eps=eps, act=act)
    if x.device.type != "cuda":
        raise RuntimeError(f"conv_ln_act: no kernel for device {x.device}")

    if x.dtype not in _DTYPES:
        raise TypeError(f"conv_ln_act kernel takes float32 or bfloat16, got {x.dtype}")
    operands = [x, w] + ([residual] if residual is not None else [])
    for t in operands:
        if t.device != x.device or t.dtype != x.dtype:
            raise TypeError("x, w and residual must share x's device and dtype")
        if not t.is_contiguous():
            raise ValueError("x, w and residual must be contiguous (NHWC / HWIO)")
    params = [p.to(device=x.device, dtype=torch.float32).contiguous() for p in (b, gamma, beta)]
    out = torch.empty((n, h, wd, co), device=x.device, dtype=x.dtype)
    scratch = torch.empty((n, h * wd, co), device=x.device, dtype=torch.float32)
    lib = _build.library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.conv_ln_act_launch(
        x.data_ptr(), w.data_ptr(), params[0].data_ptr(), params[1].data_ptr(),
        params[2].data_ptr(), residual.data_ptr() if residual is not None else None,
        out.data_ptr(), scratch.data_ptr(), n, h, wd, ci, co, kernel, float(eps),
        int(act == "relu"), _DTYPES[x.dtype], stream)
    conv_ln_act.launches += 1
    _build.check(err, "conv_ln_act")
    return out


conv_ln_act.launches = 0
