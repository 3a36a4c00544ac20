"""Fused serving MBConv: EfficientNet's mobile inverted bottleneck with
squeeze-excitation, its BatchNorms folded into the convs, without the
expanded tensor ever going through device memory. Counterpart of the JAX
package's ``ops/pallas_mbconv.py::fused_mbconv_chw``.

    a  = silu(we^T x + be)                      1x1 expand (``we is None``: a = x)
    d  = silu(depthwise_kxk(a) + bdw)           zero padding, k in {3, 5}
    se = sigmoid(silu(mean(d) wr + br) ws + bs) per image and channel
    y  = wp^T (d * se) + bp (+ x)               1x1 project, optional residual

At stride 2 the block keeps positions ``[1::2, 1::2]`` of the stride-1 map
``d``, which for even H and W is the TF-SAME stride-2 depthwise conv (k3
pads (0, 1), k5 pads (1, 2)); odd extents are refused.

The CUDA kernel is ``csrc/mbconv.cu``, two launches: :func:`mbconv_sums`
(per image and channel sums of ``d``) and :func:`mbconv_apply` (recompute
``d``, scale, project); the small squeeze-excite products between them are
plain float32 tensor ops, as the JAX package leaves them to XLA. In
bfloat16 the kernel runs both 1x1 products on the tensor cores and its SiLU
as ``x / (1 + exp(-x))`` with the fast exponential and division, which stays
within the bf16 tolerance; float32 keeps full-precision ``expf`` and the
true division on the float32 units.
``*_plain`` are the same functions in plain PyTorch: the path for CPU
tensors and the oracle the kernels are held against.

Layout: ``x`` is the logical ``(B, Ci, H, W)`` of the port's modules with
any strides; the kernels read it through them and write ``y`` in x's memory
format (channels-last when x's channel stride is 1, which is what the served
encoder hands over: its NHWC input is only viewed as NCHW, and cuDNN keeps
that format), so nothing is copied or transposed around the call (the JAX
model transposes around its kernel).

Rounding rule (kernels and plain versions alike), with T the dtype of ``x``
(float32 or bfloat16) in which the caller also hands over the folded weights
and biases: operands are widened to float32 and every sum is float32; ``a``
is rounded to T after its SiLU; ``d`` stays float32 for the mean; ``se`` is
rounded to T; ``d * se`` is rounded to T before the project; ``y`` is rounded
to T before the residual is added in T. This is the JAX kernel's rule with
one deviation: the JAX kernel also rounds each depthwise tap product to T
before it sums them in float32; here the product stays float32 (one fused
multiply-add per tap), which in bfloat16 is the more exact of the two and in
float32 the same.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_LIMIT = 227 * 1024
BN_EPS = 1e-3

__all__ = ["fused_mbconv", "fused_mbconv_plain", "mbconv_sums", "mbconv_sums_plain",
           "mbconv_apply", "mbconv_apply_plain", "squeeze_excite", "fold_bn"]


def fold_bn(scale: torch.Tensor, bias: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
            eps: float = BN_EPS) -> Tuple[torch.Tensor, torch.Tensor]:
    """BN on running statistics as float32 ``(gain, shift)``: ``y = x * gain +
    shift`` (pallas_mbconv.py:223)."""
    g = scale.to(torch.float32) * torch.rsqrt(var.to(torch.float32) + eps)
    return g, bias.to(torch.float32) - mean.to(torch.float32) * g


def _check(x, we, be, wdw, bdw, kernel: int, stride: int, wp=None, bp=None,
           residual: bool = False) -> Tuple[int, int, int]:
    """Shapes of one pass's operands -> (Ci, Cm, Co); Co is 0 for the sums
    pass, which has no project conv."""
    if x.dim() != 4:
        raise ValueError(f"fused_mbconv: x must be (B, Ci, H, W), got {tuple(x.shape)}")
    _, ci, h, w = x.shape
    if kernel not in (3, 5) or stride not in (1, 2):
        raise ValueError(f"fused_mbconv: kernel in (3, 5) and stride in (1, 2), got "
                         f"{kernel}, {stride}")
    if h % stride or w % stride:
        raise ValueError(f"fused_mbconv: stride {stride} needs even H and W, got {h}x{w} (the "
                         "kept positions [1::2] equal the SAME stride-2 conv only then)")
    if wdw.dim() != 3 or tuple(wdw.shape[:2]) != (kernel, kernel):
        raise ValueError(f"fused_mbconv: wdw must be ({kernel}, {kernel}, Cm), got "
                         f"{tuple(wdw.shape)}")
    cm = wdw.shape[2]
    if we is None:
        if cm != ci or be is not None:
            raise ValueError("fused_mbconv: without an expand conv Cm must equal Ci and be None")
    elif tuple(we.shape) != (ci, cm) or be is None or tuple(be.shape) != (cm,):
        raise ValueError(f"fused_mbconv: we must be ({ci}, {cm}) with be ({cm},), got "
                         f"{tuple(we.shape)}")
    if tuple(bdw.shape) != (cm,):
        raise ValueError(f"fused_mbconv: bdw must be ({cm},), got {tuple(bdw.shape)}")
    if wp is None:
        return ci, cm, 0
    if wp.dim() != 2 or wp.shape[0] != cm or tuple(bp.shape) != (wp.shape[1],):
        raise ValueError("fused_mbconv: wp (Cm, Co), bp (Co,) expected")
    co = wp.shape[1]
    if residual and (stride != 1 or co != ci):
        raise ValueError("fused_mbconv: the residual needs stride 1 and Co == Ci")
    return ci, cm, co


def _conv(x, w, **kwargs):
    """float32 conv without TF32 (cuDNN would use it by default)."""
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        return F.conv2d(x, w, **kwargs)


def _expand_dw_plain(x, we, be, wdw, bdw, kernel: int, stride: int) -> torch.Tensor:
    """float32 ``d`` on the kept grid, (B, Cm, H / stride, W / stride)."""
    f32 = torch.float32
    a = x.to(f32)
    if we is not None:
        a = _conv(a, we.to(f32).t()[:, :, None, None]) + be.to(f32)[:, None, None]
        a = F.silu(a).to(x.dtype).to(f32)
    r = kernel // 2
    lo = r - (stride - 1)  # stride 2 keeps the positions 2o + 1 of the stride-1 map
    a = F.pad(a, (lo, r, lo, r))
    cm = wdw.shape[2]
    d = _conv(a, wdw.to(f32).permute(2, 0, 1)[:, None], stride=stride, groups=cm)
    return F.silu(d + bdw.to(f32)[:, None, None])


def mbconv_sums_plain(x, we, be, wdw, bdw, kernel: int = 3, stride: int = 1) -> torch.Tensor:
    """:func:`mbconv_sums` in plain PyTorch (any device)."""
    return _expand_dw_plain(x, we, be, wdw, bdw, kernel, stride).sum(dim=(2, 3))


def squeeze_excite(sums: torch.Tensor, count: int, wr, br, ws, bs,
                   dtype: torch.dtype) -> torch.Tensor:
    """(B, Cm) float32 sums over ``count`` positions -> the squeeze-excite
    scale (B, Cm) in ``dtype``, computed in float32 (pallas_mbconv.py:196)."""
    f32 = torch.float32
    m = sums / count
    u = F.silu(m @ wr.to(f32) + br.to(f32))
    return torch.sigmoid(u @ ws.to(f32) + bs.to(f32)).to(dtype)


def mbconv_apply_plain(x, se, we, be, wdw, bdw, wp, bp, kernel: int = 3, stride: int = 1,
                       residual: bool = False) -> torch.Tensor:
    """:func:`mbconv_apply` in plain PyTorch (any device)."""
    f32 = torch.float32
    d = _expand_dw_plain(x, we, be, wdw, bdw, kernel, stride)
    ds = (d * se.to(f32)[:, :, None, None]).to(x.dtype).to(f32)
    y = _conv(ds, wp.to(f32).t()[:, :, None, None]) + bp.to(f32)[:, None, None]
    y = y.to(x.dtype)
    return y + x if residual else y


def fused_mbconv_plain(x, we, be, wdw, bdw, wr, br, ws, bs, wp, bp, kernel: int = 3,
                       stride: int = 1, residual: bool = False) -> torch.Tensor:
    """:func:`fused_mbconv` in plain PyTorch (any device), by the module's
    rounding rule."""
    _check(x, we, be, wdw, bdw, kernel, stride, wp, bp, residual)
    sums = mbconv_sums_plain(x, we, be, wdw, bdw, kernel, stride)
    count = (x.shape[2] // stride) * (x.shape[3] // stride)
    se = squeeze_excite(sums, count, wr, br, ws, bs, x.dtype)
    return mbconv_apply_plain(x, se, we, be, wdw, bdw, wp, bp, kernel, stride, residual)


def _launch(x, we, be, wdw, bdw, se, wp, bp, out, partial, dims, kernel, stride, residual,
            apply: bool, name: str) -> None:
    ci, cm, co = dims
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name} kernel takes float32 or bfloat16, got {x.dtype}")
    for t in (we, be, wdw, bdw, se, wp, bp):
        if t is not None and (t.dtype != x.dtype or t.device != x.device
                              or not t.is_contiguous()):
            raise ValueError(f"{name}: every operand must be contiguous, on x's device and in "
                             f"x's dtype ({x.dtype})")
    lib = _build.library()
    need = lib.mbconv_smem_bytes_for(ci, co, kernel, stride, x.element_size(),
                                     int(we is not None), int(apply))
    if need > _SMEM_LIMIT:
        raise ValueError(f"{name}: Ci={ci}, Co={co}, k={kernel}, stride={stride} needs {need} "
                         f"bytes of shared memory per block, more than the {_SMEM_LIMIT} a "
                         "block can have")

    def ptr(t):
        return t.data_ptr() if t is not None else None

    b, _, h, w = x.shape
    ostrides = out.stride() if out is not None else (0, 0, 0, 0)
    err = lib.mbconv_launch(ptr(x), *x.stride(), ptr(we), ptr(be), ptr(wdw), ptr(bdw), ptr(se),
                            ptr(wp), ptr(bp), ptr(out), *ostrides, ptr(partial), b, ci, cm, co, h,
                            w, kernel, stride, int(residual), int(apply), _DTYPES[x.dtype],
                            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, name)


def mbconv_sums(x, we, be, wdw, bdw, kernel: int = 3, stride: int = 1) -> torch.Tensor:
    """Pass 1: float32 (B, Cm) sums of ``d`` over the kept grid. A CPU tensor
    (or any inside :func:`._build.plain`) takes the plain version; a CUDA
    tensor launches the kernel (per-tile sums, added here in a fixed order)
    or raises."""
    ci, cm, _ = _check(x, we, be, wdw, bdw, kernel, stride)
    if not _build.takes_kernel(x, "mbconv_sums"):
        return mbconv_sums_plain(x, we, be, wdw, bdw, kernel, stride)
    b, _, h, w = x.shape
    tiles = _build.library().mbconv_tiles_for(h // stride, w // stride, stride, x.element_size())
    partial = torch.empty((b, tiles, cm), dtype=torch.float32, device=x.device)
    _launch(x, we, be, wdw.reshape(kernel * kernel, cm), bdw, None, None, None, None, partial,
            (ci, cm, 0), kernel, stride, False, False, "mbconv_sums")
    mbconv_sums.launches += 1
    return partial.sum(dim=1)


mbconv_sums.launches = 0


def mbconv_apply(x, se, we, be, wdw, bdw, wp, bp, kernel: int = 3, stride: int = 1,
                 residual: bool = False) -> torch.Tensor:
    """Pass 2: ``se`` (B, Cm) in x's dtype -> y (B, Co, H / stride, W / stride).
    A CPU tensor (or any inside :func:`._build.plain`) takes the plain
    version; a CUDA tensor launches the kernel or raises."""
    ci, cm, co = _check(x, we, be, wdw, bdw, kernel, stride, wp, bp, residual)
    b, _, h, w = x.shape
    if tuple(se.shape) != (b, cm):
        raise ValueError(f"mbconv_apply: se must be ({b}, {cm}), got {tuple(se.shape)}")
    if not _build.takes_kernel(x, "mbconv_apply"):
        return mbconv_apply_plain(x, se, we, be, wdw, bdw, wp, bp, kernel, stride, residual)
    fmt = torch.channels_last if x.stride(1) == 1 and ci > 1 else torch.contiguous_format
    out = torch.empty((b, co, h // stride, w // stride), dtype=x.dtype, device=x.device,
                      memory_format=fmt)
    _launch(x, we, be, wdw.reshape(kernel * kernel, cm), bdw, se.contiguous(), wp, bp, out, None,
            (ci, cm, co), kernel, stride, residual, True, "mbconv_apply")
    mbconv_apply.launches += 1
    return out


mbconv_apply.launches = 0


def fused_mbconv(x: torch.Tensor, we: Optional[torch.Tensor], be: Optional[torch.Tensor],
                 wdw: torch.Tensor, bdw: torch.Tensor, wr: torch.Tensor, br: torch.Tensor,
                 ws: torch.Tensor, bs: torch.Tensor, wp: torch.Tensor, bp: torch.Tensor,
                 kernel: int = 3, stride: int = 1, residual: bool = False) -> torch.Tensor:
    """x (B, Ci, H, W); we (Ci, Cm) or None (expand ratio 1, Cm == Ci); wdw
    (k, k, Cm); wr (Cm, Cse); ws (Cse, Cm); wp (Cm, Co); biases 1-D; the BNs
    folded into we/be, wdw/bdw and wp/bp by the caller. Returns (B, Co,
    H / stride, W / stride) in x's dtype. A CPU tensor takes the plain
    versions; a CUDA tensor launches the two kernels or raises."""
    sums = mbconv_sums(x, we, be, wdw, bdw, kernel, stride)
    count = (x.shape[2] // stride) * (x.shape[3] // stride)
    se = squeeze_excite(sums, count, wr, br, ws, bs, x.dtype)
    return mbconv_apply(x, se, we, be, wdw, bdw, wp, bp, kernel, stride, residual)
