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

Rounding rule (kernel and plain version alike). BN (eval, eps 1e-5) is one
float32 scale and shift per channel (:func:`fold_bn`), applied to the
float32 conv sum as a multiply, then an add, then the ReLU; the head's bias
is a float32 add. The 2x upsample is computed in float32 from the widened
input, rows first, each weight a separate multiply and add.

- float32 ``x``: the conv weights are widened to float32 whatever their
  dtype; every intermediate stays float32; the logit is rounded once to
  ``x``'s dtype.
- bfloat16 ``x``: each conv multiplies bfloat16 operands with float32 sums
  (the weights are rounded to bfloat16 if they come in float32), and three
  activations are rounded to bfloat16: the upsampled input of conv0,
  conv0's output after BN and ReLU, and conv1's output after BN and ReLU.
  The logit is rounded once. This is the rule of the JAX kernel
  (``pallas_tail.py``: bf16 operands, float32 accumulators, each stage's
  output rounded), with BN kept as a float32 epilogue instead of being
  folded into the weights before they are rounded, and the upsample
  computed and rounded instead of being composed into conv0's weights.

Int8 form (:func:`tail_q`, counterpart of ``ops/pallas_tail_q.py::
tail_with_borders_q``; kernel ``csrc/tail_q.cu``, plain version
:func:`tail_q_plain`): the same chain with three s8 x s8 -> s32 convs and
calibrated static activation scales ``s_x``, ``s_mid``, ``s_head``:

1. ``xq = clip(round(x * float32(1 / s_x)), -127, 127)`` unless x is int8;
2. conv0 is the composition of the upsample with ``k0 * bn0's scale``: four
   3x3 kernels on x's own grid, one per output parity, zero padding on that
   grid, quantized with one scale per (parity, output channel)
   (:func:`build_tail_weights_q`; composed in float64 and rounded once); the
   s32 sum times ``s_x * sw0``, plus BN0's shift, ReLU;
3. requantize with ``1 / s_mid``; conv1 with ``k1 * bn1's scale`` quantized
   per output channel, times ``s_mid * sw1``, plus BN1's shift, ReLU;
4. requantize with ``1 / s_head``; the head with one weight scale, times
   ``s_head * swh``, plus ``bh``;
5. the outer six rows and columns of the map are not int8: they are the float
   tail (:func:`tail_plain`'s rule, un-quantized weights) of the dequantized
   input ``xq * s_x`` (rounded to the output dtype), which the plain version
   computes on four edge strips (the first and last 8 rows and columns of x;
   the strips' own edges are further from the six kept rows and columns than
   the tail's receptive field, so this is the float tail of the whole
   dequantized map there);
6. the result is in ``out_dtype``, else x's dtype, bfloat16 for an int8 x.

The kernel (one launch for a bf16 output): a persistent grid that stages the
weights once per block, quantizes x while it stages each tile (no int8 copy
of a float x), runs the three s8 convs and, in the tiles that meet the
border, the bf16 float tail for the border pixels. A float32 output keeps
the float32 rule for its border: a second launch of the float32 tail kernel
in border mode. Integer sums are exact and every float step after them is one
correctly rounded float32 operation in the kernel and in the plain version,
so the two are equal in the interior; the border differs as the float kernel
differs from its plain version.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import _build
from .quant import _div, quantize_symmetric, s8_conv_plain
from .s2d import quantize_static
from .sampling import upsample_2x_bilinear

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_IC = 8    # csrc/tail.cu, float32 kernel: input channels per chunk
_OC = 16   # csrc/tail.cu, float32 kernel: output channels per thread
_G0_MAX, _G1_MAX = 4, 2  # csrc/tail.cu, bf16 kernel: 16-channel groups of Ci and C
_SMEM_LIMIT = 227 * 1024
BN_EPS = 1e-5

BatchNormParams = Sequence[torch.Tensor]  # (scale, bias, mean, var), each (C,)

BORDER = 6   # outer rows and columns of the int8 map that are float
_STRIP = 8   # input rows and columns whose float tail covers the border
_MAX_CIP_Q = 64  # csrc/tail_q.cu: at most four 16-channel groups of the input
_IN_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

__all__ = ["tail", "tail_plain", "fold_bn", "pack_tail_weights", "tail_q", "tail_q_plain",
           "build_tail_weights_q", "pack_tail_weights_q", "compose_up_conv", "TailWeightsQ",
           "TailPackedQ"]


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
    f32 = torch.float32
    if x.dtype == torch.bfloat16:
        def rnd(t):  # one of the bf16 rule's rounding points
            return t.to(torch.bfloat16).to(f32)
    else:
        def rnd(t):
            return t
    s0, t0 = fold_bn(bn0)
    s1, t1 = fold_bn(bn1)
    y = rnd(upsample_2x_bilinear(x.to(f32).permute(0, 3, 1, 2), axes=(2, 3)))
    y = rnd(F.relu(_conv(y, rnd(k0)) * s0[:, None, None] + t0[:, None, None]))
    y = rnd(F.relu(_conv(y, rnd(k1)) * s1[:, None, None] + t1[:, None, None]))
    y = _conv(y, rnd(kh))[:, 0] + bh.to(f32).reshape(())
    return y.to(x.dtype)


def _pad_to(t: torch.Tensor, shape) -> torch.Tensor:
    out = torch.zeros(shape, dtype=torch.float32, device=t.device)
    out[tuple(slice(0, n) for n in t.shape)] = t
    return out


def _pack_conv_bf16(k: torch.Tensor, groups: int, rows: int) -> torch.Tensor:
    """(3, 3, Cin, N) HWIO -> [9 groups][rows][16] bf16 as ``csrc/tail.cu``'s
    ``conv3x3`` reads it: K step ``(dy * 3 + dx) * groups + cg``, row ``n``,
    the weights of channels ``16 cg ...`` of tap (dy, dx) for output n, the
    two halves of 8 swapped in rows with ``n & 4`` (the kernel's bank
    swizzle); zero past Cin and N."""
    cin, n = k.shape[2], k.shape[3]
    t = torch.zeros((3, 3, groups * 16, rows), dtype=torch.bfloat16, device=k.device)
    t[:, :, :cin, :n] = k
    out = t.reshape(9, groups, 16, rows).transpose(2, 3).reshape(9 * groups, rows // 8, 2, 4, 2, 8)
    # row n = 8 a + 4 s + r: for s = 1 the two halves swap (no host sync, no mask)
    out = torch.stack([out[:, :, 0], out[:, :, 1].flip(3)], dim=2)
    return out.reshape(9 * groups, rows, 16)


def pack_tail_weights(k0: torch.Tensor, bn0: BatchNormParams, k1: torch.Tensor,
                      bn1: BatchNormParams, kh: torch.Tensor, bh: torch.Tensor):
    """The bf16 kernel's operands, made once and handed to :func:`tail` as
    ``packed``: (w0, w1, wh) bf16 as :func:`_pack_conv_bf16` lays them out
    (the weights rounded to bf16, Ci and C padded to 16-channel groups, the
    head's N padded to 8), and fp float32 ``s0 | t0 | s1 | t1`` (Cp each),
    ``bh``, three zeros."""
    ci, c = k0.shape[2], k0.shape[3]
    g0, g1 = -(-ci // 16), -(-c // 16)
    cp = 16 * g1
    fp = torch.zeros(4 * cp + 4, dtype=torch.float32, device=k0.device)
    for i, v in enumerate((*fold_bn(bn0), *fold_bn(bn1))):
        fp[i * cp:i * cp + c] = v
    fp[4 * cp] = bh.to(torch.float32).reshape(())
    return (_pack_conv_bf16(k0, g0, cp), _pack_conv_bf16(k1, g1, cp), _pack_conv_bf16(kh, g1, 8),
            fp)


def _f32_operands(k0, bn0, k1, bn1, kh, bh):
    """The float32 kernel's operands (w0, st0, w1, st1, wh, bh), zero beyond
    the real channels: padded channels come out as relu(0 * 0 + 0) = 0 and
    meet zero weights downstream."""
    ci, c = k0.shape[2], k0.shape[3]
    cip, cp = -(-ci // _IC) * _IC, -(-c // _OC) * _OC
    return (_pad_to(k0.reshape(9, ci, c), (9, cip, cp)), _pad_to(torch.stack(fold_bn(bn0)), (2, cp)),
            _pad_to(k1.reshape(9, c, c), (9, cp, cp)), _pad_to(torch.stack(fold_bn(bn1)), (2, cp)),
            _pad_to(kh.reshape(9, c), (9, cp)), bh.to(torch.float32).reshape(1).contiguous())


def tail(x: torch.Tensor, k0: torch.Tensor, bn0: BatchNormParams, k1: torch.Tensor,
         bn1: BatchNormParams, kh: torch.Tensor, bh: torch.Tensor, packed=None) -> torch.Tensor:
    """:func:`tail_plain`'s function. A CPU tensor (or any inside
    :func:`._build.plain`) takes the plain version; a CUDA tensor launches
    the kernel or raises. ``x`` may have any strides.
    ``packed``: :func:`pack_tail_weights`'s result for these weights, made
    earlier (bfloat16 only; built here when None)."""
    ci, c = _check(x, k0, bn0, k1, bn1, kh, bh)
    if not _build.takes_kernel(x, "tail"):
        return tail_plain(x, k0, bn0, k1, bn1, kh, bh)
    if x.dtype not in _DTYPES:
        raise TypeError(f"tail kernel takes float32 or bfloat16, got {x.dtype}")
    b, h, w, _ = x.shape
    lib = _build.library()
    out = torch.empty((b, 2 * h, 2 * w), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if x.dtype == torch.bfloat16:
        g0, g1 = -(-ci // 16), -(-c // 16)
        need = lib.tail_bf16_smem_bytes_for(g0, g1) if g0 <= _G0_MAX and g1 <= _G1_MAX else None
        if need is None or need > _SMEM_LIMIT:
            raise ValueError(f"tail: the bf16 kernel takes Ci <= {16 * _G0_MAX} and C <= "
                             f"{16 * _G1_MAX} within {_SMEM_LIMIT} bytes of shared memory, got "
                             f"Ci={ci}, C={c}")
        if packed is None:
            packed = pack_tail_weights(k0, bn0, k1, bn1, kh, bh)
        cp = 16 * g1
        want = ((9 * g0, cp, 16), (9 * g1, cp, 16), (9 * g1, 8, 16), (4 * cp + 4,))
        dtypes = (torch.bfloat16,) * 3 + (torch.float32,)
        if tuple((tuple(t.shape), t.dtype) for t in packed) != tuple(zip(want, dtypes)) or any(
                t.device != x.device or not t.is_contiguous() for t in packed):
            raise ValueError(f"tail: packed operands must be contiguous bf16 weights and float32 "
                             f"parameters on x's device with shapes {want}")
        err = lib.tail_bf16_launch(x.data_ptr(), *x.stride(), *(t.data_ptr() for t in packed),
                                   out.data_ptr(), b, h, w, ci, g0, g1, stream)
    else:
        need = lib.tail_smem_bytes_for(-(-c // _OC) * _OC)
        if need > _SMEM_LIMIT:
            raise ValueError(f"tail: C={c} needs {need} bytes of shared memory per block, more "
                             f"than the {_SMEM_LIMIT} a block can have")
        ops = _f32_operands(k0, bn0, k1, bn1, kh, bh)
        err = lib.tail_launch(x.data_ptr(), *x.stride(), *(t.data_ptr() for t in ops),
                              out.data_ptr(), b, h, w, ci, -(-ci // _IC) * _IC, -(-c // _OC) * _OC,
                              stream)
    tail.launches += 1
    _build.check(err, "tail")
    return out


tail.launches = 0


# ---- int8 form -------------------------------------------------------------

# 2x half-pixel bilinear upsample, output 2i + f of source i: {source offset: weight}
_UP = {-1: {-1: 0.75, 0: 0.25}, 0: {-1: 0.25, 0: 0.75}, 1: {0: 0.75, 1: 0.25},
       2: {0: 0.25, 1: 0.75}}


class TailWeightsQ(NamedTuple):
    """:func:`build_tail_weights_q`'s result. ``w0q`` (3, 3, Ci, 4, C) int8:
    the composed conv0 on x's grid, axis 3 the output parity ``2 py + px``;
    ``g0`` (4, C) = ``s_x * sw0``; ``w1q`` (3, 3, C, C), ``g1`` (C,) = ``s_mid
    * sw1``; ``whq`` (3, 3, C, 1), ``gh`` (1,) = ``s_head * swh``; ``b0``,
    ``b1`` (C,) the BN shifts, ``bh`` (1,); all float32 but the codes."""
    w0q: torch.Tensor
    g0: torch.Tensor
    b0: torch.Tensor
    w1q: torch.Tensor
    g1: torch.Tensor
    b1: torch.Tensor
    whq: torch.Tensor
    gh: torch.Tensor
    bh: torch.Tensor
    s_x: float
    s_mid: float
    s_head: float


def compose_up_conv(k: torch.Tensor) -> torch.Tensor:
    """Fold the 2x bilinear upsample into a following 3x3 conv: k (3, 3, Ci,
    Co) float64 -> (3, 3, Ci, 4, Co) over the source grid, ``y[2i + py, 2j +
    px] = sum_delta K[delta, :, 2 py + px] x[(i, j) + delta]`` away from the
    source's edge (the JAX package's ``ops/s2d.py::compose_up_conv_kernel``)."""
    fac = torch.zeros((2, 3, 3), dtype=torch.float64)  # [parity, tap d + 1, source offset + 1]
    for a in range(2):
        for d in (-1, 0, 1):
            for delta, wt in _UP[a + d].items():
                fac[a, d + 1, delta + 1] += wt
    fac = fac.to(k.device)
    return torch.einsum("yxio,ayY,bxX->YXiabo", k, fac, fac).reshape(3, 3, k.shape[2], 4,
                                                                     k.shape[3])


def _quantize_out_channels(w: torch.Tensor, keep: Tuple[int, ...]):
    """int8 codes and float32 scales ``max(|w|, 1e-8) / 127`` over every axis
    not in ``keep`` (pallas_tail_q.py:66)."""
    red = tuple(i for i in range(w.dim()) if i not in keep)
    sw = _div(w.abs().amax(dim=red, keepdim=True).clamp_min(1e-8), 127.0)
    return quantize_symmetric(w, sw), sw.reshape([w.shape[i] for i in keep])


def build_tail_weights_q(k0, bn0, k1, bn1, kh, bh, s_x: float, s_mid: float,
                         s_head: float) -> TailWeightsQ:
    """The int8 tail's weight codes and dequantization scales
    (pallas_tail_q.py:78, without its patch-matrix layouts). The composed
    conv0 weights are built in float64 and rounded to float32 once, then
    quantized as the JAX package quantizes its float32 ones."""
    f32, f64 = torch.float32, torch.float64
    s0, t0 = fold_bn(bn0)
    s1, t1 = fold_bn(bn1)
    w0 = (compose_up_conv(k0.to(f64)) * s0.to(f64)).to(f32)
    w0q, sw0 = _quantize_out_channels(w0, (3, 4))
    w1q, sw1 = _quantize_out_channels(k1.to(f32) * s1, (3,))
    whq, swh = _quantize_out_channels(kh.to(f32), ())

    def scale(s, sw):
        return torch.full((1,), s, dtype=f32, device=sw.device) * sw

    return TailWeightsQ(w0q, scale(s_x, sw0), t0, w1q, scale(s_mid, sw1), t1, whq,
                        scale(s_head, swh.reshape(1)), bh.to(f32).reshape(1), float(s_x),
                        float(s_mid), float(s_head))


def _edge_dtype(x: torch.Tensor, out_dtype: Optional[torch.dtype]) -> torch.dtype:
    if out_dtype is not None:
        return out_dtype
    return torch.bfloat16 if x.dtype == torch.int8 else x.dtype


def _check_q(x, k0, bn0, k1, bn1, kh, bh, out_dtype) -> torch.dtype:
    _check(x, k0, bn0, k1, bn1, kh, bh)
    if x.dtype not in (torch.float32, torch.bfloat16, torch.int8):
        raise TypeError(f"tail_q takes float32, bfloat16 or int8 input, got {x.dtype}")
    edge = _edge_dtype(x, out_dtype)
    if edge not in _DTYPES:
        raise TypeError(f"tail_q writes float32 or bfloat16, got {edge}")
    return edge


def _write_border(out: torch.Tensor, xq: torch.Tensor, s_x: float, float_tail, ops) -> None:
    """Overwrite the outer ``BORDER`` rows and columns of ``out`` (B, 2h, 2w)
    with the float tail of the dequantized edge strips of ``xq`` (B, h, w, Ci)
    (left and right first, then top and bottom, as the JAX package merges
    them; the strips agree where they overlap)."""
    b = xq.shape[0]
    sx = torch.full((1,), s_x, dtype=torch.float32, device=xq.device)

    def strips(lo, hi):
        deq = (torch.cat([lo, hi]).to(torch.float32) * sx).to(out.dtype)
        y = float_tail(deq, *ops)
        return y[:b], y[b:]

    left, right = strips(xq[:, :, :_STRIP], xq[:, :, -_STRIP:])
    out[:, :, :BORDER] = left[:, :, :BORDER]
    out[:, :, -BORDER:] = right[:, :, -BORDER:]
    top, bottom = strips(xq[:, :_STRIP], xq[:, -_STRIP:])
    out[:, :BORDER] = top[:, :BORDER]
    out[:, -BORDER:] = bottom[:, -BORDER:]


def _dequant(acc: torch.Tensor, g: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """int32 sums -> float32: one multiply, one add, each rounded once."""
    return acc.to(torch.float32) * g + shift


def tail_q_plain(x: torch.Tensor, k0, bn0, k1, bn1, kh, bh, s_x: float, s_mid: float,
                 s_head: float, out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """:func:`tail_q` in plain PyTorch (any device): exact integer convs
    (float64 sums of the integer tensors), the float steps one tensor op
    each, the border from :func:`tail_plain`."""
    edge = _check_q(x, k0, bn0, k1, bn1, kh, bh, out_dtype)
    wq = build_tail_weights_q(k0, bn0, k1, bn1, kh, bh, s_x, s_mid, s_head)
    b, h, w, ci = x.shape
    c = k0.shape[3]
    xq = x.contiguous() if x.dtype == torch.int8 else quantize_static(x, s_x)
    acc = s8_conv_plain(xq, wq.w0q.reshape(3, 3, ci, 4 * c), padding=1)
    y = F.relu(_dequant(acc.reshape(b, h, w, 4, c), wq.g0, wq.b0))
    yq = quantize_static(y, s_mid).reshape(b, h, w, 2, 2, c)
    yq = yq.permute(0, 1, 3, 2, 4, 5).reshape(b, 2 * h, 2 * w, c)  # the four parities interleaved
    y = F.relu(_dequant(s8_conv_plain(yq, wq.w1q, padding=1), wq.g1, wq.b1))
    yq = quantize_static(y, s_head)
    out = _dequant(s8_conv_plain(yq, wq.whq, padding=1)[..., 0], wq.gh, wq.bh).to(edge)
    _write_border(out, xq, s_x, tail_plain, (k0, bn0, k1, bn1, kh, bh))
    return out


def _pack_rows(wq: torch.Tensor, cs: int, n_pad: int) -> torch.Tensor:
    """(3, 3, Cin, N) codes -> [steps][n_pad][32] as ``csrc/tail_q.cu`` reads
    them: the contraction runs over 16-byte halves h = tap * (cs / 16) + group
    (tap = 3 dy + dx, channels 16 group ... 16 group + 15), half h at bytes 16
    (h % 2) of step h / 2; zero codes past Cin, past N and in the last half of
    an odd count."""
    _, _, cin, n = wq.shape
    halves = 9 * cs // 16
    steps = -(-halves // 2)
    rows = torch.zeros((9, cs, n_pad), dtype=torch.int8, device=wq.device)
    rows[:, :cin, :n] = wq.reshape(9, cin, n)
    flat = torch.zeros((2 * steps, 16, n_pad), dtype=torch.int8, device=wq.device)
    flat[:halves] = rows.reshape(halves, 16, n_pad)
    return flat.reshape(steps, 2, 16, n_pad).permute(0, 3, 1, 2).reshape(steps, n_pad, 32) \
        .contiguous()


class TailPackedQ(NamedTuple):
    """The kernel's operands (:func:`pack_tail_weights_q`): the int8 codes as
    :func:`_pack_rows` lays them out, the float32 parameters, and the float
    border's operands for one output dtype (``border_dtype``): bf16,
    :func:`pack_tail_weights`' result; float32, the float32 tail kernel's
    padded weights, BN scale and shift and head bias."""
    w0: torch.Tensor
    w1: torch.Tensor
    wh: torch.Tensor
    fp: torch.Tensor
    border: tuple
    border_dtype: torch.dtype


def pack_tail_weights_q(wq: TailWeightsQ, float_ops,
                        out_dtype: torch.dtype = torch.bfloat16) -> TailPackedQ:
    """The kernel's operands, made once: w0, w1, wh int8 as :func:`_pack_rows`
    lays them out; float32 parameters g0 (4 Cp) | b0 | g1 | b1 (Cp each) | gh,
    bh, 1 / s_mid, 1 / s_head, with Cip and Cp = Ci and C rounded up to 16;
    and the border's operands for ``out_dtype`` from ``float_ops`` = (k0, bn0,
    k1, bn1, kh, bh), the weights of ``wq``."""
    ci, c = wq.w0q.shape[2], wq.w0q.shape[4]
    cip, cp = -(-ci // 16) * 16, -(-c // 16) * 16
    dev = wq.w0q.device
    w0 = torch.zeros((3, 3, ci, 4, cp), dtype=torch.int8, device=dev)
    w0[..., :c] = wq.w0q
    fp = torch.zeros(7 * cp + 4, dtype=torch.float32, device=dev)
    fp[:4 * cp].view(4, cp)[:, :c] = wq.g0
    for i, v in enumerate((wq.b0, wq.g1, wq.b1)):
        fp[(4 + i) * cp:(4 + i) * cp + c] = v
    fp[7 * cp:] = torch.cat([wq.gh, wq.bh, torch.tensor(
        [1.0 / wq.s_mid, 1.0 / wq.s_head], dtype=torch.float32, device=dev)])
    if out_dtype == torch.bfloat16:
        border = pack_tail_weights(*float_ops)
    elif out_dtype == torch.float32:
        border = _f32_operands(*float_ops)
    else:
        raise TypeError(f"tail_q writes float32 or bfloat16, got {out_dtype}")
    return TailPackedQ(_pack_rows(w0.reshape(3, 3, ci, 4 * cp), cip, 4 * cp),
                       _pack_rows(wq.w1q, cp, cp), _pack_rows(wq.whq, cp, 8), fp, border,
                       out_dtype)


def tail_q(x: torch.Tensor, k0, bn0, k1, bn1, kh, bh, s_x: float, s_mid: float, s_head: float,
           out_dtype: Optional[torch.dtype] = None, packed: Optional[TailPackedQ] = None
           ) -> torch.Tensor:
    """The int8 fused tail (module docstring). x (B, h, w, Ci) float32 or
    bfloat16 with any strides, or int8 already quantized with ``s_x``;
    operands as :func:`tail`; returns (B, 2h, 2w). ``packed`` is
    :func:`pack_tail_weights_q`'s result for these weights and scales and
    this output dtype, made earlier (built here when None). A CPU tensor (or
    any inside :func:`._build.plain`) takes :func:`tail_q_plain`; a CUDA
    tensor launches the kernel (and, for a float32 output, the float32
    border) or raises."""
    edge = _check_q(x, k0, bn0, k1, bn1, kh, bh, out_dtype)
    if not _build.takes_kernel(x, "tail_q"):
        return tail_q_plain(x, k0, bn0, k1, bn1, kh, bh, s_x, s_mid, s_head, out_dtype)
    b, h, w, ci = x.shape
    c = k0.shape[3]
    cip, cp = -(-ci // 16) * 16, -(-c // 16) * 16
    if cp > 32 or cip > _MAX_CIP_Q:
        raise ValueError(f"tail_q: the kernel takes Ci <= {_MAX_CIP_Q} and C <= 32, got Ci={ci}, "
                         f"C={c}")
    lib = _build.library()
    bf16 = edge == torch.bfloat16
    need = lib.tail_q_smem_bytes_for(cip, cp, int(bf16))
    if need > _SMEM_LIMIT:
        raise ValueError(f"tail_q: Ci={ci}, C={c} needs {need} bytes of shared memory per block, "
                         f"more than the {_SMEM_LIMIT} a block can have")
    if packed is None:
        packed = pack_tail_weights_q(build_tail_weights_q(k0, bn0, k1, bn1, kh, bh, s_x, s_mid,
                                                          s_head), (k0, bn0, k1, bn1, kh, bh), edge)
    ks0, ks1 = -(-9 * cip // 32), -(-9 * cp // 32)
    want = ((ks0, 4 * cp, 32), (ks1, cp, 32), (ks1, 8, 32), (7 * cp + 4,))
    dtypes = (torch.int8, torch.int8, torch.int8, torch.float32)
    if tuple((tuple(t.shape), t.dtype) for t in packed[:4]) != tuple(zip(want, dtypes)) or any(
            t.device != x.device or not t.is_contiguous() for t in packed[:4]) \
            or packed.border_dtype != edge or any(t.device != x.device for t in packed.border) \
            or (bf16 and tuple(tuple(t.shape) for t in packed.border) != (
                (9 * cip // 16, cp, 16), (9 * cp // 16, cp, 16), (9 * cp // 16, 8, 16), (4 * cp + 4,))):
        raise ValueError(f"tail_q: packed operands must be contiguous int8 codes and float32 "
                         f"parameters on x's device with shapes {want}, with the border's "
                         f"operands for {edge}")
    inv, stream = 1.0 / s_x, _build.current_stream(x.device)
    out = torch.empty((b, 2 * h, 2 * w), dtype=edge, device=x.device)
    codes = [t.data_ptr() for t in packed[:4]]
    border = [t.data_ptr() for t in packed.border] if bf16 else [None] * 4
    err = lib.tail_q_launch(x.data_ptr(), *x.stride(), _IN_DTYPES[x.dtype], inv, s_x, *codes,
                            *border, out.data_ptr(), b, h, w, ci, cip, cp, _DTYPES[edge], stream)
    tail_q.launches += 1
    _build.check(err, "tail_q")
    if not bf16:  # the float32 border: the float32 tail kernel on the dequantized input
        err = lib.tail_border_f32_launch(
            x.data_ptr(), *x.stride(), _IN_DTYPES[x.dtype], inv, s_x,
            *(t.data_ptr() for t in packed.border), out.data_ptr(), b, h, w, ci,
            -(-ci // _IC) * _IC, -(-c // _OC) * _OC, stream)
        _build.check(err, "tail_q (float32 border)")
    return out


tail_q.launches = 0
