"""Int8 serving convolutions with calibrated static activation scales.

Counterpart of the JAX package's ``ops/quant.py``: :class:`QConv` is an
``nn.Conv2d`` (same ``weight``/``bias``, so ``weights.from_jax_params`` maps
it unchanged) that runs s8 x s8 -> s32 under int8 serving, with a
per-tensor activation scale (calibrated, else the dynamic abs-max) and
per-output-channel weight scales. Outside int8 serving it is exactly
``nn.Conv2d``.

The JAX package keeps the serving mode, the scales and the denylist in
thread-local contexts read at trace time. Here :func:`set_int8_serving`
writes them onto every QConv of a model, keyed by the module's path
(``named_modules`` name with ``.`` replaced by ``/``, letter for letter the
JAX module path), and :func:`calibration` records each eligible QConv's
input abs-max, denied or not.

The s8 convolution is ``csrc/qconv.cu`` on ``csrc/s8_igemm.cuh``: wgmma for
more than 32 output channels (a float input is quantized once into an int8
buffer first; an aligned int8 input is read where it lies), one launch that
quantizes its input tile into shared memory for narrower outputs. The kernel
reads x through its strides and takes the int8 weights packed K-major
(:func:`pack_weight_kmajor`); :class:`QConv` keeps them, the scale tensors and
the bias (:class:`S8Operands`) until a weight or a scale changes, so a
static-scale int8 forward is the kernel launches and their ``torch.empty``.
:func:`qconv2d_plain` is the same function in plain PyTorch, the path for CPU
tensors (and for any inside :func:`._build.plain`) and the oracle the kernel
is held against. Its integer convolution is
exact: it accumulates in float64, where every partial sum of s8 x s8 products
is an integer far below 2^53 (float32 is not exact: 9 * 384 * 127^2 > 2^24).

Rounding follows JAX bit for bit: ``qconv2d`` divides by the scale
(``round(x / s)``), the producer-side :func:`..s2d.quantize_static` and the
fused unit multiply by ``float32(1 / s)``; ``torch.round`` rounds half to
even as ``jnp.round`` does. Every division by a scale divides by a tensor on
the operand's device: PyTorch's CUDA divide by a Python scalar multiplies by
the reciprocal, which is not the same rounding.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterator, NamedTuple, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from . import _build

# A QConv runs int8 only when its contraction kh * kw * Ci is at least this
# (quant.py:282): below it the quantization noise is large for little work.
MIN_INT8_CONTRACTION = 48

_OUT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_IN_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_OUT_S32 = 2
_Q_DIV = 0

Scale = Union[float, torch.Tensor]


def _scalar(s: Scale, device: torch.device) -> torch.Tensor:
    """A float32 scale as a one-element tensor on ``device``."""
    if isinstance(s, torch.Tensor):
        return s.to(device=device, dtype=torch.float32).reshape(1)
    return torch.full((1,), s, dtype=torch.float32, device=device)


def _div(a: torch.Tensor, s: Scale) -> torch.Tensor:
    """``a / s`` as a true float32 division (the divisor lies on a's device)."""
    return a / (s if isinstance(s, torch.Tensor) else _scalar(s, a.device))


def quantize_symmetric(x: torch.Tensor, scale: Scale) -> torch.Tensor:
    """Round-to-nearest-even symmetric int8 with saturation: ``round(x / s)``
    clipped to +-127. ``scale`` is a scalar or broadcasts against x."""
    q = torch.round(_div(x.to(torch.float32), scale))
    return q.clamp(-127.0, 127.0).to(torch.int8)


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel int8 weights: w (kh, kw, Ci, Co) -> (int8 w, float32
    scales (Co,)) with ``sw = max(|w|, 1e-8) / 127`` (quant.py:216-218)."""
    wf = w.to(torch.float32)
    sw = _div(wf.abs().amax(dim=(0, 1, 2)).clamp_min(1e-8), 127.0)
    return quantize_symmetric(wf, sw), sw


def dynamic_scale(x: torch.Tensor) -> torch.Tensor:
    """Per-tensor abs-max activation scale, ``max(max|x|, 1e-6) / 127``, as a
    one-element float32 tensor on x's device (no host sync)."""
    return _div(x.abs().amax().to(torch.float32).clamp_min(1e-6), 127.0).reshape(1)


def s8_conv_plain(xq: torch.Tensor, wq: torch.Tensor, padding: int = 0,
                  stride: int = 1) -> torch.Tensor:
    """Exact s8 convolution: xq (N, H, W, Ci) int8, wq (kh, kw, Ci, Co) int8
    -> int32 (N, Ho, Wo, Co), accumulated in float64. Contiguous NHWC, as
    the kernel writes it: what follows runs on the same memory layout on
    either path, so layout-dependent reductions and cuDNN algorithm choices
    downstream see the same operands."""
    y = F.conv2d(xq.permute(0, 3, 1, 2).to(torch.float64),
                 wq.permute(3, 2, 0, 1).to(torch.float64), stride=stride, padding=padding)
    return y.to(torch.int32).permute(0, 2, 3, 1).contiguous()


def packed_k(ci: int, k: int) -> int:
    """Bytes in one packed weight row: k * k taps of Ci rounded up to 16
    codes, the row rounded up to 128 (``csrc/s8_igemm.cuh::packed_k``)."""
    return -(-(k * k * (-(-ci // 16) * 16)) // 128) * 128


def pack_weight_kmajor(wq: torch.Tensor) -> torch.Tensor:
    """int8 HWIO weights (k, k, Ci, Co) -> (Co, packed_k(Ci, k)) int8, the
    kernel's K-major B operand: row co holds, tap after tap, that tap's Ci
    codes and zero codes up to a multiple of 16; zero codes fill the row."""
    k, k2, ci, co = wq.shape
    if k != k2:
        raise ValueError("the s8 kernel takes square kernels")
    cp = -(-ci // 16) * 16
    rows = F.pad(wq.permute(3, 0, 1, 2).reshape(co, k * k, ci), (0, cp - ci))
    rows = rows.reshape(co, k * k * cp)
    return F.pad(rows, (0, packed_k(ci, k) - rows.shape[1])).contiguous()


def unpack_weight_kmajor(packed: torch.Tensor, k: int, ci: int) -> torch.Tensor:
    """The HWIO weights :func:`pack_weight_kmajor` was given."""
    co = packed.shape[0]
    cp = -(-ci // 16) * 16
    taps = packed[:, :k * k * cp].reshape(co, k, k, cp)[..., :ci]
    return taps.permute(1, 2, 3, 0).contiguous()


class S8Weights(NamedTuple):
    """What depends on the weight alone."""

    wq: torch.Tensor      # int8 HWIO, quantize_weight's codes (the plain version's operand)
    sw: torch.Tensor      # (Co,) float32 weight scales
    packed: torch.Tensor  # pack_weight_kmajor(wq) (the kernel's operand)


class S8Operands(NamedTuple):
    """Everything of an s8 conv that depends only on the weight, the bias,
    the output dtype and the static scale: made once, kept by :class:`QConv`."""

    wq: torch.Tensor
    sw: torch.Tensor
    packed: torch.Tensor
    sx: Optional[torch.Tensor]      # (1,) float32 static activation scale; None: dynamic
    scale: Optional[torch.Tensor]   # (Co,) float32 sx * sw; None: dynamic
    bias: Optional[torch.Tensor]    # (Co,) in the output dtype (the plain version adds it)
    bias32: Optional[torch.Tensor]  # the same values widened to float32 (the kernel adds them)


def s8_weights(w: torch.Tensor) -> S8Weights:
    """Quantize and pack HWIO float weights."""
    wq, sw = quantize_weight(w)
    wq = wq.contiguous()
    return S8Weights(wq, sw.contiguous(), pack_weight_kmajor(wq))


def s8_operands(weights: S8Weights, static_scale: Optional[Scale] = None,
                bias: Optional[torch.Tensor] = None,
                out_dtype: torch.dtype = torch.float32) -> S8Operands:
    """The prepared operands of :func:`qconv2d` for these weights."""
    device = weights.wq.device
    sx = scale = bias_d = bias32 = None
    if static_scale is not None:
        sx = _scalar(static_scale, device)
        scale = (sx * weights.sw).contiguous()
    if bias is not None:
        bias_d = bias.detach().to(device=device, dtype=out_dtype).contiguous()
        bias32 = bias_d.to(torch.float32)
    return S8Operands(weights.wq, weights.sw, weights.packed, sx, scale, bias_d, bias32)


def _scales(x: torch.Tensor, ops: S8Operands) -> Tuple[torch.Tensor, torch.Tensor]:
    """(activation scale, sx * sw): the prepared static ones, else dynamic."""
    if ops.sx is not None:
        return ops.sx, ops.scale
    if x.dtype == torch.int8:
        raise ValueError("an int8 input needs its producer's static scale")
    sx = dynamic_scale(x)
    return sx, (sx * ops.sw).contiguous()


def _out_dtype(x: torch.Tensor, w: Optional[torch.Tensor],
               out_dtype: Optional[torch.dtype]) -> torch.dtype:
    """x's dtype; for an int8 x the named one, else w's."""
    if out_dtype is not None:
        return out_dtype
    if x.dtype != torch.int8:
        return x.dtype
    if w is None:
        raise ValueError("an int8 input with prepared operands needs out_dtype")
    return w.dtype


def _operands_for(x, w, static_scale, prepared, bias, out_dtype) -> S8Operands:
    if prepared is not None:
        return prepared
    if x.dtype == torch.int8 and static_scale is None:
        raise ValueError("an int8 input needs its producer's static scale")
    return s8_operands(s8_weights(w.to(x.device)), static_scale, bias, out_dtype)


def qconv2d_plain(x: torch.Tensor, w: Optional[torch.Tensor], stride: int = 1, padding: int = 0,
                  static_scale: Optional[float] = None,
                  prepared: Optional[S8Operands] = None,
                  bias: Optional[torch.Tensor] = None,
                  out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """:func:`qconv2d` in plain PyTorch (any device, any strides of x)."""
    out_dtype = _out_dtype(x, w, out_dtype)
    ops = _operands_for(x, w, static_scale, prepared, bias, out_dtype)
    sx, scale = _scales(x, ops)
    xq = x if x.dtype == torch.int8 else quantize_symmetric(x, sx)
    acc = s8_conv_plain(xq, ops.wq, padding=padding, stride=stride)
    y = (acc.to(torch.float32) * scale).to(out_dtype)
    if ops.bias is not None:
        y = y + ops.bias
    return y


def staging_buffer(x: torch.Tensor) -> torch.Tensor:
    """The int8 buffer the wgmma kernel's first pass quantizes (or copies) x
    (N, H, W, Ci) into: N*H*W rows of Ci rounded up to 16 codes
    (``csrc/s8_igemm.cuh``). The one-launch kernel for narrow outputs and an
    aligned int8 input do without it."""
    n, h, w, ci = x.shape
    return torch.empty(n * h * w * (-(-ci // 16) * 16), dtype=torch.int8, device=x.device)


def nchw_strides(x: torch.Tensor) -> Tuple[int, int, int, int]:
    """Element strides of x (N, C, H, W), 0 for an extent of 1."""
    return tuple(st if size > 1 else 0 for st, size in zip(x.stride(), x.shape))


_NARROW: Dict[Tuple[int, int, int], bool] = {}  # (Ci, Co, k) -> the one-launch kernel takes it


def _needs_staging(lib, x: torch.Tensor, strides, ci: int, co: int, k: int) -> bool:
    """Whether the launch needs :func:`staging_buffer` (``csrc/s8_igemm.cuh::
    needs_staging``; a launch that needs one and gets none is refused)."""
    narrow = _NARROW.get((ci, co, k))
    if narrow is None:
        # a float input needs staging exactly when the wgmma kernel takes the shape
        narrow = _NARROW[(ci, co, k)] = not lib.s8_conv_needs_staging(
            None, 0, 1, 0, 0, _IN_DTYPES[torch.float32], ci, co, k)
    if narrow:
        return False
    if x.dtype != torch.int8 or ci % 16:
        return True
    sn, sc, sh, sw = strides
    return sc != 1 or (x.data_ptr() | sn | sh | sw) % 16 != 0


def _launch(x: torch.Tensor, packed: torch.Tensor, k: int, sx: Optional[torch.Tensor],
            scale: Optional[torch.Tensor], bias32: Optional[torch.Tensor], out: torch.Tensor,
            pad: int, name: str) -> None:
    """Launch ``s8_conv_launch`` on x viewed (N, Ci, H, W) in any strides,
    packed weights (Co, packed_k) and a contiguous NHWC ``out``. The scales
    and the bias are float32, contiguous, on x's device (:func:`s8_operands`
    makes them so)."""
    n, ci, h, w = x.shape
    co, kp = packed.shape
    if packed.device != x.device or packed.dtype != torch.int8 or kp != packed_k(ci, k) \
            or not packed.is_contiguous():
        raise ValueError(f"{name}: packed weights must be contiguous int8 ({co}, "
                         f"{packed_k(ci, k)}) on {x.device}, got {packed.dtype} "
                         f"{tuple(packed.shape)} on {packed.device}")
    lib = _build.library()
    strides = x.stride() if min(x.shape) > 1 else nchw_strides(x)
    ws = staging_buffer(x.permute(0, 2, 3, 1)) if _needs_staging(lib, x, strides, ci, co, k) \
        else None
    err = lib.s8_conv_launch(
        x.data_ptr(), *strides, _IN_DTYPES[x.dtype], packed.data_ptr(),
        sx.data_ptr() if sx is not None else None, _Q_DIV,
        scale.data_ptr() if scale is not None else None,
        bias32.data_ptr() if bias32 is not None else None,
        out.data_ptr(), _OUT_DTYPES.get(out.dtype, _OUT_S32),
        ws.data_ptr() if ws is not None else None,
        n, h, w, ci, co, k, pad, _build.current_stream(x.device))
    _build.check(err, name)


def _qconv_cuda(x: torch.Tensor, ops: S8Operands, stride: int, padding: int,
                out_dtype: torch.dtype) -> torch.Tensor:
    """The kernel on a CUDA x viewed (N, Ci, H, W); returns NHWC."""
    if x.dtype not in _IN_DTYPES:
        raise TypeError(f"qconv2d kernel takes float32, bfloat16 or int8 input, got {x.dtype}")
    if stride != 1:
        raise ValueError("qconv2d kernel takes stride 1 and a square kernel")
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"qconv2d kernel writes float32 or bfloat16, got {out_dtype}")
    sx, scale = (ops.sx, ops.scale) if ops.sx is not None else _scales(x, ops)
    n, _, h, wd = x.shape
    k = ops.wq.shape[0]
    out = torch.empty((n, h + 2 * padding - k + 1, wd + 2 * padding - k + 1, ops.packed.shape[0]),
                      device=x.device, dtype=out_dtype)
    _launch(x, ops.packed, k, sx, scale, ops.bias32, out, padding, "qconv2d")
    qconv2d.launches += 1
    return out


def qconv2d(x: torch.Tensor, w: Optional[torch.Tensor], stride: int = 1, padding: int = 0,
            static_scale: Optional[float] = None,
            prepared: Optional[S8Operands] = None,
            bias: Optional[torch.Tensor] = None,
            out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Quantized NHWC conv (quant.py:180): x (N, H, W, Ci) float, or int8
    already quantized by its producer with ``static_scale``; w (kh, kw, Ci,
    Co) float. Activation scale ``static_scale`` if given, else the dynamic
    abs-max; weight scales per output channel. Returns ``float(acc) * (sx *
    sw)`` in x's dtype (in w's dtype, or ``out_dtype``, for int8 x), plus
    ``bias`` (Co,) added in that dtype when given.

    ``prepared`` (:func:`s8_operands`, made once) stands for w,
    ``static_scale`` and ``bias``, which are then not read. x may have any
    strides (an NCHW tensor permuted to NHWC comes in without a copy).

    A CPU tensor (or any inside :func:`._build.plain`) takes
    :func:`qconv2d_plain`. A CUDA tensor launches ``csrc/qconv.cu`` (stride
    1, square kernel, symmetric padding) or raises.
    """
    ci = prepared.wq.shape[2] if prepared is not None else (w.shape[2] if w.dim() == 4 else -1)
    if x.dim() != 4 or ci != x.shape[3]:
        raise ValueError(f"x (N, H, W, Ci) and w (kh, kw, Ci, Co) disagree: {tuple(x.shape)}, "
                         f"{tuple(prepared.wq.shape if prepared is not None else w.shape)}")
    if not _build.takes_kernel(x, "qconv2d"):
        return qconv2d_plain(x, w, stride, padding, static_scale, prepared, bias, out_dtype)
    if prepared is None and w.shape[0] != w.shape[1]:
        raise ValueError("qconv2d kernel takes stride 1 and a square kernel")
    out_dtype = _out_dtype(x, w, out_dtype)
    ops = _operands_for(x, w, static_scale, prepared, bias, out_dtype)
    return _qconv_cuda(x.permute(0, 3, 1, 2), ops, stride, padding, out_dtype)


qconv2d.launches = 0


def qconv2d_nchw(x: torch.Tensor, ops: S8Operands, stride: int = 1, padding: int = 0,
                 out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """:func:`qconv2d` for the modules: x (N, Ci, H, W) as it lies in memory
    (channels-last or contiguous, no copy is made), prepared operands; returns
    (N, Co, Ho, Wo) in channels-last memory."""
    out_dtype = _out_dtype(x, None, out_dtype)
    if _build.takes_kernel(x, "qconv2d"):
        y = _qconv_cuda(x, ops, stride, padding, out_dtype)
    else:
        y = qconv2d_plain(x.permute(0, 2, 3, 1), None, stride, padding, prepared=ops,
                          out_dtype=out_dtype)
    return y.permute(0, 3, 1, 2)


def s8_matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact (M, K) int8 x (K, N) int8 -> (M, N) int32, in float64."""
    return (a.to(torch.float64) @ b.to(torch.float64)).to(torch.int32)


def pack_matmul_b(b: torch.Tensor) -> torch.Tensor:
    """(K, N) int8 -> the kernel's K-major operand (N, packed_k(K, 1)): b
    transposed, each row zero-padded (8-bit wgmma reads both operands with
    K contiguous)."""
    return pack_weight_kmajor(b.reshape(1, 1, *b.shape))


def s8_matmul(a: torch.Tensor, b: torch.Tensor,
              packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """s8 x s8 -> s32 GEMM through the qconv kernel's main loop (a 1x1 conv
    over M pixels, no float epilogue). ``packed`` is ``pack_matmul_b(b)``
    made earlier (a conv packs its weights once; without it b is packed at
    every call). A CPU tensor (or any inside :func:`._build.plain`) takes
    :func:`s8_matmul_plain`; a CUDA tensor launches the kernel or raises."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"need (M, K) and (K, N), got {tuple(a.shape)}, {tuple(b.shape)}")
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError("s8_matmul takes int8 operands")
    if not _build.takes_kernel(a, "s8_matmul"):
        return s8_matmul_plain(a, b)
    m = a.shape[0]
    out = torch.empty((1, 1, m, b.shape[1]), device=a.device, dtype=torch.int32)
    if packed is None:
        packed = pack_matmul_b(b)
    # a as a one-row image of M pixels with K channels, viewed (1, K, 1, M)
    _launch(a.t().unsqueeze(0).unsqueeze(2), packed, 1, None, None, None, out, 0, "s8_matmul")
    s8_matmul.launches += 1
    return out.reshape(m, -1)


s8_matmul.launches = 0


# ---- QConv, the serving switch, calibration -------------------------------


def int8_denied(path: str, deny: Sequence[str]) -> bool:
    """True when a denylist substring occurs in the module path (quant.py:86)."""
    return any(d in path for d in deny)


class QConv(nn.Conv2d):
    """``nn.Conv2d`` that runs int8 under int8 serving (quant.py:240).

    Dense, stride-1 or not, groups 1. The int8 path is skipped for
    contractions ``kh * kw * Ci < 48``. An int8 input (quantized by its
    producer with this conv's calibrated scale) always takes the int8 path.
    The serving fields are set by :func:`set_int8_serving`. The packed int8
    weights, the scale tensors and the bias are made once and kept until a
    parameter's storage, version or dtype or the static scale changes
    (:meth:`cached`), as JAX quantizes them once per trace. x comes in as it
    lies in memory and the output is channels-last: no copy on either side.
    """

    int8_calls = 0  # int8 forwards of every QConv, for launch-count checks
    operand_builds = 0  # misses of cached(): weights and operands built (again)

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if self.groups != 1 or self.dilation != (1, 1):
            raise ValueError("QConv is the dense, undilated conv only")
        self.serving = False
        self.denied = False
        self.static_scale: Optional[float] = None
        self.calib_amax: Optional[list] = None
        self._cache: dict = {}  # slot -> (key, tensors kept alive, value); see cached()

    @property
    def eligible(self) -> bool:
        kh, kw = self.kernel_size
        return kh * kw * self.in_channels >= MIN_INT8_CONTRACTION

    @property
    def runs_int8(self) -> bool:
        """Whether a float input takes the int8 path."""
        return self.serving and self.eligible and not self.denied

    def cached(self, slot: str, tensors: Sequence[Optional[torch.Tensor]], extras: tuple,
               build: Callable[[], object]):
        """``build()``, made once per state of ``tensors`` (device, storage,
        version counter, dtype) and ``extras`` and kept under ``slot`` until
        one of them changes. An inference-mode tensor has no version counter
        (an in-place change would go unseen), so with one nothing is kept.
        Every build adds one to ``QConv.operand_builds``: in steady serving
        it stays still."""
        live = [t for t in tensors if t is not None]
        if any(t.is_inference() for t in live):
            QConv.operand_builds += 1
            return build()
        key = (extras, tuple((t.device, t.data_ptr(), t._version, t.dtype) for t in live))
        hit = self._cache.get(slot)
        if hit is None or hit[0] != key:
            QConv.operand_builds += 1
            # the detached tensors share the version counters and hold the
            # storages, so no other tensor can take their addresses meanwhile
            with torch.inference_mode(False), torch.no_grad():
                hit = (key, [t.detach() for t in live], build())
            self._cache[slot] = hit
        return hit[2]

    def quantized_weight(self, dtype: torch.dtype) -> S8Weights:
        """The int8 codes, scales and K-major pack of the HWIO weight cast
        to ``dtype`` (JAX casts it to the input dtype first, quant.py:280-281)."""
        return self.cached(
            "weights", (self.weight,), (dtype,),
            lambda: s8_weights(self.weight.detach().to(dtype).permute(2, 3, 1, 0).contiguous()))

    def prepared(self, dtype: torch.dtype) -> S8Operands:
        """The conv's :class:`S8Operands` for activations of ``dtype``: weights,
        ``sx``, ``sx * sw`` and the bias, rebuilt when the weight, the bias,
        the static scale or the dtype changes."""
        return self.cached(
            "operands", (self.weight, self.bias), (dtype, self.static_scale),
            lambda: s8_operands(self.quantized_weight(dtype), self.static_scale, self.bias, dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pre = x.dtype == torch.int8
        if self.calib_amax is not None and self.eligible:
            self.calib_amax.append(x.abs().amax().to(torch.float32))
        if not (self.runs_int8 or pre):
            return super().forward(x)
        if self.padding_mode != "zeros" or self.padding[0] != self.padding[1] \
                or self.stride[0] != self.stride[1]:
            raise ValueError("QConv int8 path takes symmetric zero padding and square strides")
        dtype = self.weight.dtype if pre else x.dtype
        y = qconv2d_nchw(x, self.prepared(dtype), self.stride[0], self.padding[0], dtype)
        QConv.int8_calls += 1
        return y


def set_int8_serving(model: nn.Module, enabled: bool, scales: Optional[Dict[str, float]] = None,
                     deny: Sequence[str] = ()) -> None:
    """Set int8 serving on every QConv under ``model`` (the JAX package's
    ``int8_serving(enabled, scales, deny)`` context): the mode, the deny
    decision and the calibrated scale, keyed by the module path."""
    for name, m in model.named_modules():
        key = name.replace(".", "/")
        if isinstance(m, QConv):
            m.serving = enabled
            m.denied = int8_denied(key, deny)
            m.static_scale = scales.get(key) if scales else None
        elif hasattr(m, "set_tail_scales"):  # the UNet: its s8 tail's ``#x``, ``#mid``, ``#head``
            m.set_tail_scales(scales if enabled else None, key)


@contextlib.contextmanager
def calibration(model: nn.Module) -> Iterator[dict]:
    """Record the input abs-max of every eligible QConv under ``model``
    (denied or not) while the block runs. Yields a dict that, on exit, holds
    the JAX ``calib`` collection's nested form: module path parts down to an
    ``amax`` leaf, a tuple of one value per call. A module with a
    ``calib_tags`` attribute (the UNet, for its fused tail's points) gets a
    dict to fill with ``{(sub-path, tag): [abs-max, ...]}``; these become
    ``amax_<tag>`` leaves under the module's path and sub-path."""
    tree: dict = {}
    named = list(model.named_modules())
    qconvs = [(n, m) for n, m in named if isinstance(m, QConv)]
    tagged = [(n, m) for n, m in named if hasattr(m, "calib_tags")]
    for _, m in qconvs:
        m.calib_amax = []
    for _, m in tagged:
        m.calib_tags = {}
    try:
        yield tree
    finally:
        for name, m in tagged:
            for (sub, tag), values in m.calib_tags.items():
                node = tree
                for part in [p for p in name.split(".") + [sub] if p]:
                    node = node.setdefault(part, {})
                node["amax_" + tag] = tuple(float(v) for v in values)
            m.calib_tags = None
        for name, m in qconvs:
            if m.calib_amax:
                node = tree
                for part in name.split("."):
                    node = node.setdefault(part, {})
                node["amax"] = tuple(float(v) for v in m.calib_amax)
            m.calib_amax = None


def collect_scales(calib: dict, margin: float = 1.0) -> Dict[str, float]:
    """Flatten a calibration tree into ``{path: scale}`` (quant.py:144): an
    ``amax`` leaf keys its module path, ``amax_<tag>`` keys ``path#tag``;
    ``scale = max(amax * margin, 1e-6) / 127``."""
    flat: Dict[str, float] = {}

    def walk(tree, path):
        for k, v in tree.items():
            if k == "amax" or k.startswith("amax_"):
                amax = max(float(x) for x in v) if isinstance(v, tuple) else float(v)
                key = "/".join(path)
                if k != "amax":
                    key = key + "#" + k[len("amax_"):]
                flat[key] = max(amax * margin, 1e-6) / 127.0
            else:
                walk(v, path + (k,))

    walk(calib, ())
    return flat


def merge_scales(a: Dict[str, float], b: Dict[str, float]) -> Dict[str, float]:
    """Pointwise max of two scale dicts (multi-batch calibration)."""
    return {k: max(a.get(k, 0.0), b.get(k, 0.0)) for k in set(a) | set(b)}
