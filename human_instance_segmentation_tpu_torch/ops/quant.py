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

The s8 convolution is ``csrc/qconv.cu`` (one pass that quantizes a float
input, then an implicit GEMM on the tensor cores); :func:`qconv2d_plain` is
the same function in plain PyTorch, the path for CPU tensors and the oracle
the kernel is held against. Its integer convolution is exact: it accumulates in
float64, where every partial sum of s8 x s8 products is an integer far below
2^53 (float32 is not exact: 9 * 384 * 127^2 > 2^24).

Rounding follows JAX bit for bit: ``qconv2d`` divides by the scale
(``round(x / s)``), the producer-side :func:`..s2d.quantize_static` and the
fused unit multiply by ``float32(1 / s)``; ``torch.round`` rounds half to
even as ``jnp.round`` does. Every division by a scale divides by a tensor on
the operand's device: PyTorch's CUDA divide by a Python scalar multiplies by
the reciprocal, which is not the same rounding.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, Optional, Sequence, Tuple, Union

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


QWeight = Tuple[torch.Tensor, torch.Tensor]  # quantize_weight's (int8 HWIO, scales)


def _prepare(x: torch.Tensor, w: torch.Tensor, static_scale: Optional[float],
             wq: Optional[QWeight]):
    """(activation scale tensor, out dtype, int8 weights, sx * sw) as
    qconv2d defines them (quant.py:197-218)."""
    if x.dtype == torch.int8:
        if static_scale is None:
            raise ValueError("an int8 input needs its producer's static scale")
        sx = _scalar(static_scale, x.device)
        out_dtype = w.dtype
    else:
        sx = _scalar(static_scale, x.device) if static_scale is not None else dynamic_scale(x)
        out_dtype = x.dtype
    wq, sw = wq if wq is not None else quantize_weight(w.to(x.device).contiguous())
    return sx, out_dtype, wq, sx * sw


def qconv2d_plain(x: torch.Tensor, w: torch.Tensor, stride: int = 1, padding: int = 0,
                  static_scale: Optional[float] = None,
                  wq: Optional[QWeight] = None) -> torch.Tensor:
    """:func:`qconv2d` in plain PyTorch (any device)."""
    sx, out_dtype, wq, scale = _prepare(x, w, static_scale, wq)
    xq = x if x.dtype == torch.int8 else quantize_symmetric(x, sx)
    acc = s8_conv_plain(xq, wq, padding=padding, stride=stride)
    return (acc.to(torch.float32) * scale).to(out_dtype)


def staging_buffer(x: torch.Tensor) -> torch.Tensor:
    """The int8 buffer the s8 kernel quantizes (or copies) x (N, H, W, Ci)
    into once before its conv: N*H*W rows of Ci rounded up to 16 codes
    (``csrc/s8_igemm.cuh``)."""
    n, h, w, ci = x.shape
    return torch.empty(n * h * w * (-(-ci // 16) * 16), dtype=torch.int8, device=x.device)


def _launch(x: torch.Tensor, wq: torch.Tensor, sx: torch.Tensor, scale: Optional[torch.Tensor],
            out: torch.Tensor, pad: int, name: str) -> None:
    for t in (x, wq, out):
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous (NHWC / HWIO)")
        if t.device != x.device:
            raise ValueError(f"{name}: operands must share x's device")
    n, h, w, ci = x.shape
    k = wq.shape[0]
    ws = staging_buffer(x)
    err = _build.library().s8_conv_launch(
        x.data_ptr(), wq.data_ptr(), sx.data_ptr(), _Q_DIV,
        scale.data_ptr() if scale is not None else None, None, out.data_ptr(), ws.data_ptr(),
        n, h, w, ci, wq.shape[-1], k, pad,
        _IN_DTYPES[x.dtype], _OUT_DTYPES.get(out.dtype, _OUT_S32),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, name)


def qconv2d(x: torch.Tensor, w: torch.Tensor, stride: int = 1, padding: int = 0,
            static_scale: Optional[float] = None,
            wq: Optional[QWeight] = None) -> torch.Tensor:
    """Quantized NHWC conv (quant.py:180): x (N, H, W, Ci) float, or int8
    already quantized by its producer with ``static_scale``; w (kh, kw, Ci,
    Co) float. Activation scale ``static_scale`` if given, else the dynamic
    abs-max; weight scales per output channel (``wq``, when given, is
    ``quantize_weight(w)`` made earlier). Returns ``float(acc) * (sx *
    sw)`` in x's dtype (in w's dtype for int8 x).

    A CPU tensor takes :func:`qconv2d_plain`. A CUDA tensor launches
    ``csrc/qconv.cu`` (stride 1, square kernel, symmetric padding) or raises.
    """
    if x.dim() != 4 or w.dim() != 4 or w.shape[2] != x.shape[3]:
        raise ValueError(f"x (N, H, W, Ci) and w (kh, kw, Ci, Co) disagree: "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    if x.device.type == "cpu":
        return qconv2d_plain(x, w, stride, padding, static_scale, wq)
    if x.device.type != "cuda":
        raise RuntimeError(f"qconv2d: no kernel for device {x.device}")
    if x.dtype not in _IN_DTYPES:
        raise TypeError(f"qconv2d kernel takes float32, bfloat16 or int8 input, got {x.dtype}")
    if stride != 1 or w.shape[0] != w.shape[1]:
        raise ValueError("qconv2d kernel takes stride 1 and a square kernel")
    sx, out_dtype, wq, scale = _prepare(x, w, static_scale, wq)
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"qconv2d kernel writes float32 or bfloat16, got {out_dtype}")
    n, h, wd, _ = x.shape
    k = w.shape[0]
    ho, wo = h + 2 * padding - k + 1, wd + 2 * padding - k + 1
    out = torch.empty((n, ho, wo, w.shape[-1]), device=x.device, dtype=out_dtype)
    _launch(x.contiguous(), wq, sx, scale.contiguous(), out, padding, "qconv2d")
    qconv2d.launches += 1
    return out


qconv2d.launches = 0


def s8_matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact (M, K) int8 x (K, N) int8 -> (M, N) int32, in float64."""
    return (a.to(torch.float64) @ b.to(torch.float64)).to(torch.int32)


def s8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """s8 x s8 -> s32 GEMM through the qconv kernel's main loop (a 1x1 conv
    over M pixels, no epilogue). A CPU tensor takes :func:`s8_matmul_plain`;
    a CUDA tensor launches the kernel or raises."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"need (M, K) and (K, N), got {tuple(a.shape)}, {tuple(b.shape)}")
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError("s8_matmul takes int8 operands")
    if a.device.type == "cpu":
        return s8_matmul_plain(a, b)
    if a.device.type != "cuda":
        raise RuntimeError(f"s8_matmul: no kernel for device {a.device}")
    m, kdim = a.shape
    out = torch.empty((1, 1, m, b.shape[1]), device=a.device, dtype=torch.int32)
    one = torch.ones(1, device=a.device, dtype=torch.float32)
    _launch(a.contiguous().reshape(1, 1, m, kdim), b.contiguous().reshape(1, 1, kdim, -1), one,
            None, out, 0, "s8_matmul")
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
    The serving fields are set by :func:`set_int8_serving`. The int8
    weights are made once and kept until the weight's storage, version or
    dtype changes, as JAX quantizes them once per trace.
    """

    int8_calls = 0  # int8 forwards of every QConv, for launch-count checks

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if self.groups != 1 or self.dilation != (1, 1):
            raise ValueError("QConv is the dense, undilated conv only")
        self.serving = False
        self.denied = False
        self.static_scale: Optional[float] = None
        self.use_kernel = True
        self.calib_amax: Optional[list] = None
        self._wq: Optional[tuple] = None  # (key, weight kept alive, QWeight)

    @property
    def eligible(self) -> bool:
        kh, kw = self.kernel_size
        return kh * kw * self.in_channels >= MIN_INT8_CONTRACTION

    @property
    def runs_int8(self) -> bool:
        """Whether a float input takes the int8 path."""
        return self.serving and self.eligible and not self.denied

    def quantized_weight(self, dtype: torch.dtype) -> QWeight:
        """``quantize_weight`` of the HWIO weight cast to ``dtype`` (JAX
        casts it to the input dtype first, quant.py:280-281)."""
        w = self.weight
        if w.is_inference():  # no version counter: in-place changes go unseen
            return quantize_weight(w.to(dtype).permute(2, 3, 1, 0).contiguous())
        key = (dtype, w.device, w.data_ptr(), w._version)
        if self._wq is None or self._wq[0] != key:
            # the detached weight shares the version counter and holds the
            # storage, so no other tensor can take its address meanwhile
            with torch.inference_mode(False), torch.no_grad():
                hwio = w.detach().to(dtype).permute(2, 3, 1, 0).contiguous()
                self._wq = (key, w.detach(), quantize_weight(hwio))
        return self._wq[2]

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
        w = self.weight.to(dtype).permute(2, 3, 1, 0)
        xh = x.permute(0, 2, 3, 1).contiguous()
        fn = qconv2d if self.use_kernel else qconv2d_plain
        y = fn(xh, w, self.stride[0], self.padding[0], self.static_scale,
               self.quantized_weight(dtype))
        QConv.int8_calls += 1
        y = y.permute(0, 3, 1, 2)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)[:, None, None]
        return y


def set_int8_serving(model: nn.Module, enabled: bool, scales: Optional[Dict[str, float]] = None,
                     deny: Sequence[str] = (), kernel: bool = True) -> None:
    """Set int8 serving on every QConv under ``model`` (the JAX package's
    ``int8_serving(enabled, scales, deny)`` context): the mode, the deny
    decision and the calibrated scale, keyed by the module path. ``kernel``
    False routes the int8 convs through :func:`qconv2d_plain` on any device
    (the plain int8 path a GPU run is compared against)."""
    for name, m in model.named_modules():
        key = name.replace(".", "/")
        if isinstance(m, QConv):
            m.serving = enabled
            m.denied = int8_denied(key, deny)
            m.static_scale = scales.get(key) if scales else None
            m.use_kernel = kernel
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
