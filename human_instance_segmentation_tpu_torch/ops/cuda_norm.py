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
  quantize_static`, optionally on given statistics. It is the kernel's
  oracle and the path of CPU tensors.
* :func:`ln_stats_plain` computes the kernel's statistics in PyTorch: the
  same float32 operations in the same order (the blocks, the threads, the
  Chan merges and their fixed trees, the two multiply-adds ``nvcc``
  contracts into FMAs), so it equals the kernel's bit for bit.
* :func:`ln_act` is the entry point. A CUDA tensor launches the kernels or
  raises; inside :func:`._build.plain` it takes :func:`ln_act_plain` on
  :func:`ln_stats_plain`'s statistics, the kernel's values without the
  kernel. A CPU tensor takes the plain chain with its own statistics.
  ``ln_act.launches`` counts its kernel calls (two launches each).
* :func:`norm_act` is what the modules call with their norm and activation.
  On the card it takes :func:`ln_act` (the kernel, or inside ``plain()``
  its twin) only where that computes what the modules computed
  (:func:`engages`): x in bf16 or float32, autograd not recording (serving
  runs under ``inference_mode``; training keeps the chain, whose backward
  it needs), a :class:`.norms.LayerNorm2d` in x's dtype, ReLU or the
  identity, a residual of x's shape and dtype, and no ``torch.export`` or
  ``torch.compile`` tracing (the kernels are bound through ``ctypes``,
  opaque to a tracer). Everything else, CPU tensors included, runs the
  modules' own chain.

The kernel's outputs differ from the modules' chain only by the order of
the statistics' sums (float32 in both); every later step rounds where the
chain rounds. So the twin on the kernel's statistics equals the kernel: the
int8 graph, where one ulp can cross a quantizer's rounding boundary, is
held to a plain path that computes the same float32 values.
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

__all__ = ["ln_act", "ln_act_plain", "ln_stats_plain", "norm_act", "engages", "plan"]

_SMS = 132              # the H100's streaming multiprocessors
_BLOCKS_AN_SM = 8       # 256-thread blocks an SM holds
_MIN_BLOCK = 4096       # values a block at least
_MAX_SLICES = 1024      # blocks a sample at most (each apply block merges them all)
_MAX_SAMPLES = 65535    # gridDim.y
_VEC = 8                # values a vector
_THREADS = 256          # threads a block
_UNROLL = 4             # vectors a thread loads before it uses any (statistics)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_RELU = {F.relu: True, _identity: False}  # the activations the kernel applies


def ln_act_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5,
                 residual: Optional[torch.Tensor] = None, relu: bool = True,
                 qscale: Optional[float] = None, *,
                 stats: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``LayerNorm2d`` (statistics in float32, normalised map cast to x's
    dtype, then the affine) -> ``+ residual`` -> ReLU or identity ->
    ``quantize_static(., qscale)`` when a scale is given: the modules'
    chain, op for op. ``stats`` ((N, 2) float32 means and biased
    variances, as :func:`ln_stats_plain` returns them) stands for the
    chain's own statistics."""
    y = layer_norm_2d(x, weight, bias, eps, stats)
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


def _layout(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
            residual: Optional[torch.Tensor]) -> Tuple[torch.Tensor, bool, bool]:
    """``(x, channels_last, vec)``: x as the kernels read it (NCHW or
    channels-last memory; any other layout made NCHW), and whether they read
    it 8 channels a vector (channels-last, C % 8 == 0, x, the parameters and
    a residual of x's strides on 16 bytes; the output, a new tensor, is)."""
    if x.is_contiguous():
        channels_last = False
    elif x.is_contiguous(memory_format=torch.channels_last):
        channels_last = True
    else:
        x, channels_last = x.contiguous(), False
    res_same = residual is not None and residual.stride() == x.stride()
    vec = (channels_last and x.shape[1] % _VEC == 0 and _aligned(x, weight, bias)
           and (not res_same or _aligned(residual)))
    return x, channels_last, vec


# The statistics in PyTorch, operation for operation as csrc/layernorm_act.cu
# computes them. A summary is (count, mean, M2), three float32 tensors.


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as an FMA. The product is exact
    in float64; the float64 sum's own rounding error (TwoSum) decides the
    one case where rounding twice could differ, a sum that lands exactly
    halfway between two float32 values."""
    p, cd = a.double() * b.double(), c.double()
    s = p + cd
    bv = s - p
    err = (p - (s - bv)) + (cd - bv)
    r = s.float()
    rd = r.double()
    nxt = torch.nextafter(r, torch.where(s > rd, torch.inf, -torch.inf).float())
    half = (s != rd) & (2.0 * s == rd + nxt.double())
    return torch.where(half & (err != 0) & ((err > 0) == (s > rd)), nxt, r)


def _merge(a, b):
    """The kernels' ``merge``: Chan's rule in float32, ``mean`` and ``M2``
    each ending in a contracted multiply-add; a summary of count 0 leaves
    the other."""
    an, am, a2 = a
    bn, bm, b2 = b
    n = an + bn
    fb = bn / n
    delta = bm - am
    mean = _fma(delta, fb, am)
    m2 = _fma(delta * delta * an, fb, a2 + b2)
    keep_a, take_b = bn == 0, an == 0
    return tuple(torch.where(keep_a, u, torch.where(take_b, v, w))
                 for u, v, w in zip(a, b, (n, mean, m2)))


def _warp_merge(s):
    """Lane 0's summary after ``warp_merge`` over the last axis (32 lanes):
    lane l merges lane l + off for off = 16, 8, 4, 2, 1."""
    for off in (16, 8, 4, 2, 1):
        s = _merge(tuple(t[..., :off] for t in s), tuple(t[..., off:2 * off] for t in s))
    return tuple(t[..., 0] for t in s)


def _zero(shape, device):
    return tuple(torch.zeros(shape, dtype=torch.float32, device=device) for _ in range(3))


def _block_partials(flat: torch.Tensor, vec: bool, p: int, chunk: int):
    """``ln_stats_kernel``: the (N, p) block summaries of flat (N, per
    sample) float32 values in memory order, block q of a sample reading
    values [q * chunk, (q + 1) * chunk)."""
    n, per_sample = flat.shape
    dev = flat.device
    step = _THREADS * _VEC * _UNROLL if vec else _THREADS  # values a thread's iteration spans
    k = -(-chunk // step)
    x = F.pad(flat, (0, p * chunk - per_sample)).view(n, p, chunk)
    x = F.pad(x, (0, k * step - chunk))
    length = (per_sample - chunk * torch.arange(p, device=dev)).clamp(max=chunk)  # (p,)
    if vec:
        x = x.view(n, p, k, _UNROLL, _THREADS, _VEC)
        first = (torch.arange(k, device=dev)[:, None, None] * step
                 + torch.arange(_UNROLL, device=dev)[:, None] * _THREADS * _VEC
                 + torch.arange(_THREADS, device=dev) * _VEC)  # (k, unroll, threads)
        valid = first < length[:, None, None, None]  # (p, k, unroll, threads): whole vectors
        v = [x[..., j] for j in range(_VEC)]
        tree = ((v[0] + v[1]) + (v[2] + v[3])) + ((v[4] + v[5]) + (v[6] + v[7]))
        total = torch.zeros((n, p, k, _THREADS), dtype=torch.float32, device=dev)
        for u in range(_UNROLL):
            total = torch.where(valid[:, :, u], total + tree[:, :, :, u], total)
        cnt = (valid.sum(dim=2) * _VEC).float().expand(n, p, k, _THREADS)
        m = total / cnt
        m2 = torch.zeros_like(total)
        for u in range(_UNROLL):
            for j in range(_VEC):
                d = x[:, :, :, u, :, j] - m
                m2 = torch.where(valid[:, :, u], _fma(d, d, m2), m2)
        groups = (cnt, m, m2)
    else:
        x = x.view(n, p, k, _THREADS)
        index = torch.arange(k, device=dev)[:, None] * _THREADS + torch.arange(_THREADS,
                                                                                device=dev)
        cnt = (index < length[:, None, None]).float().expand(n, p, k, _THREADS)
        groups = (cnt, x, torch.zeros_like(x))
    s = _zero((n, p, _THREADS), dev)
    for i in range(k):
        s = _merge(s, tuple(t[:, :, i] for t in groups))
    w = _warp_merge(tuple(t.reshape(n, p, _THREADS // 32, 32) for t in s))  # (n, p, warps)
    t = tuple(u[..., 0] for u in w)
    for i in range(1, _THREADS // 32):
        t = _merge(t, tuple(u[..., i] for u in w))
    return t


def _sample_stats(partials):
    """``ln_apply_kernel``'s warp 0: lane l merges partials l, l + 32, ... in
    turn, then the warp merges its lanes; (N, 2) mean and biased variance."""
    n, p = partials[0].shape
    rounds = -(-p // 32)
    padded = tuple(F.pad(t, (0, rounds * 32 - p)).view(n, rounds, 32) for t in partials)
    s = _zero((n, 32), partials[0].device)
    for i in range(rounds):
        s = _merge(s, tuple(t[:, i] for t in padded))
    count, mean, m2 = _warp_merge(s)
    return torch.stack((mean, m2 / count), dim=1)


def ln_stats_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(N, 2) float32: each sample's mean and biased variance as
    :func:`ln_act` computes them on these operands (which decide the
    kernels' form and so their order of sums): what its ``stats`` receives,
    bit for bit."""
    x, channels_last, vec = _layout(x, weight.contiguous(), bias.contiguous(), residual)
    n = x.shape[0]
    flat = (x.permute(0, 2, 3, 1) if channels_last else x).reshape(n, -1).to(torch.float32)
    p, chunk = plan(n, flat.shape[1], vec)
    return _sample_stats(_block_partials(flat, vec, p, chunk))


def ln_act(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5,
           residual: Optional[torch.Tensor] = None, relu: bool = True,
           qscale: Optional[float] = None, *,
           stats: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`ln_act_plain`'s function on (N, C, H, W) x. A CUDA tensor
    launches the two kernels or raises; inside :func:`._build.plain` it
    takes the plain chain on the kernels' statistics
    (:func:`ln_stats_plain`), and a CPU tensor the plain chain. x is
    read in NCHW or channels-last memory (any other layout is made NCHW
    first) and the output keeps x's layout; channels-last x with C % 8 == 0
    is read 8 channels a vector, anything else value by value. The residual
    is read through its own strides. ``stats``, a (N, 2) float32 CUDA
    tensor, receives each sample's mean and biased variance."""
    if not _build.takes_kernel(x, "ln_act"):
        own = ln_stats_plain(x, weight, bias, residual) if x.is_cuda else None
        return ln_act_plain(x, weight, bias, eps, residual, relu, qscale, stats=own)
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
    weight, bias = weight.contiguous(), bias.contiguous()
    x, channels_last, vec = _layout(x, weight, bias, residual)
    out = torch.empty_like(x, dtype=torch.int8 if qscale is not None else x.dtype)
    if x.numel() == 0:
        return out
    per_sample = c * h * w
    res_same = residual is not None and residual.stride() == x.stride()
    vec = vec and _aligned(out)
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
    """Whether these operands are ones the kernel computes as the modules
    do (on a device where :func:`._build.takes_kernel` launches it)."""
    if x.dim() != 4 or x.dtype not in _DTYPES:
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
    one is given: through :func:`ln_act` on the card (the kernel, or inside
    ``plain()`` its twin on the kernel's statistics) or where
    :func:`._build.takes_kernel` launches it, and :func:`engages` allows;
    else through the modules themselves."""
    if (x.is_cuda or _build.takes_kernel(x, "ln_act")) and engages(x, norm, act, residual):
        return ln_act(x, norm.weight, norm.bias, norm.eps, residual, _RELU[act], qscale)
    y = norm(x)
    if residual is not None:
        y = y + residual
    y = act(y)
    return y if qscale is None else quantize_static(y, qscale)
