"""The LayerNorm2d kernel pair's twin (ops/cuda_norm.py): ``ln_stats_plain``
computes the kernels' statistics in PyTorch, so that ``ln_act`` inside
``ops._build.plain()`` computes the kernels' values without them.

On the CPU ``ln_stats_plain`` is held bit for bit to a line-by-line
transcription of ``csrc/layernorm_act.cu``'s loops in numpy float32. The
tests marked ``cuda`` hold the kernels to ``ln_stats_plain`` and to the
twin bit for bit; they skip without a card. Run them there with

    python -m pytest --noconftest tests/test_torch_ln_twin.py -q -m cuda
"""

from fractions import Fraction

import numpy as np
import pytest
import torch

from human_instance_segmentation_tpu_torch.ops import _build, cuda_norm

QSCALE = 3.0 / 127


def _operands(shape, n, dtype, channels_last, seed=0):
    g = torch.Generator().manual_seed(seed)
    c = shape[0]
    x = torch.randn((n, *shape), generator=g) * 2.0 + 0.5
    res = torch.randn((n, *shape), generator=g)
    weight = 1.0 + 0.2 * torch.randn(c, generator=g)
    bias = 0.1 * torch.randn(c, generator=g)
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    x, res = (t.to(dtype).contiguous(memory_format=fmt) for t in (x, res))
    return x, res, weight.to(dtype), bias.to(dtype)


F32 = np.float32


def _round32(exact: Fraction) -> np.float32:
    """The float32 nearest ``exact``, ties to even."""
    r = F32(float(exact))
    near = [np.nextafter(r, F32(-np.inf)), r, np.nextafter(r, F32(np.inf))]
    return min(near, key=lambda c: (abs(Fraction(float(c)) - exact), int(c.view(np.int32)) & 1))


def _fma(a, b, c) -> np.float32:
    """float32 a * b + c rounded once: the float64 sum rounds right unless it
    lands on a float32 midpoint, where the exact value decides."""
    s = float(a) * float(b) + float(c)
    r = F32(s)
    other = np.nextafter(r, F32(np.inf) if s > float(r) else F32(-np.inf))
    if s != float(r) and 2 * s == float(r) + float(other):
        return _round32(Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c)))
    return r


def _merge(a, b):
    if b[0] == 0:
        return a
    if a[0] == 0:
        return b
    n = a[0] + b[0]
    fb = b[0] / n
    delta = b[1] - a[1]
    return n, _fma(delta, fb, a[1]), _fma(delta * delta * a[0], fb, a[2] + b[2])


def _tree(lanes):
    for off in (16, 8, 4, 2, 1):
        lanes = [_merge(lanes[i], lanes[i + off]) for i in range(off)]
    return lanes[0]


def _kernel_stats(flat: np.ndarray, vec: bool, p: int, chunk: int) -> np.ndarray:
    """csrc/layernorm_act.cu's ln_stats_kernel and the statistics of
    ln_apply_kernel, loop for loop, in float32: (N, 2) mean and variance."""
    zero = (F32(0), F32(0), F32(0))
    out = []
    for xs in flat.astype(F32):
        partials = []
        for q in range(p):
            lo, hi = q * chunk, min((q + 1) * chunk, xs.size)
            threads = []
            for t in range(256):
                s = zero
                if vec:
                    for base in range(lo + t * 8, hi, 8192):
                        vs = [xs[base + u * 2048:base + u * 2048 + 8] for u in range(4)
                              if base + u * 2048 < hi]
                        total = F32(0)
                        for v in vs:
                            total += ((v[0] + v[1]) + (v[2] + v[3])) + ((v[4] + v[5]) + (v[6] + v[7]))
                        m = total / F32(8 * len(vs))
                        m2 = F32(0)
                        for v in vs:
                            for j in range(8):
                                m2 = _fma(v[j] - m, v[j] - m, m2)
                        s = _merge(s, (F32(8 * len(vs)), m, m2))
                else:
                    for i in range(lo + t, hi, 256):
                        s = _merge(s, (F32(1), xs[i], F32(0)))
                threads.append(s)
            warps = [_tree(threads[w * 32:(w + 1) * 32]) for w in range(8)]
            block = warps[0]
            for w in warps[1:]:
                block = _merge(block, w)
            partials.append(block)
        lanes = []
        for lane in range(32):
            s = zero
            for q in range(lane, p, 32):
                s = _merge(s, partials[q])
            lanes.append(s)
        n, mean, m2 = _tree(lanes)
        out.append((mean, m2 / n))
    return np.array(out, dtype=F32)


@pytest.mark.parametrize("vec", [True, False], ids=["vec", "scalar"])
@pytest.mark.parametrize("n,per_sample,p,chunk", [(1, 9008, 1, 9008), (1, 2600, 37, 72),
                                                  (2, 4104, 3, 1368)],
                         ids=["two-iterations", "two-rounds", "ragged"])
def test_stats_replay_the_kernels_loops(vec, n, per_sample, p, chunk):
    """The blocks, the threads' iterations (two of a vector form's, ragged
    last groups), the warp trees and the apply kernel's lanes over more than
    32 partials, bit for bit."""
    g = torch.Generator().manual_seed(per_sample)
    flat = (torch.randn((n, per_sample), generator=g) * 3.0 + 1.5).to(torch.bfloat16).float()
    got = cuda_norm._sample_stats(cuda_norm._block_partials(flat, vec, p, chunk))
    assert np.array_equal(got.numpy(), _kernel_stats(flat.numpy(), vec, p, chunk))


@pytest.mark.parametrize("cl", [True, False], ids=["channels-last", "nchw"])
def test_ln_stats_plain_reads_as_the_kernels_do(cl):
    """ln_stats_plain on a map: the kernels' form (vectors for channels-last
    C % 8 == 0) and their plan, over the values in memory order."""
    x, _, weight, bias = _operands((16, 24, 24), 2, torch.float32, cl, seed=2)
    vec = cl
    p, chunk = cuda_norm.plan(2, x[0].numel(), vec)
    assert p > 1
    flat = (x.permute(0, 2, 3, 1) if cl else x).reshape(2, -1).numpy()
    want = _kernel_stats(flat, vec, p, chunk)
    assert np.array_equal(cuda_norm.ln_stats_plain(x, weight, bias).numpy(), want)
    # the statistics of a float64 reference, within float32 rounding
    xd = x.double().reshape(2, -1)
    assert np.allclose(want[:, 0], xd.mean(1).numpy(), rtol=0, atol=1e-6)
    assert np.allclose(want[:, 1], xd.var(1, unbiased=False).numpy(), rtol=1e-6)


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape,cl", [((96, 64, 48), True), ((16, 12, 8), False),
                                      ((7, 5, 3), True), ((256, 20, 15), True)],
                         ids=["vec", "nchw", "ragged-c", "vec-small"])
def test_twin_is_the_kernel_bit_for_bit(card, dtype, shape, cl):
    """On the card, the kernels' statistics equal ln_stats_plain's and
    ln_act inside plain() equals the kernels, residual and int8 out too."""
    x, res, weight, bias = (t.to(card) for t in _operands(shape, 6, dtype, cl, seed=9))
    for residual, qscale in [(None, None), (res, None), (res, QSCALE), (None, QSCALE)]:
        stats = torch.empty((6, 2), dtype=torch.float32, device=card)
        got = cuda_norm.ln_act(x, weight, bias, 1e-5, residual, True, qscale, stats=stats)
        assert cuda_norm.ln_act.last_vec == (cl and shape[0] % 8 == 0)
        assert torch.equal(stats, cuda_norm.ln_stats_plain(x, weight, bias, residual))
        before = cuda_norm.ln_act.launches
        with _build.plain():
            twin = cuda_norm.ln_act(x, weight, bias, 1e-5, residual, True, qscale)
        assert cuda_norm.ln_act.launches == before
        assert torch.equal(got, twin)
