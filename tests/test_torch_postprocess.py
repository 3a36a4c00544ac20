"""The port's post-processing (models/postprocess.py, ops/morphology.py,
ops/cuda_kernels.py) vs the JAX package's, on the same numpy inputs (CPU,
float32).

Float outputs are held to atol 1e-5; binarised outputs must be equal. The
two functions that have a kernel (``bilateral_filter``,
``edge_smooth_binary_mask``) are also held against the JAX package's Pallas
kernels run in interpret mode. On the CPU every wrapper takes its kernel's
plain version; the CUDA kernels themselves are held against those plain
versions on a GPU by ``chip_smoke.py``.
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from human_instance_segmentation_tpu.models import postprocess as jpp
from human_instance_segmentation_tpu.ops import morphology as jmorph
from human_instance_segmentation_tpu.ops.pallas_kernels import (bilateral_filter_pallas,
                                                                edge_smooth_pallas)
from human_instance_segmentation_tpu_torch.models import postprocess as pp
from human_instance_segmentation_tpu_torch.ops import cuda_kernels, morphology
from human_instance_segmentation_tpu_torch.ops._build import plain

ATOL = 1e-5
SHAPES = [(2, 16, 24, 3), (1, 9, 13, 1)]


def _soft(rng, shape):
    return rng.random(shape).astype(np.float32)


def _blobs(rng, shape):
    """A {0, 1} mask of smooth blobs (thresholded low-pass noise) with a few
    flipped pixels: edges of every orientation, speckle, flat regions."""
    b, h, w, c = shape
    coarse = rng.standard_normal((b, h // 4 + 2, w // 4 + 2, c))
    up = np.repeat(np.repeat(coarse, 4, axis=1), 4, axis=2)[:, :h, :w]
    up = (up + np.roll(up, 1, 1) + np.roll(up, 1, 2) + np.roll(up, (1, 1), (1, 2))) / 4
    mask = up > 0
    return (mask ^ (rng.random(shape) < 0.03)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


# name -> (input maker, JAX call, port call, binarised output?)
CASES = {
    "mask_dilation_logit_boost": (
        lambda rng, s: rng.standard_normal(s[:3] + (3,)).astype(np.float32) * 2,
        lambda x: jpp.mask_dilation_logit_boost(x, 1),
        lambda x: pp.mask_dilation_logit_boost(x, 1), False),
    "edge_smooth_binary_mask": (
        _blobs, lambda x: jpp.edge_smooth_binary_mask(x, 0.5, 3.0),
        lambda x: pp.edge_smooth_binary_mask(x, 0.5, 3.0), True),
    "edge_smooth_binary_mask_params": (
        _blobs, lambda x: jpp.edge_smooth_binary_mask(x, 0.4, 1.5),
        lambda x: pp.edge_smooth_binary_mask(x, 0.4, 1.5), True),
    "directional_edge_smooth": (
        _blobs, jpp.directional_edge_smooth, pp.directional_edge_smooth, True),
    "optimized_edge_smooth": (
        _blobs, lambda x: jpp.optimized_edge_smooth(x, "bfloat16"),
        lambda x: pp.optimized_edge_smooth(x, torch.bfloat16), True),
    "optimized_edge_smooth_f32": (
        _blobs, lambda x: jpp.optimized_edge_smooth(x, "float32"),
        lambda x: pp.optimized_edge_smooth(x, torch.float32), True),
    "multiclass_edge_smooth_basic": (
        lambda rng, s: rng.standard_normal(s[:3] + (3,)).astype(np.float32),
        lambda x: jpp.multiclass_edge_smooth(x, 2, "basic"),
        lambda x: pp.multiclass_edge_smooth(x, 2, "basic"), True),
    "multiclass_edge_smooth_directional": (
        lambda rng, s: rng.standard_normal(s[:3] + (3,)).astype(np.float32),
        lambda x: jpp.multiclass_edge_smooth(x, 1, "directional"),
        lambda x: pp.multiclass_edge_smooth(x, 1, "directional"), True),
    "multiclass_edge_smooth_optimized": (
        lambda rng, s: rng.standard_normal(s[:3] + (3,)).astype(np.float32),
        lambda x: jpp.multiclass_edge_smooth(x, 1, "optimized"),
        lambda x: pp.multiclass_edge_smooth(x, 1, "optimized"), True),
    "bilateral_filter_k5": (
        _soft, lambda x: jpp.bilateral_filter(x, 5, 1.0, 0.1),
        lambda x: pp.bilateral_filter(x, 5, 1.0, 0.1), False),
    "bilateral_filter_k7": (
        _soft, lambda x: jpp.bilateral_filter(x, 7, 1.5, 0.2),
        lambda x: pp.bilateral_filter(x, 7, 1.5, 0.2), False),
    "fast_bilateral_filter": (
        _soft, lambda x: jpp.fast_bilateral_filter(x, 5, 1.0, 0.1, 2),
        lambda x: pp.fast_bilateral_filter(x, 5, 1.0, 0.1, 2), False),
    "fast_bilateral_filter_one_pass": (
        _soft, lambda x: jpp.fast_bilateral_filter(x, 3, 0.8, 0.2, 1),
        lambda x: pp.fast_bilateral_filter(x, 3, 0.8, 0.2, 1), False),
    "guided_filter": (
        _soft, lambda x: jpp.guided_filter(x, None, 2, 0.01),
        lambda x: pp.guided_filter(x, None, 2, 0.01), False),
    "binary_mask_bilateral": (
        _soft, lambda x: jpp.binary_mask_bilateral(x, 7, 1.5, 0.5, 2),
        lambda x: pp.binary_mask_bilateral(x, 7, 1.5, 0.5, 2), True),
    "morphological_bilateral": (
        _blobs, lambda x: jpp.morphological_bilateral(x, 5, 1.0, 3),
        lambda x: pp.morphological_bilateral(x, 5, 1.0, 3), True),
    "erode": (
        _soft, lambda x: jmorph.erode(x, 2), lambda x: morphology.erode(x, 2), False),
    "dilate": (
        _soft, lambda x: jmorph.dilate(x, 1), lambda x: morphology.dilate(x, 1), False),
    "avg_pool2d": (
        _soft, lambda x: jmorph.avg_pool2d(x, 3, 1, 1),
        lambda x: morphology.avg_pool2d(x, 3, 1, 1), False),
    "avg_pool2d_strided": (
        _soft, lambda x: jmorph.avg_pool2d(x, 2, 2, 0),
        lambda x: morphology.avg_pool2d(x, 2, 2, 0), False),
}


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_jax(rng, name, shape):
    make, jfn, tfn, binarised = CASES[name]
    x = make(rng, shape)
    ref = np.asarray(jfn(jnp.asarray(x)))
    out = tfn(_t(x))
    assert out.dtype == torch.float32 and tuple(out.shape) == ref.shape
    if binarised:
        assert set(np.unique(ref)) <= {0.0, 1.0}
        np.testing.assert_array_equal(out.numpy(), ref)
    else:
        np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_adaptive_edge_smooth_matches_jax(rng, shape):
    m = _blobs(rng, shape)
    b = shape[0]
    bs = rng.uniform(1, 5, b).astype(np.float32)
    es = rng.uniform(0.5, 2, (b, 1)).astype(np.float32)
    ft = rng.uniform(0.3, 0.7, b).astype(np.float32)
    ref = np.asarray(jpp.adaptive_edge_smooth(*(jnp.asarray(v) for v in (m, bs, es, ft))))
    out = pp.adaptive_edge_smooth(_t(m), _t(bs), _t(es), _t(ft))
    np.testing.assert_array_equal(out.numpy(), ref)


def test_guided_filter_with_guide_matches_jax(rng):
    x, g = _soft(rng, SHAPES[0]), _soft(rng, SHAPES[0])
    ref = np.asarray(jpp.guided_filter(jnp.asarray(x), jnp.asarray(g), 1, 0.05))
    np.testing.assert_allclose(pp.guided_filter(_t(x), _t(g), 1, 0.05).numpy(), ref, atol=ATOL)


@pytest.mark.parametrize("kernels", [True, False])
@pytest.mark.parametrize("shape,k,ss,sr", [((2, 16, 24, 3), 5, 1.0, 0.1),
                                           ((1, 8, 8, 1), 7, 1.5, 0.2)])
def test_bilateral_filter_matches_pallas(rng, shape, k, ss, sr, kernels):
    """The shapes of tests/test_pallas_kernels.py; on the CPU, inside
    ``plain()`` or not, the wrapper computes the plain version and launches
    nothing."""
    x = _soft(rng, shape)
    ref = np.asarray(bilateral_filter_pallas(jnp.asarray(x), k, ss, sr, interpret=True))
    before = cuda_kernels.bilateral_filter.launches
    with contextlib.nullcontext() if kernels else plain():
        out = pp.bilateral_filter(_t(x), k, ss, sr)
    assert cuda_kernels.bilateral_filter.launches == before
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)


@pytest.mark.parametrize("kernels", [True, False])
@pytest.mark.parametrize("shape", [(2, 16, 16, 1), (2, 16, 24, 3)])
def test_edge_smooth_matches_pallas(rng, shape, kernels):
    m = (rng.random(shape) > 0.5).astype(np.float32)
    ref = np.asarray(edge_smooth_pallas(jnp.asarray(m), 0.5, 3.0, interpret=True))
    before = cuda_kernels.edge_smooth.launches
    with contextlib.nullcontext() if kernels else plain():
        out = pp.edge_smooth_binary_mask(_t(m), 0.5, 3.0)
    assert cuda_kernels.edge_smooth.launches == before
    np.testing.assert_array_equal(out.numpy(), ref)


def test_edge_smooth_keeps_mask_dtype(rng):
    m = torch.from_numpy(_blobs(rng, SHAPES[0])).to(torch.bfloat16)
    out = pp.edge_smooth_binary_mask(m)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out.float(), pp.edge_smooth_binary_mask(m.float()))


@pytest.mark.parametrize("fn,args,err", [
    (cuda_kernels.bilateral_filter, (torch.zeros(2, 4, 4), 5), ValueError),       # rank
    (cuda_kernels.bilateral_filter, (torch.zeros(1, 2, 8, 1), 5), ValueError),    # pad >= H
    (cuda_kernels.bilateral_filter, (torch.zeros(1, 8, 8, 1, dtype=torch.int32), 5), TypeError),
    (cuda_kernels.edge_smooth, (torch.zeros(4, 4),), ValueError),
    (cuda_kernels.edge_smooth, (torch.zeros(1, 4, 4, 1, dtype=torch.int64),), TypeError),
])
def test_kernel_wrappers_reject(fn, args, err):
    with pytest.raises(err):
        fn(*args)


@pytest.mark.parametrize("fn", [cuda_kernels.bilateral_filter, cuda_kernels.edge_smooth])
def test_no_plain_fallback_off_the_cpu(fn):
    """A tensor that is neither on the CPU nor on a CUDA device never
    reaches the plain version through the wrapper."""
    with pytest.raises(RuntimeError, match="no kernel for device"):
        fn(torch.zeros(1, 8, 8, 1, device="meta"))


@pytest.mark.parametrize("k,ss,sr", [(4, 1.0, 0.1), (0, 1.0, 0.1), (-3, 1.0, 0.1),
                                     (5, 0.0, 0.1), (5, 1.0, -0.2), (5, float("nan"), 0.1)])
def test_bilateral_kernel_rejects_bad_arguments(k, ss, sr):
    """What the CUDA kernel is never given: an even or non-positive window,
    a sigma that is not positive."""
    with pytest.raises(ValueError):
        cuda_kernels.bilateral_rates(k, ss, sr)


def _kernel_emulation(plane, k, ss, sr):
    """csrc/bilateral.cu on one float32 plane, step by step: its blocks, bands
    and lanes (a numpy vector over the 32 lanes of a warp), the staged tile
    with its halo lanes and clamped reflect, the pairs each pixel computes
    and the weights handed on by ``__shfl_up_sync``; ``np.exp2`` for
    ``ex2.approx``. Each pixel must be stored exactly once."""
    lanes_n, bands, rows = 32, 4, 8
    f32 = np.float32
    a_s, a_r = (f32(a) for a in cuda_kernels.bilateral_rates(k, ss, sr))
    q = np.sqrt(a_r, dtype=f32)
    h, w = plane.shape
    kk = k if k in (3, 5, 7, 9) else 0  # the unrolled instantiations
    hl, pad = kk // 2, k // 2
    ow, th = lanes_n - hl, bands * rows
    out = np.zeros((h, w), f32)
    stores = np.zeros((h, w), int)
    lane = np.arange(lanes_n)

    def reflect(i, n):
        i = np.where(i < 0, -i, i)
        return np.where(i >= n, 2 * n - 2 - i, i)

    def weight(v, c, s):
        d = v - c
        return np.exp2(f32(s) - d * d).astype(f32)

    for y0 in range(0, h, th):
        for x0 in range(0, w, ow):
            gx = reflect(np.clip(x0 - hl + np.arange(lanes_n + 2 * pad) - pad, -pad, w - 1 + pad), w)
            gy = reflect(np.minimum(y0 + np.arange(th + 2 * pad) - pad, h - 1 + pad), h)
            tile = (q * plane[np.ix_(gy, gx)]).astype(f32)
            for r0 in range(0, th, rows):
                def col(i, o):  # band row i - pad, column offset o, every lane
                    return tile[r0 + i, lane + pad + o]

                centre = [col(r + pad, 0) for r in range(rows)]
                num = [c.copy() for c in centre]
                den = [np.ones(lanes_n, f32) for _ in range(rows)]

                def add(wt, v, r):
                    num[r] = (num[r] + wt * v).astype(f32)
                    den[r] = (den[r] + wt).astype(f32)

                if kk:
                    p = kk // 2
                    sd = [-m * a_s for m in range(2 * p * p + 1)]
                    c = [col(i, 0) for i in range(rows + 2 * p)]
                    for r in range(rows):
                        for di in range(1, p + 1):
                            wt = weight(c[r + p + di], centre[r], sd[di * di])
                            add(wt, c[r + p + di], r)
                            if r + di < rows:
                                add(wt, centre[r], r + di)
                            if r - di < 0:
                                add(weight(c[r + p - di], centre[r], sd[di * di]), c[r + p - di], r)
                    for dj in range(1, p + 1):
                        a = [col(i, dj) for i in range(rows + 2 * p)]
                        b = [col(i, -dj) for i in range(rows + 2 * p)]
                        for r in range(rows):
                            for di in range(-p, p + 1):
                                s = sd[di * di + dj * dj]
                                wt = weight(a[r + p + di], centre[r], s)
                                add(wt, a[r + p + di], r)
                                given = np.concatenate([wt[:dj], wt[:-dj]])  # shfl_up by dj
                                if 0 <= r + di < rows:
                                    add(given, b[r + p], r + di)
                                if not 0 <= r - di < rows:
                                    add(weight(b[r + p - di], centre[r], s), b[r + p - di], r)
                else:
                    for dj in range(-pad, pad + 1):
                        for di in range(-pad, pad + 1):
                            if di or dj:
                                s = -f32(di * di + dj * dj) * a_s
                                for r in range(rows):
                                    v = col(r + pad + di, dj)
                                    add(weight(v, centre[r], s), v, r)
                for ln in range(hl, lanes_n):
                    x = x0 - hl + ln
                    for r in range(rows):
                        y = y0 + r0 + r
                        if x < w and y < h:
                            out[y, x] = num[r][ln] / (den[r][ln] + f32(1e-8)) * (f32(1) / q)
                            stores[y, x] += 1
    assert (stores == 1).all()
    return out


@pytest.mark.parametrize("shape", [(37, 61), (6, 13)], ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("k,ss,sr", [(3, 0.8, 0.05), (5, 1.0, 0.1), (7, 1.5, 0.2), (9, 2.0, 0.3),
                                     (11, 3.0, 0.5)])
def test_bilateral_kernel_arithmetic_matches_plain(rng, shape, k, ss, sr):
    """The kernel's design, emulated on the CPU (the folded exponent, the
    pair weights computed once and handed between lanes, the halo lanes,
    the tiling and the summation order), stays within the 1e-5 the card
    holds the kernel to: at every unrolled k and a generic one (11), on a
    plane of several blocks and bands and on one narrower than a block."""
    x = _soft(rng, (1, *shape, 1))
    ref = cuda_kernels.bilateral_filter_plain(_t(x), k, ss, sr).numpy()[0, ..., 0]
    np.testing.assert_allclose(_kernel_emulation(x[0, ..., 0], k, ss, sr), ref, atol=ATOL)
    a_s, a_r = cuda_kernels.bilateral_rates(k, ss, sr)
    assert a_s == pytest.approx(np.log2(np.e) / (2 * ss ** 2), rel=1e-12)
    assert a_r == pytest.approx(np.log2(np.e) / (2 * sr ** 2), rel=1e-12)


# the edge-smoothing kernel's output rows a warp: kRows in csrc/postprocess.cu
_EDGE_ROWS = 2


def _edge_kernel_emulation(planes, vec, strength, threshold):
    """csrc/postprocess.cu on float32 planes (P, H, W), step by step: one warp
    a work item (plane, strip of ``_EDGE_ROWS`` rows, segment of 32 * vec
    columns), a numpy vector over its 32 lanes, each lane on ``vec``
    adjacent columns; the strip and its two halo rows loaded with zeros off
    the plane, the neighbour columns handed on by
    ``__shfl_up_sync`` / ``__shfl_down_sync`` with lanes 0 and 31 loading
    their own, the kernel's float32 arithmetic in its grouping. Returns the
    thresholded planes and the blend before the threshold; each pixel must
    be stored exactly once."""
    f32 = np.float32
    p_n, h, w = planes.shape
    rows, seg_w = _EDGE_ROWS, 32 * vec
    if vec == 4:
        assert w % 4 == 0  # what the wrapper checks before it picks four columns
    segs, strips = -(-w // seg_w), -(-h // rows)
    out = np.zeros(planes.shape, f32)
    blend = np.zeros(planes.shape, f32)
    stores = np.zeros(planes.shape, int)
    lane = np.arange(32)
    zero = np.zeros(32, f32)
    strength, threshold = f32(strength), f32(threshold)
    for item in range(p_n * strips * segs):
        seg, rest = item % segs, item // segs
        y0, p = (rest % strips) * rows, rest // strips
        xs = seg * seg_w
        x0 = xs + lane * vec
        hx = np.where(lane == 0, xs - 1, xs + seg_w)
        edge_lane = ((lane == 0) & (hx >= 0)) | ((lane == 31) & (hx < w))
        v, left, right = [], [], []
        for i in range(rows + 2):
            y = y0 - 1 + i
            row_ok = 0 <= y < h
            cols = [np.where(row_ok & (x0 < w), planes[p, y % h, np.minimum(x0 + j, w - 1)], zero)
                    for j in range(vec)]
            halo = np.where(edge_lane & row_ok, planes[p, y % h, np.clip(hx, 0, w - 1)], zero)
            v.append(cols)
            left.append(np.concatenate([halo[:1], cols[-1][:-1]]))   # shfl_up by 1
            right.append(np.concatenate([cols[0][1:], halo[31:]]))   # shfl_down by 1
        for r in range(rows):
            y = y0 + r
            if y >= h:
                break
            for j in range(vec):
                def at(i, dj):
                    k = j + dj
                    return left[i] if k < 0 else right[i] if k == vec else v[i][k]

                c = v[r + 1][j]
                corners = (at(r, -1) + at(r, 1)) + (at(r + 2, -1) + at(r + 2, 1))
                sides = (v[r][j] + at(r + 1, -1)) + (at(r + 1, 1) + v[r + 2][j])
                edges = np.abs(f32(8) * c - (corners + sides))
                ew = f32(1) / (f32(1) + np.exp(-(edges * strength)))
                blurred = ((corners + f32(2) * sides) + f32(4) * c) * f32(1 / 16)
                smoothed = c * (f32(1) - ew) + blurred * ew
                ok = x0 < w  # the lanes that store
                xo = x0[ok] + j
                out[p, y, xo] = (smoothed[ok] > threshold).astype(f32)
                blend[p, y, xo] = smoothed[ok]
                stores[p, y, xo] += 1
    assert (stores == 1).all()
    return out, blend


def _edge_blend_f64(planes, strength):
    """The blend before the threshold in float64, straight from the
    definition: zero padding, the 3x3 Laplacian's magnitude, the 1-2-1 blur."""
    x = np.pad(planes.astype(np.float64), ((0, 0), (1, 1), (1, 1)))
    h, w = planes.shape[1:]

    def tap(di, dj):
        return x[:, 1 + di:1 + di + h, 1 + dj:1 + dj + w]

    corners = tap(-1, -1) + tap(-1, 1) + tap(1, -1) + tap(1, 1)
    sides = tap(-1, 0) + tap(0, -1) + tap(0, 1) + tap(1, 0)
    c = tap(0, 0)
    ew = 1 / (1 + np.exp(-np.abs(8 * c - corners - sides) * strength))
    return c * (1 - ew) + (corners + 2 * sides + 4 * c) / 16 * ew


@pytest.mark.parametrize("vec,shape", [
    (4, (2, 19, 132)),   # two segments, the second 4 columns wide; a ragged strip
    (4, (3, 16, 8)),     # strips ending on the plane's last row; lanes 2-31 off the plane
    (4, (1, 5, 256)),    # two full segments; H = 5
    (4, (2, 1, 64)), (1, (1, 1, 5)),                   # H = 1, shorter than any strip
    (1, (1, 9, 1)), (1, (2, 7, 3)), (1, (1, 17, 5)),   # W narrower than a warp
    (1, (1, 11, 127)), (1, (1, 8, 129)),           # segment edges at 32 columns
], ids=lambda s: "x".join(map(str, s)) if isinstance(s, tuple) else f"vec{s}")
@pytest.mark.parametrize("strength,threshold", [(3.0, 0.5), (1.5, 0.4)])
def test_edge_smooth_kernel_layout_matches_plain(rng, vec, shape, strength, threshold):
    """The edge-smoothing kernel's schedule, emulated on the CPU (strips and
    their halo rows, the lanes' columns, the neighbour columns handed on by
    shuffles and loaded by the edge lanes, zero padding by global
    coordinate), equals ``edge_smooth_plain`` bit for bit on binary masks of
    the shapes the card checks it at, in both instantiations; and its blend
    before the threshold is the definition's, so a misjudged neighbour
    shows even where the threshold would hide it."""
    masks = [(rng.random(shape) > 0.5).astype(np.float32)]
    if shape[1] >= 4 and shape[2] >= 4:
        masks.append(_blobs(rng, (*shape, 1))[..., 0])
    for m in masks:
        got, blend = _edge_kernel_emulation(m, vec, strength, threshold)
        ref = cuda_kernels.edge_smooth_plain(_t(m[..., None]), threshold, strength).numpy()
        np.testing.assert_array_equal(got, ref[..., 0])
        np.testing.assert_allclose(blend, _edge_blend_f64(m, strength), rtol=0, atol=1e-6)


def test_edge_smooth_vec_picks_the_form(rng):
    """Four columns a lane only for a width that is a multiple of 4 and
    planes that start on 16 bytes."""
    flat = torch.zeros(4 * 6 * 8 + 1)
    planes = flat[:-1].view(4, 6, 8)
    out = torch.empty_like(planes)
    assert cuda_kernels.edge_smooth_vec(planes, out) == 4
    assert cuda_kernels.edge_smooth_vec(flat[1:].view(4, 6, 8), out) == 1   # 4-byte offset
    assert cuda_kernels.edge_smooth_vec(torch.zeros(4, 6, 10), torch.zeros(4, 6, 10)) == 1
