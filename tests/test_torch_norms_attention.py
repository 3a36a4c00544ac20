"""The port's norm/activation/attention zoo and the stage-2 refinement heads
against the JAX package's modules (CPU, float32, JAX under
``jax.default_matmul_precision("highest")``, inputs from a numpy seed,
the same weights through ``weights.from_jax_params``).

Tolerances: forwards within rtol 1e-4 / atol 1e-5. Running statistics
within atol 1e-6, except where a variance goes through flax's fast
variance ``E[x^2] - E[x]^2`` (BatchNorm, GroupNorm): there the two
packages' float32 sums of squares differ in their last bits, and the
cancellation makes that an absolute error of about ``|E[x^2]| * 2^-23``
per sum, so those variances are held within atol 1e-6 + rtol 1e-5 of
flax's. A bf16 BatchNorm step's statistics are held within that of the
statistics JAX computes from the same bf16 input.

Gradients (``test_*_gradient_matches_jax``): of ``sum(out * w)`` for a
fixed random ``w``, with respect to every input and every parameter,
``jax.grad`` against autograd, both in float64 (``jax.enable_x64``, the
port module ``.double()``), within rtol 1e-4 / atol 1e-5. The norms run in
train mode, so the batch statistics' own gradients and every
``stop_gradient`` / ``detach`` are held. Float64, because in float32 a
conv weight's gradient, a sum over every pixel, differs between the two
packages' summation orders by up to 1.7e-5 (``progressive``,
``v2_attention``); the heads take GroupNorm there, since LayerNorm2d
computes its statistics in float32 in both packages even in float64.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import fast_init
from human_instance_segmentation_tpu.models import blocks as jblocks
from human_instance_segmentation_tpu.models import heads as jheads
from human_instance_segmentation_tpu.ops import activations as jact
from human_instance_segmentation_tpu.ops import attention as jatt
from human_instance_segmentation_tpu.ops import norms as jnorms
from human_instance_segmentation_tpu_torch.models import blocks as pblocks
from human_instance_segmentation_tpu_torch.models import heads as pheads
from human_instance_segmentation_tpu_torch.ops import activations as pact
from human_instance_segmentation_tpu_torch.ops import attention as patt
from human_instance_segmentation_tpu_torch.ops import norms as pnorms
from human_instance_segmentation_tpu_torch.weights import from_jax_params, load_jax_params

RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(x), (0, 3, 1, 2))))


def nhwc(t):
    return np.transpose(t.detach().float().numpy(), (0, 2, 3, 1))


def _x(shape, seed=0, scale=1.0, shift=0.3):
    return (scale * np.random.default_rng(seed).standard_normal(shape) + shift).astype(np.float32)


def _perturbed(variables, seed=11):
    """Norm affines away from 1/0, so a mis-mapped scale or bias shows."""
    rng = np.random.default_rng(seed)

    def f(path, leaf):
        leaf = np.asarray(leaf)
        name = str(getattr(path[-1], "key", path[-1]))
        if path[0].key == "params" and name in ("scale", "bias"):
            return leaf + (0.2 * rng.standard_normal(leaf.shape)).astype(leaf.dtype)
        return leaf

    return jax.tree_util.tree_map_with_path(f, variables)


def _jax(module, variables, *args, train=None, mutable=False, **kw):
    if train is not None:
        kw["train"] = train
    with jax.default_matmul_precision("highest"):
        out = module.apply(variables, *[jnp.asarray(a) for a in args], mutable=mutable, **kw)
    return jax.tree.map(np.asarray, out)


# ---------------------------------------------------------------------------
# activations and pixel_shuffle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,beta", [("relu", 1.0), ("silu", 1.0), ("swish", 1.0),
                                       ("swish", 1.7), ("gelu", 1.0), ("sigmoid", 1.0),
                                       ("tanh", 1.0), ("identity", 1.0), ("none", 1.0),
                                       ("linear", 1.0)])
def test_activation_matches_jax(name, beta):
    x = _x((4, 33), seed=1, scale=3.0)
    want = np.asarray(jact.get_activation(name, beta)(jnp.asarray(x)))
    got = pact.get_activation(name, beta)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(pact.swish(torch.from_numpy(x), beta).numpy(),
                               np.asarray(jact.swish(jnp.asarray(x), beta)), rtol=1e-6, atol=1e-6)


def test_unknown_activation_raises():
    with pytest.raises(ValueError, match="Unsupported"):
        pact.get_activation("mish")


@pytest.mark.parametrize("r", [2, 3])
def test_pixel_shuffle_matches_jax(r):
    x = _x((2, 3, 5, 2 * r * r), seed=2)
    want = np.asarray(jblocks.pixel_shuffle(jnp.asarray(x), r))
    got = nhwc(pblocks.pixel_shuffle(nchw(x), r))
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

NORMS = ["layernorm2d", "batchnorm", "instance", "groupnorm", "spatial_group",
         "adaptive_instance", "foreground_aware", "mixed"]


def _norm_pair(norm_type, channels, groups, init_train):
    jm = jnorms.get_normalization(norm_type, channels, groups)
    x0 = jnp.zeros((2, 4, 4, channels))
    v = jm.init(jax.random.PRNGKey(0), x0, train=init_train) if init_train else fast_init(
        jm, x0, train=False, seed=3)
    v = _perturbed(jax.tree.map(np.asarray, v))
    pm = pnorms.get_normalization(norm_type, channels, groups)
    load_jax_params(pm, v)
    return jm, v, pm


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("norm_type", NORMS)
def test_norm_matches_jax(norm_type, train):
    """Forward in eval and train mode, and the running statistics a train
    step leaves (BatchNorm at flax's momentum 0.9 with the biased fast
    variance, AdaptiveInstanceNorm2d at 0.1)."""
    c = 12
    jm, v, pm = _norm_pair(norm_type, c, 8, init_train=norm_type == "mixed")
    x = _x((3, 5, 6, c), seed=4, scale=1.5)
    mutable = ["batch_stats"] if train and "batch_stats" in v else False
    out = _jax(jm, v, x, train=train, mutable=mutable)
    want, new_vars = out if mutable else (out, None)
    pm.train(train)
    with pnorms.deferred_running_stats() as collected:
        got = pm(nchw(x))
    np.testing.assert_allclose(nhwc(got), want, rtol=RTOL, atol=ATOL)
    stats = pnorms.running_stat_modules(pm)
    if not train or not stats:
        assert not collected
        return
    port_new = {}
    for (m, name), value in collected.items():
        prefix = next(k for k, mm in pm.named_modules() if mm is m)
        port_new[f"{prefix}.{name}".lstrip(".")] = value
    want_state = from_jax_params({"batch_stats": new_vars["batch_stats"]})
    assert set(port_new) == set(want_state)
    for k, w in want_state.items():
        rtol = 1e-5 if k.endswith("running_var") and norm_type != "adaptive_instance" else 0
        np.testing.assert_allclose(port_new[k].numpy(), w.numpy(), rtol=rtol, atol=1e-6,
                                   err_msg=k)


def test_running_stats_written_without_a_collector():
    """Outside ``deferred_running_stats`` a train-mode forward writes the
    buffers in place (bumping their version, which the fused kernels' weight
    caches key on); eval mode leaves them."""
    bn = pnorms.BatchNorm2d(4)
    x = torch.from_numpy(_x((2, 4, 3, 3), seed=5))
    version = bn.running_mean._version
    bn.eval()(x)
    assert bn.running_mean._version == version and not bn.running_mean.any()
    bn.train()(x)
    assert bn.running_mean._version > version
    np.testing.assert_allclose(bn.running_mean.numpy(), 0.1 * x.mean(dim=(0, 2, 3)).numpy(),
                               rtol=1e-6, atol=1e-7)


def test_batchnorm_bf16_running_update_matches_flax():
    """A bf16 forward over bf16 copies of the statistics (the bf16 train
    step's): the output and flax's update ``0.9 * bf16(running) + 0.1 *
    batch`` in float32."""
    c = 8
    jm = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    x = _x((4, 5, 5, c), seed=6)
    v = _perturbed(jax.tree.map(np.asarray, fast_init(jm, jnp.zeros((1, 5, 5, c)), seed=4)))
    vb = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), v)
    xb = jnp.asarray(x, jnp.bfloat16)
    want, new = jm.apply(vb, xb, mutable=["batch_stats"])
    pm = pnorms.BatchNorm2d(c)
    load_jax_params(pm, v)
    pm.bfloat16().train()  # the bf16 copies the step's forward reads
    with pnorms.deferred_running_stats() as collected:
        got = pm(nchw(np.asarray(xb.astype(jnp.float32))).bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(nhwc(got), np.asarray(want.astype(jnp.float32)), rtol=1e-2,
                               atol=1e-2)
    for name, key in (("running_mean", "mean"), ("running_var", "var")):
        value = collected[(pm, name)]
        assert value.dtype == torch.float32  # flax's bf16 * 0.9 + f32 term is float32
        np.testing.assert_allclose(value.numpy(), np.asarray(new["batch_stats"][key]),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("channels,groups,want_groups", [(12, 8, 4), (6, 8, 2), (7, 8, 1),
                                                         (16, 8, 8), (32, 4, 4)])
def test_group_fallback(channels, groups, want_groups):
    """GroupNorm's divisor fallback 8 -> 4 -> 2 -> 1, and the forward at it."""
    assert jnorms._group_fallback(channels, groups) == want_groups
    assert pnorms._group_fallback(channels, groups) == want_groups
    jm, v, pm = _norm_pair("groupnorm", channels, groups, init_train=False)
    assert pm.GroupNorm_0.num_groups == want_groups
    x = _x((2, 3, 4, channels), seed=7)
    np.testing.assert_allclose(nhwc(pm(nchw(x))), _jax(jm, v, x), rtol=RTOL, atol=ATOL)


def test_unknown_norm_raises():
    with pytest.raises(ValueError, match="Unknown normalization"):
        pnorms.get_normalization("weightnorm", 8)


def test_mixed_norm_initialised_for_eval():
    """The JAX ``MixedNormalization`` initialised for eval has no
    ``InstanceNorm2d_0`` parameters; ``from_jax_params`` fills the port's at
    flax's initial values, which is what a train-mode init gives."""
    jm = jnorms.get_normalization("mixed", 8)
    v_eval = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 3, 3, 8))))
    v_train = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 3, 3, 8)),
                                               train=True))
    assert "InstanceNorm2d_0" not in v_eval["params"]
    assert "InstanceNorm2d_0" in v_train["params"]
    pm = pnorms.get_normalization("mixed", 8)
    got = from_jax_params(v_eval, pm)
    want = from_jax_params(v_train, pm)
    assert set(got) == set(want)
    for k in got:
        assert torch.equal(got[k], want[k]), k


def test_foreground_detector_reads_detached_input():
    """No gradient reaches x through the foreground detector, as JAX's
    ``stop_gradient``: x's gradient equals that of the same norm whose
    detector output is a constant."""
    pm = pnorms.ForegroundAwareNorm(8)
    x = nchw(_x((2, 5, 5, 8), seed=8)).requires_grad_()
    (pm(x) ** 2).sum().backward()
    g = x.grad.clone()
    x2 = x.detach().clone().requires_grad_()
    fg = torch.sigmoid(pm.Conv_1(torch.relu(pm.Conv_0(x2.detach()))))
    mean = x2.mean(dim=(2, 3), keepdim=True)
    var = (x2 - mean).square().mean(dim=(2, 3), keepdim=True)
    y = (x2 - mean) * torch.rsqrt(var + 1e-5)
    c = lambda p: p[:, None, None]  # noqa: E731
    out = y * (fg * c(pm.fg_scale) + (1 - fg) * c(pm.bg_scale)) + (
        fg * c(pm.fg_bias) + (1 - fg) * c(pm.bg_bias))
    (out ** 2).sum().backward()
    np.testing.assert_allclose(g.numpy(), x2.grad.numpy(), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def _module_pair(jm, pm, *example, seed=3, **kw):
    v = _perturbed(jax.tree.map(np.asarray, fast_init(jm, *[jnp.zeros(e.shape) for e in example],
                                                      seed=seed, **kw)))
    load_jax_params(pm, v)
    return v


def _attention_case(kind):
    """(JAX module, port module, inputs) of one attention module."""
    c = 24
    x = _x((2, 6, 5, c), seed=9)
    args = (x,)
    if kind.startswith("channel"):
        act = "swish" if kind == "channel_swish" else "relu"
        jm = jatt.ChannelAttention(activation=act, activation_beta=1.5)
        pm = patt.ChannelAttention(c, activation=act, activation_beta=1.5)
    elif kind.startswith("spatial"):
        k = 3 if kind == "spatial_k3" else 7
        jm, pm = jatt.SpatialAttention(kernel_size=k), patt.SpatialAttention(k)
    elif kind == "cbam":
        jm, pm = jatt.CBAM(reduction_ratio=4), patt.CBAM(c, reduction_ratio=4)
    else:
        g = _x((2, 3, 3, 10) if kind == "gate_resized" else (2, 6, 5, 10), seed=10)
        jm, pm = jatt.AttentionGate(), patt.AttentionGate(c, 10)
        args = (x, g)
    return jm, pm, args


ATTENTION = ["channel", "channel_swish", "spatial", "spatial_k3", "cbam", "gate", "gate_resized"]


@pytest.mark.parametrize("kind", ATTENTION)
def test_attention_matches_jax(kind):
    jm, pm, args = _attention_case(kind)
    v = _module_pair(jm, pm, *args)
    want = _jax(jm, v, *args)
    with torch.no_grad():
        got = pm(*[nchw(a) for a in args])
    np.testing.assert_allclose(nhwc(got), want, rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# the new heads
# ---------------------------------------------------------------------------

HEAD_KW = dict(norm="layernorm2d", norm_groups=8, activation="relu", activation_beta=1.0)


def _head_case(kind, norm="layernorm2d"):
    """(JAX module, port module, inputs, JAX call kwargs), the heads' norm
    ``norm`` (``boundary_groupnorm`` takes GroupNorm whatever it is)."""
    HEAD_KW = dict(globals()["HEAD_KW"], norm=norm)
    if kind.startswith("boundary"):
        norm = "groupnorm" if kind == "boundary_groupnorm" else "layernorm2d"
        kw = dict(HEAD_KW, norm=norm)
        x = _x((3, 12, 10, 3), seed=12, scale=2.0)
        return (jheads.BoundaryRefinement(**kw), pheads.BoundaryRefinement(3, **kw), (x,), {})
    if kind == "progressive":
        x = _x((2, 6, 5, 16), seed=13)
        return (jheads.ProgressiveUpsamplingDecoder(**HEAD_KW),
                pheads.ProgressiveUpsamplingDecoder(16, **HEAD_KW), (x,),
                {"target_hw": (24, 20)})
    if kind == "progressive_resized":
        x = _x((2, 6, 5, 16), seed=13)
        return (jheads.ProgressiveUpsamplingDecoder(**HEAD_KW),
                pheads.ProgressiveUpsamplingDecoder(16, **HEAD_KW), (x,),
                {"target_hw": (16, 12)})
    if kind == "subpixel":
        x = _x((2, 6, 5, 16), seed=14)
        return jheads.SubPixelDecoder(), pheads.SubPixelDecoder(16), (x,), {}
    if kind == "v2_attention":
        x = _x((2, 8, 6, 16), seed=15)
        kw = dict(mid_channels=32, mask_size=(16, 12), base_channels=8, depth=2,
                  use_attention_module=True, dropout_rate=0.0)
        return (jheads.HierarchicalHeadV2(**kw, **HEAD_KW),
                pheads.HierarchicalHeadV2(16, **kw, **HEAD_KW), (x,), {})
    att = kind.endswith("attention")
    x = _x((2, 6, 5, 16), seed=16)
    mask = _x((2, 6, 5, 2) if "mask2" in kind else (2, 3, 3, 1), seed=17, scale=2.0)
    kw = dict(mid_channels=32, mask_size=(12, 10), use_attention_module=att, dropout_rate=0.0)
    return (jheads.PretrainedUNetGuidedHead(**kw, **HEAD_KW),
            pheads.PretrainedUNetGuidedHead(16, **kw, **HEAD_KW), (x, mask), {})


HEADS = ["boundary", "boundary_groupnorm", "progressive", "progressive_resized", "subpixel",
         "v2_attention", "guided_mask2", "guided_mask1", "guided_mask2_attention"]


@pytest.mark.parametrize("kind", HEADS)
def test_head_matches_jax(kind):
    jm, pm, args, kw = _head_case(kind)
    v = _module_pair(jm, pm, *args, seed=5, **kw)
    kwargs = dict(kw)
    if "train" in jm.__call__.__code__.co_varnames:
        kwargs["train"] = False
    with jax.default_matmul_precision("highest"):
        want = jm.apply(v, *[jnp.asarray(a) for a in args], **kwargs)
    pm.eval()
    with torch.no_grad():
        got = pm(*[nchw(a) for a in args], *kw.values())
    if isinstance(want, tuple):
        want_logits, want_aux = jax.tree.map(np.asarray, want)
        got_logits, got_aux = got
        assert set(got_aux) == set(want_aux)
        for k, w in want_aux.items():
            np.testing.assert_allclose(nhwc(got_aux[k]), w, rtol=RTOL, atol=ATOL, err_msg=k)
    else:
        want_logits, got_logits = np.asarray(want), got
    np.testing.assert_allclose(nhwc(got_logits), want_logits, rtol=RTOL, atol=ATOL)


def test_boundary_refinement_flat_logits():
    """A batch with no edge at all (constant logits): the edge map is zero,
    so the logits come back unchanged, as in JAX."""
    jm, pm, _, _ = _head_case("boundary")
    x = np.full((2, 6, 5, 3), 0.7, np.float32)
    v = _module_pair(jm, pm, x, seed=6)
    with torch.no_grad():
        got = nhwc(pm(nchw(x)))
    np.testing.assert_array_equal(got, _jax(jm, v, x, train=False))
    np.testing.assert_array_equal(got, x)


def test_boundary_refinement_gradient_at_ties():
    """ROADMAP C9: where neighbouring probabilities tie in both directions
    (a flat patch, common in bf16), the edge magnitude's gradient is 0, not
    the NaN of ``sqrt``'s at 0 that makes JAX's step skip; elsewhere the
    gradient is plain ``torch.sqrt``'s."""
    pm = pheads.BoundaryRefinement(3, **HEAD_KW)
    x = nchw(_x((2, 8, 6, 3), seed=18, scale=2.0))
    x[:, :, 2:6, 1:5] = 0.25  # a flat patch: dy = dx = 0 there
    for flat in (True, False):
        noise = 0.01 * torch.randn(x.shape, generator=torch.Generator().manual_seed(0))
        xi = (x if flat else x + noise).clone().requires_grad_()
        pm(xi).square().sum().backward()
        assert torch.isfinite(xi.grad).all()
        with torch.no_grad():
            assert torch.equal(pm(xi), _plain_sqrt_refinement(pm, xi))
        xj = xi.detach().clone().requires_grad_()
        _plain_sqrt_refinement(pm, xj).square().sum().backward()
        if flat:
            assert not torch.isfinite(xj.grad).all()
        else:
            np.testing.assert_allclose(xi.grad.numpy(), xj.grad.numpy(), rtol=1e-6, atol=1e-7)


def _plain_sqrt_refinement(pm, x):
    """BoundaryRefinement's forward with ``torch.sqrt`` as the JAX module
    writes it."""
    probs = torch.softmax(x, dim=1)
    dy = (probs[:, :, 1:] - probs[:, :, :-1]).abs()
    dx = (probs[:, :, :, 1:] - probs[:, :, :, :-1]).abs()
    dy = torch.cat([dy, dy[:, :, -1:]], dim=2)
    dx = torch.cat([dx, dx[:, :, :, -1:]], dim=3)
    edges = torch.sqrt(dy ** 2 + dx ** 2).mean(dim=1, keepdim=True)
    emin, emax = edges.amin(), edges.amax()
    edges = torch.where(emax - emin < 1e-6, torch.zeros_like(edges),
                        (edges - emin) / (emax - emin + 1e-6))
    h = pm.act(pm.edge_norm0(pm.edge0(x)))
    h = pm.act(pm.edge_norm1(pm.edge1(h)))
    return x + pm.blend_weight * pm.edge_out(h) * edges


# ---------------------------------------------------------------------------
# gradients
# ---------------------------------------------------------------------------

def _gradient_parity(jm, v, pm, args, kw=None, train=None, seed=31):
    """``jax.grad`` of ``sum(out * w)`` (``w`` fixed random, out the logits
    where the module returns ``(logits, aux)``) against autograd of the same
    in the port, in float64: every input's gradient and every parameter's,
    by the port's names."""
    kw = dict(kw or {})
    jkw = dict(kw)
    if train is not None:
        jkw["train"] = train
    mutable = ["batch_stats"] if train and "batch_stats" in v else False
    pm.double().train(bool(train))
    xs = [nchw(a).double().requires_grad_() for a in args]
    with pnorms.deferred_running_stats():
        out = pm(*xs, *kw.values())
    y = out[0] if isinstance(out, tuple) else out
    w = np.random.default_rng(seed).standard_normal(y.shape)
    named = [(n, p) for n, p in pm.named_parameters()]
    found = torch.autograd.grad((y * torch.from_numpy(w)).sum(), xs + [p for _, p in named],
                                allow_unused=True)

    def f(params, *inputs):
        res = jm.apply(dict(v64, params=params), *inputs, mutable=mutable, **jkw)
        res = res[0] if mutable else res
        res = res[0] if isinstance(res, tuple) else res
        return jnp.sum(res * jnp.asarray(np.transpose(w, (0, 2, 3, 1))))

    f64 = lambda t: jax.tree.map(lambda a: np.asarray(a, np.float64), t)  # noqa: E731
    v64 = f64(v)
    with jax.enable_x64(True), jax.default_matmul_precision("highest"):
        grads = jax.jit(jax.grad(f, argnums=tuple(range(1 + len(args)))))(
            v64["params"], *[jnp.asarray(a, jnp.float64) for a in args])
    grads = jax.tree.map(np.asarray, grads)
    for i, (g_port, g_jax) in enumerate(zip(found[:len(xs)], grads[1:])):
        assert g_port is not None, f"input {i}"
        np.testing.assert_allclose(np.transpose(g_port.numpy(), (0, 2, 3, 1)), g_jax,
                                   rtol=RTOL, atol=ATOL, err_msg=f"input {i}")
    want = from_jax_params({"params": grads[0]})
    assert {n for n, _ in named} == set(want)
    assert any(np.abs(g.numpy()).max() > 1e-3 for g in want.values())
    for (name, _), g in zip(named, found[len(xs):]):
        got = np.zeros(want[name].shape) if g is None else g.numpy()
        np.testing.assert_allclose(got, want[name].numpy(), rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("norm_type", NORMS)
def test_norm_gradient_matches_jax(norm_type):
    """Train mode: the gradient through the batch (or instance) statistics,
    AdaIN's and the foreground detector's detached inputs, MixedNorm's
    blend."""
    jm, v, pm = _norm_pair(norm_type, 12, 8, init_train=norm_type == "mixed")
    _gradient_parity(jm, v, pm, (_x((3, 5, 6, 12), seed=4, scale=1.5),), train=True)


@pytest.mark.parametrize("kind", ATTENTION)
def test_attention_gradient_matches_jax(kind):
    jm, pm, args = _attention_case(kind)
    _gradient_parity(jm, _module_pair(jm, pm, *args), pm, args)


@pytest.mark.parametrize("kind", HEADS)
def test_head_gradient_matches_jax(kind):
    """The refinement heads in eval mode: the boundary refinement away from
    ties, the guided head's mask path, the attention module's branches.
    With GroupNorm: LayerNorm2d computes its statistics in float32 in both
    packages even in float64, which leaves up to 1.8e-5 between the two
    gradients of ``v2_attention``."""
    jm, pm, args, kw = _head_case(kind, norm="groupnorm")
    v = _module_pair(jm, pm, *args, seed=5, **kw)
    train = False if "train" in jm.__call__.__code__.co_varnames else None
    _gradient_parity(jm, v, pm, args, kw, train=train)
