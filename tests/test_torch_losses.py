"""The port's losses against the JAX package's on the same numpy inputs
(CPU, float32).

Values within rtol 1e-5 / atol 1e-6 (float32 reductions in another order);
the refined loss's gradient with respect to the logits and the aux maps
within atol 1e-6. Inputs include padded ROIs (``valid`` 0), the EMA state
uninitialised and warm, and inputs that drive each clipped refinement term
past its ``clip(..., None, 10.0)``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from human_instance_segmentation_tpu import losses as jl
from human_instance_segmentation_tpu_torch import losses as pl

RTOL, ATOL = 1e-5, 1e-6
N, H, W = 3, 24, 20


def _inputs(seed=0, h=H, w=W, scale=2.0):
    rng = np.random.default_rng(seed)
    targets = rng.integers(0, 3, (N, h, w)).astype(np.int32)
    targets[0, : h // 2] = 1  # a block of target, so the bands and distances are not noise
    return {
        "preds": (scale * rng.standard_normal((N, h, w, 3))).astype(np.float32),
        "targets": targets,
        "bg_fg_logits": (scale * rng.standard_normal((N, h, w, 2))).astype(np.float32),
        "target_nontarget_logits": rng.standard_normal((N, h, w, 2)).astype(np.float32),
        "contours": rng.uniform(0.01, 0.99, (N, h, w, 1)).astype(np.float32),
        "distance_map": rng.standard_normal((N, h, w, 1)).astype(np.float32),
        "valid": np.asarray([1.0, 1.0, 0.0], np.float32),
        "class_weights": np.asarray([0.7, 1.6, 0.9], np.float32),
    }


def _j(x):
    return jnp.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, **kw):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(got, torch.Tensor) else got),
                               np.asarray(want), rtol=kw.pop("rtol", RTOL),
                               atol=kw.pop("atol", ATOL), **kw)


@pytest.fixture(scope="module")
def inp():
    return _inputs()


@pytest.mark.parametrize("weights", [False, True])
@pytest.mark.parametrize("valid", [False, True])
@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_cross_entropy(inp, weights, valid, reduction):
    kw = dict(reduction=reduction)
    jkw, pkw = dict(kw), dict(kw)
    if weights:
        jkw["class_weights"], pkw["class_weights"] = _j(inp["class_weights"]), _t(
            inp["class_weights"])
    if valid:
        jkw["valid"], pkw["valid"] = _j(inp["valid"]), _t(inp["valid"])
    want = jl.cross_entropy(_j(inp["preds"]), _j(inp["targets"]), **jkw)
    got = pl.cross_entropy(_t(inp["preds"]), _t(inp["targets"]), **pkw)
    _close(got, want)


@pytest.mark.parametrize("classes", [(1,), (1, 2), (0, 1, 2)])
@pytest.mark.parametrize("valid", [False, True])
def test_dice_loss(inp, classes, valid):
    v = (_j(inp["valid"]), _t(inp["valid"])) if valid else (None, None)
    _close(pl.dice_loss(_t(inp["preds"]), _t(inp["targets"]), classes, valid=v[1]),
           jl.dice_loss(_j(inp["preds"]), _j(inp["targets"]), classes, valid=v[0]))
    probs = np.asarray(jax.nn.softmax(_j(inp["preds"]), -1))
    _close(pl.dice_loss(_t(probs), _t(inp["targets"]), classes, apply_softmax=False),
           jl.dice_loss(_j(probs), _j(inp["targets"]), classes, apply_softmax=False))


@pytest.mark.parametrize("alpha", [False, True])
@pytest.mark.parametrize("gamma", [0.0, 2.0, 3.5])
def test_focal_loss(inp, alpha, gamma):
    a = (_j(inp["class_weights"]), _t(inp["class_weights"])) if alpha else (None, None)
    _close(pl.focal_loss(_t(inp["preds"]), _t(inp["targets"]), gamma, a[1], _t(inp["valid"])),
           jl.focal_loss(_j(inp["preds"]), _j(inp["targets"]), gamma, a[0], _j(inp["valid"])))


@pytest.mark.parametrize("use_focal", [False, True])
def test_segmentation_loss(inp, use_focal):
    kw = dict(ce_weight=0.7, dice_weight=1.3, dice_classes=(1, 2), use_focal=use_focal)
    jt, jm = jl.segmentation_loss(_j(inp["preds"]), _j(inp["targets"]),
                                  _j(inp["class_weights"]), valid=_j(inp["valid"]), **kw)
    pt, pm = pl.segmentation_loss(_t(inp["preds"]), _t(inp["targets"]),
                                  _t(inp["class_weights"]), valid=_t(inp["valid"]), **kw)
    _close(pt, jt)
    assert set(pm) == set(jm)
    for k in jm:
        _close(pm[k], jm[k], err_msg=k)


@pytest.mark.parametrize("log", [False, True])
def test_class_weights_from_pixel_ratios(log):
    ratios = {"background": 0.8, "target": 0.15, "non_target": 0.05}
    assert pl.class_weights_from_pixel_ratios(ratios, log) == \
        jl.class_weights_from_pixel_ratios(ratios, log)


@pytest.mark.parametrize("max_distance", [1, 4, 10])
def test_approximate_distance_transform(inp, max_distance):
    mask = (inp["targets"] == 1).astype(np.float32)[..., None]
    _close(pl.approximate_distance_transform(_t(mask), max_distance),
           jl.approximate_distance_transform(_j(mask), max_distance), rtol=0, atol=0)


def test_boundary_and_separation_weights(inp):
    _close(pl.boundary_distance_weights(_t(inp["targets"]), 3, 3.5, 0.4, 6),
           jl.boundary_distance_weights(_j(inp["targets"]), 3, 3.5, 0.4, 6))
    for radius in (1, 2, 3):
        _close(pl.instance_separation_weights(_t(inp["targets"]), 2.5, radius),
               jl.instance_separation_weights(_j(inp["targets"]), 2.5, radius), rtol=0, atol=0)


@pytest.mark.parametrize("weights", [False, True])
def test_distance_aware_loss(inp, weights):
    cfg_kw = dict(boundary_weight=2.0, separation_weight=3.0, max_distance=5, dice_weight=0.5)
    w = (_j(inp["class_weights"]), _t(inp["class_weights"])) if weights else (None, None)
    jt, jm = jl.distance_aware_loss(_j(inp["preds"]), _j(inp["targets"]),
                                    jl.DistanceAwareLossConfig(**cfg_kw), w[0],
                                    _j(inp["valid"]))
    pt, pm = pl.distance_aware_loss(_t(inp["preds"]), _t(inp["targets"]),
                                    pl.DistanceAwareLossConfig(**cfg_kw), w[1],
                                    _t(inp["valid"]))
    _close(pt, jt)
    for k in jm:
        _close(pm[k], jm[k], err_msg=k)


def _aux(inp, to):
    return {k: to(inp[k]) for k in ("bg_fg_logits", "target_nontarget_logits", "contours",
                                    "distance_map")}


WARM = dict(ema_bg=1.3, ema_fg=0.7, ema_target=2.1, ema_nontarget=0.6)


def _states(warm):
    if not warm:
        return jl.HierarchicalLossState.create(), pl.HierarchicalLossState.create()
    return (jl.HierarchicalLossState(**{k: jnp.asarray(v, jnp.float32) for k, v in WARM.items()},
                                     initialized=jnp.asarray(True)),
            pl.HierarchicalLossState(**{k: torch.tensor(v) for k, v in WARM.items()},
                                     initialized=torch.tensor(True)))


def _check_state(ps, js):
    for f in pl.HierarchicalLossState.FIELDS:
        _close(getattr(ps, f), getattr(js, f), err_msg=f)


@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("cfg_kw", [
    {},
    dict(use_dynamic_weights=False, target_weight=1.4),
    dict(use_focal=True, focal_gamma=1.5, final_class_weights=(0.5, 2.0, 1.0)),
    dict(bg_weight=1.5, fg_weight=1.5, target_weight=1.2, consistency_weight=0.3,
         ema_alpha=0.8),
], ids=["default", "static", "focal", "flagship"])
@pytest.mark.parametrize("valid", [False, True])
def test_hierarchical_loss(inp, warm, cfg_kw, valid):
    js, ps = _states(warm)
    v = (_j(inp["valid"]), _t(inp["valid"])) if valid else (None, None)
    jt, jns, jm = jl.hierarchical_loss(_j(inp["preds"]), _j(inp["targets"]), _aux(inp, _j), js,
                                       jl.HierarchicalLossConfig(**cfg_kw), v[0])
    pt, pns, pm = pl.hierarchical_loss(_t(inp["preds"]), _t(inp["targets"]), _aux(inp, _t), ps,
                                       pl.HierarchicalLossConfig(**cfg_kw), v[1])
    _close(pt, jt)
    _check_state(pns, jns)
    assert set(pm) == set(jm)
    for k in jm:
        _close(pm[k], jm[k], err_msg=k)


def test_hierarchical_loss_without_foreground():
    """No target or non-target pixel: the target/non-target term is 0."""
    inp = _inputs(1)
    inp["targets"][:] = 0
    js, ps = _states(False)
    jt, _, jm = jl.hierarchical_loss(_j(inp["preds"]), _j(inp["targets"]), _aux(inp, _j), js)
    pt, _, pm = pl.hierarchical_loss(_t(inp["preds"]), _t(inp["targets"]), _aux(inp, _t), ps)
    assert float(pm["target_nontarget_loss"]) == 0.0
    _close(pt, jt)


@pytest.mark.parametrize("smooth", [0.0, 0.01, 0.5])
def test_active_contour_loss(inp, smooth):
    probs = np.asarray(jax.nn.softmax(_j(inp["preds"]), -1))
    _close(pl.active_contour_loss(_t(probs), smooth), jl.active_contour_loss(_j(probs), smooth))
    one = probs[..., 1:2]
    _close(pl.active_contour_loss(_t(one), smooth), jl.active_contour_loss(_j(one), smooth))


@pytest.mark.parametrize("width,weight", [(3, 2.0), (5, 5.0)])
def test_boundary_aware_loss(inp, width, weight):
    for v in ((None, None), (_j(inp["valid"]), _t(inp["valid"]))):
        _close(pl.boundary_aware_loss(_t(inp["preds"]), _t(inp["targets"]), width, weight, v[1]),
               jl.boundary_aware_loss(_j(inp["preds"]), _j(inp["targets"]), width, weight, v[0]))


@pytest.mark.parametrize("hw", [(24, 20), (64, 48), (128, 96)])
def test_contour_and_distance_targets(hw):
    """Edge widths 1, 1 and 3 (the width grows with the resolution)."""
    targets = _inputs(2, *hw)["targets"]
    _close(pl.generate_contour_targets(_t(targets)), jl.generate_contour_targets(_j(targets)),
           rtol=0, atol=0)
    for it in (1, 5):
        _close(pl.generate_distance_targets(_t(targets), it),
               jl.generate_distance_targets(_j(targets), it))


REFINED = {
    "flagship": dict(use_boundary_aware_loss=True, base_mask_size=(32, 24)),
    "all_terms": dict(use_active_contour_loss=True, use_boundary_aware_loss=True,
                      auto_adjust_contour_weight=False,
                      distance_aware=("da", dict(boundary_weight=2.0, separation_weight=3.0,
                                                 max_distance=5))),
    "no_refinement": dict(use_contour_detection=False, use_distance_transform=False),
}


def _refined_cfg(mod, name):
    kw = dict(REFINED[name])
    if "distance_aware" in kw:
        kw["distance_aware"] = mod.DistanceAwareLossConfig(**kw["distance_aware"][1])
    return mod.RefinedLossConfig(**kw)


def _refined(mod, inp, name, to, state, valid=True, scale_aux=1.0):
    aux = _aux(inp, to)
    aux["distance_map"] = aux["distance_map"] * scale_aux
    return mod.refined_hierarchical_loss(to(inp["preds"]), to(inp["targets"]), aux, state,
                                         _refined_cfg(mod, name),
                                         to(inp["valid"]) if valid else None)


@pytest.mark.parametrize("name", sorted(REFINED))
@pytest.mark.parametrize("valid", [False, True])
@pytest.mark.parametrize("warm", [False, True])
def test_refined_hierarchical_loss(inp, name, valid, warm):
    js, ps = _states(warm)
    jt, jns, jm = _refined(jl, inp, name, _j, js, valid)
    pt, pns, pm = _refined(pl, inp, name, _t, ps, valid)
    _close(pt, jt)
    _check_state(pns, jns)
    assert set(pm) == set(jm)
    for k in jm:
        _close(pm[k], jm[k], err_msg=k)


def test_refined_loss_clipped_terms():
    """A distance map far off its targets (L1 term past 10), confident wrong
    contours (BCE past 10) and extreme logits (boundary-aware CE past 10):
    each clipped to 10 in both packages, and the total equal."""
    inp = _inputs(3, scale=40.0)
    ct = np.asarray(jl.generate_contour_targets(_j(inp["targets"])))
    inp["contours"] = np.where(ct > 0, 1e-9, 1 - 1e-9).astype(np.float32)
    js, ps = _states(False)
    jt, _, jm = _refined(jl, inp, "all_terms", _j, js, scale_aux=100.0)
    pt, _, pm = _refined(pl, inp, "all_terms", _t, ps, scale_aux=100.0)
    for k in ("distance_transform", "contour", "boundary_aware"):
        assert float(jm[k]) == 10.0 and float(pm[k]) == 10.0, k
    _close(pt, jt)


@pytest.mark.parametrize("name,scale_aux", [("flagship", 1.0), ("all_terms", 1.0),
                                            ("all_terms", 100.0)])
def test_refined_loss_gradient(inp, name, scale_aux):
    """d loss / d (logits, bg_fg_logits, target_nontarget_logits, contours,
    distance_map), with and without the L1 term clipped."""
    keys = ("preds", "bg_fg_logits", "target_nontarget_logits", "contours", "distance_map")
    cfg_j = _refined_cfg(jl, name)

    def jloss(*xs):
        d = dict(zip(keys, xs))
        aux = {k: d[k] for k in keys[1:]}
        aux["distance_map"] = aux["distance_map"] * scale_aux
        return jl.refined_hierarchical_loss(d["preds"], _j(inp["targets"]), aux,
                                            jl.HierarchicalLossState.create(), cfg_j,
                                            _j(inp["valid"]))[0]

    want = jax.grad(jloss, argnums=tuple(range(len(keys))))(*[_j(inp[k]) for k in keys])
    xs = {k: _t(inp[k].copy()).requires_grad_(True) for k in keys}
    aux = {k: xs[k] for k in keys[1:]}
    aux["distance_map"] = aux["distance_map"] * scale_aux
    loss = pl.refined_hierarchical_loss(xs["preds"], _t(inp["targets"]), aux,
                                        pl.HierarchicalLossState.create(),
                                        _refined_cfg(pl, name), _t(inp["valid"]))[0]
    got = torch.autograd.grad(loss, [xs[k] for k in keys])
    for k, g, w in zip(keys, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6, err_msg=k)
        assert np.abs(np.asarray(w)).max() > 0 or (k == "distance_map" and scale_aux > 1), k


def test_configs_have_the_same_fields():
    for a, b in ((pl.HierarchicalLossConfig, jl.HierarchicalLossConfig),
                 (pl.RefinedLossConfig, jl.RefinedLossConfig),
                 (pl.DistanceAwareLossConfig, jl.DistanceAwareLossConfig)):
        fa = {(f.name, str(f.default)) for f in dataclasses.fields(a)
              if f.default is not dataclasses.MISSING}
        fb = {(f.name, str(f.default)) for f in dataclasses.fields(b)
              if f.default is not dataclasses.MISSING}
        assert fa == fb, a
    assert dataclasses.asdict(pl.RefinedLossConfig()) == dataclasses.asdict(jl.RefinedLossConfig())
