"""``weights.from_jax_params``: every JAX leaf lands on a port parameter and
every port parameter is filled, plus the leaf transforms that are easy to
get wrong (the flipped transposed-conv taps, HWIO -> OIHW, BN statistics,
TF 'SAME' padding in the encoder), each held against the JAX module."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import fast_init
from human_instance_segmentation_tpu.models import blocks as jblocks
from human_instance_segmentation_tpu.models.assembly import (
    HierarchicalInstanceSegmenter as JaxSegmenter)
from human_instance_segmentation_tpu.models.efficientnet import EfficientNetEncoder as JaxEncoder
from human_instance_segmentation_tpu_torch.inference import create_flagship
from human_instance_segmentation_tpu_torch.models import blocks
from human_instance_segmentation_tpu_torch.models.efficientnet import EfficientNetEncoder
from human_instance_segmentation_tpu_torch.weights import from_jax_params, load_jax_params

TINY = dict(roi_size=(16, 12), mask_size=(32, 24), image_size=(64, 96), mid_channels=32,
            base_channels=64)


@pytest.fixture(scope="module")
def tiny_variables():
    model = JaxSegmenter(encoder_variant="tiny", **TINY)
    v = fast_init(model, jnp.zeros((1, 64, 96, 3)), jnp.zeros((1, 5)), train=False)
    return jax.tree.map(np.asarray, v)


def _n_leaves(tree):
    return len(jax.tree_util.tree_leaves(tree))


def test_every_leaf_consumed_every_parameter_filled(tiny_variables):
    port = create_flagship(variant="tiny", device="cpu", **TINY)
    state = from_jax_params(tiny_variables, port)
    assert len(state) == _n_leaves(tiny_variables) == len(port.state_dict())
    load_jax_params(port, tiny_variables)
    for key, value in port.state_dict().items():
        torch.testing.assert_close(value, state[key], rtol=0, atol=0)


@pytest.mark.parametrize("mutation", ["extra_leaf", "missing_leaf", "bad_shape", "unknown_leaf",
                                      "unknown_collection"])
def test_mismatch_raises(tiny_variables, mutation):
    port = create_flagship(variant="tiny", device="cpu", **TINY)
    v = jax.tree.map(lambda a: a, tiny_variables)  # fresh containers, shared leaves
    head = v["params"]["head"]
    err = KeyError
    if mutation == "extra_leaf":
        head["extra_conv"] = {"kernel": np.zeros((1, 1, 2, 2), np.float32)}
    elif mutation == "missing_leaf":
        del head["distance"]["threshold"]
    elif mutation == "bad_shape":
        head["distance"]["out"]["bias"] = np.zeros(3, np.float32)
        err = ValueError
    elif mutation == "unknown_leaf":
        head["distance"]["out"]["gain"] = np.zeros(1, np.float32)
    else:
        v["calib"] = {}
    with pytest.raises(err):
        from_jax_params(v, port)


def test_transposed_conv_taps_are_flipped(rng):
    x = rng.standard_normal((2, 3, 4, 5)).astype(np.float32)
    jmod = jblocks.ConvTranspose2x(6)
    v = jax.tree.map(np.asarray, jmod.init(jax.random.PRNGKey(1), jnp.asarray(x)))
    v["params"]["deconv"]["bias"] = rng.standard_normal(6).astype(np.float32)
    ref = np.asarray(jmod.apply(v, jnp.asarray(x)))
    port = load_jax_params(blocks.ConvTranspose2x(5, 6), v)
    with torch.no_grad():
        out = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5)


@pytest.mark.parametrize("hw", [(64, 96), (30, 46), (33, 47)])
def test_encoder_same_padding_and_bn(rng, hw):
    """TF 'SAME' pads stride-2 convs asymmetrically; odd extents and
    non-trivial BN statistics included."""
    x = rng.standard_normal((2, *hw, 3)).astype(np.float32)
    jenc = JaxEncoder("tiny")
    v = jax.tree.map(np.asarray, fast_init(jenc, jnp.asarray(x), train=False))
    with jax.default_matmul_precision("highest"):
        ref = jenc.apply(v, jnp.asarray(x), train=False)
    port = load_jax_params(EfficientNetEncoder("tiny"), v).eval()
    with torch.no_grad():
        taps = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(taps) == len(ref) == 5
    for t, r in zip(taps, ref):
        np.testing.assert_allclose(t.permute(0, 2, 3, 1).numpy(), np.asarray(r),
                                   atol=1e-4, rtol=1e-4)
