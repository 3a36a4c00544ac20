"""The benchmark's plain reference against the port's plain path, and what
the benchmark's files import. CPU only, at the tiny variant.

    python -m pytest port_bench/tests -q
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from port_bench.lib import guard, spec, traffic, weights
from port_bench.lib.system import parameter_shapes
from port_bench.reference import flagship

BENCH = Path(__file__).resolve().parents[1]
TINY = spec.load_json(BENCH / "tests" / "data" / "tiny_config.json")
PORT = "human_instance_segmentation_tpu_torch"


def _tiny(**model):
    cfg = dict(TINY, model=dict(TINY["model"], **model))
    return cfg


@pytest.mark.parametrize("pallas_tail", [False, True], ids=["plain_tail", "fused_tail"])
@pytest.mark.parametrize("mid", [32, 128])
def test_reference_matches_port_plain_path(pallas_tail, mid):
    """float32 on the CPU: the port's plain path (``kernels=False``, the plain
    crops) and the reference agree on the class logits, the binary masks and
    the instance masks."""
    from human_instance_segmentation_tpu_torch.inference import InferenceEngine
    from human_instance_segmentation_tpu_torch.models.assembly import (
        HierarchicalInstanceSegmenter)

    cfg = _tiny(pallas_tail=pallas_tail, pallas_roi_align=False, encoder_fused_blocks=0,
                mid_channels=mid)
    w = weights.draw(parameter_shapes(cfg), 1234567891011, "cpu")
    # non-trivial norms and biases, so a mis-mapped affine or statistic shows
    gen = torch.Generator().manual_seed(3)
    for name, t in w.items():
        if t.dim() == 1 and not name.startswith("unet_wrapper"):
            w[name] = t + 0.1 * torch.rand(t.shape, generator=gen)
    model = HierarchicalInstanceSegmenter(**cfg["model"])
    model.load_state_dict(w)
    engine = InferenceEngine(model.eval(), device="cpu", dilation_pixels=1, kernels=False)
    req = traffic.request(spec.load_json(BENCH / "tests" / "data" / "tiny_traffic.json"), 8,
                          tuple(cfg["model"]["image_size"]), traffic.rng(5, 0))
    images, rois = torch.as_tensor(req.images), torch.as_tensor(req.rois)
    inst, binary, logits = engine.forward(images, rois)

    ref = flagship.build(cfg, "cpu")
    flagship.load(ref, w)
    with torch.no_grad():
        dense, rbinary = ref.stage1(images)
        rlogits, rinst = ref.stage2(images, dense, rois)
    np.testing.assert_allclose(logits.permute(0, 3, 1, 2).numpy(), rlogits.numpy(),
                               atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(binary.numpy(), rbinary.numpy(), atol=1e-5)
    assert (inst.numpy() != rinst.numpy()).mean() < 1e-3


def test_reference_ignores_only_the_auxiliary_branches():
    """Every parameter the reference reads exists in the served model under
    the same name and shape; what it leaves out is the contour and distance
    branches, which feed no deployed output."""
    shapes = parameter_shapes(TINY)
    ref = flagship.build(TINY, "meta")
    own = {n: tuple(t.shape) for n, t in ref.state_dict().items()}
    assert all(shapes[n] == s for n, s in own.items())
    left = {n.split(".")[1] for n in set(shapes) - set(own)}
    assert left == {"contour", "distance"}


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_reference_imports_nothing_of_the_port_or_jax():
    for path in (BENCH / "reference").glob("*.py"):
        names = {n.split(".")[0] for n in _imports(path)}
        assert not names & {PORT, *guard.FORBIDDEN}, path
        assert names <= {"__future__", "contextlib", "math", "typing", "torch"}, path


def test_benchmark_imports_no_jax_and_the_port_in_one_place():
    """Top-level names compared whole: the port's name begins with the JAX
    package's."""
    importers = []
    for path in BENCH.rglob("*.py"):
        names = [n for n in _imports(path) if n]
        assert not guard.forbidden(names), path
        if any(n.split(".")[0] == PORT for n in names) and "tests" not in path.parts:
            importers.append(path.relative_to(BENCH).as_posix())
    assert importers == ["lib/system.py"]


def test_guard_compares_whole_top_level_names():
    assert guard.forbidden([PORT, f"{PORT}.inference", "jaxtyping", "flaxen"]) == []
    assert guard.forbidden(["jax.numpy", "human_instance_segmentation_tpu.ops", "flax"]) == [
        "flax", "human_instance_segmentation_tpu", "jax"]
