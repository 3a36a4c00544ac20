"""The timed path broken underneath, for showing that ``correct`` comes out
false: each factory builds the served engine as ``runner.port_system`` does
and breaks it where its answers are produced. Used by the CPU tests and by
``port_bench.readings --fault-seeds`` on the card."""

from __future__ import annotations

from .runner import port_system


def altered_answer(config, weights, calibration, device):
    """One RoI's mask inverted where the engine produces it."""
    engine = port_system(config, weights, calibration, device)
    forward = engine.forward

    def broken(images, rois):
        inst, binary, logits = forward(images, rois)
        inst = inst.clone()
        inst[0] = 1.0 - inst[0]
        return inst, binary, logits

    engine.forward = broken
    return engine


def half_batch(config, weights, calibration, device):
    """The second half of the images left out: their binary masks and their
    RoIs' instance masks come back empty."""
    engine = port_system(config, weights, calibration, device)
    forward = engine.forward

    def broken(images, rois):
        inst, binary, logits = forward(images, rois)
        half = images.shape[0] // 2
        binary = binary.clone()
        binary[half:] = 0.0
        inst = inst * (rois[:, 0] < half).to(inst.dtype)[:, None, None, None]
        return inst, binary, logits

    engine.forward = broken
    return engine


class _Stale:
    """Hands back the first answer to each request shape."""

    def __init__(self, engine):
        self.engine, self.model, self.first = engine, engine.model, {}

    def __call__(self, images, rois):
        key = (images.shape, rois.shape)
        if key not in self.first:
            self.first[key] = self.engine(images, rois)
        return self.first[key]


def stale_answer(config, weights, calibration, device):
    """The state left unchanged: the first answer to a request shape handed
    back to every later request of that shape."""
    return _Stale(port_system(config, weights, calibration, device))


FAULTS = {"answer_altered": altered_answer, "half_batch_left_out": half_batch,
          "state_unchanged": stale_answer}
