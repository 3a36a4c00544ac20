"""A whole run of a cell on the CPU at the tiny variant (the harness's look
for a card skipped), sound and with the timed path broken underneath: the
comparison has to come out false for each fault a serving cell can have,
and for the control in the program's place.

The tiny cell's limits (``data/tiny_limits.json``) were set as the real
cells' are, from the program's readings on 12 seeds and the control's on
3, here on the CPU.

    python -m pytest port_bench/tests -q
"""

import time

import pytest
import torch

from port_bench.lib import runner, spec
from port_bench.lib.faults import FAULTS
from port_bench.readings import control_system

DATA = spec.BENCH_DIR / "tests" / "data"
SEED = 2 ** 31 + 77


def _cell():
    return {"workload": {"name": "tiny", "chips": 1},
            "config": spec.load_json(DATA / "tiny_config.json"),
            "traffic": spec.load_json(DATA / "tiny_traffic.json"),
            "limits": spec.load_json(DATA / "tiny_limits.json"),
            "end_to_end": [m for m in spec.benchmark()["end_to_end"] if m["name"] == "setup_s"],
            "per_layer": []}


def _run(make_system=runner.port_system, trace=False):
    return runner.run(_cell(), SEED, 0.2, trace, "cpu", time.perf_counter(), make_system)


def test_sound_run_is_correct_and_reports():
    result, lines = _run(trace=True)
    assert result["correct"] is True, lines
    assert result["failed"] == 0 and result["attempted"] >= 3 + 3
    assert list(result)[-1] == "checks"
    assert set(result["checks"]) == {"inst_logit_err", "inst_worst_roi", "binary_mad",
                                     "binary_worst_image"}
    assert result["device"]["window_s"] > 0 and "breakdown" in result


@pytest.mark.parametrize("fault", [*FAULTS.values(), control_system],
                         ids=[*FAULTS, "control_int4"])
def test_broken_timed_path_is_not_correct(fault):
    torch.manual_seed(0)
    result, lines = _run(fault)
    assert result["correct"] is False, lines
