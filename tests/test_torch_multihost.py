"""The port's multi-process worker and dry run on the CPU (Gloo).

``parallel.multihost``'s CLI runs as two OS processes joined through
``init_distributed`` at a free local port (JAX ``tests/test_multihost.py``,
whose worker carves virtual devices; here one process is one device): both
print ``MULTIHOST OK`` with the same loss, the all-gathered loss being
bit-identical inside each worker. ``run_dryrun(2)`` overfits the tiny model
on two ranks, requires the loss to fall and the eval IoU to be above 0,
and serves the trained weights through the mesh engine within the atol
1e-5 it states (ROADMAP C2). Every process is killed after the test's own
limit.
"""

import os
import re
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
LIMIT = 240


def test_two_process_cli(tmp_path):
    from human_instance_segmentation_tpu_torch.parallel.launch import free_port

    port = free_port()
    env = {k: v for k, v in os.environ.items() if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK")}
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    # a file each: a worker blocked on a full pipe would hold the other in a
    # collective
    logs = [tmp_path / f"worker{i}.log" for i in range(2)]
    files = [open(path, "w") for path in logs]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "human_instance_segmentation_tpu_torch.parallel.multihost",
         "--coordinator", f"127.0.0.1:{port}", "--num_processes", "2", "--process_id", str(i),
         "--device", "cpu"], cwd=REPO, env=env, stdout=f, stderr=subprocess.STDOUT)
        for i, f in enumerate(files)]
    deadline = time.monotonic() + LIMIT
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in files:
            f.close()
    outs = [path.read_text() for path in logs]
    losses = []
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out[-3000:]}"
        m = re.search(r"MULTIHOST OK proc=%d loss=([0-9.+-eE]+) eval_n=(\d+)" % pid, out)
        assert m, f"no OK line from proc {pid}:\n{out[-3000:]}"
        assert m.group(2) == "4"  # 2 ROIs x 1 image x 2 processes
        losses.append(float(m.group(1)))
    assert losses[0] == losses[1], losses


def test_dryrun_two_ranks():
    from human_instance_segmentation_tpu_torch.parallel.dryrun import SERVE_ATOL, STEPS, run_dryrun

    rep = run_dryrun(2, device="cpu", verbose=False, timeout=LIMIT)
    assert len(rep["losses"]) == STEPS and rep["losses"][-1] < rep["losses"][0]
    assert rep["eval_n"] == 4 and rep["mean_iou"] > 0.0
    assert rep["binary_max_abs"] <= SERVE_ATOL == 1e-5
    assert rep["serving_agreement"] > 0.99
