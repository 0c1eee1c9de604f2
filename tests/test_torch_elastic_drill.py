"""The port's elastic chaos drills on the CPU
(`dear_pytorch_tpu_torch.scripts.chaos_check`), with the JAX package's
scenarios and verdicts (JAX ``scripts/chaos_check.py`` :421-666 and
:1241-1676), as that package's own tests run its drills:

  - ``--elastic``: 3 ranks under the port's supervisor; rank 2 SIGKILLs
    itself before attempt 5; the survivors commit epoch 1 (world 2) and
    roll back to the newest common checkpoint, the relaunch rejoins at
    epoch 2 (world 3), and the fleet ends in lockstep. With
    ``--replay-shrink`` the relaunch waits out the peer timeout first and
    the survivors' world-2 losses are held bitwise against a fresh 2-rank
    run restored from the same checkpoint;
  - ``--autoscale``: scale-up to 3, a SIGKILL and its relaunch, a SIGTERM
    drain and its backfill (epochs 1-5, each decision record's signed
    delta), then a cold start from the remote tier alone. The JAX gate's
    steps-per-hour SLO (its ``scripts/bench_gate.py --slo``) is the one
    verdict the port's drill leaves out.

The peer timeout is 10 s here (``DEAR_CLUSTER_TIMEOUT_SECS``), so a
collective of the data plane times out after 2.5 s.
"""

import json
import os
import subprocess
import sys

from tests.test_torch_dear import ROOT


def _drill(tmp_path, *argv):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("DEAR_", "JAX_", "XLA_"))}
    env.update(DEAR_CLUSTER_TIMEOUT_SECS="10", OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT) + os.pathsep + env.get("PYTHONPATH", ""))
    out = subprocess.run(
        [sys.executable, "-m", "dear_pytorch_tpu_torch.scripts.chaos_check",
         "--device", "cpu", "--workdir", str(tmp_path / "drill"),
         "--deadline", "120", *argv],
        cwd=str(ROOT), env=env, capture_output=True, text=True, timeout=240)
    lines = out.stdout.strip().splitlines()
    assert out.returncode == 0 and lines[-1] == "CHAOS CHECK PASSED", (
        out.stdout[-6000:] + out.stderr[-6000:])
    return json.loads(lines[-2])


def test_chaos_check_elastic_drill_passes_with_jax_verdicts(tmp_path):
    summary = _drill(tmp_path, "--elastic", "--replay-shrink",
                     "--relaunch-delay", "2")
    assert summary["passed"] and not summary["failures"]
    replay = summary["replay"]
    assert replay["step"] == 4 and replay["same_groups"]
    assert replay["losses"] == replay["survivor"] and replay["losses"]


def test_chaos_check_autoscale_drill_passes_with_jax_verdicts(tmp_path):
    summary = _drill(tmp_path, "--autoscale")
    assert summary["passed"] and not summary["failures"]
    assert summary["policy_decisions"].count("scale_up") >= 2
    assert summary["cold"]["passed"]
    assert summary["cold"]["restored_step"] == summary["newest_uploaded"]
