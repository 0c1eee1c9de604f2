"""The port's multi-slice chaos drills on the CPU
(`dear_pytorch_tpu_torch.scripts.chaos_check --multislice*`), with the
JAX package's stories and verdicts (JAX ``scripts/chaos_check.py``
:1677-2400), as that package's own tests run its drills
(tests/test_multislice.py:645-731):

  - ``--multislice``: 2 slices x 2 ranks train the hierarchical schedule;
    slice 1 SIGKILLs itself before attempt 5; the survivors commit ONE
    shrink epoch (``slices.removed == [1]``), train degraded, and readmit
    the relaunched slice as ONE epoch (``slices.added == [1]``); lockstep
    at the end, nothing lost past the newest upload;
  - ``--multislice-flap``: a sub-budget ``dcn_flap`` under bounded
    staleness: zero rollbacks, zero membership epochs, the ladder's skip
    rung engaged;
  - ``--multislice-degraded`` (marked slow, as JAX marks its own): a
    past-budget ``dcn_partition``; the victim slice evicts itself and
    rejoins.

The peer timeout is 10 s here (``DEAR_CLUSTER_TIMEOUT_SECS``), so the
strict drill's DCN deadline is 4.5 s.
"""

import json
import os
import subprocess
import sys

import pytest

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
        cwd=str(ROOT), env=env, capture_output=True, text=True, timeout=300)
    lines = out.stdout.strip().splitlines()
    assert out.returncode == 0 and lines[-1] == "CHAOS CHECK PASSED", (
        out.stdout[-6000:] + out.stderr[-6000:])
    return json.loads(lines[-2])


def test_chaos_check_multislice_drill_passes_with_jax_verdicts(tmp_path):
    summary = _drill(tmp_path, "--multislice")
    assert summary["passed"] and not summary["failures"]
    story = summary["story"]
    for r in (0, 1):   # the survivors
        s = story[str(r)]
        assert s["degraded_steps"] >= 1 and s["renorms"] >= 2
        assert s["death_to_commit_s"] > 0 and s["readmit_s"] > 0
        assert all(n >= 0 for n in s["steps_lost"] if n is not None)
        assert s["dcn_fit"] is not None and s["dcn_bytes"] > 0


def test_chaos_check_multislice_flap_drill_passes_with_jax_verdicts(
        tmp_path):
    summary = _drill(tmp_path, "--multislice-flap")
    assert summary["passed"] and not summary["failures"]
    assert summary["steps_per_hour"] > 0


@pytest.mark.slow
def test_chaos_check_multislice_degraded_drill_passes_with_jax_verdicts(
        tmp_path):
    summary = _drill(tmp_path, "--multislice-degraded")
    assert summary["passed"] and not summary["failures"]
