"""The overhead probe in the port (dear_pytorch_tpu_torch.ops.overhead_probe,
K9's plain version and wrapper, and the entry point
dear_pytorch_tpu_torch.scripts.overhead_probe) against the JAX probe,
scripts/pallas_overhead_probe.py, on the CPU.

K9 computes ``x * 2 + 1`` in fp32. The JAX kernel runs through
``pl.pallas_call(..., interpret=True)`` at two grids over the same numpy
inputs; the port's plain version and its wrapper (which takes the plain
version for a CPU tensor) must be BITWISE equal to it: ``2x`` is exact, so
the result is rounded once however the two operations are fused. The
Hopper kernel itself is held bitwise against the plain version on the card
by chip_smoke.py.
"""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from dear_pytorch_tpu_torch.ops import overhead_probe as OP
from dear_pytorch_tpu_torch.scripts import overhead_probe as probe
from tests.test_torch_dear import spawn_ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_probe():
    """scripts/pallas_overhead_probe.py, loaded by path (scripts/ is not a
    package)."""
    path = os.path.join(ROOT, "scripts", "pallas_overhead_probe.py")
    spec = importlib.util.spec_from_file_location("pallas_overhead_probe",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_k9(x: np.ndarray, nblocks: int, rows_per_block: int) -> np.ndarray:
    kern = _jax_probe().kern
    spec = pl.BlockSpec((rows_per_block, OP.WIDTH), lambda i: (i, 0))
    f = pl.pallas_call(kern, grid=(nblocks,), in_specs=[spec],
                       out_specs=spec,
                       out_shape=jax.ShapeDtypeStruct(x.shape, jnp.float32),
                       interpret=True)
    return np.asarray(f(jnp.asarray(x)))


def _inputs(rows: int) -> np.ndarray:
    x = np.random.RandomState(rows).randn(rows, OP.WIDTH).astype(np.float32)
    x[0, :6] = [np.inf, -np.inf, 3.0e38, -0.0, 1e-42, -1.5]  # inf, overflow,
    return x                                                 # a subnormal


@pytest.mark.parametrize("nblocks,rows_per_block", [(4, 8), (2, 16)])
def test_k9_matches_the_pallas_kernel_bitwise(nblocks, rows_per_block):
    x = _inputs(nblocks * rows_per_block)
    want = _jax_k9(x, nblocks, rows_per_block)
    plain = OP.affine_probe_plain(torch.from_numpy(x)).numpy()
    launches = OP.affine_probe_launches
    got = OP.affine_probe(torch.from_numpy(x), rows_per_block).numpy()
    assert OP.affine_probe_launches == launches     # the CPU runs no kernel
    for a in (plain, got):
        np.testing.assert_array_equal(a.view(np.int32), want.view(np.int32))
    out = torch.full(x.shape, 7.0)
    assert OP.affine_probe(torch.from_numpy(x), rows_per_block, out=out) \
        is out
    np.testing.assert_array_equal(out.numpy().view(np.int32),
                                  want.view(np.int32))


@pytest.mark.parametrize("shape,dtype,rows_per_block,match", [
    ((33, 512), torch.float32, 8, "do not split"),
    ((32, 512), torch.float32, 0, "do not split"),
    ((0, 512), torch.float32, 8, "do not split"),
    ((32, 256), torch.float32, 8, "rows of 512"),
    ((32 * 512,), torch.float32, 8, "rows of 512"),
    ((32, 512), torch.float64, 8, "float32"),
    ((32, 512), torch.bfloat16, 8, "float32"),
])
def test_k9_rejects_what_the_kernel_does_not_take(shape, dtype,
                                                  rows_per_block, match):
    with pytest.raises(ValueError, match=match):
        OP.affine_probe(torch.zeros(shape, dtype=dtype), rows_per_block)


def test_k9_launcher_refuses_a_cpu_tensor():
    x = torch.zeros(8, 512)
    with pytest.raises(ValueError, match="not on one card"):
        OP._launch(x, torch.empty_like(x), 1, 8)
    with pytest.raises(ValueError, match="out must be"):
        OP.affine_probe(x, 8, out=torch.empty(8, 256))


def test_probe_runs_both_sections_on_the_cpu(capsys):
    """The JAX probe's sections, sizes and printed fields, on the plain
    versions (host times only; no device number)."""
    launches = OP.affine_probe_launches
    res = probe.main(["--section", "all", "--device", "cpu"])
    out = capsys.readouterr().out
    assert OP.affine_probe_launches == launches
    assert [(r["nblocks"], r["rows_per_block"]) for r in res["elementwise"]] \
        == [(16, 1024), (2048, 8)]
    assert all(r["bytes"] == 67_108_864 and "device_ms" not in r
               for r in res["elementwise"])
    assert "grid=   16 x (1024,512): " in out
    assert "grid= 2048 x (8,512): " in out
    assert out.count(" us/grid-step") == 2
    assert out.count("device time: not measured") == 2
    rows = res["kernels"]
    assert [(r["kernel"], r["shard"]) for r in rows] == [
        ("ring_all_gather", 65536), ("ring_rs_update", 65536),
        ("ring_all_gather", 1024), ("ring_rs_update", 1024)]
    assert all(r["transport"] == "LocalRing" and r["world"] == 2
               for r in rows)
    assert "ring-kernel probes on a 2-rank LocalRing" in out
    for ss in ("  65536", "   1024"):
        assert f"ring_all_gather  shard={ss} f32: " in out
        assert f"fused_rs_update  shard={ss} f32: " in out
    assert out.count(" us/hop (") == 4
    assert out.count("GiB/s/device wire)") == 4
    assert out.count("(incl. SGD-momentum epilogue") == 2


def test_probe_kernel_section_skips_at_world_1(capsys):
    res = probe.main(["--section", "kernels", "--device", "cpu",
                      "--world", "1"])
    assert res == {"elementwise": [], "kernels": []}
    assert "kernel section needs a multi-device mesh; skipping" \
        in capsys.readouterr().out


def test_probe_needs_the_card_unless_told_otherwise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        probe.main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        probe.main(["--section", "kernels"])


_WORKER = '''
import json, os, sys
sys.path.insert(0, {root!r})
from dear_pytorch_tpu_torch.scripts import overhead_probe as probe

rank, world, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
os.environ.update(DEAR_NUM_PROCESSES=str(world), DEAR_PROCESS_ID=str(rank),
                  DEAR_COORDINATOR_ADDRESS="file://" + out + "/store")
res = probe.main(["--section", "all", "--device", "cpu"])
with open(f"{{out}}/rank{{rank}}.json", "w") as f:
    json.dump(res, f)
'''


def test_probe_kernel_section_as_two_ranks(tmp_path):
    """Started as two ranks through the launcher variables, the kernel
    section runs over the group's ring (on the CPU: the distributed plain
    versions over gloo) and the elementwise section on rank 0 only."""
    out = str(tmp_path)
    spawn_ranks(_WORKER.format(root=ROOT), 2, out)
    for rank in range(2):
        res = json.load(open(os.path.join(out, f"rank{rank}.json")))
        assert len(res["elementwise"]) == (2 if rank == 0 else 0)
        assert [(r["kernel"], r["shard"], r["transport"], r["world"])
                for r in res["kernels"]] == [
            (k, ss, "Ring", 2) for ss in (65536, 1024)
            for k in ("ring_all_gather", "ring_rs_update")]
        log = open(os.path.join(out, f"rank{rank}.log")).read()
        assert f"gloo group, rank {rank} of 2" in log
        assert log.count(" us/hop (") == 4
