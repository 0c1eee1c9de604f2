"""The port's DeAR train step over BERT and ViT against the JAX package's
``build_train_step`` on the CPU, at world 1 over a single-rank gloo group:
the small models of tests/test_torch_bert.py and tests/test_torch_vit.py
(dropout-free, as the CLIs' ``--dropout0``) with the same flax weights on
both sides, one numpy batch (BERT with per-row padding lengths), 3 steps,
then the per-step losses and the gathered master parameters compared by
name.

Cases: the bench's optimizers with gradients in bf16 (bench.py
``bench_bert``: SGD lr 2e-5 without momentum; ``bench_vit``: lr 0.01,
momentum 0.9), and fp32 at lr 0.05 with momentum 0.9, where a wrong
gradient cannot hide under a tiny step; BERT also with the flash impl on
both sides (JAX's Pallas kernels in interpret mode, the port's plain
versions) over the padding mask.

Tolerances: 1e-5 in fp32 (summation order only); 2e-4 where gradients
travel in bf16 (``comm_dtype``): fp32 gradients that differ in their last
bits can round to neighbouring bf16 values (tests/test_torch_dear.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dear_pytorch_tpu import models as jmodels
from dear_pytorch_tpu.models import bert as jbert
from dear_pytorch_tpu.models import data as jdata
from dear_pytorch_tpu.models import vit as jvit
from dear_pytorch_tpu.ops import fused_sgd as jopt
from dear_pytorch_tpu.ops import make_flash_attention_impl as jflash_impl
from dear_pytorch_tpu.parallel import dear as jdear
from dear_pytorch_tpu_torch.models import bert as tbert
from dear_pytorch_tpu_torch.models import data as tdata
from dear_pytorch_tpu_torch.models.convert import (
    bert_params_from_jax, vit_params_from_jax,
)
from dear_pytorch_tpu_torch.ops import flash_attention as FA
from dear_pytorch_tpu_torch.ops import fused_sgd as topt
from dear_pytorch_tpu_torch.parallel import dear as tdear
from tests import test_torch_bert as TB
from tests import test_torch_vit as TV

STEPS = 3
THRESHOLD_MB = 0.01      # ~10 KB buckets: several of them
TOL, TOL_BF16 = 1e-5, 2e-4
#: (lr, momentum) of the optimizers
BENCH_BERT, BENCH_VIT, LARGER = (2e-5, 0.0), (0.01, 0.9), (0.05, 0.9)

CASES = {
    "bert_bench_bf16": {"model": "bert", "opt": BENCH_BERT, "comm": "bf16"},
    "bert_fp32": {"model": "bert", "opt": LARGER},
    "bert_flash": {"model": "bert", "opt": LARGER, "flash": True},
    "vit_bench_bf16": {"model": "vit", "opt": BENCH_VIT, "comm": "bf16"},
    "vit_fp32": {"model": "vit", "opt": LARGER},
}


def _bert_config():
    return jmodels.dropout_free(TB.jax_config())


def _bert_batch():
    b = TB.batch(7)
    return b, {k: torch.from_numpy(v) for k, v in b.items()}


def _vit_batch():
    rs = np.random.RandomState(8)
    x = rs.randn(4, 3, TV.SIZE, TV.SIZE).astype(np.float32)
    y = rs.randint(0, TV.WIDTHS["num_classes"], 4)
    return ({"image": jnp.asarray(x.transpose(0, 2, 3, 1)),
             "label": jnp.asarray(y)},
            {"image": torch.from_numpy(x), "label": torch.from_numpy(y)})


def _jax_side(opts):
    """(flax params, loss_fn, batch, params -> state_dict) of the case."""
    if opts["model"] == "bert":
        jcfg = _bert_config()
        params = TB.jax_params(jcfg, seed=1)
        model = jbert.BertForPreTraining(
            jcfg, attention_impl=jflash_impl() if opts.get("flash") else None)

        def loss_fn(p, b):
            logits, nsp = model.apply(
                {"params": p}, b["input_ids"], b["token_type_ids"],
                b["attention_mask"], train=True)
            return jbert.bert_pretraining_loss(
                logits, nsp, b["masked_lm_labels"], b["next_sentence_labels"])

        return (params, loss_fn, _bert_batch()[0],
                lambda p: bert_params_from_jax(p, jcfg))
    params = TV.jax_params(seed=1)
    model = jvit.VisionTransformer(**TV.WIDTHS)

    def loss_fn(p, b):
        return jdata.softmax_xent(
            model.apply({"params": p}, b["image"], train=True), b["label"])

    return params, loss_fn, _vit_batch()[0], vit_params_from_jax


def _port_model(opts, params):
    if opts["model"] == "bert":
        model = TB.port_model(
            params, _bert_config(),
            attention_impl=(FA.make_flash_attention_impl()
                            if opts.get("flash") else None))

        def loss_fn(m, b):
            logits, nsp = m(b["input_ids"], b["token_type_ids"],
                            b["attention_mask"], train=True)
            return tbert.bert_pretraining_loss(
                logits, nsp, b["masked_lm_labels"], b["next_sentence_labels"])

        return model, loss_fn, _bert_batch()[1]
    model = TV.port_model(params)

    def loss_fn(m, b):
        return tdata.softmax_xent(m(b["image"], train=True), b["label"])

    return model, loss_fn, _vit_batch()[1]


@pytest.fixture(scope="module")
def group():
    from dear_pytorch_tpu_torch.comm import backend

    return backend.init("cpu")


@pytest.mark.parametrize("case", sorted(CASES))
def test_dear_steps_match_jax(case, group):
    opts = CASES[case]
    lr, mom = opts["opt"]
    bf16 = opts.get("comm") == "bf16"
    params, jloss, jbatch, to_torch = _jax_side(opts)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("dp",))
    jts = jdear.build_train_step(
        jloss, params, optimizer=jopt.fused_sgd(lr=lr, momentum=mom),
        mesh=mesh, mode="dear", threshold_mb=THRESHOLD_MB,
        comm_dtype=jnp.bfloat16 if bf16 else None)
    jstate = jts.init(jax.tree.map(jnp.copy, params))
    jlosses = []
    for _ in range(STEPS):
        jstate, m = jts.step(jstate, jbatch)
        jlosses.append(float(m["loss"]))
    want = to_torch(jax.tree.map(np.asarray, jts.gather_params(jstate)))

    model, loss_fn, batch = _port_model(opts, params)
    ts = tdear.build_train_step(
        loss_fn, model, optimizer=topt.fused_sgd(lr=lr, momentum=mom),
        group=group, device="cpu", mode="dear", threshold_mb=THRESHOLD_MB,
        comm_dtype=torch.bfloat16 if bf16 else None)
    state = ts.init()
    losses = []
    for _ in range(STEPS):
        state, m = ts.step(state, batch)
        losses.append(float(m["loss"]))
    got = ts.gather_params(state)
    assert ts.plan.num_buckets >= 3
    assert ts.rs_launches == ts.update_launches == STEPS * ts.plan.num_buckets

    tol = TOL_BF16 if bf16 else TOL
    np.testing.assert_allclose(losses, jlosses, rtol=tol, atol=tol)
    assert losses[-1] < losses[0]
    assert set(got) == set(want)
    init, moved = to_torch(params), 0.0
    for name, value in got.items():
        np.testing.assert_allclose(value.numpy(), want[name].numpy(),
                                   rtol=tol, atol=tol, err_msg=name)
        moved = max(moved, float((value - init[name]).abs().max()))
    assert moved > (1e-6 if lr < 1e-3 else 1e-3)   # the steps moved them
