"""Held repairs of the port: ``fsdp`` recomputes the cast of a VIEW of a
parameter (``weight.t()``, a reshape or a permute before the cast) from the
re-gathered bucket, as it does a cast of the parameter itself, instead of
keeping the cast's copy alive from the forward to the backward.

The module below computes in fp32 over bf16 buckets (``gather_dtype``
bf16), so every product reads a cast of a parameter view. The saved-tensor
hooks are held directly: whatever fsdp's pack keeps as a tensor must not be
a cast (``ToCopyBackward0``) of a parameter, and every such cast must be
saved as a reference that casts again on unpack. The run's losses and
parameters equal ``dear``'s with the same wire dtypes, bit for bit."""

import numpy as np
import pytest
import torch

from dear_pytorch_tpu_torch.ops import fused_sgd as topt
from dear_pytorch_tpu_torch.parallel import dear as tdear


class ViewCasts(torch.nn.Module):
    """Three products of views of parameters, each cast to fp32."""

    def __init__(self, seed: int):
        super().__init__()
        rng = np.random.default_rng(seed)

        def param(*shape):
            return torch.nn.Parameter(torch.from_numpy(
                rng.standard_normal(shape).astype(np.float32) * 0.3))

        self.u = param(6, 6)
        self.w = param(8, 6)
        self.v = param(3, 4, 6)
        self.device = torch.device("cpu")

    def forward(self, x):
        a = torch.tanh(x @ self.u.float())
        h1 = a @ self.w.t().float()                              # t
        h2 = a @ self.v.reshape(12, 6).t().float()               # view, t
        h3 = a @ self.v.permute(2, 0, 1).reshape(6, 12).float()  # permute
        return (h1 ** 2).mean() + (h2 ** 2).mean() + (h3 ** 2).mean()


def _run(mode, group):
    bf16 = torch.bfloat16
    model = ViewCasts(0)
    ts = tdear.build_train_step(
        lambda m, b: m(b["x"]), model,
        optimizer=topt.fused_sgd(lr=0.1, momentum=0.9), group=group,
        device="cpu", mode=mode, threshold_mb=0.0001, gather_dtype=bf16,
        comm_dtype=None if mode == "fsdp" else bf16)
    seen = {"kept_casts": 0, "recasts": 0}
    if mode == "fsdp":
        pack = ts._pack

        def counting_pack(t):
            saved = pack(t)
            if saved is not t:
                seen["recasts"] += saved.cast is not None
            elif type((t if t._base is None else t._base).grad_fn
                      ).__name__ == "ToCopyBackward0":
                seen["kept_casts"] += 1
            return saved

        ts._pack = counting_pack
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (4, 6)).astype(np.float32))
    state = ts.init()
    losses = []
    for _ in range(3):
        state, m = ts.step(state, {"x": x})
        losses.append(float(m["loss"]))
    final = {k: v.clone() for k, v in ts.gather_params(state).items()}
    ts.close()
    return losses, final, seen


@pytest.fixture(scope="module")
def group():
    from dear_pytorch_tpu_torch.comm import backend

    return backend.init("cpu")


def test_fsdp_recasts_parameter_views_and_equals_dear(group):
    losses, final, seen = _run("fsdp", group)
    d_losses, d_final, _ = _run("dear", group)
    # the three view casts, in each of 3 forwards (u's cast is not saved:
    # its product's other operand needs no gradient)
    assert seen["kept_casts"] == 0, seen
    assert seen["recasts"] == 3 * 3, seen
    assert losses == d_losses
    for name, p in final.items():
        assert torch.equal(p, d_final[name]), name
