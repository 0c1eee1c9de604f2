"""The port's ViT (dear_pytorch_tpu_torch.models.vit) against the JAX
package's flax model on the CPU: a 2-layer ViT of narrow widths (hidden
32, 2 heads, MLP 64, patch 4 over 16² images: 16 patches and the [CLS]
token, 5 classes) with the same flax weights on both sides
(`models.convert.vit_params_from_jax`; every leaf moved off its init by
numpy noise, ``cls_token`` included), one numpy batch of NCHW images (NHWC
for flax). The forward in fp32 and bf16, the converter, the ViT-S/16 and
ViT-B/16 widths and the registry.

Tolerances: the largest difference over the largest |logit|, 2e-4 in fp32
(summation order) and 5e-2 in bf16. In bf16 every op rounds at its own
point in the two frameworks (flax rounds a dense layer's product before
adding the bias, torch's addmm once after), about twenty roundings stand
between the image and the [CLS] row, and the 5 logits per image come out
of sums that cancel: over four seeds flax's own bf16 logits lay up to
1.6e-2 from its fp32 ones and the port's up to 4.4e-2 (seed 0, this
test's), each above the other on two of the four.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dear_pytorch_tpu import models as jmodels
from dear_pytorch_tpu.models import vit as jvit
from dear_pytorch_tpu_torch import models as tmodels
from dear_pytorch_tpu_torch.models import vit as tvit
from dear_pytorch_tpu_torch.models.convert import vit_params_from_jax

WIDTHS = {"hidden_size": 32, "num_layers": 2, "num_heads": 2, "mlp_dim": 64,
          "patch": 4, "num_classes": 5}
SIZE, B = 16, 3
RTOL = {"fp32": 2e-4, "bf16": 5e-2}
DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def jax_params(seed=0):
    model = jvit.VisionTransformer(**WIDTHS)
    p = jax.jit(lambda key: model.init(
        {"params": key}, jnp.zeros((1, SIZE, SIZE, 3)), train=False))(
            jax.random.PRNGKey(seed))["params"]
    rs = np.random.RandomState(seed + 3)
    return jax.tree.map(
        lambda x: (np.asarray(x) + rs.normal(0, 0.05, x.shape)).astype(
            np.float32), p)


def port_model(params, dtype=torch.float32):
    model = tvit.VisionTransformer(**WIDTHS, dtype=dtype, image_size=SIZE,
                                   device="cpu")
    model.load_state_dict(vit_params_from_jax(params))
    return model


def images(seed=1):
    return np.random.RandomState(seed).randn(B, 3, SIZE, SIZE).astype(
        np.float32)


@pytest.fixture(scope="module")
def params():
    return jax_params()


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_forward_matches_flax(params, dt):
    jdt, tdt = DTYPES[dt]
    x = images()
    # eager: each op rounds to bf16 where the flax model says
    want = np.asarray(jvit.VisionTransformer(**WIDTHS, dtype=jdt).apply(
        {"params": params}, jnp.asarray(x.transpose(0, 2, 3, 1)),
        train=False))
    with torch.no_grad():
        got = port_model(params, tdt)(torch.from_numpy(x))
    assert got.shape == (B, 5) and got.dtype == torch.float32
    err = float(np.abs(got.numpy() - want).max() / np.abs(want).max())
    assert err <= RTOL[dt], (dt, err)


def test_converter_covers_every_parameter(params):
    sd = vit_params_from_jax(params)
    model = tvit.VisionTransformer(**WIDTHS, image_size=SIZE, device="cpu")
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd, strict=True)
    assert sum(v.numel() for v in sd.values()) == sum(
        np.size(x) for x in jax.tree.leaves(params))
    k = np.asarray(params["patch_embed"]["kernel"])          # [p, p, 3, E]
    np.testing.assert_array_equal(sd["patch_embed.weight"].numpy(),
                                  k.transpose(3, 2, 0, 1))
    assert sd["pos_embed"].shape == (1, 17, 32)


def test_init_follows_flax():
    """cls_token zeros, pos_embed normal(0.02), LayerNorm 1 / 0 (eps 1e-6),
    zero biases; one seed, one model."""
    a = tvit.VisionTransformer(**WIDTHS, image_size=SIZE, device="cpu")
    b = tvit.VisionTransformer(**WIDTHS, image_size=SIZE, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(),
                                                 b.state_dict().values()))
    assert bool((a.cls_token == 0).all())
    assert 0.005 < float(a.pos_embed.detach().std()) < 0.04
    assert a.block1.ln1.eps == 1e-6 and bool((a.ln_final.weight == 1).all())
    assert bool((a.block2.mlp_in.bias == 0).all())
    with pytest.raises(ValueError, match="divisible"):
        a(torch.zeros(1, 3, 18, 18))


def test_widths_and_registry_match_jax():
    for name in ("ViTS16", "ViTB16"):
        j = getattr(jvit, name)(num_layers=1)
        t = getattr(tvit, name)(num_layers=1, device="cpu")
        assert (t.hidden_size, t.patch, t.num_layers) == (
            j.hidden_size, j.patch, j.num_layers)
        assert t.block1.attn.num_heads == j.num_heads
        assert t.block1.mlp_in.out_features == j.mlp_dim
        assert t.head.out_features == j.num_classes
        assert t.pos_embed.shape == (1, 197, j.hidden_size)
    assert {"vit_s16", "vit_b16"} <= set(tmodels.cnn_names())
    assert set(tmodels.cnn_names()) <= set(jmodels.cnn_names())
    m = tmodels.get_model("vit_s16", device="cpu", num_layers=1,
                          dtype=torch.bfloat16, image_size=32)
    assert isinstance(m, tvit.VisionTransformer) and m.dtype == torch.bfloat16
    assert m.cls_token.dtype == torch.float32
