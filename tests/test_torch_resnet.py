"""The port's ResNet (dear_pytorch_tpu_torch.models.resnet) against the JAX
package's flax ResNet on the CPU, with the flax weights carried across by
`models.convert.resnet_params_from_jax`.

Small sizes: width 8, stages (1, 1, 1) of bottleneck and of basic blocks,
batch 2, images of 33 px (the 7x7 stem; odd, so the padding edges count)
or 32 px (the space-to-depth stem packs 2x2 blocks). The flax init's BN
scales, biases and running statistics are drawn anew from a numpy seed, so
no block's branch is switched off by its zero-initialised last BN.

Tolerances: fp32 2e-4 (tests/test_convert.py's, for summation order over
a few convs). bf16 1e-2 of the largest |value|, a few bf16 ulps (2^-8,
0.4% relative, each): both packages round every conv and BN output to
bf16, and fp32 sums taken in another order round to neighbouring bf16
values now and then; such a difference passes through the later layers,
and the batch statistics of a small map are taken over few values.

The train-mode running variance is flax's biased one; at the last stage the
map is tiny (3x3 or 2x2 at batch 2), so an unbiased update, n/(n-1) larger,
would miss the fp32 tolerance by far: the test asserts that it would.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dear_pytorch_tpu import models as jmodels
from dear_pytorch_tpu.models import convert as jconvert
from dear_pytorch_tpu.models import data as jdata
from dear_pytorch_tpu.models import resnet as jres
from dear_pytorch_tpu_torch import models as tmodels
from dear_pytorch_tpu_torch.models import data as tdata
from dear_pytorch_tpu_torch.models import resnet as tres
from dear_pytorch_tpu_torch.models.convert import resnet_params_from_jax

WIDTH, CLASSES, B = 8, 5, 2
TOL, TOL_BF16 = 2e-4, 1e-2
#: name -> (stage sizes, flax block, port block)
ARCHS = {
    "bottleneck": ((1, 1, 1), jres.BottleneckBlock, tres.BottleneckBlock),
    "basic": ((1, 1, 1), jres.BasicBlock, tres.BasicBlock),
}
SIZE = {"conv7": 33, "s2d": 32}


def _flax_model(arch, stem, dtype=jnp.float32):
    stages, jblock, _ = ARCHS[arch]
    return jres.ResNet(stage_sizes=stages, block=jblock, num_classes=CLASSES,
                       width=WIDTH, dtype=dtype, stem=stem)


def _port_model(arch, stem, dtype=torch.float32):
    stages, _, tblock = ARCHS[arch]
    return tres.ResNet(stages, tblock, num_classes=CLASSES, width=WIDTH,
                       dtype=dtype, stem=stem, device="cpu")


def flax_variables(arch, stem, seed=0):
    """Flax init, with BN scale, bias, mean and var redrawn from numpy."""
    size = SIZE[stem]
    v = _flax_model(arch, stem).init(
        {"params": jax.random.PRNGKey(seed)},
        jnp.zeros((1, size, size, 3)), train=False)
    rs = np.random.RandomState(seed + 10)
    params = jax.tree.map(np.asarray, v["params"])
    stats = jax.tree.map(np.asarray, v["batch_stats"])

    def redraw(tree, key, lo, hi):
        if isinstance(tree, dict):
            return {k: (rs.uniform(lo, hi, x.shape).astype(np.float32)
                        if k == key else redraw(x, key, lo, hi))
                    for k, x in tree.items()}
        return tree

    params = redraw(redraw(params, "scale", 0.5, 1.5), "bias", -0.3, 0.3)
    params["fc"]["bias"] = rs.uniform(-0.3, 0.3, CLASSES).astype(np.float32)
    stats = redraw(redraw(stats, "mean", -0.2, 0.2), "var", 0.6, 1.4)
    return params, stats


def _images(stem, seed=3):
    size = SIZE[stem]
    return np.random.RandomState(seed).randn(B, 3, size, size).astype(
        np.float32)


def _nhwc(x):
    return jnp.asarray(x.transpose(0, 2, 3, 1))


def _port_stats(model):
    """The port's running buffers in flax's batch_stats layout."""
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    params, stats = jconvert.convert_resnet_from_torch(
        sd, stage_sizes=model.stage_sizes)
    return stats


def _close(got, want, tol, err_msg=""):
    if tol == TOL:
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol,
                                   err_msg=err_msg)
    else:   # bf16: of the largest |value|
        scale = max(float(np.abs(want).max()), 1e-6)
        err = float(np.abs(np.asarray(got, np.float64) - want).max())
        assert err <= tol * scale, (err_msg, err, scale)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("stem", ["conv7", "s2d"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_forward_matches_flax(arch, stem, train, dtype):
    """Logits and (train) the updated batch_stats against flax."""
    jdt, tdt, tol = ((jnp.float32, torch.float32, TOL) if dtype == "fp32"
                     else (jnp.bfloat16, torch.bfloat16, TOL_BF16))
    params, stats = flax_variables(arch, stem)
    x = _images(stem)
    jmodel = _flax_model(arch, stem, jdt)
    if train:
        want, new = jmodel.apply({"params": params, "batch_stats": stats},
                                 _nhwc(x), train=True,
                                 mutable=["batch_stats"])
        want_stats = jax.tree.map(np.asarray, new["batch_stats"])
    else:
        want = jmodel.apply({"params": params, "batch_stats": stats},
                            _nhwc(x), train=False)
    want = np.asarray(want)

    model = _port_model(arch, stem, tdt)
    model.load_state_dict(resnet_params_from_jax(
        params, stats, stage_sizes=model.stage_sizes, stem=stem))
    model.train(train)
    shapes = []
    hooks = [m.register_forward_hook(
        lambda m, i, o: shapes.append(tuple(i[0].shape)))
        for m in model.modules() if isinstance(m, tres.BatchNorm2d)]
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    for h in hooks:
        h.remove()
    assert got.dtype == torch.float32 and got.shape == (B, CLASSES)
    _close(got.numpy(), want, tol, "logits")
    if not train:
        return
    got_stats = _port_stats(model)
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want_stats),
                            jax.tree.leaves(got_stats)):
        _close(g, w, tol, jax.tree_util.keystr(path))
    assert all(int(m.num_batches_tracked) == 1 for m in model.modules()
               if isinstance(m, tres.BatchNorm2d))
    # an unbiased running variance would be off by 0.1 var / (n - 1) at the
    # last stage's tiny map: far outside the fp32 tolerance
    n = min(s[0] * s[2] * s[3] for s in shapes)
    assert n <= B * 3 * 3 and 0.1 * 0.6 / (n - 1) > 10 * TOL


@pytest.mark.parametrize("stem", ["conv7", "s2d"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_converter_round_trips_through_the_reference(arch, stem):
    """port state_dict -> the JAX package's convert_resnet_from_torch ->
    resnet_params_from_jax is the identity (the s2d stem's [F, 4C, 4, 4]
    weight maps to its [4, 4, 4C, F] kernel directly, so the reference's
    conv7 mapping carries it); and it inverts the flax -> port direction."""
    model = _port_model(arch, stem)
    sd = model.state_dict()
    params, stats = jconvert.convert_resnet_from_torch(
        {k: v.numpy() for k, v in sd.items()}, stage_sizes=model.stage_sizes)
    back = resnet_params_from_jax(params, stats,
                                  stage_sizes=model.stage_sizes, stem=stem)
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        torch.testing.assert_close(back[k], v, rtol=0, atol=0, msg=k)
    fparams, fstats = flax_variables(arch, stem)
    sd2 = resnet_params_from_jax(fparams, fstats,
                                 stage_sizes=model.stage_sizes, stem=stem)
    p2, s2 = jconvert.convert_resnet_from_torch(
        {k: v.numpy() for k, v in sd2.items()},
        stage_sizes=model.stage_sizes)
    for a, b in ((p2, fparams), (s2, fstats)):
        jax.tree.map(np.testing.assert_array_equal, a, b)
    with pytest.raises(ValueError, match="stem"):
        resnet_params_from_jax(fparams, fstats,
                               stage_sizes=model.stage_sizes,
                               stem="conv7" if stem == "s2d" else "s2d")


def test_s2d_stem_is_the_conv7_stem_under_the_repack():
    """A torchvision-shaped conv7 state_dict, carried into the s2d model
    through the reference's repack (convert_resnet_from_torch(stem="s2d")),
    computes the conv7 model's function; the port's numpy repack and
    space_to_depth equal the JAX package's."""
    conv7 = _port_model("bottleneck", "conv7").eval()
    sd = {k: v.numpy() for k, v in conv7.state_dict().items()}
    params, stats = jconvert.convert_resnet_from_torch(
        sd, stage_sizes=conv7.stage_sizes, stem="s2d")
    s2d = _port_model("bottleneck", "s2d").eval()
    s2d.load_state_dict(resnet_params_from_jax(
        params, stats, stage_sizes=s2d.stage_sizes, stem="s2d"))
    x = torch.from_numpy(_images("s2d"))
    with torch.no_grad():
        torch.testing.assert_close(s2d(x), conv7(x), rtol=TOL, atol=TOL)
    k7 = np.random.RandomState(1).randn(7, 7, 3, 8).astype(np.float32)
    np.testing.assert_array_equal(tres.repack_stem_conv7_to_s2d(k7),
                                  np.asarray(jres.repack_stem_conv7_to_s2d(k7)))
    xs = np.random.RandomState(2).randn(2, 3, 8, 6).astype(np.float32)
    np.testing.assert_array_equal(
        tres.space_to_depth(torch.from_numpy(xs)).numpy().transpose(
            0, 2, 3, 1),
        np.asarray(jres.space_to_depth(_nhwc(xs))))
    with pytest.raises(ValueError, match="7x7"):
        tres.repack_stem_conv7_to_s2d(np.zeros((3, 3, 3, 8)))


@pytest.mark.parametrize("name,count", [("resnet50", 25_557_032),
                                        ("resnet18", 11_689_512)])
def test_param_counts_match_jax(name, count):
    """tests/test_models.py's torchvision counts, which the flax models
    reach too; and torchvision's state-dict names."""
    model = tmodels.get_model(name, device="cpu")
    assert sum(p.numel() for p in model.parameters()) == count
    names = set(model.state_dict())
    assert {"conv1.weight", "bn1.running_var", "layer1.0.conv1.weight",
            "layer2.0.downsample.0.weight", "layer2.0.downsample.1.weight",
            "layer4.1.bn2.num_batches_tracked", "fc.weight",
            "fc.bias"} <= names
    assert model.conv1.weight.is_contiguous()


def test_seeded_init_has_flax_scale():
    """The port's init draws from flax's distributions: every conv and fc
    kernel is flax's lecun-normal (a normal truncated at two stds, scaled
    to variance 1/fan_in: its std within 5% of 1/sqrt(fan_in), every |w|
    within the truncation), the fc bias 0; BN scale 1, each block's last
    BN 0; one seed replays, another does not."""
    model = tmodels.get_model("resnet18", device="cpu", seed=1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() < 2:
                continue
            want = 1 / np.sqrt(np.prod(p.shape[1:]))
            assert abs(float(p.std()) - want) <= 0.05 * want, name
            assert float(p.abs().max()) <= 2 * want / 0.87962566 + 1e-6
    assert torch.all(model.fc.bias == 0)
    for blk in (model.layer1[0], model.layer2[0], model.layer4[1]):
        assert torch.all(blk.bn2.weight == 0)
        assert torch.all(blk.bn1.weight == 1)
    again = tmodels.get_model("resnet18", device="cpu", seed=1)
    other = tmodels.get_model("resnet18", device="cpu", seed=2)
    assert torch.equal(again.conv1.weight, model.conv1.weight)
    assert not torch.equal(other.conv1.weight, model.conv1.weight)


def test_registry_lists_only_ported_cnns():
    assert tmodels.cnn_names() == ["resnet101", "resnet152", "resnet18",
                                   "resnet34", "resnet50", "vit_b16",
                                   "vit_s16"]
    assert set(tmodels.cnn_names()) <= set(jmodels.cnn_names())
    m = tmodels.get_model("ResNet18", device="cpu", stem="s2d",
                          dtype=torch.bfloat16)
    assert m.stem == "s2d" and m.conv1.weight.shape == (64, 12, 4, 4)
    assert m.dtype == torch.bfloat16 and m.conv1.weight.dtype == \
        torch.float32
    for name in ("densenet121", "vgg16", "inceptionv4", "mnistnet"):
        with pytest.raises(KeyError, match="item 5b"):
            tmodels.get_model(name, device="cpu")
    with pytest.raises(ValueError, match="stem"):
        tmodels.get_model("resnet18", device="cpu", stem="s4d")


def test_synthetic_image_batch_and_softmax_xent():
    """The batch's shapes, dtypes and device, reproducible from a seed;
    `softmax_xent` equal to the JAX package's on one numpy input."""
    a = tdata.synthetic_image_batch(0, 3, image_size=16, num_classes=7,
                                    dtype=torch.bfloat16, device="cpu")
    b = tdata.synthetic_image_batch(torch.Generator().manual_seed(0), 3,
                                    image_size=16, num_classes=7,
                                    dtype=torch.bfloat16)
    assert a["image"].shape == (3, 3, 16, 16)
    assert a["image"].dtype == torch.bfloat16
    assert a["label"].dtype == torch.int64
    assert int(a["label"].min()) >= 0 and int(a["label"].max()) < 7
    assert torch.equal(a["image"], b["image"])
    assert torch.equal(a["label"], b["label"])
    rs = np.random.RandomState(4)
    logits = rs.randn(6, 11).astype(np.float32) * 3
    labels = rs.randint(0, 11, 6)
    want = float(jdata.softmax_xent(jnp.asarray(logits), jnp.asarray(labels)))
    got = float(tdata.softmax_xent(torch.from_numpy(logits).bfloat16()
                                   .float(), torch.from_numpy(labels)))
    want_bf = float(jdata.softmax_xent(jnp.asarray(logits).astype(
        jnp.bfloat16), jnp.asarray(labels)))
    np.testing.assert_allclose(got, want_bf, rtol=1e-6)
    got = float(tdata.softmax_xent(torch.from_numpy(logits),
                                   torch.from_numpy(labels)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
