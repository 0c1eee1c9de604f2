"""The rest of the port's model zoo (dear_pytorch_tpu_torch.models:
DenseNet, Inception-v4, VGG, MnistNet) against the JAX package's flax
models on the CPU, with the flax weights carried across by the
`models.convert.*_params_from_jax` converters.

The forward cases of DenseNet and Inception-v4 run in
tests/test_torch_densenet.py and tests/test_torch_inception.py through
`check_forward`. Small sizes, full widths: DenseNet-121 and -201 on 64 px images (the
7x7/2 SAME stem pads (2, 3) on an even side; their last map is 2x2, the
BN statistics of a 1x1 map at batch 2 being ill-conditioned), a DenseNet
cut to two blocks of three layers on 33 px, Inception-v4 on 107 px in
train mode (its last map 2x2) and on 75 px, the smallest input its VALID
reductions allow, in eval mode, VGG-11
and -16 on 64 px (fc1 reads a 2x2x512 map, so a flatten in the wrong
order fails), MnistNet on 28 px; batch 2, 10 classes. The flax init's BN
scales, biases and running statistics are redrawn from a numpy seed.

Tolerances, as tests/test_torch_resnet.py's: fp32 2e-4; bf16 1e-2 of the
largest |value| (both packages round every conv and BN output to bf16; a
sum in another order rounds to a neighbouring bf16 value now and then).
The flax references are jitted, but for the bf16 train-mode case, which
runs flax eagerly (a jitted forward keeps fused intermediates in fp32).

The DeAR steps of a DenseNet and VGG-11 are in tests/test_torch_dear_zoo.py;
the real digits' loader and the sharded sampler are held byte for byte
against the JAX package's.
"""

import contextlib
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dear_pytorch_tpu.models import data as jdata
from dear_pytorch_tpu.models import densenet as jdense
from dear_pytorch_tpu.models import inception as jinc
from dear_pytorch_tpu.models import mnist as jmnist
from dear_pytorch_tpu.models import vgg as jvgg
from dear_pytorch_tpu_torch import models as tmodels
from dear_pytorch_tpu_torch.models import convert as tconvert
from dear_pytorch_tpu_torch.models import data as tdata
from dear_pytorch_tpu_torch.models import densenet as tdense
from dear_pytorch_tpu_torch.models import inception as tinc
from dear_pytorch_tpu_torch.models import mnist as tmnist
from dear_pytorch_tpu_torch.models import resnet as tres
from dear_pytorch_tpu_torch.models import vgg as tvgg

B, CLASSES = 2, 10
TOL, TOL_BF16 = 2e-4, 1e-2

#: name -> (flax model, port model, image size, channels, has BN)
ZOO = {
    "densenet121": (functools.partial(jdense.DenseNet121,
                                      num_classes=CLASSES),
                    functools.partial(tdense.DenseNet121,
                                      num_classes=CLASSES), 64, 3, True),
    "densenet201": (functools.partial(jdense.DenseNet201,
                                      num_classes=CLASSES),
                    functools.partial(tdense.DenseNet201,
                                      num_classes=CLASSES), 64, 3, True),
    # two dense blocks of three layers: the bf16 train-mode case (below)
    "densenet_cut": (functools.partial(jdense.DenseNet, block_sizes=(3, 3),
                                       num_classes=CLASSES),
                     functools.partial(tdense.DenseNet, (3, 3),
                                       num_classes=CLASSES), 33, 3, True),
    "inceptionv4": (functools.partial(jinc.InceptionV4, num_classes=CLASSES),
                    functools.partial(tinc.InceptionV4, num_classes=CLASSES),
                    107, 3, True),
    "vgg11": (functools.partial(jvgg.VGG11, num_classes=CLASSES),
              functools.partial(tvgg.VGG11, num_classes=CLASSES,
                                image_size=64), 64, 3, False),
    "vgg16": (functools.partial(jvgg.VGG16, num_classes=CLASSES),
              functools.partial(tvgg.VGG16, num_classes=CLASSES,
                                image_size=64), 64, 3, False),
    "mnistnet": (jmnist.MnistNet, tmnist.MnistNet, 28, 1, False),
}
CONVERT = {"densenet": tconvert.densenet_params_from_jax,
           "inceptionv4": tconvert.inception_params_from_jax,
           "vgg": lambda p, s: tconvert.vgg_params_from_jax(p),
           "mnistnet": lambda p, s: tconvert.mnist_params_from_jax(p)}


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads for the module's torch work, then the old
    count: the zoo's convs at 8 threads beside the other workers of a
    parallel run oversubscribe the cores (alone, 2 threads were faster
    too: 65 s against 83 s for the DenseNet file)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@contextlib.contextmanager
def shapes_only():
    """Models built on the ``meta`` device hold no values to draw: the
    zoo's constructors skip `flax_init_` while this is open."""
    with contextlib.ExitStack() as stack:
        for mod in (tdense, tinc, tvgg, tmnist):
            stack.enter_context(mock.patch.object(
                mod, "flax_init_", lambda *a, **k: None))
        yield


def bn_forward_fp64(self, x):
    """`tres.BatchNorm2d.forward` (train mode) with the statistics in the
    input's fp64: the fp64 reference case's BatchNorm; the port's own
    runs them in fp32."""
    assert self.training and x.dtype == torch.float64
    y, mean, invstd = torch.native_batch_norm(
        x, self.weight, self.bias, None, None, True, 0.0, self.eps)
    with torch.no_grad():
        self.running_mean.lerp_(mean, self.momentum)
        self.running_var.lerp_(invstd.pow(-2).sub_(self.eps), self.momentum)
        self.num_batches_tracked.add_(1)
    return y


def _convert(name, params, stats):
    key = next(k for k in CONVERT if name.startswith(k))
    return CONVERT[key](params, stats)


def draw_variables(jmodel, size, ch, has_bn, bn_init=False):
    """The variables of the flax model ``jmodel()`` on ``size``² images of
    ``ch`` channels, drawn from a numpy seed at flax's shapes
    (``jax.eval_shape`` of its init: no init is compiled): kernels normal
    with variance 1/fan_in, biases uniform in (-0.3, 0.3), BN scales in
    (0.5, 1.5), running means in (-0.2, 0.2) and variances in (0.6, 1.4)
    — no branch switched off, no output at exactly zero. ``bn_init``:
    flax's BN scale 1 and bias 0 instead."""
    shapes = jax.eval_shape(
        lambda: jmodel().init({"params": jax.random.PRNGKey(0)},
                              jnp.zeros((1, size, size, ch)), train=False))
    rs = np.random.RandomState(10)

    def draw(tree):
        out = {}
        for k, x in tree.items():
            if isinstance(x, dict):
                out[k] = draw(x)
            elif k == "kernel":
                fan_in = int(np.prod(x.shape[:-1]))
                out[k] = (rs.randn(*x.shape) / np.sqrt(fan_in)).astype(
                    np.float32)
            else:
                lo, hi = {"scale": (0.5, 1.5), "bias": (-0.3, 0.3),
                          "mean": (-0.2, 0.2), "var": (0.6, 1.4)}[k]
                out[k] = rs.uniform(lo, hi, x.shape).astype(np.float32)
        return out

    params = draw(shapes["params"])
    if bn_init:
        def reset(tree):
            if "scale" in tree:
                return {"scale": np.ones_like(tree["scale"]),
                        "bias": np.zeros_like(tree["bias"])}
            return {k: reset(v) if isinstance(v, dict) else v
                    for k, v in tree.items()}

        params = reset(params)
    return params, draw(shapes["batch_stats"]) if has_bn else None


@functools.lru_cache(maxsize=None)
def flax_variables(name):
    """`draw_variables` of a ``ZOO`` model at its test size."""
    jmodel, _, size, ch, has_bn = ZOO[name]
    return draw_variables(jmodel, size, ch, has_bn)


def _images(name, seed=3, n=B, size=None):
    _, _, zoo_size, ch, _ = ZOO[name]
    size = size or zoo_size
    return np.random.RandomState(seed).randn(n, ch, size, size).astype(
        np.float32)


def _nhwc(x):
    return jnp.asarray(x.transpose(0, 2, 3, 1))


def port_model(name, dtype=torch.float32):
    """The port's model holding `flax_variables`: built on the meta device
    and the converted tensors assigned (the converters copy), so no init
    is drawn only to be overwritten."""
    _, tmodel, _, _, _ = ZOO[name]
    with shapes_only():
        model = tmodel(dtype=dtype, device="meta")
    model.load_state_dict(_convert(name, *flax_variables(name)), assign=True)
    return model


def _close(got, want, tol, err_msg=""):
    if tol == TOL:
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol,
                                   err_msg=err_msg)
    else:   # bf16: of the largest |value|
        scale = max(float(np.abs(want).max()), 1e-6)
        err = float(np.abs(np.asarray(got, np.float64) - want).max())
        assert err <= tol * scale, (err_msg, err, scale)


def _port_stats(model):
    """The port's running buffers, by module name (num_batches_tracked
    aside)."""
    return {k: v.numpy() for k, v in model.state_dict().items()
            if ".running_" in k}


def _stats_as_port(stats, prefix=""):
    out = {}
    for k, v in stats.items():
        if "mean" in v and not isinstance(v["mean"], dict):
            out[f"{prefix}{k}.running_mean"] = torch.from_numpy(
                np.asarray(v["mean"], np.float32))
            out[f"{prefix}{k}.running_var"] = torch.from_numpy(
                np.asarray(v["var"], np.float32))
        else:
            out.update(_stats_as_port(v, f"{prefix}{k}."))
    return out


#: (model, train mode, dtype). Eval mode in fp32 and bf16 (DenseNet-201
#: in bf16: its fp32 eval is DenseNet-121's code at more depth), train
#: mode in fp32 with BatchNorm. bf16 train mode on the cut DenseNet only:
#: a deep train-mode net in bf16 over a small batch is chaotic — at 64 px,
#: B = 2 to 8, DenseNet-121's bf16 logits in train mode were 3.5-10% of
#: the largest value from its own fp32 logits in BOTH packages, and 4-7%
#: from each other; no tolerance of a bf16 forward can hold that.
#: Inception-v4 in train mode is ill-conditioned in fp32 as well: at
#: 107 px, B = 2, both packages' fp32 logits were 3.8e-3 from the port's
#: own fp64 logits (1.3e-3 at 139 px), so it is held in fp64 on both
#: sides; in eval mode it runs at 75 px, the smallest input its VALID
#: reductions allow
FORWARD_CASES = [
    ("vgg11", False, "fp32"), ("vgg11", False, "bf16"),
    ("vgg16", False, "fp32"), ("vgg16", False, "bf16"),
    ("mnistnet", False, "fp32"), ("mnistnet", False, "bf16")]
#: the DenseNet cases (tests/test_torch_densenet.py) and the Inception-v4
#: ones (tests/test_torch_inception.py): files of their own, so that a
#: parallel run spreads the zoo's heaviest compiles over its workers
DENSENET_CASES = [
    ("densenet121", True, "fp32"), ("densenet121", False, "fp32"),
    ("densenet121", False, "bf16"), ("densenet201", True, "fp32"),
    ("densenet201", False, "bf16"), ("densenet_cut", True, "bf16")]
INCEPTION_CASES = [
    ("inceptionv4", True, "fp64"), ("inceptionv4", False, "fp32"),
    ("inceptionv4", False, "bf16")]
#: eval-mode image sides where they differ from ``ZOO``'s
EVAL_SIZE = {"inceptionv4": 75}


def case_ids(cases):
    return [f"{n}-{'train' if t else 'eval'}-{d}" for n, t, d in cases]


@pytest.mark.parametrize("name,train,dtype", FORWARD_CASES,
                         ids=case_ids(FORWARD_CASES))
def test_forward_matches_flax(name, train, dtype):
    """VGG and MnistNet in eval mode against flax; their train mode is
    their dropout, held to its statistics below."""
    check_forward(name, train, dtype)


def check_forward(name, train, dtype):
    """The port's logits and (train mode, the BN models) its updated
    running statistics against flax's."""
    jdt, tdt, tol = {"fp32": (jnp.float32, torch.float32, TOL),
                     "fp64": (jnp.float64, torch.float64, TOL),
                     "bf16": (jnp.bfloat16, torch.bfloat16, TOL_BF16)}[dtype]
    params, stats = flax_variables(name)
    x = _images(name, size=None if train else EVAL_SIZE.get(name))
    jmodel = ZOO[name][0](dtype=jdt)
    variables = {"params": params}
    if stats is not None:
        variables["batch_stats"] = stats
    # jitted (a first eager run compiles each op alone: slower), but the
    # bf16 train case eagerly, every intermediate rounded as flax rounds it
    with jax.disable_jit(train and dtype == "bf16"), \
            jax.enable_x64(dtype == "fp64"):
        if dtype == "fp64":
            variables = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                                     variables)
        if train:
            want, new = jax.jit(functools.partial(
                jmodel.apply, train=True, mutable=["batch_stats"]))(
                variables, _nhwc(x))
            want_stats = _stats_as_port(jax.tree.map(np.asarray,
                                                     new["batch_stats"]))
        else:
            want = jax.jit(functools.partial(jmodel.apply, train=False))(
                variables, _nhwc(x))
        want = np.asarray(want, np.float32)

    model = port_model(name, tdt)
    if dtype == "fp64":
        model.double()
    model.train(train)
    with torch.no_grad(), mock.patch.object(
            tres.BatchNorm2d, "forward", bn_forward_fp64) \
            if dtype == "fp64" else contextlib.nullcontext():
        got = model(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (B, CLASSES)
    _close(got.numpy(), want, tol, "logits")
    if not train:
        return
    got_stats = _port_stats(model)
    assert sorted(got_stats) == sorted(want_stats)
    for k, w in want_stats.items():
        _close(got_stats[k], w.numpy(), tol, k)
    assert all(int(m.num_batches_tracked) == 1 for m in model.modules()
               if isinstance(m, tres.BatchNorm2d))


def test_inception_avgpool_counts_the_zero_border():
    """The SAME 3x3/1 average pool against flax's on a 5x7 map: the corner
    of a constant map is 4/9 of it, an edge 6/9 (the zero padding counts),
    in fp32 and bf16."""
    import flax.linen as fnn

    x = np.random.RandomState(1).randn(2, 3, 5, 7).astype(np.float32)
    for jdt, tdt, tol in ((jnp.float32, torch.float32, 1e-6),
                          (jnp.bfloat16, torch.bfloat16, 1e-2)):
        want = np.asarray(fnn.avg_pool(_nhwc(x).astype(jdt), (3, 3),
                                       strides=(1, 1), padding="SAME"),
                          np.float32).transpose(0, 3, 1, 2)
        got = tinc.avgpool_same(torch.from_numpy(x).to(tdt)).float().numpy()
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    ones = tinc.avgpool_same(torch.ones(1, 1, 5, 7))[0, 0]
    assert float(ones[0, 0]) == pytest.approx(4 / 9)
    assert float(ones[0, 3]) == pytest.approx(6 / 9)
    assert float(ones[2, 3]) == pytest.approx(1.0)


def test_densenet_same_pad_is_flax_same():
    """The stem's SAME padding: (2, 3) on an even side at stride 2, (3, 3)
    on an odd one; the conv over it equals flax's SAME conv."""
    import flax.linen as fnn

    for size in (32, 33):
        x = np.random.RandomState(size).randn(1, 3, size, size).astype(
            np.float32)
        conv = fnn.Conv(4, (7, 7), strides=(2, 2), use_bias=False)
        v = conv.init(jax.random.PRNGKey(0), _nhwc(x))
        want = np.asarray(conv.apply(v, _nhwc(x))).transpose(0, 3, 1, 2)
        k = torch.from_numpy(np.asarray(v["params"]["kernel"])).permute(
            3, 2, 0, 1)
        got = torch.nn.functional.conv2d(
            tdense.same_pad(torch.from_numpy(x), 7, 2), k, stride=2)
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
        total = tdense.same_pad(torch.zeros(1, 1, size, size), 7, 2).shape[-1]
        assert total - size == (5 if size == 32 else 6)


def test_vgg_flattens_in_flax_order():
    """fc1 reads flax's (H, W, C) flatten of a 2x2x512 map: the forward
    matches (test_forward_matches_flax); a (C, H, W) flatten of the same
    weights does not."""
    model = port_model("vgg11").eval()
    assert model.fc1.in_features == 2 * 2 * 512
    x = torch.from_numpy(_images("vgg11"))
    params, _ = flax_variables("vgg11")
    want = np.asarray(ZOO["vgg11"][0]().apply({"params": params},
                                              _nhwc(x.numpy()), train=False))
    with torch.no_grad():
        np.testing.assert_allclose(model(x).numpy(), want, rtol=TOL, atol=TOL)
        feats = x.to(memory_format=torch.channels_last)
        i = 0
        for v in model.cfg:
            if v == "M":
                feats = torch.nn.functional.max_pool2d(feats, 2, 2)
            else:
                i += 1
                feats = torch.relu(getattr(model, f"conv{i}")(feats))
        wrong = model.fc3(torch.relu(model.fc2(torch.relu(model.fc1(
            feats.reshape(B, -1))))))
    assert float(np.abs(wrong.numpy() - want).max()) > 100 * TOL


@pytest.mark.parametrize("name", ["vgg11", "mnistnet"])
def test_dropout_statistics(name):
    """Train mode drops with the generator's masks: reproducible from a
    seed, different from eval and from another seed; MnistNet's first
    dropout drops whole feature maps (a map is either all zero or none of
    it is)."""
    model = port_model(name)
    x = torch.from_numpy(_images(name, n=4))
    with torch.no_grad():
        ev = model(x)
        a = model(x, train=True, generator=torch.Generator().manual_seed(1))
        b = model(x, train=True, generator=torch.Generator().manual_seed(1))
        c = model(x, train=True, generator=torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.equal(a, ev) and bool(torch.isfinite(a).all())
    with pytest.raises(ValueError, match="generator"):
        model(x, train=True)
    if name == "mnistnet":
        # Dropout2d: one draw per (image, channel) map, then one per fc1
        # unit; the forward recomputed by hand from those draws
        g = torch.Generator().manual_seed(3)
        keep2d = torch.rand((4, 20, 1, 1), generator=g) < 0.5
        keep = torch.rand((4, 50), generator=g) < 0.5
        F = torch.nn.functional
        with torch.no_grad():
            y = F.max_pool2d(F.relu(model.conv1(x)), 2, 2)
            y = model.conv2(y) * keep2d * 2.0
            y = F.max_pool2d(F.relu(y), 2, 2).permute(0, 2, 3, 1)
            y = F.relu(model.fc1(y.reshape(4, -1))) * keep * 2.0
            want = F.log_softmax(model.fc2(y), dim=-1)
            got = model(x, train=True,
                        generator=torch.Generator().manual_seed(3))
        torch.testing.assert_close(got, want)


@pytest.mark.parametrize("name,count", [("densenet201", 20_013_928),
                                        ("vgg16", 138_357_544),
                                        ("inceptionv4", 42_679_816)])
def test_param_counts_match_jax(name, count):
    """tests/test_models.py's torchvision counts, which the flax models
    reach too; the registry builds the default (1000-class, 224² / 299²)
    model (on the meta device: shapes only)."""
    with shapes_only():
        model = tmodels.get_model(name, device="meta")
    assert sum(p.numel() for p in model.parameters()) == count


def test_seeded_init_has_flax_scale():
    """flax's initialisers (lecun-normal kernels, zero biases, BN 1/0), one
    seed replays and another does not; the MnistNet of the example."""
    model = tmodels.get_model("mnistnet", device="cpu", seed=1)
    with torch.no_grad():
        for pname, p in model.named_parameters():
            if p.dim() < 2:
                assert torch.all(p == 0), pname
                continue
            want = 1 / np.sqrt(np.prod(p.shape[1:]))
            assert abs(float(p.std()) - want) <= 0.15 * want, pname
            assert float(p.abs().max()) <= 2 * want / 0.87962566 + 1e-6
    again = tmodels.get_model("mnistnet", device="cpu", seed=1)
    other = tmodels.get_model("mnistnet", device="cpu", seed=2)
    assert torch.equal(again.conv1.weight, model.conv1.weight)
    assert not torch.equal(other.conv1.weight, model.conv1.weight)
    dn = tdense.DenseNet((1, 1), growth_rate=4, num_classes=3, device="cpu")
    assert all(torch.all(m.weight == 1) for m in dn.modules()
               if isinstance(m, tres.BatchNorm2d))
    inc = tmodels.get_model("inceptionv4", device="cpu",
                            dtype=torch.bfloat16)
    assert inc.stem1.bn.eps == tinc.BN_EPS == 1e-3
    assert inc.dtype == torch.bfloat16 and inc.fc.weight.dtype == \
        torch.float32


def test_converters_round_trip_names_and_shapes():
    """Every converter covers every parameter and buffer of the port's
    model, each with its shape."""
    for name in ZOO:
        with shapes_only():
            model = ZOO[name][1](device="meta")
        want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
        sd = _convert(name, *flax_variables(name))
        assert {k: tuple(v.shape) for k, v in sd.items()} == want, name


@pytest.mark.parametrize("image_size,seed", [(28, 0), (8, 3), (17, 1)])
def test_load_real_digits_is_byte_identical_to_jax(image_size, seed):
    """The port's copy of the loader: the same arrays, byte for byte."""
    pytest.importorskip("sklearn")
    want = jdata.load_real_digits(image_size=image_size, seed=seed)
    got = tdata.load_real_digits(image_size=image_size, seed=seed)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


@pytest.mark.parametrize("n,world,shuffle", [(1797, 1, True), (1527, 2, True),
                                             (10, 4, True), (9, 2, False)])
def test_sharded_sampler_is_jax_s(n, world, shuffle):
    """Every rank's indices for every epoch equal the JAX package's; the
    shards partition the (wrap-padded) permutation; a bad rank raises."""
    for rank in range(world):
        a = tdata.ShardedSampler(n, world, rank, seed=1234, shuffle=shuffle)
        b = jdata.ShardedSampler(n, world, rank, seed=1234, shuffle=shuffle)
        assert a.shard_len == b.shard_len
        for epoch in range(3):
            np.testing.assert_array_equal(a.epoch_indices(epoch),
                                          b.epoch_indices(epoch))
    every = np.concatenate([tdata.ShardedSampler(n, world, r, seed=1)
                            .epoch_indices(0) for r in range(world)])
    assert set(every.tolist()) == set(range(n))
    with pytest.raises(ValueError, match="rank"):
        tdata.ShardedSampler(n, world, world)


def test_synthetic_mnist_batch():
    a = tdata.synthetic_mnist_batch(0, 5, device="cpu")
    b = tdata.synthetic_mnist_batch(torch.Generator().manual_seed(0), 5)
    assert a["image"].shape == (5, 1, 28, 28)
    assert a["image"].dtype == torch.float32
    assert a["label"].dtype == torch.int64
    assert 0 <= int(a["label"].min()) and int(a["label"].max()) < 10
    assert torch.equal(a["image"], b["image"])
    assert torch.equal(a["label"], b["label"])
