"""The port's BERT (dear_pytorch_tpu_torch.models.bert) against the JAX
package's flax model on the CPU: a 2-layer BERT of narrow widths (hidden
32, 2 heads, vocab 61 padded to 64) with the same flax weights on both
sides (`models.convert.bert_params_from_jax`; every leaf moved off its
init by numpy noise, so no zero bias hides a wrong mapping), the same
numpy batch with per-row padding lengths and random token types. The
forward with the dense core and with `make_flash_attention_impl` (JAX's
Pallas kernel in interpret mode, the port's plain versions), the
pre-training loss and its gradients, the converter, the configs and the
registry, `synthetic_bert_batch`, and dropout held to its statistics.

Tolerances: the largest difference over the largest |value|, 2e-4 in fp32
(summation order) and 1e-2 in bf16 (every op rounds to bf16 at its own
point in the two frameworks); gradients 1e-4 of each parameter's largest.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dear_pytorch_tpu import models as jmodels
from dear_pytorch_tpu.models import bert as jbert
from dear_pytorch_tpu.models import data as jdata
from dear_pytorch_tpu.ops import make_flash_attention_impl as jflash_impl
from dear_pytorch_tpu_torch import models as tmodels
from dear_pytorch_tpu_torch.models import bert as tbert
from dear_pytorch_tpu_torch.models import data as tdata
from dear_pytorch_tpu_torch.models.convert import bert_params_from_jax
from dear_pytorch_tpu_torch.ops import flash_attention as FA

B, S, VOCAB = 3, 16, 61
LENGTHS = [16, 11, 5]
RTOL = {"fp32": 2e-4, "bf16": 1e-2}
DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def jax_config(dtype=jnp.float32, **kw):
    return jbert.BertConfig(
        vocab_size=VOCAB, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=2, intermediate_size=64,
        max_position_embeddings=32, dtype=dtype, **kw)


def torch_config(jcfg, dtype=torch.float32):
    """The port's config with the JAX config's fields (and ``dtype``)."""
    kw = {f.name: getattr(jcfg, f.name)
          for f in dataclasses.fields(tbert.BertConfig)}
    kw["dtype"] = dtype
    return tbert.BertConfig(**kw)


def jax_params(cfg=None, seed=0):
    """flax init, every leaf plus numpy noise (biases, LN, mlm_bias too)."""
    model = jbert.BertForPreTraining(cfg or jax_config())
    p = jax.jit(lambda key: model.init(
        {"params": key}, jnp.zeros((1, S), jnp.int32), train=False))(
            jax.random.PRNGKey(seed))["params"]
    rs = np.random.RandomState(seed + 3)
    return jax.tree.map(
        lambda x: (np.asarray(x) + rs.normal(0, 0.05, x.shape)).astype(
            np.float32), p)


def batch(seed=1):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, VOCAB, (B, S)).astype(np.int32)
    types = rs.randint(0, 2, (B, S)).astype(np.int32)
    mask = (np.arange(S)[None, :] < np.array(LENGTHS)[:, None]).astype(
        np.int32)
    labels = np.where(rs.rand(B, S) < 0.3, rs.randint(0, VOCAB, (B, S)),
                      -1).astype(np.int32)
    nsp = rs.randint(0, 2, (B,)).astype(np.int32)
    return {"input_ids": ids, "token_type_ids": types,
            "attention_mask": mask, "masked_lm_labels": labels,
            "next_sentence_labels": nsp}


def port_model(params, jcfg, dtype=torch.float32, attention_impl=None):
    model = tbert.BertForPreTraining(torch_config(jcfg, dtype),
                                     attention_impl=attention_impl,
                                     device="cpu")
    model.load_state_dict(bert_params_from_jax(params, jcfg))
    return model


def _rel(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def params():
    return jax_params()


@pytest.mark.parametrize("flash", [False, True], ids=["dense", "flash"])
@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_forward_matches_flax(params, dt, flash):
    jdt, tdt = DTYPES[dt]
    jcfg = jax_config(jdt)
    b = batch()
    jm = jbert.BertForPreTraining(
        jcfg, attention_impl=jflash_impl() if flash else None)
    # eager: each op rounds to bf16 where the flax model says (a jitted
    # program may keep fused intermediates in fp32)
    want = jm.apply({"params": params}, b["input_ids"], b["token_type_ids"],
                    b["attention_mask"], train=False)
    model = port_model(params, jcfg, tdt,
                       FA.make_flash_attention_impl() if flash else None)
    with torch.no_grad():
        got = model(*(torch.from_numpy(b[k]) for k in (
            "input_ids", "token_type_ids", "attention_mask")))
    assert got[0].shape == (B, S, 64) and got[1].shape == (B, 2)
    assert got[0].dtype == got[1].dtype == torch.float32
    for g, w in zip(got, want):
        assert _rel(g.numpy(), w) <= RTOL[dt], (dt, flash, _rel(g, w))


def test_loss_and_gradients_match_jax(params):
    """`bert_pretraining_loss` of the fp32 forward and its gradient with
    respect to every parameter, by name."""
    jcfg = jax_config()
    b = batch(2)
    jm = jbert.BertForPreTraining(jcfg)

    def jloss(p):
        logits, nsp = jm.apply({"params": p}, b["input_ids"],
                               b["token_type_ids"], b["attention_mask"],
                               train=False)
        return jbert.bert_pretraining_loss(logits, nsp,
                                           b["masked_lm_labels"],
                                           b["next_sentence_labels"])

    want, jgrads = jax.jit(jax.value_and_grad(jloss))(params)
    want_grads = bert_params_from_jax(jax.tree.map(np.asarray, jgrads), jcfg)
    model = port_model(params, jcfg)
    t = {k: torch.from_numpy(v) for k, v in b.items()}
    logits, nsp = model(t["input_ids"], t["token_type_ids"],
                        t["attention_mask"])
    loss = tbert.bert_pretraining_loss(logits, nsp, t["masked_lm_labels"],
                                       t["next_sentence_labels"])
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert set(grads) == set(want_grads)
    for n, g in grads.items():
        w = want_grads[n].numpy()
        scale = max(float(np.abs(w).max()), 1e-6)
        assert float(np.abs(g.numpy() - w).max()) <= 1e-4 * scale, n


def test_loss_ignores_unlabelled_positions():
    """Only labelled positions count (the mean over them), plus the NSP
    mean; no labelled position gives the NSP term alone."""
    rs = np.random.RandomState(4)
    logits = torch.from_numpy(rs.randn(2, 5, 8).astype(np.float32))
    nsp = torch.from_numpy(rs.randn(2, 2).astype(np.float32))
    labels = torch.tensor([[3, -1, -1, 0, -1], [-1, -1, 7, -1, -1]])
    nsp_labels = torch.tensor([1, 0])
    got = tbert.bert_pretraining_loss(logits, nsp, labels, nsp_labels)
    want = jbert.bert_pretraining_loss(
        jnp.asarray(logits.numpy()), jnp.asarray(nsp.numpy()),
        jnp.asarray(labels.numpy()), jnp.asarray(nsp_labels.numpy()))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    none = tbert.bert_pretraining_loss(logits, nsp, torch.full((2, 5), -1),
                                       nsp_labels)
    nsp_only = torch.nn.functional.cross_entropy(nsp, nsp_labels)
    np.testing.assert_allclose(float(none), float(nsp_only), rtol=1e-6)


def test_converter_covers_every_parameter(params):
    jcfg = jax_config()
    sd = bert_params_from_jax(params, jcfg)
    model = tbert.BertForPreTraining(torch_config(jcfg), device="cpu")
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd, strict=True)
    n_flax = sum(np.size(x) for x in jax.tree.leaves(params))
    assert sum(v.numel() for v in sd.values()) == n_flax
    # the [h, nh, d] / [nh, d, h] kernels land as [out, in] weights
    q = np.asarray(params["layer_1"]["attention"]["query"]["kernel"])
    np.testing.assert_array_equal(
        sd["layer_1.attention.query.weight"].numpy(), q.reshape(32, 32).T)
    o = np.asarray(params["layer_0"]["attention"]["output"]["kernel"])
    np.testing.assert_array_equal(
        sd["layer_0.attention.output.weight"].numpy(), o.reshape(32, 32).T)


def test_configs_and_registry_match_jax():
    for name in ("BERT_BASE", "BERT_LARGE"):
        j, t = getattr(jbert, name), getattr(tbert, name)
        jf = {f.name: getattr(j, f.name) for f in dataclasses.fields(j)}
        tf = {f.name: getattr(t, f.name) for f in dataclasses.fields(t)}
        # the decode path's fields wait with it (ROADMAP item 5b)
        assert set(jf) - set(tf) == {"kv_cache_len", "decode_use_flash",
                                     "kv_cache_dtype"}
        for k in tf:
            if k != "dtype":
                assert tf[k] == jf[k], (name, k)
        assert t.dtype == torch.float32 and t.padded_vocab_size == \
            j.padded_vocab_size == 30528
    assert tmodels.bert_names() == jmodels.bert_names()
    for name in ("bert", "BERT_LARGE", "bert_base", "gpt2", "resnet50"):
        assert tmodels.is_bert(name) == jmodels.is_bert(name)
    assert tmodels.bert_config("bert") == tbert.BERT_LARGE
    cfg = tmodels.bert_config("bert_base", dtype=torch.bfloat16)
    assert cfg == dataclasses.replace(tbert.BERT_BASE, dtype=torch.bfloat16)
    small = tmodels.get_model("bert_base", device="cpu", dtype=torch.bfloat16)
    assert isinstance(small, tbert.BertForPreTraining)
    assert small.config.dtype == torch.bfloat16
    assert small.word_embeddings.weight.shape == (30528, 768)
    assert small.word_embeddings.weight.dtype == torch.float32
    for name in ("densenet121", "mnistnet"):
        with pytest.raises(KeyError, match="item 5b"):
            tmodels.get_model(name, device="cpu")


def test_synthetic_bert_batch():
    """The JAX package's fields and dtypes, shapes, label ranges, the
    masked fraction, and one seed -> one batch."""
    want = jdata.synthetic_bert_batch(jax.random.PRNGKey(0), 4, seq_len=8,
                                      vocab_size=50)
    got = tdata.synthetic_bert_batch(0, 4, seq_len=8, vocab_size=50,
                                     device="cpu")
    assert set(got) == set(want)
    for k, v in got.items():
        assert v.shape == tuple(want[k].shape), k
        assert str(v.dtype).replace("torch.", "") == str(want[k].dtype), k
    big = tdata.synthetic_bert_batch(torch.Generator().manual_seed(3), 64,
                                     seq_len=128, vocab_size=50)
    labels = big["masked_lm_labels"]
    frac = float((labels >= 0).float().mean())
    assert abs(frac - 0.15) < 0.015, frac
    assert int(labels.max()) < 50 and int(labels[labels < 0].max()) == -1
    assert int(big["input_ids"].min()) >= 0
    assert int(big["input_ids"].max()) < 50
    assert bool((big["attention_mask"] == 1).all())
    assert bool((big["token_type_ids"] == 0).all())
    assert set(big["next_sentence_labels"].tolist()) == {0, 1}
    again = tdata.synthetic_bert_batch(torch.Generator().manual_seed(3), 64,
                                       seq_len=128, vocab_size=50)
    assert all(torch.equal(big[k], again[k]) for k in big)


def test_attention_dropout_statistics():
    """The attention-probability dropout: with v the identity over the
    keys, the output IS the dropped probabilities — about ``rate`` of them
    zero, the rest scaled by 1 / (1 - rate); one seed, one mask."""
    rate, Sk = 0.25, 64
    rs = np.random.RandomState(0)
    q = torch.from_numpy(rs.randn(4, 32, 2, Sk).astype(np.float32))
    k = torch.from_numpy(rs.randn(4, Sk, 2, Sk).astype(np.float32))
    v = torch.eye(Sk)[None, :, None, :].expand(4, Sk, 2, Sk).contiguous()
    plain = tbert.dot_product_attention(q, k, v, None)
    got = tbert.dot_product_attention(
        q, k, v, None, dropout_rate=rate,
        generator=torch.Generator().manual_seed(1))
    zero = got == 0
    assert abs(float(zero.float().mean()) - rate) < 0.01
    torch.testing.assert_close(got[~zero], plain[~zero] / (1 - rate))
    again = tbert.dot_product_attention(
        q, k, v, None, dropout_rate=rate,
        generator=torch.Generator().manual_seed(1))
    assert torch.equal(got, again)


def test_training_mode_dropout(params):
    """Train mode draws its masks from the generator: one seed, one output;
    another seed, another; eval mode none; no generator raises. The flash
    impl under an active dropout rate takes the dense core, mask for
    mask."""
    jcfg = jax_config(hidden_dropout_prob=0.1,
                      attention_probs_dropout_prob=0.1)
    b = {k: torch.from_numpy(v) for k, v in batch().items()}
    args = (b["input_ids"], b["token_type_ids"], b["attention_mask"])

    def run(model, seed):
        with torch.no_grad():
            return model(*args, train=True,
                         generator=torch.Generator().manual_seed(seed))[0]

    dense = port_model(params, jcfg)
    flash = port_model(params, jcfg,
                       attention_impl=FA.make_flash_attention_impl())
    a, again, other = run(dense, 3), run(dense, 3), run(dense, 4)
    assert torch.equal(a, again) and not torch.equal(a, other)
    with torch.no_grad():
        assert not torch.equal(a, dense(*args)[0])
    assert torch.equal(run(flash, 3), a)
    with pytest.raises(ValueError, match="torch.Generator"):
        dense(*args, train=True)


def test_flash_impl_mask_and_dropout_rules():
    """The additive [B, 1, 1, S] mask becomes the key validity; with an
    active dropout rate the impl is the dense core with dropout."""
    rs = np.random.RandomState(2)
    q, k, v = (torch.from_numpy(rs.randn(2, 8, 2, 16).astype(np.float32))
               for _ in range(3))
    valid = torch.arange(8)[None, :] < torch.tensor([[8], [3]])
    mask = ((1.0 - valid[:, None, None, :].float()) * -1e9)
    impl = FA.make_flash_attention_impl()
    got = impl(q, k, v, mask)
    torch.testing.assert_close(got, FA.flash_attention(q, k, v,
                                                       kv_mask=valid))
    torch.testing.assert_close(got, tbert.dot_product_attention(q, k, v,
                                                                mask))
    g = torch.Generator().manual_seed(5)
    dropped = impl(q, k, v, mask, dropout_rate=0.5, generator=g)
    want = tbert.dot_product_attention(
        q, k, v, mask, dropout_rate=0.5,
        generator=torch.Generator().manual_seed(5))
    assert torch.equal(dropped, want)


def test_unported_paths_raise_naming_their_item():
    cfg = torch_config(jax_config())
    with pytest.raises(NotImplementedError, match="item 5b"):
        tbert.BertForPreTraining(cfg, projection_impl=lambda *a: None,
                                 device="cpu")
    model = tbert.BertForPreTraining(cfg, device="cpu")
    ids = torch.zeros((1, 4), dtype=torch.int32)
    for kw in ({"decode": True}, {"causal": True}):
        with pytest.raises(NotImplementedError, match="item 5b"):
            model(ids, **kw)
