"""The port's GPT-2 (dear_pytorch_tpu_torch.models.gpt) against the JAX
model, on the CPU at the small size of tests/test_serving.py: flax init
from seed 0, carried across with `gpt_params_from_jax`, the same token ids
through both.

Tolerances: logits 2e-4 in fp32 (the JAX suite's own decode-parity
bound), 5e-2 where bf16 is in play; tokens exactly; the LM loss and its
gradients 1e-5 in fp32. Dropout cannot match JAX's PRNG bits: it is held
to its statistics."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dear_pytorch_tpu import models as jmodels
from dear_pytorch_tpu.models import gpt as jgpt
from dear_pytorch_tpu_torch import models as tmodels
from dear_pytorch_tpu_torch.models import gpt as tgpt
from dear_pytorch_tpu_torch.models.convert import gpt_params_from_jax

_DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


_PORTED_FIELDS = {f.name for f in dataclasses.fields(tgpt.GptConfig)}


def _torch_config(cfg):
    """The JAX config's fields that the port carries (it leaves out only
    the expert capacity of the unported mixture of experts)."""
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
          if f.name in _PORTED_FIELDS}
    kw["dtype"] = _DTYPES[cfg.dtype]
    if cfg.kv_cache_dtype is not None:
        kw["kv_cache_dtype"] = _DTYPES[cfg.kv_cache_dtype]
    return tgpt.GptConfig(**kw)


def _pair(dtype=jnp.float32, *, flash=False, **kw):
    """The small GPT in both packages with the same seeded flax weights:
    (jax model, jax params, port model on the CPU)."""
    cfg = jgpt.GptConfig(
        vocab_size=61, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=2, intermediate_size=64,
        max_position_embeddings=32, embd_dropout_prob=0.0,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
        dtype=dtype, **kw)
    jmodel = jgpt.GptLmHeadModel(
        cfg, attention_impl=jgpt.flash_causal_attention_impl() if flash
        else None)
    params = jmodel.init({"params": jax.random.PRNGKey(0)},
                         jnp.zeros((2, 4), jnp.int32), train=False)["params"]
    tcfg = _torch_config(cfg)
    tmodel = tgpt.GptLmHeadModel(
        tcfg, attention_impl=tgpt.flash_causal_attention_impl() if flash
        else None, device="cpu")
    tmodel.load_state_dict(
        gpt_params_from_jax(jax.tree.map(np.asarray, params), tcfg))
    return jmodel, params, tmodel


def _ids(seed, shape, vocab=61):
    return np.random.RandomState(seed).randint(0, vocab, shape)


def _jax_decode_logits(model, params, ids):
    cache = model.init({"params": jax.random.PRNGKey(0)}, ids[:, :1],
                       train=False, decode=True)["cache"]
    step = jax.jit(lambda c, tok, t: model.apply(
        {"params": params, "cache": c}, tok, train=False, decode=True,
        position_offset=t, mutable=["cache"]))
    out = []
    for t in range(ids.shape[1]):
        logits, vars_out = step(cache, jnp.asarray(ids[:, t:t + 1]), t)
        cache = vars_out["cache"]
        out.append(np.asarray(logits[:, 0], np.float32))
    return np.stack(out, axis=1)


def _torch_decode_logits(model, ids):
    cache = model.init_cache(ids.shape[0])
    with torch.no_grad():
        return np.stack([
            model(torch.from_numpy(ids[:, t:t + 1]), position_offset=t,
                  cache=cache)[:, 0].numpy()
            for t in range(ids.shape[1])], axis=1)


def _chunks(S, C):
    pos = 0
    while pos < S:
        n = min(C, S - pos)
        yield pos, n
        pos += n


def _jax_chunk_logits(model, params, ids, C):
    B, S = ids.shape
    cache = model.init({"params": jax.random.PRNGKey(0)},
                       jnp.zeros((B, C), jnp.int32), train=False, decode=True,
                       prefill_lengths=jnp.zeros((B,), jnp.int32))["cache"]
    out = []
    for pos, n in _chunks(S, C):
        toks = np.zeros((B, C), np.int32)
        toks[:, :n] = ids[:, pos:pos + n]
        logits, vars_out = model.apply(
            {"params": params, "cache": cache}, jnp.asarray(toks),
            train=False, decode=True,
            position_offset=jnp.full((B,), pos, jnp.int32),
            prefill_lengths=jnp.full((B,), n, jnp.int32), mutable=["cache"])
        cache = vars_out["cache"]
        out.append(np.asarray(logits)[:, :n])
    return np.concatenate(out, axis=1)


def _torch_chunk_logits(model, ids, C):
    B, S = ids.shape
    cache = model.init_cache(B)
    out = []
    with torch.no_grad():
        for pos, n in _chunks(S, C):
            toks = np.zeros((B, C), np.int64)
            toks[:, :n] = ids[:, pos:pos + n]
            logits = model(torch.from_numpy(toks),
                           position_offset=torch.full((B,), pos),
                           cache=cache, prefill_lengths=torch.full((B,), n))
            out.append(logits.numpy()[:, :n])
    return np.concatenate(out, axis=1)


@pytest.mark.parametrize("dtype,tol", [(jnp.float32, 2e-4),
                                       (jnp.bfloat16, 5e-2)])
@pytest.mark.parametrize("flash", [False, True])
def test_full_forward_logits_match_jax(flash, dtype, tol):
    """Dense and flash-causal attention, fp32 and bf16."""
    jmodel, params, tmodel = _pair(dtype, flash=flash)
    ids = _ids(1, (2, 13))
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(ids),
                                   train=False))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(ids))
    assert got.dtype == torch.float32 and got.shape == (2, 13, 64)
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("flash", [False, True])
def test_stepwise_decode_matches_jax_past_ring_wrap(flash):
    """S=20 > L=16: past the wrap, the ring is a sliding window; the
    port's decode logits follow the JAX decode at every step, with the
    decode attend dense or through the flash kernel's plain version."""
    jmodel, params, tmodel = _pair(kv_cache_len=16, decode_use_flash=flash)
    ids = _ids(2, (2, 20))
    want = _jax_decode_logits(jmodel, params, ids)
    got = _torch_decode_logits(tmodel, ids)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    # and before the wrap the decode equals the full forward
    with torch.no_grad():
        full = tmodel(torch.from_numpy(ids[:, :16])).numpy()
    np.testing.assert_allclose(got[:, :16], full, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("ring", [16, 8])
def test_chunked_prefill_matches_jax(ring):
    """C=4 over S=13; at L=8 one chunk spans the ring's wrap."""
    jmodel, params, tmodel = _pair(kv_cache_len=ring)
    ids = _ids(3, (2, 13))
    want = _jax_chunk_logits(jmodel, params, ids, 4)
    got = _torch_chunk_logits(tmodel, ids, 4)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got, _torch_decode_logits(tmodel, ids),
                               rtol=2e-4, atol=2e-4)


def test_kv_cache_bf16_matches_jax():
    jmodel, params, tmodel = _pair(kv_cache_len=16,
                                   kv_cache_dtype=jnp.bfloat16)
    assert tmodel.init_cache(1)[0][0].dtype == torch.bfloat16
    ids = _ids(4, (2, 13))
    np.testing.assert_allclose(_torch_decode_logits(tmodel, ids),
                               _jax_decode_logits(jmodel, params, ids),
                               rtol=5e-2, atol=5e-2)
    np.testing.assert_allclose(_torch_chunk_logits(tmodel, ids, 4),
                               _jax_chunk_logits(jmodel, params, ids, 4),
                               rtol=5e-2, atol=5e-2)


def test_bf16_decode_matches_jax():
    jmodel, params, tmodel = _pair(jnp.bfloat16, kv_cache_len=16,
                                   decode_use_flash=True)
    ids = _ids(5, (2, 13))
    np.testing.assert_allclose(_torch_decode_logits(tmodel, ids),
                               _jax_decode_logits(jmodel, params, ids),
                               rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("flash", [False, True])
def test_greedy_generate_tokens_match_jax(flash):
    jmodel, params, tmodel = _pair(kv_cache_len=16, decode_use_flash=flash)
    prompt = _ids(6, (2, 5))
    want = np.asarray(jgpt.generate(jmodel, params, jnp.asarray(prompt),
                                    max_new_tokens=8))
    got = tgpt.generate(tmodel, torch.from_numpy(prompt), 8, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


def test_sampled_generate_follows_its_generator():
    _, _, tmodel = _pair(kv_cache_len=16)
    prompt = torch.from_numpy(_ids(7, (2, 3)))
    runs = [tgpt.generate(tmodel, prompt, 6, temperature=0.8, top_p=0.9,
                          generator=torch.Generator().manual_seed(5),
                          device="cpu") for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    assert torch.equal(runs[0][:, :3], prompt)
    assert int(runs[0].max()) < 61  # padded ids are never chosen
    with pytest.raises(ValueError, match="torch.Generator"):
        tgpt.generate(tmodel, prompt, 2, temperature=1.0, device="cpu")
    with pytest.raises(ValueError, match="top_p"):
        tgpt.generate(tmodel, prompt, 2, top_p=0.0, device="cpu")
    with pytest.raises(ValueError, match="cache budget"):
        tgpt.generate(tmodel, prompt, 40, device="cpu")


@pytest.mark.parametrize("top_p", [0.3, 0.9, 1.0])
def test_top_p_filter_matches_jax(top_p):
    logits = np.random.RandomState(8).randn(3, 17).astype(np.float32) * 2
    want = np.asarray(jgpt._top_p_filter(jnp.asarray(logits), top_p))
    got = tgpt._top_p_filter(torch.from_numpy(logits), top_p).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_array_equal(got[np.isfinite(got)],
                                  want[np.isfinite(want)])


def test_presets_and_registry_match_jax():
    for name, tcfg in (("gpt2", tgpt.GPT2_SMALL),
                       ("gpt2_medium", tgpt.GPT2_MEDIUM),
                       ("gpt2_large", tgpt.GPT2_LARGE)):
        jcfg = {"gpt2": jgpt.GPT2_SMALL, "gpt2_medium": jgpt.GPT2_MEDIUM,
                "gpt2_large": jgpt.GPT2_LARGE}[name]
        assert tcfg == _torch_config(jcfg)
        assert tmodels._GPT_REGISTRY[name] == tcfg
    assert tgpt.GPT2_SMALL.padded_vocab_size == 50264
    with pytest.raises(KeyError, match="gpt2"):
        tmodels.get_model("densenet264", device="cpu")


def test_converted_state_dict_covers_every_parameter():
    jmodel, params, tmodel = _pair()
    sd = gpt_params_from_jax(jax.tree.map(np.asarray, params),
                             tmodel.config)
    assert set(sd) == set(tmodel.state_dict())
    assert tmodel.h_1.query.weight.shape == (32, 32)
    assert tmodel.h_0.mlp_in.weight.shape == (64, 32)


def test_seeded_init_is_reproducible_and_flax_shaped():
    cfg = _torch_config(_pair()[0].config)
    a = tgpt.GptLmHeadModel(cfg, device="cpu", seed=3)
    b = tgpt.GptLmHeadModel(cfg, device="cpu", seed=3)
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), name
    assert torch.all(a.ln_f.weight == 1) and torch.all(a.h_0.query.bias == 0)
    assert 0.01 < float(a.wte.weight.detach().std()) < 0.03


def test_unported_options_raise():
    """MoE and remat still raise; ``projection_impl``, ported now, builds a
    model whose parameter names and shapes are the dense model's (with the
    same seeded values), its QKV and MLP-up going through the impl; dropout
    in training mode needs an explicit generator and then runs."""
    from dear_pytorch_tpu_torch.ops.collective_matmul import (
        make_ring_projection_impl,
    )

    cfg = _torch_config(_pair()[0].config)
    for bad in (dict(num_experts=2), dict(remat=True)):
        with pytest.raises(NotImplementedError):
            tgpt.GptLmHeadModel(dataclasses.replace(cfg, **bad),
                                device="cpu")
    dense = tgpt.GptLmHeadModel(cfg, device="cpu", seed=1)
    proj = tgpt.GptLmHeadModel(cfg, projection_impl=make_ring_projection_impl(),
                               device="cpu", seed=1)
    want = [(n, p.shape) for n, p in dense.named_parameters()]
    assert [(n, p.shape) for n, p in proj.named_parameters()] == want
    for (name, a), b in zip(dense.named_parameters(), proj.parameters()):
        assert torch.equal(a, b), name
    ids0 = torch.arange(5)[None] % cfg.vocab_size
    torch.testing.assert_close(proj(ids0), dense(ids0), rtol=1e-6, atol=1e-6)
    model = tgpt.GptLmHeadModel(
        dataclasses.replace(cfg, hidden_dropout_prob=0.1), device="cpu")
    ids = torch.zeros((1, 3), dtype=torch.long)
    with pytest.raises(ValueError, match="torch.Generator"):
        model(ids, train=True)
    out = model(ids, train=True, generator=torch.Generator().manual_seed(0))
    assert out.shape == (1, 3, 64) and bool(torch.isfinite(out).all())


@pytest.mark.parametrize("padded", [False, True])
def test_gpt_lm_loss_matches_jax(padded):
    """Value and gradient of the streamed loss; with ``vocab_size`` < the
    padded width the pad columns leave the softmax support (and get zero
    gradient)."""
    rs = np.random.RandomState(9)
    logits = rs.randn(3, 7, 64).astype(np.float32) * 2
    ids = rs.randint(0, 61, (3, 7))
    vocab = 61 if padded else None

    def jl(x):
        return jgpt.gpt_lm_loss(x, jnp.asarray(ids), vocab_size=vocab)

    want, want_g = jax.value_and_grad(jl)(jnp.asarray(logits))
    t = torch.from_numpy(logits).requires_grad_()
    got = tgpt.gpt_lm_loss(t, torch.from_numpy(ids), vocab_size=vocab)
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want_g),
                               rtol=1e-5, atol=1e-5)
    if padded:
        assert float(t.grad[..., 61:].abs().max()) == 0.0


@pytest.mark.parametrize("flash", [False, True])
def test_loss_gradients_match_jax(flash):
    """d(loss)/d(param) of the whole model, dense and flash attention,
    per parameter (the JAX gradients carried across like the weights)."""
    jmodel, params, tmodel = _pair(flash=flash)
    ids = _ids(10, (2, 13))

    def jl(p):
        logits = jmodel.apply({"params": p}, jnp.asarray(ids), train=False)
        return jgpt.gpt_lm_loss(logits, jnp.asarray(ids), vocab_size=61)

    want, grads = jax.value_and_grad(jl)(params)
    want_g = gpt_params_from_jax(jax.tree.map(np.asarray, grads),
                                 tmodel.config)
    tids = torch.from_numpy(ids)
    loss = tgpt.gpt_lm_loss(tmodel(tids, train=True), tids, vocab_size=61)
    loss.backward()
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-5,
                               atol=1e-5)
    for name, p in tmodel.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_g[name].numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def test_dropout_keep_rate_scale_and_determinism():
    """Keep rate within 5 sigma of 1 - rate, kept values scaled by
    1 / (1 - rate), one generator seed gives one mask."""
    x = torch.ones(200, 500)
    rate = 0.1
    out = tgpt.dropout(x, rate, torch.Generator().manual_seed(1))
    kept = out != 0
    n = x.numel()
    sigma = (rate * (1 - rate) / n) ** 0.5
    assert abs(float(kept.float().mean()) - (1 - rate)) < 5 * sigma
    np.testing.assert_allclose(out[kept].numpy(), 1 / (1 - rate), rtol=1e-6)
    again = tgpt.dropout(x, rate, torch.Generator().manual_seed(1))
    other = tgpt.dropout(x, rate, torch.Generator().manual_seed(2))
    assert torch.equal(out, again) and not torch.equal(out, other)
    # through the model: every dropout on, deterministic per seed, and
    # different from the dropout-free forward
    jmodel, _, _ = _pair()
    cfg = dataclasses.replace(_torch_config(jmodel.config),
                              embd_dropout_prob=0.1, hidden_dropout_prob=0.1,
                              attention_probs_dropout_prob=0.1)
    model = tgpt.GptLmHeadModel(cfg, device="cpu")
    ids = torch.from_numpy(_ids(11, (2, 9)))
    runs = [model(ids, train=True,
                  generator=torch.Generator().manual_seed(s))
            for s in (3, 3, 4)]
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])
    assert not torch.equal(runs[0], model(ids))
    # the flash impl has no attention-dropout path (the JAX message)
    fmodel = tgpt.GptLmHeadModel(
        cfg, attention_impl=tgpt.flash_causal_attention_impl(), device="cpu")
    with pytest.raises(ValueError, match="no attention-dropout path"):
        fmodel(ids, train=True, generator=torch.Generator().manual_seed(0))


def test_dropout_free_and_model_registry():
    jcfg = jgpt.GPT2_SMALL
    want = jmodels.dropout_free(jcfg)
    got = tmodels.dropout_free(tgpt.GPT2_SMALL)
    assert got == _torch_config(want)
    assert got.embd_dropout_prob == got.hidden_dropout_prob == \
        got.attention_probs_dropout_prob == 0.0
    assert tmodels.gpt_names() == jmodels.gpt_names()
    cfg = tmodels.gpt_config("GPT2", dtype=torch.bfloat16)
    assert cfg == dataclasses.replace(tgpt.GPT2_SMALL, dtype=torch.bfloat16)
    assert tmodels.cnn_names() == jmodels.cnn_names()   # the whole zoo
    with pytest.raises(KeyError, match="unknown model"):
        tmodels.get_model("gpt5", device="cpu")
