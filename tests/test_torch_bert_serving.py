"""BERT's serving paths in the port (dear_pytorch_tpu_torch.models.bert:
``causal=True``, decode mode over the ring KV cache, chunked prefill; and
`serving.engine.DecodeEngine` over a BERT model) against the JAX package's
flax BERT (``causal=True``, ``decode=True``) and its engine on the CPU,
after tests/test_serving.py's BERT cases: a 2-layer BERT of narrow widths
(hidden 32, 2 heads, vocab 60 padded to 64, 32 positions, a 16-slot ring
whose wrap the chunked prefill crosses), the same flax weights on
both sides (`models.convert.bert_params_from_jax`).

Tolerances: tests/test_serving.py's — 2e-4 in fp32, 5e-2 in bf16 (the
decode path's cached K/V travel in bf16 as the full forward's do, and the
two frameworks round at different points); the causal forward 2e-4 and
1e-2 of the largest |value| (tests/test_torch_bert.py's).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dear_pytorch_tpu.models import bert as jbert
from dear_pytorch_tpu.serving.engine import DecodeEngine as JaxEngine
from dear_pytorch_tpu_torch.models import bert as tbert
from dear_pytorch_tpu_torch.models.convert import bert_params_from_jax
from dear_pytorch_tpu_torch.ops import flash_attention as FA
from dear_pytorch_tpu_torch.serving import kvcache as KV
from dear_pytorch_tpu_torch.serving.engine import DecodeEngine
from tests.test_torch_zoo import few_threads  # noqa: F401 (autouse)

VOCAB = 60
DTYPES = {"fp32": (jnp.float32, torch.float32, 2e-4),
          "bf16": (jnp.bfloat16, torch.bfloat16, 5e-2)}


def _config(dtype="fp32", **kw):
    return jbert.BertConfig(
        vocab_size=VOCAB, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=2, intermediate_size=64,
        max_position_embeddings=32, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0, dtype=DTYPES[dtype][0], **kw)


@functools.cache
def _params():
    """flax's init of `_config` from one key, plus numpy noise on every
    leaf: fp32 leaves whose shapes and values no dtype or decode field
    changes, so every case shares one init's compile."""
    jmodel = jbert.BertForPreTraining(_config())
    params = jax.jit(lambda k: jmodel.init(
        {"params": k}, jnp.zeros((2, 4), jnp.int32), train=False))(
        jax.random.PRNGKey(0))["params"]
    rs = np.random.RandomState(3)
    return jax.tree.map(lambda x: (np.asarray(x) + rs.normal(
        0, 0.05, x.shape)).astype(np.float32), params)


def _pair(dtype="fp32", **kw):
    """The flax BERT with seeded weights (`_params`) and the port's BERT
    holding them."""
    _, tdt, _ = DTYPES[dtype]
    jcfg = _config(dtype, **kw)
    jmodel = jbert.BertForPreTraining(jcfg)
    params = _params()
    tkw = {f.name: getattr(jcfg, f.name)
           for f in dataclasses.fields(tbert.BertConfig)}
    tkw["dtype"] = tdt
    if jcfg.kv_cache_dtype is not None:
        tkw["kv_cache_dtype"] = torch.bfloat16
    tcfg = tbert.BertConfig(**tkw)
    tmodel = tbert.BertForPreTraining(tcfg, device="cpu").eval()
    tmodel.load_state_dict(bert_params_from_jax(params, tcfg))
    return jmodel, params, tmodel


def _ids(seed, shape):
    return np.random.RandomState(seed).randint(0, VOCAB, shape)


def _jax_decode(jmodel, params, ids, chunks=None):
    """Stepwise (``chunks=None``) or chunked-prefill decode through the
    flax model: one call per token, or per chunk with every row's
    ``prefill_lengths``; the stacked logits of every position."""
    B, S = ids.shape
    cache = jmodel.init({"params": jax.random.PRNGKey(0)},
                        jnp.asarray(ids[:, :1]), train=False,
                        decode=True)["cache"]
    steps, t = [], 0

    @jax.jit
    def step(cache, tok, pos, lengths):
        return jmodel.apply(
            {"params": params, "cache": cache}, tok, train=False,
            decode=True, position_offset=pos, mutable=["cache"],
            prefill_lengths=lengths)

    for c in chunks or [1] * S:
        (logits, _), out = step(cache, jnp.asarray(ids[:, t:t + c]),
                                jnp.full((B,), t),
                                jnp.full((B,), c, jnp.int32) if c > 1
                                else None)
        cache = out["cache"]
        steps.append(np.asarray(logits, np.float32))
        t += c
    return np.concatenate(steps, axis=1)


def _port_decode(tmodel, ids, chunks=None):
    B, S = ids.shape
    cache = tmodel.init_cache(B)
    steps, t = [], 0
    with torch.no_grad():
        for c in chunks or [1] * S:
            logits, nsp = tmodel(
                torch.tensor(ids[:, t:t + c]), position_offset=t,
                cache=cache,
                prefill_lengths=(torch.full((B,), c) if c > 1 else None))
            assert nsp.shape == (B, 2)
            steps.append(logits.numpy())
            t += c
    return np.concatenate(steps, axis=1)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_causal_forward_matches_jax(dtype):
    """``causal=True`` over a batch with a padded row: logits and NSP
    logits against flax's (bf16: eagerly, 1e-2 of the largest value); the
    causal triangle changes the bidirectional logits; a custom attention
    impl is refused, as in JAX."""
    jmodel, params, tmodel = _pair(dtype)
    ids = _ids(4, (2, 13))
    mask = np.ones((2, 13), np.int32)
    mask[1, 9:] = 0
    apply = functools.partial(jmodel.apply, train=False, causal=True)
    with jax.disable_jit(dtype == "bf16"):   # fp32: one compile
        want, want_nsp = jax.jit(apply)({"params": params}, jnp.asarray(ids),
                                        attention_mask=jnp.asarray(mask))
    with torch.no_grad():
        got, nsp = tmodel(torch.tensor(ids),
                          attention_mask=torch.tensor(mask), causal=True)
        bidir, _ = tmodel(torch.tensor(ids),
                          attention_mask=torch.tensor(mask))
    for g, w in ((got, want), (nsp, want_nsp)):
        w = np.asarray(w, np.float32)
        if dtype == "fp32":
            np.testing.assert_allclose(g.numpy(), w, rtol=2e-4, atol=2e-4)
        else:
            assert float(np.abs(g.numpy() - w).max()) <= \
                1e-2 * float(np.abs(w).max())
    assert float((got - bidir).abs().max()) > 1e-2
    custom = tbert.BertForPreTraining(tmodel.config, device="cpu",
                                      attention_impl=tbert.
                                      dot_product_attention)
    with pytest.raises(ValueError, match="causal=True"):
        custom(torch.tensor(ids), causal=True)


@pytest.mark.parametrize("dtype,flash", [("fp32", False), ("bf16", False),
                                         ("fp32", True)])
def test_stepwise_decode_matches_jax_and_the_causal_forward(dtype, flash,
                                                            monkeypatch):
    """Token-by-token decode over 13 positions of a 16-slot ring: the
    port's logits equal flax's decode and the port's own causal forward
    (tests/test_serving.py's test_bert_decode_parity); ``decode_use_flash``
    sends every tick through the flash kernel's plain version on the
    CPU, 2 launches (layers) per tick."""
    _, _, tol = DTYPES[dtype]
    jmodel, params, tmodel = _pair(dtype, kv_cache_len=16,
                                   decode_use_flash=flash)
    ids = _ids(4, (2, 13))
    calls = []

    def counted(*a, **k):
        calls.append(a[0].shape)
        return FA.flash_attention(*a, **k)

    monkeypatch.setattr(KV, "flash_attention", counted)
    got = _port_decode(tmodel, ids)
    assert calls == ([(2, 1, 2, 16)] * 2 * 13 if flash else [])
    want = _jax_decode(jmodel, params, ids)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    with torch.no_grad():
        full, _ = tmodel(torch.tensor(ids), causal=True)
    np.testing.assert_allclose(got, full.numpy(), rtol=tol, atol=tol)


@pytest.mark.parametrize("chunks", [[4, 4, 4, 4, 4, 2], [8, 8, 6],
                                    [1, 5, 16]])
def test_chunked_prefill_matches_jax(chunks):
    """Chunked prefill over 22 positions of the 16-slot ring (the chunks
    span its wrap): logits equal flax's chunked decode and the port's
    stepwise decode; a chunk longer than the ring, or one without
    ``prefill_lengths``, is refused."""
    jmodel, params, tmodel = _pair(kv_cache_len=16)
    ids = _ids(5, (2, 22))
    got = _port_decode(tmodel, ids, chunks)
    want = _jax_decode(jmodel, params, ids, chunks)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got, _port_decode(tmodel, ids), rtol=2e-4,
                               atol=2e-4)
    cache = tmodel.init_cache(2)
    with pytest.raises(ValueError, match="prefill_lengths"):
        tmodel(torch.tensor(ids[:, :4]), cache=cache)
    with pytest.raises(ValueError, match="ring length"):
        tmodel(torch.tensor(ids[:, :17]), cache=cache,
               prefill_lengths=torch.full((2,), 17))
    with pytest.raises(ValueError, match="cache="):
        tmodel(torch.tensor(ids[:, :1]), decode=True)


def test_init_cache_and_position_clamp():
    """``init_cache``: per layer a (k, v) pair of ``[B, L, heads, d]`` in
    the cache dtype; decode clamps position ids past the table (a partial
    last chunk's padding rows), the plain forward does not need to."""
    _, _, tmodel = _pair(kv_cache_len=16, kv_cache_dtype=jnp.bfloat16)
    cache = tmodel.init_cache(3)
    assert len(cache) == 2 and all(len(kv) == 2 for kv in cache)
    assert cache[0][0].shape == (3, 16, 2, 16)
    assert tmodel.config.cache_len == 16
    _, _, plain = _pair()
    assert plain.config.cache_len == 32
    with torch.no_grad():
        logits, _ = plain(torch.zeros((1, 4), dtype=torch.long),
                          position_offset=30, cache=plain.init_cache(1),
                          prefill_lengths=torch.tensor([2]))
    assert bool(torch.isfinite(logits).all())


_PROMPT_LENS = (4, 9, 5, 3)


def _serve(engine, prompts, max_new=5):
    """Two requests at once, the rest as slots free; {id: tokens}."""
    done, pending = {}, list(range(2, len(prompts)))
    engine.submit(prompts[0], max_new, request_id=0)
    engine.submit(prompts[1], max_new, request_id=1)
    for _ in range(200):
        for fin in engine.tick():
            done[fin.request_id] = fin.tokens
            while pending and engine.free:
                rid = pending.pop(0)
                engine.submit(prompts[rid], max_new, request_id=rid)
        if len(done) == len(prompts):
            break
    return done


@pytest.mark.parametrize("chunk,flash", [(1, False), (4, False), (1, True),
                                         (4, True)])
def test_engine_serves_bert_as_the_jax_engine_does(chunk, flash):
    """`DecodeEngine` over a BERT model (its ``(logits, nsp)`` pair, the
    padded vocab sliced to the real one): every request's tokens equal the
    JAX engine's over the same weights, and the greedy tokens of the port's
    causal full forward."""
    jmodel, params, tmodel = _pair(kv_cache_len=16, decode_use_flash=flash)
    rs = np.random.RandomState(9)
    prompts = [list(rs.randint(0, VOCAB, n)) for n in _PROMPT_LENS]
    want = _serve(JaxEngine(jmodel, params, slots=2, prefill_chunk=chunk),
                  prompts)
    got = _serve(DecodeEngine(tmodel, slots=2, prefill_chunk=chunk,
                              device="cpu"), prompts)
    assert got == want
    for rid, p in enumerate(prompts):
        seq = list(p)
        with torch.no_grad():
            for _ in range(5):
                logits, _ = tmodel(torch.tensor([seq]), causal=True)
                seq.append(int(logits[0, -1, :VOCAB].argmax()))
        assert got[rid] == seq[len(p):], rid
