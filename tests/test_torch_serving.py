"""The port's serving path against the JAX package's: each ring KV-cache
function on random inputs, and DecodeEngine tokens for staggered arrivals
with slot reuse — the port's engine must emit exactly the JAX engine's
tokens, token-at-a-time and chunked, with the decode attend dense or
through the flash kernel's plain version (CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dear_pytorch_tpu.serving import kvcache as JKV
from dear_pytorch_tpu.serving.engine import DecodeEngine as JaxEngine
from dear_pytorch_tpu_torch.models import gpt as tgpt
from dear_pytorch_tpu_torch.serving import kvcache as KV
from dear_pytorch_tpu_torch.serving.engine import DecodeEngine

from test_torch_gpt import _pair

TOL = 1e-5
B, L, H, D = 3, 8, 2, 4


def _t(x):
    return torch.from_numpy(np.array(x))


def _caches(rs):
    return (rs.randn(B, L, H, D).astype(np.float32),
            rs.randn(B, L, H, D).astype(np.float32))


def test_ring_write_matches_jax():
    rs = np.random.RandomState(0)
    ck, cv = _caches(rs)
    k, v = (rs.randn(B, 1, H, D).astype(np.float32) for _ in range(2))
    pos = np.array([0, 5, 11], np.int32)  # the last row has wrapped
    jk, jv = JKV.ring_write(jnp.asarray(ck), jnp.asarray(cv),
                            jnp.asarray(pos), jnp.asarray(k), jnp.asarray(v))
    tk, tv = _t(ck), _t(cv)
    out = KV.ring_write(tk, tv, _t(pos).long(), _t(k), _t(v))
    assert out[0] is tk and out[1] is tv  # updated in place
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_ring_validity_matches_jax():
    pos = np.array([0, 3, 7, 8, 30], np.int32)
    np.testing.assert_array_equal(
        KV.ring_validity(_t(pos).long(), L).numpy(),
        np.asarray(JKV.ring_validity(jnp.asarray(pos), L)))


def test_ring_write_chunk_matches_jax():
    """Rows: frozen (n_valid 0), a partial chunk, a chunk across the wrap."""
    rs = np.random.RandomState(1)
    ck, cv = _caches(rs)
    C = 4
    k, v = (rs.randn(B, C, H, D).astype(np.float32) for _ in range(2))
    pos = np.array([2, 0, 6], np.int32)
    nvalid = np.array([0, 3, 4], np.int32)
    jk, jv = JKV.ring_write_chunk(jnp.asarray(ck), jnp.asarray(cv),
                                  jnp.asarray(pos), jnp.asarray(k),
                                  jnp.asarray(v), jnp.asarray(nvalid))
    tk, tv = _t(ck), _t(cv)
    KV.ring_write_chunk(tk, tv, _t(pos).long(), _t(k), _t(v),
                        _t(nvalid).long())
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tk[0].numpy(), ck[0])  # frozen row


def test_chunk_attend_matches_jax():
    rs = np.random.RandomState(2)
    ck, cv = _caches(rs)
    C = 4
    q, k, v = (rs.randn(B, C, H, D).astype(np.float32) for _ in range(3))
    pos = np.array([0, 5, 10], np.int32)
    nvalid = np.array([4, 2, 4], np.int32)
    want = JKV.chunk_attend(jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv),
                            jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
                            jnp.asarray(nvalid), dtype=jnp.float32)
    got = KV.chunk_attend(_t(q), _t(ck), _t(cv), _t(k), _t(v),
                          _t(pos).long(), _t(nvalid).long(),
                          dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("use_flash", [False, True])
def test_cache_attend_matches_jax(use_flash):
    rs = np.random.RandomState(3)
    ck, cv = _caches(rs)
    q = rs.randn(B, 1, H, D).astype(np.float32)
    valid = np.asarray(JKV.ring_validity(jnp.asarray([0, 4, 9]), L))
    want = JKV.cache_attend(jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv),
                            jnp.asarray(valid), dtype=jnp.float32,
                            use_flash=use_flash)
    got = KV.cache_attend(_t(q), _t(ck), _t(cv), _t(valid),
                          dtype=torch.float32, use_flash=use_flash)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

_PROMPT_LENS = (4, 9, 5, 3)


def _serve(engine, prompts, max_new=5):
    """Two requests at once, the rest arriving as slots free (continuous
    batching with slot reuse). Returns {request id: tokens}."""
    done, pending = {}, list(range(2, len(prompts)))
    assert engine.submit(prompts[0], max_new, request_id=0) is not None
    assert engine.submit(prompts[1], max_new, request_id=1) is not None
    assert engine.submit(prompts[2], max_new, request_id=2) is None  # full
    for _ in range(200):
        for fin in engine.tick():
            done[fin.request_id] = fin.tokens
            while pending and engine.free:
                rid = pending.pop(0)
                engine.submit(prompts[rid], max_new, request_id=rid)
        if len(done) == len(prompts):
            break
    assert engine.active == 0 and engine.free == engine.slots
    return done


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("chunk", [1, 4])
def test_engine_tokens_match_jax_engine(chunk, flash):
    jmodel, params, tmodel = _pair(kv_cache_len=16, decode_use_flash=flash)
    rs = np.random.RandomState(9)
    prompts = [list(rs.randint(0, 61, n)) for n in _PROMPT_LENS]
    want = _serve(JaxEngine(jmodel, params, slots=2, prefill_chunk=chunk),
                  prompts)
    eng = DecodeEngine(tmodel, slots=2, prefill_chunk=chunk, device="cpu")
    got = _serve(eng, prompts)
    assert got == want
    for rid, p in enumerate(prompts):  # and the port's own generate()
        ref = tgpt.generate(tmodel, torch.tensor([p]), 5, device="cpu")
        assert got[rid] == ref[0, len(p):].tolist()
    keys = {"serve.decode_tick_ms_p50", "serve.decode_tick_ms_p99"}
    if chunk > 1:
        keys |= {"serve.prefill_ms_p50", "serve.prefill_ms_p99"}
    assert set(eng.phase_gauges()) == keys


@pytest.mark.parametrize("burst", [1, 2])
def test_engine_interleave_policy_matches_jax(burst):
    """Tick by tick, the port's engine makes the JAX engine's prefill /
    decode choices under the ``prefill_burst`` budget (a long prompt
    arriving while a short request decodes), and its requests finish on
    the same ticks with the same tokens."""
    jmodel, params, tmodel = _pair(kv_cache_len=16)
    rs = np.random.RandomState(22)
    short, long_ = list(rs.randint(0, 61, 2)), list(rs.randint(0, 61, 13))
    traces = []
    for eng in (JaxEngine(jmodel, params, slots=2, prefill_chunk=4,
                          prefill_burst=burst),
                DecodeEngine(tmodel, slots=2, prefill_chunk=4,
                             prefill_burst=burst, device="cpu")):
        eng.submit(short, 8, request_id="short")
        trace = []
        for t in range(14):
            if t == 2:
                eng.submit(long_, 2, request_id="long")
            fins = eng.tick()
            trace.append((
                [None if s is None else (s.fed, len(s.generated))
                 for s in eng._slots],
                [(f.request_id, f.tokens, f.steps) for f in fins]))
        traces.append(trace)
    assert traces[0] == traces[1]
    assert sum(len(fins) for _, fins in traces[1]) == 2


def test_engine_eos_stops_a_request():
    _, _, tmodel = _pair(kv_cache_len=16)
    prompt = [3, 1, 4, 1]
    ref = tgpt.generate(tmodel, torch.tensor([prompt]), 5, device="cpu")
    gen = ref[0, len(prompt):].tolist()
    eos = gen[1]
    stop = gen.index(eos)  # the first time the model emits it
    eng = DecodeEngine(tmodel, slots=1, eos_id=eos, device="cpu")
    eng.submit(prompt, 5, request_id="r")
    fins = [f for _ in range(20) for f in eng.tick()]
    assert [f.tokens for f in fins] == [gen[:stop + 1]]
    assert fins[0].steps == len(prompt) + stop


def test_engine_rejections_match_jax():
    jmodel, params, tmodel = _pair(kv_cache_len=8)
    jeng = JaxEngine(jmodel, params, slots=1)
    eng = DecodeEngine(tmodel, slots=1, device="cpu")
    for e in (jeng, eng):
        with pytest.raises(ValueError, match="position budget"):
            e.submit(list(range(30)), 10)
        with pytest.raises(ValueError, match="empty prompt"):
            e.submit([], 4)
    with pytest.raises(ValueError, match="only sampler='greedy'"):
        DecodeEngine(tmodel, sampler="top_p", device="cpu")
    with pytest.raises(ValueError, match="ring length"):
        DecodeEngine(tmodel, prefill_chunk=9, device="cpu")
    with pytest.raises(ValueError, match="prefill_chunk must be"):
        DecodeEngine(tmodel, prefill_chunk=0, device="cpu")
    with pytest.raises(NotImplementedError, match="tensor-parallel"):
        DecodeEngine(tmodel, tp_mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="ring length"):
        tmodel(torch.zeros((1, 9), dtype=torch.long),
               position_offset=torch.zeros(1, dtype=torch.long),
               cache=tmodel.init_cache(1),
               prefill_lengths=torch.full((1,), 9))
