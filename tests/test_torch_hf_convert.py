"""The port's HF converters (dear_pytorch_tpu_torch.models.convert:
``config_from_hf``, ``convert_bert_from_torch``, ``bert_to_torch_state_dict``,
``gpt_config_from_hf``, ``convert_gpt2_from_torch``,
``gpt2_to_torch_state_dict``) against ``transformers``' own
``BertForPreTraining`` and ``GPT2LMHeadModel`` built from LOCAL configs
with seeded weights (no download), after tests/test_convert.py, and
against the JAX package's converters on the same checkpoints.

Tolerances: 2e-4 (tests/test_convert.py's; fp32, summation order). The HF
BERT uses ``gelu_new``, the port's tanh GELU.
"""

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from dear_pytorch_tpu.models import convert as jconvert  # noqa: E402
from dear_pytorch_tpu_torch.models import bert as tbert  # noqa: E402
from dear_pytorch_tpu_torch.models import convert as tconvert  # noqa: E402
from dear_pytorch_tpu_torch.models import gpt as tgpt  # noqa: E402
from dear_pytorch_tpu_torch.models.convert import (  # noqa: E402
    bert_params_from_jax, gpt_params_from_jax,
)

TOL = dict(rtol=2e-4, atol=2e-4)


def _hf_bert(vocab, seed=0):
    hf_cfg = transformers.BertConfig(
        vocab_size=vocab, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=64,
        max_position_embeddings=64, type_vocab_size=2,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
        hidden_act="gelu_new")
    torch.manual_seed(seed)
    model = transformers.BertForPreTraining(hf_cfg).eval()
    return model, hf_cfg


def _hf_gpt2(seed=0, n_positions=64):
    hf_cfg = transformers.GPT2Config(
        vocab_size=61, n_positions=n_positions, n_embd=32, n_layer=2,
        n_head=4, embd_pdrop=0.0, resid_pdrop=0.0, attn_pdrop=0.0)
    torch.manual_seed(seed)
    return transformers.GPT2LMHeadModel(hf_cfg).eval(), hf_cfg


def _port_bert(sd, cfg):
    model = tbert.BertForPreTraining(cfg, device="cpu").eval()
    model.load_state_dict(sd)
    return model


def _port_gpt(sd, cfg):
    model = tgpt.GptLmHeadModel(cfg, device="cpu").eval()
    model.load_state_dict(sd)
    return model


@pytest.mark.parametrize("vocab", [48, 50])   # %8 == 0 and padded
def test_bert_forward_matches_hf(vocab):
    """Logits and NSP logits over a batch with a padded row and random
    token types; padded vocab ids numerically dead (bias -1e9); the config
    and the state_dict equal the JAX package's conversion carried over."""
    hf, hf_cfg = _hf_bert(vocab)
    cfg = tconvert.config_from_hf(hf_cfg)
    assert cfg.vocab_size == vocab and cfg.padded_vocab_size == 56 - 8 * (
        vocab == 48)
    sd = tconvert.convert_bert_from_torch(hf.state_dict(), cfg)
    model = _port_bert(sd, cfg)
    rs = np.random.RandomState(1)
    ids = rs.randint(0, vocab, (3, 16))
    types = rs.randint(0, 2, (3, 16))
    mask = np.ones((3, 16), np.int64)
    mask[1, 10:] = 0
    args = [torch.tensor(a) for a in (ids, types, mask)]
    with torch.no_grad():
        ref = hf(input_ids=args[0], token_type_ids=args[1],
                 attention_mask=args[2])
        logits, nsp = model(*args)
    if cfg.padded_vocab_size > vocab:
        assert bool((logits[..., vocab:] < -1e8).all())
    np.testing.assert_allclose(logits[..., :vocab].numpy(),
                               ref.prediction_logits.numpy(), **TOL)
    np.testing.assert_allclose(nsp.numpy(),
                               ref.seq_relationship_logits.numpy(), **TOL)
    jcfg = jconvert.config_from_hf(hf_cfg)
    via_jax = bert_params_from_jax(
        jconvert.convert_bert_from_torch(hf.state_dict(), jcfg), cfg)
    assert sorted(via_jax) == sorted(sd)
    for k, v in sd.items():
        torch.testing.assert_close(v, via_jax[k], rtol=0, atol=0, msg=k)
    assert tconvert.config_from_hf(hf_cfg.to_dict()) == cfg


def test_bert_export_round_trip_into_hf():
    """Train here, serve there: the exported state_dict loads into a fresh
    HF BertForPreTraining with strict key matching (no weight missing) and
    reproduces the port's forward; converting it back is the identity."""
    src, hf_cfg = _hf_bert(50)
    cfg = tconvert.config_from_hf(hf_cfg)
    sd = tconvert.convert_bert_from_torch(src.state_dict(), cfg)
    exported = tconvert.bert_to_torch_state_dict(sd, cfg)
    dst = transformers.BertForPreTraining(hf_cfg)
    missing, unexpected = dst.load_state_dict(exported, strict=False)
    assert not [k for k in missing if "position_ids" not in k], missing
    assert not unexpected, unexpected
    dst.eval()
    ids = torch.tensor(np.random.RandomState(20).randint(0, 50, (2, 12)))
    with torch.no_grad():
        ref = dst(input_ids=ids).prediction_logits
        ours, _ = _port_bert(sd, cfg)(ids)
    np.testing.assert_allclose(ours[..., :50].numpy(), ref.numpy(), **TOL)
    back = tconvert.convert_bert_from_torch(exported, cfg)
    for k, v in sd.items():
        torch.testing.assert_close(back[k], v, rtol=0, atol=0, msg=k)
    with pytest.raises(KeyError, match="bert.encoder.layer.1"):
        tconvert.convert_bert_from_torch(
            {k: v for k, v in src.state_dict().items()
             if "layer.1." not in k}, cfg)


def test_gpt2_forward_and_generation_match_hf():
    """Logits over the real vocab against HF's, and greedy tokens from the
    converted weights through the port's KV-cache `generate` equal to HF's
    own ``generate``; the state_dict equals the JAX package's conversion
    carried over."""
    hf, hf_cfg = _hf_gpt2()
    cfg = tconvert.gpt_config_from_hf(hf_cfg)
    assert cfg.padded_vocab_size == 64 and cfg.intermediate_size == 128
    sd = tconvert.convert_gpt2_from_torch(hf.state_dict(), cfg)
    model = _port_gpt(sd, cfg)
    ids = torch.tensor(np.random.RandomState(3).randint(0, 61, (2, 16)))
    with torch.no_grad():
        ref = hf(ids).logits
        got = model(ids)
    np.testing.assert_allclose(got[..., :61].numpy(), ref.numpy(), **TOL)
    prompt = torch.tensor(np.random.RandomState(7).randint(0, 61, (2, 6)))
    with torch.no_grad():
        want = hf.generate(prompt, max_new_tokens=8, do_sample=False,
                           pad_token_id=0)
    got = tgpt.generate(model, prompt, 8, device="cpu")
    assert got.tolist() == want.tolist()
    jcfg = jconvert.gpt_config_from_hf(hf_cfg)
    via_jax = gpt_params_from_jax(
        jconvert.convert_gpt2_from_torch(hf.state_dict(), jcfg), cfg)
    assert sorted(via_jax) == sorted(sd)
    for k, v in sd.items():
        torch.testing.assert_close(v, via_jax[k], rtol=0, atol=0, msg=k)


def test_gpt2_export_round_trip_into_hf():
    src, hf_cfg = _hf_gpt2(seed=3, n_positions=32)
    cfg = tconvert.gpt_config_from_hf(hf_cfg.to_dict())
    sd = tconvert.convert_gpt2_from_torch(src.state_dict(), cfg)
    exported = tconvert.gpt2_to_torch_state_dict(sd, cfg)
    dst = transformers.GPT2LMHeadModel(hf_cfg)
    missing, unexpected = dst.load_state_dict(exported, strict=False)
    assert not [k for k in missing if ".attn.bias" not in k
                and ".attn.masked_bias" not in k], missing
    assert not unexpected, unexpected
    dst.eval()
    ids = torch.tensor(np.random.RandomState(21).randint(0, 61, (2, 10)))
    with torch.no_grad():
        ref = dst(ids).logits
        ours = _port_gpt(sd, cfg)(ids)
    np.testing.assert_allclose(ours[..., :61].numpy(), ref.numpy(), **TOL)
    back = tconvert.convert_gpt2_from_torch(exported, cfg)
    for k, v in sd.items():
        torch.testing.assert_close(back[k], v, rtol=0, atol=0, msg=k)
