"""The PyTorch port's GPT decoder against the JAX package.

Same numpy weights (carried across by name with ``params_from_jax``) and
tokens on both sides, on the CPU: the full-sequence ``gpt_logits`` and the
paged ``gpt_forward_paged`` (logits, new_k, new_v) at rtol = atol = 1e-5
(fp32 both sides, another summation order). The JAX side's paged forward
takes its lax attention path, as its serving family does.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from incubator_mxnet_tpu.models import gpt as jgpt
from incubator_mxnet_tpu_torch.models import gpt as tgpt

RTOL = ATOL = 1e-5
CFG = {"vocab_size": 29, "units": 24, "num_layers": 2, "num_heads": 2,
       "max_len": 64}


def _params(cfg, seed, scale=0.05):
    rs = np.random.RandomState(seed)
    return {n: (rs.randn(*s) * scale).astype(np.float32)
            for n, s in jgpt.gpt_param_shapes(jgpt.gpt_config(cfg)).items()}


def _jax_logits(params, cfg, tokens):
    """JAX's gpt_logits, jitted (op by op it compiles every primitive)."""
    return np.asarray(jax.jit(lambda p, t: jgpt.gpt_logits(p, cfg, t))(
        params, jnp.asarray(tokens, jnp.int32)))


def _jax_paged(params, cfg, *arrays):
    return jax.jit(lambda p, *a: jgpt.gpt_forward_paged(p, cfg, *a))(
        params, *arrays)


def _both(params, cfg=CFG):
    return ({n: jnp.asarray(v) for n, v in params.items()},
            tgpt.params_from_jax(params, cfg, "cpu"))


def test_param_names_and_shapes_match_jax():
    for cfg in (CFG, dict(CFG, ffn_hidden=40, max_len=16)):
        assert tgpt.gpt_param_shapes(tgpt.gpt_config(cfg)) \
            == jgpt.gpt_param_shapes(jgpt.gpt_config(cfg))
    m = tgpt.GPTDecoder(device="cpu", **CFG)
    assert {n: tuple(p.shape) for n, p in m.named_parameters()} \
        == jgpt.gpt_param_shapes(jgpt.gpt_config(CFG))


@pytest.mark.parametrize("B,T", [(1, 1), (2, 9), (3, 17)])
def test_gpt_logits_match_jax(B, T):
    jp, tp = _both(_params(CFG, B * T))
    tokens = np.random.RandomState(T).randint(0, CFG["vocab_size"], (B, T))
    want = _jax_logits(jp, CFG, tokens)
    got = tgpt.gpt_logits(tp, CFG, torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("C,past", [(1, [0, 3, 16]), (4, [5, 0, 9]),
                                    (7, [12, 1, 0])])
def test_gpt_forward_paged_matches_jax(C, past):
    """A chunk of C tokens per sequence over a random paged history:
    logits and every layer's new K and V."""
    S, bs, mb = 3, 4, 5
    H = CFG["num_heads"]
    D = CFG["units"] // H
    L = CFG["num_layers"]
    rs = np.random.RandomState(C)
    jp, tp = _both(_params(CFG, 11 + C))
    tokens = rs.randint(0, CFG["vocab_size"], (S, C)).astype(np.int32)
    lengths = np.asarray(past, np.int32)
    tables = rs.permutation(S * mb).reshape(S, mb).astype(np.int32)
    kps = [rs.randn(S * mb, bs, H, D).astype(np.float32) for _ in range(L)]
    vps = [rs.randn(S * mb, bs, H, D).astype(np.float32) for _ in range(L)]
    want = _jax_paged(jp, CFG, tokens, lengths, tables, kps, vps)
    got = tgpt.gpt_forward_paged(
        tp, CFG, torch.from_numpy(tokens), torch.from_numpy(lengths),
        torch.from_numpy(tables), [torch.from_numpy(a) for a in kps],
        [torch.from_numpy(a) for a in vps])
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=RTOL, atol=ATOL)
    for i in range(L):
        for g, w in ((got[1][i], want[1][i]), (got[2][i], want[2][i])):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                       atol=ATOL)


def test_positions_clip_at_max_len():
    """A feed past the position table reads its last row, as in JAX."""
    cfg = dict(CFG, max_len=8)
    jp, tp = _both(_params(cfg, 3), cfg)
    H, D = 2, 12
    kp = np.zeros((4, 4, H, D), np.float32)
    tables = np.arange(4, dtype=np.int32)[None]
    lengths = np.asarray([10], np.int32)
    tokens = np.asarray([[1, 2]], np.int32)
    want = _jax_paged(jp, cfg, tokens, lengths, tables, [kp] * 2, [kp] * 2)
    got = tgpt.gpt_forward_paged(tp, cfg, torch.from_numpy(tokens),
                                 torch.from_numpy(lengths),
                                 torch.from_numpy(tables),
                                 [torch.from_numpy(kp)] * 2,
                                 [torch.from_numpy(kp)] * 2)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=RTOL, atol=ATOL)


def test_gelu_is_the_tanh_approximation(monkeypatch):
    """jax.nn.gelu defaults to the tanh form; with the erf GELU the port
    would miss JAX by far more than the tolerance at these weights."""
    cfg = dict(CFG, num_layers=1)
    jp, tp = _both(_params(cfg, 21, scale=0.6), cfg)
    tokens = np.arange(12, dtype=np.int64)[None] % cfg["vocab_size"]
    want = _jax_logits(jp, cfg, tokens)
    got = tgpt.gpt_logits(tp, cfg, torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    real_gelu = F.gelu
    monkeypatch.setattr(tgpt.F, "gelu",
                        lambda x, approximate="none": real_gelu(x))
    erf = tgpt.gpt_logits(tp, cfg, torch.from_numpy(tokens)).numpy()
    assert np.abs(erf - want).max() > 10 * ATOL


def test_full_forward_matches_incremental_paged_decode():
    """Inside the port: feeding a sequence token by token over a paged cache
    gives the full causal forward's rows."""
    from incubator_mxnet_tpu_torch.generate import GenerateEngine, GPTPagedLM
    params = _params(CFG, 7)
    lm = GPTPagedLM(params, CFG, device="cpu")
    tokens = [3, 5, 7, 2, 11, 1, 4, 9]
    full = tgpt.gpt_logits(lm.model.params(), CFG,
                           torch.tensor([tokens])).numpy()[0]
    cache = lm.make_cache(1, max_len=32, block_size=4)
    eng = GenerateEngine(lm, cache)
    slot = cache.alloc()
    inc = [eng._step(lm, cache, [slot], np.asarray([[t]], np.int32))[0]
           for t in tokens]
    np.testing.assert_allclose(np.asarray(inc), full, atol=1e-5, rtol=1e-5)


def test_decoder_module_load_params_and_guards():
    params = _params(CFG, 5)
    m = tgpt.GPTDecoder(device="cpu", **CFG).load_params(params)
    np.testing.assert_array_equal(m.h1_fc_w.detach().numpy(),
                                  params["h1_fc_w"])
    assert m.config["ffn_hidden"] == 4 * CFG["units"]
    with pytest.raises(KeyError, match="missing"):
        m.load_params({k: v for k, v in params.items() if k != "wte"})
    bad = dict(params, wpe=np.zeros((3, 24), np.float32))
    with pytest.raises(ValueError, match="wpe"):
        m.load_params(bad)
    with pytest.raises(NotImplementedError, match="parallel/moe.py"):
        tgpt.GPTDecoder(device="cpu", moe_experts=2, **CFG)
    with pytest.raises(ValueError, match="divide"):
        tgpt.gpt_config(dict(CFG, num_heads=5))
