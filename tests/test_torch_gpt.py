"""The PyTorch port's GPT decoder against the JAX package.

Same numpy weights (carried across by name with ``params_from_jax``) and
tokens on both sides, on the CPU: the full-sequence ``gpt_logits`` and the
paged ``gpt_forward_paged`` (logits, new_k, new_v) at rtol = atol = 1e-5
(fp32 both sides, another summation order). The JAX side's paged forward
takes its lax attention path, as its serving family does. bf16 weights
(ml_dtypes numpy) through both packages' GPTPagedLM compute in bf16 on
both sides, each logits and K/V row within 2**-5 of its largest.
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


# ------------------------------------------------------------------- bf16
#: bf16 logits and new K/V against the JAX package's, each (s, c) row
#: within 2**-5 of its own largest magnitude: the port's LayerNorm kernel
#: rounds once where the JAX GPT's jnp _ln rounds at every bf16 operation
#: (mean, centring, square, variance, rsqrt, scale, shift), addmm rounds
#: x @ W + b once where jnp rounds the product and the sum, and GELU rounds
#: once where jax.nn.gelu's composite rounds each step; a few bf16 steps
#: (2**-8 relative each) apart, carried through two layers. Measured: up to
#: 0.018 of the row's max on the logits, 0.015 on the new K/V.
BF16_ROW_TOL = 2.0 ** -5
BF16_CFG = {"vocab_size": 64, "units": 32, "num_layers": 2, "num_heads": 2,
            "max_len": 64}


def _bf16_params(cfg, seed, scale):
    """Weights drawn from a seed, rounded to bf16: an ml_dtypes dict, the
    form the JAX package's bf16 arrays take on the host."""
    import ml_dtypes
    return {n: a.astype(ml_dtypes.bfloat16)
            for n, a in _params(cfg, seed, scale).items()}


def _row_gap(got, want):
    """The largest |got - want| of each last-axis row over that row's
    largest |want| (rows of (S, C, ...) flattened past C)."""
    g = got.float().numpy().reshape(got.shape[0], got.shape[1], -1)
    w = np.asarray(want, np.float32).reshape(g.shape)
    return float((np.abs(g - w).max(-1)
                  / np.maximum(np.abs(w).max(-1), 1e-30)).max())


@pytest.mark.parametrize("pools", ["float32", "bfloat16"])
@pytest.mark.parametrize("C,past", [(1, [5, 0]), (3, [5, 0])])
def test_bf16_weights_compute_in_bf16_as_in_jax(pools, C, past):
    """The same bf16 weights (ml_dtypes numpy) in the JAX GPTPagedLM and the
    port's on the CPU, over fp32 pools (bf16 weights over the default spec)
    and bf16 pools: bf16 logits and new K/V on both sides, each row within
    BF16_ROW_TOL of its largest; a sequence with no past included."""
    import ml_dtypes
    from incubator_mxnet_tpu import generate as jgen
    from incubator_mxnet_tpu_torch import generate as tgen
    cfg = BF16_CFG
    params = _bf16_params(cfg, 0, 0.5)
    tlm = tgen.GPTPagedLM(params, cfg, device="cpu")
    assert all(p.dtype == torch.bfloat16 for p in tlm.model.parameters())
    S, bs, mb, L = 2, 4, 4, cfg["num_layers"]
    H = cfg["num_heads"]
    D = cfg["units"] // H
    rs = np.random.RandomState(C)
    tokens = rs.randint(0, cfg["vocab_size"], (S, C)).astype(np.int32)
    lengths = np.asarray(past, np.int32)
    tables = rs.permutation(S * mb).reshape(S, mb).astype(np.int32)
    kps, vps = ([rs.randn(S * mb, bs, H, D).astype(np.float32)
                 for _ in range(L)] for _ in range(2))
    if pools == "bfloat16":
        kps, vps = ([a.astype(ml_dtypes.bfloat16) for a in p]
                    for p in (kps, vps))
    want = jgen.GPTPagedLM(params, cfg).forward(tokens, lengths, tables,
                                                kps, vps)
    got = tlm.forward(tokens, lengths, tables,
                      *([tgpt._to_tensor(a) for a in p] for p in (kps, vps)))
    assert want[0].dtype == ml_dtypes.bfloat16
    assert got[0].dtype == got[1][0].dtype == got[2][0].dtype \
        == torch.bfloat16
    assert _row_gap(got[0], want[0]) <= BF16_ROW_TOL
    for i in range(L):
        assert _row_gap(got[1][i], want[1][i]) <= BF16_ROW_TOL, ("k", i)
        assert _row_gap(got[2][i], want[2][i]) <= BF16_ROW_TOL, ("v", i)


def test_bf16_weights_carry_over_from_numpy_and_torch():
    """params_from_jax keeps float32 and bfloat16 as given (an ml_dtypes
    array bit for bit, without ml_dtypes in the port) and carries any other
    float dtype as float32; GPTDecoder.load_params takes the weights'
    dtype."""
    import ml_dtypes
    params = _bf16_params(CFG, 3, 0.05)
    got = tgpt.params_from_jax(params, CFG, "cpu")
    assert got["wte"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got["wte"].view(torch.int16).numpy(),
        params["wte"].view(np.int16))
    mixed = dict(params, wpe=params["wpe"].astype(np.float64),
                 lnf_g=torch.from_numpy(params["lnf_g"].astype(np.float32)))
    got = tgpt.params_from_jax(mixed, CFG, "cpu")
    assert (got["wpe"].dtype, got["lnf_g"].dtype, got["h0_qkv_w"].dtype) \
        == (torch.float32, torch.float32, torch.bfloat16)
    m = tgpt.GPTDecoder(device="cpu", **CFG).load_params(
        {n: torch.from_numpy(a.astype(np.float32)).bfloat16()
         for n, a in params.items()})
    assert m.wte.dtype == torch.bfloat16 and isinstance(m.wte,
                                                        torch.nn.Parameter)
    assert np.asarray(params["wte"]).dtype == ml_dtypes.bfloat16
