"""The PyTorch port's GPT decoder against the JAX package.

Same numpy weights (carried across by name with ``params_from_jax``) and
tokens on both sides, on the CPU: the full-sequence ``gpt_logits`` and the
paged ``gpt_forward_paged`` (logits, new_k, new_v) at rtol = atol = 1e-5
(fp32 both sides, another summation order). The JAX side's paged forward
takes its lax attention path, as its serving family does. bf16 weights
(ml_dtypes numpy) and fp16 ones through both packages' GPTPagedLM compute
in their dtype on both sides, each logits and K/V row within 2**-5 (bf16)
or 2**-8 (fp16) of its largest.
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


# ------------------------------------------------------------ bf16, fp16
#: bf16 logits and new K/V against the JAX package's, each (s, c) row
#: within 2**-5 of its own largest magnitude: the port's LayerNorm kernel
#: rounds once where the JAX GPT's jnp _ln rounds at every bf16 operation
#: (mean, centring, square, variance, rsqrt, scale, shift), addmm rounds
#: x @ W + b once where jnp rounds the product and the sum, and GELU rounds
#: once where jax.nn.gelu's composite rounds each step; a few bf16 steps
#: (2**-8 relative each) apart, carried through two layers. Measured: up to
#: 0.018 of the row's max on the logits, 0.015 on the new K/V.
BF16_ROW_TOL = 2.0 ** -5
#: fp16: the same rounding points, each step 2**-11 relative, so bf16's
#: bound scaled by fp16's three more mantissa bits
FP16_ROW_TOL = 2.0 ** -8
#: dtype name -> the row bound
ROW_TOL = {"bfloat16": BF16_ROW_TOL, "float16": FP16_ROW_TOL}
BF16_CFG = {"vocab_size": 64, "units": 32, "num_layers": 2, "num_heads": 2,
            "max_len": 64}


def _half_np(dtype):
    """The numpy type of a 16-bit dtype name (ml_dtypes' for bfloat16)."""
    if dtype == "bfloat16":
        import ml_dtypes
        return ml_dtypes.bfloat16
    return np.float16


def _half_params(cfg, seed, scale, dtype="bfloat16"):
    """Weights drawn from a seed, rounded to a 16-bit dtype: a numpy dict,
    the form the JAX package's bf16 (ml_dtypes) or fp16 arrays take on the
    host."""
    return {n: a.astype(_half_np(dtype))
            for n, a in _params(cfg, seed, scale).items()}


def _row_gap(got, want):
    """The largest |got - want| of each last-axis row over that row's
    largest |want| (rows of (S, C, ...) flattened past C)."""
    g = got.float().numpy().reshape(got.shape[0], got.shape[1], -1)
    w = np.asarray(want, np.float32).reshape(g.shape)
    return float((np.abs(g - w).max(-1)
                  / np.maximum(np.abs(w).max(-1), 1e-30)).max())


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("pools", ["float32", "half"])
@pytest.mark.parametrize("C,past", [(1, [5, 0]), (3, [5, 0])])
def test_half_weights_compute_in_their_dtype_as_in_jax(pools, C, past,
                                                       dtype):
    """The same bf16 (ml_dtypes numpy) or fp16 weights in the JAX
    GPTPagedLM and the port's on the CPU, over fp32 pools (16-bit weights
    over the default spec) and pools of the weights' dtype: parameters,
    logits and new K/V of that dtype on both sides (a row bound alone
    would not show an fp16 model widened to fp32: its rows sit well
    inside it), each row within ROW_TOL of its largest; a sequence with no
    past included."""
    from incubator_mxnet_tpu import generate as jgen
    from incubator_mxnet_tpu_torch import generate as tgen
    cfg = BF16_CFG
    tdt, ndt, tol = getattr(torch, dtype), _half_np(dtype), ROW_TOL[dtype]
    params = _half_params(cfg, 0, 0.5, dtype)
    tlm = tgen.GPTPagedLM(params, cfg, device="cpu")
    assert all(p.dtype == tdt for p in tlm.model.parameters())
    S, bs, mb, L = 2, 4, 4, cfg["num_layers"]
    H = cfg["num_heads"]
    D = cfg["units"] // H
    rs = np.random.RandomState(C)
    tokens = rs.randint(0, cfg["vocab_size"], (S, C)).astype(np.int32)
    lengths = np.asarray(past, np.int32)
    tables = rs.permutation(S * mb).reshape(S, mb).astype(np.int32)
    kps, vps = ([rs.randn(S * mb, bs, H, D).astype(np.float32)
                 for _ in range(L)] for _ in range(2))
    if pools == "half":
        kps, vps = ([a.astype(ndt) for a in p] for p in (kps, vps))
    want = jgen.GPTPagedLM(params, cfg).forward(tokens, lengths, tables,
                                                kps, vps)
    got = tlm.forward(tokens, lengths, tables,
                      *([tgpt._to_tensor(a) for a in p] for p in (kps, vps)))
    assert want[0].dtype == want[1][0].dtype == want[2][0].dtype == ndt
    assert got[0].dtype == got[1][0].dtype == got[2][0].dtype == tdt
    assert _row_gap(got[0], want[0]) <= tol
    for i in range(L):
        assert _row_gap(got[1][i], want[1][i]) <= tol, ("k", i)
        assert _row_gap(got[2][i], want[2][i]) <= tol, ("v", i)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_half_weights_carry_over_from_numpy_and_torch(dtype):
    """params_from_jax keeps float32, bfloat16 and float16 as given (a
    numpy array bit for bit, an ml_dtypes one without ml_dtypes in the
    port) and carries any other float dtype as float32;
    GPTDecoder.load_params takes the weights' dtype."""
    tdt, ndt = getattr(torch, dtype), _half_np(dtype)
    params = _half_params(CFG, 3, 0.05, dtype)
    got = tgpt.params_from_jax(params, CFG, "cpu")
    assert got["wte"].dtype == tdt
    np.testing.assert_array_equal(
        got["wte"].view(torch.int16).numpy(),
        params["wte"].view(np.int16))
    mixed = dict(params, wpe=params["wpe"].astype(np.float64),
                 lnf_g=torch.from_numpy(params["lnf_g"].astype(np.float32)))
    got = tgpt.params_from_jax(mixed, CFG, "cpu")
    assert (got["wpe"].dtype, got["lnf_g"].dtype, got["h0_qkv_w"].dtype) \
        == (torch.float32, torch.float32, tdt)
    m = tgpt.GPTDecoder(device="cpu", **CFG).load_params(
        {n: torch.from_numpy(a.astype(np.float32)).to(tdt)
         for n, a in params.items()})
    assert m.wte.dtype == tdt and isinstance(m.wte, torch.nn.Parameter)
    assert np.asarray(params["wte"]).dtype == ndt


def test_fp16_full_forward_masks_with_inf_as_jnp_does():
    """The full-sequence forward on fp16 weights: jnp.where rounds the
    -1e30 mask to -inf in fp16, and the softmax gives the masked keys exact
    zeros; the port's logits are fp16, finite and each row within
    FP16_ROW_TOL of the JAX package's largest."""
    params = _half_params(BF16_CFG, 4, 0.5, "float16")
    tokens = np.random.RandomState(4).randint(0, 64, (2, 9))
    want = _jax_logits({n: jnp.asarray(a) for n, a in params.items()},
                       BF16_CFG, tokens)
    got = tgpt.gpt_logits(tgpt.params_from_jax(params, BF16_CFG, "cpu"),
                          BF16_CFG, torch.from_numpy(tokens))
    assert want.dtype == np.float16 and got.dtype == torch.float16
    assert bool(torch.isfinite(got).all())
    assert _row_gap(got, want) <= FP16_ROW_TOL
