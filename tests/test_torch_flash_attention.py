"""The PyTorch port's flash-attention forward against the JAX package.

On the CPU the port takes its plain version (materialised scores, the same
bias, dead-row zeroing); the JAX side runs the Pallas forward kernel in
interpret mode, as tests/test_pallas.py does. Same numpy inputs from a seed,
tolerance rtol = atol = 1e-5 (fp32 both sides, another summation order).
The CUDA kernel is held against the plain version on a card in
tests/test_torch_kernels_cuda.py.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from incubator_mxnet_tpu.ops.pallas import flash_attention as jflash
from incubator_mxnet_tpu.ops.pallas.flash_attention import _fwd_call
from incubator_mxnet_tpu_torch.ops.kernels.flash_attention import (
    flash_attention, flash_attention_forward)

RTOL = ATOL = 1e-5


def _qkv(B, H, T, D, seed):
    rs = np.random.RandomState(seed)
    return [rs.randn(B, H, T, D).astype(np.float32) for _ in range(3)]


def _mask(B, T, lengths):
    return (np.arange(T)[None, :] < np.asarray(lengths)[:, None]) \
        .astype(np.int32)


CASES = {
    "plain": {},
    "kv_mask": {"kv_mask": [128, 77]},
    "causal": {"causal": True},
    "kv_bias": {"kv_bias": True},
    "causal_mask_bias": {"causal": True, "kv_mask": [50, 128],
                         "kv_bias": True},
}


@pytest.mark.parametrize("T", [128, 256])
@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_matches_pallas_interpret(T, case):
    opts = CASES[case]
    B, H, D = 2, 2, 64
    q, k, v = _qkv(B, H, T, D, T)
    jkw, tkw = {}, {}
    if opts.get("causal"):
        jkw["causal"] = tkw["causal"] = True
    if "kv_mask" in opts:
        m = _mask(B, T, [min(n, T) for n in opts["kv_mask"]])
        jkw["kv_mask"], tkw["kv_mask"] = jnp.asarray(m), torch.from_numpy(m)
    if opts.get("kv_bias"):
        kb = np.random.RandomState(1).randn(B, H, T).astype(np.float32)
        jkw["kv_bias"], tkw["kv_bias"] = jnp.asarray(kb), torch.from_numpy(kb)
    want = np.asarray(jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             interpret=True, **jkw))
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), **tkw).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_flash_lse_matches_pallas_interpret():
    """lse comes out as (B*H, T); the TPU kernel's is 8-sublane
    replicated, (B*H, 8, T)."""
    B, H, T, D = 1, 2, 128, 64
    q, k, v = (a.reshape(B * H, T, D) for a in _qkv(B, H, T, D, 9))
    bias = np.zeros((B * H, T), np.float32)
    bias[:, 100:] = -1e30
    scale = 1.0 / math.sqrt(D)
    out_j, lse_j = _fwd_call(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(np.repeat(bias[:, None], 8, 1)),
                             scale, False, 128, 128, interpret=True)
    out_t, lse_t = flash_attention_forward(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(bias), scale)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j)[:, 0],
                               rtol=RTOL, atol=ATOL)


def test_flash_fully_masked_rows_are_zero():
    """Mirrors tests/test_pallas.py: a sample with no live key gives exact
    zeros (and lse 0), in the Pallas kernel and in the port."""
    B, H, T, D = 2, 2, 128, 64
    q, k, v = _qkv(B, H, T, D, 5)
    m = np.stack([np.zeros(T), np.ones(T)]).astype(np.int32)
    want = np.asarray(jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             kv_mask=jnp.asarray(m), interpret=True))
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v),
                          kv_mask=torch.from_numpy(m)).numpy()
    np.testing.assert_array_equal(got[0], 0.0)
    np.testing.assert_array_equal(want[0], 0.0)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    _out, lse = flash_attention_forward(
        *(torch.from_numpy(a.reshape(B * H, T, D)) for a in (q, k, v)),
        bias=torch.from_numpy(np.repeat(np.where(m == 0, -1e30, 0.0)
                                        .astype(np.float32), H, 0)))
    assert (lse[:H] == 0).all()


@pytest.mark.parametrize("T", [1, 100, 200])
def test_flash_takes_any_length(T):
    """The port drops the TPU kernel's T % 128 rule; at lengths the Pallas
    kernel refuses it is held against the JAX package's dense attention."""
    B, H, D = 1, 2, 64
    q, k, v = _qkv(B, H, T, D, T)
    with pytest.raises(ValueError, match="seq_len"):
        jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
               interpret=True)
    m = _mask(B, T, [max(1, T - 3)])
    s = jnp.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(D)
    s = s + jnp.where(jnp.asarray(m) != 0, 0.0, -1e30)[:, None, None, :]
    want = np.asarray(jnp.einsum("bhqk,bhkd->bhqd",
                                 jax.nn.softmax(s, axis=-1), v))
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v),
                          kv_mask=torch.from_numpy(m)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_cpu_path_does_not_launch():
    n0 = flash_attention_forward.launches
    q = torch.randn(2, 16, 32)
    flash_attention_forward(q, q, q)
    assert flash_attention_forward.launches == n0


def _tf32(x):
    """x rounded to TF32's 10 mantissa bits, to nearest with ties away from
    zero, as the kernels split (cvt.rna.tf32.f32's rounding)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _mm3(a, b):
    """One k-step of the kernel's 3xTF32 product into a fresh accumulator:
    hi*lo + lo*hi + hi*hi of the operands' tf32 halves, in float32."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return (torch.matmul(ah, bl) + torch.matmul(al, bh)) + torch.matmul(ah,
                                                                        bh)


def _forward_as_the_kernel_computes_it(q, k, v, bias, scale, causal):
    """The CUDA forward's arithmetic on (BH, T, D) float32, emulated tile by
    tile: 64-row Q tiles, 32-key stages (a stage whose biases are all at or
    below -0.5e30 is skipped for its row of BH, stages past the causal
    diagonal are not visited); S = Q K^T and O += P V as one fresh 3xTF32
    accumulator an 8-wide k-step, each added to the running fp32 sum; the
    online softmax's max, rescale and sum; dead rows zero with lse 0."""
    BH, T, D = q.shape
    out = torch.zeros_like(q)
    lse = torch.zeros(BH, T)
    for q0 in range(0, T, 64):
        rows = torch.arange(q0, min(q0 + 64, T))
        Q = q[:, rows]
        m = torch.full((BH, len(rows)), -1e30)
        l = torch.zeros(BH, len(rows))
        acc = torch.zeros(BH, len(rows), D)
        for k0 in range(0, T, 32):
            if causal and k0 > rows[-1]:
                break
            keys = torch.arange(k0, min(k0 + 32, T))
            live = (bias[:, keys] > -0.5e30).any(dim=1)[:, None, None]
            s = torch.zeros(BH, len(rows), len(keys))
            for kk in range(0, D, 8):
                s = s + _mm3(Q[..., kk:kk + 8],
                             k[:, keys, kk:kk + 8].transpose(1, 2))
            x = s * scale + bias[:, None, keys]
            if causal:
                x = x.masked_fill(keys[None, :] > rows[:, None], -1e30)
            mx = torch.maximum(m, x.amax(dim=-1))
            alpha = torch.exp(m - mx)
            p = torch.exp(x - mx[..., None])
            new_acc = acc * alpha[..., None]
            for j in range(0, len(keys), 8):
                new_acc = new_acc + _mm3(p[..., j:j + 8],
                                         v[:, keys[j:j + 8]])
            acc = torch.where(live, new_acc, acc)
            l = torch.where(live[..., 0], l * alpha + p.sum(dim=-1), l)
            m = torch.where(live[..., 0], mx, m)
        dead = m <= -0.5e30
        l_safe = l.clamp_min(1e-30)
        out[:, rows] = (acc / l_safe[..., None]).masked_fill(dead[..., None],
                                                             0.0)
        lse[:, rows] = (m + torch.log(l_safe)).masked_fill(dead, 0.0)
    return out, lse


def _attention_f64(q, k, v, bias, scale, causal):
    s = torch.matmul(q.double(), k.double().transpose(1, 2)) * scale
    s = s + bias.double()[:, None, :]
    if causal:
        pos = torch.arange(q.shape[1])
        s = s.masked_fill(pos[:, None] < pos[None, :], -1e30)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l_safe = p.sum(dim=-1).clamp_min(1e-30)
    dead = m <= -0.5e30
    out = (torch.matmul(p, v.double()) / l_safe[..., None]).masked_fill(
        dead[..., None], 0.0)
    return out, (m + torch.log(l_safe)).masked_fill(dead, 0.0)


@pytest.mark.parametrize("causal", [False, True])
def test_3xtf32_tiles_stay_within_2e5_of_float64_and_match_pallas(causal):
    """The forward kernel's numerical method, checked on the CPU (the kernel
    runs only on a card): its 3xTF32 products with fresh accumulators and
    its dead-tile skipping, emulated at a small ragged shape (3 samples x 2
    heads, T = 256, D = 64, key lengths 256, 77 and 0), stay within 2e-5 of
    the same attention in float64 and within 1e-5 of the JAX package's
    Pallas forward in interpret mode; the sample with no live key is exact
    zeros with lse 0. Plain TF32 (one product of the hi halves) would miss
    2e-5."""
    B, H, T, D = 3, 2, 256, 64
    q, k, v = _qkv(B, H, T, D, 41 + causal)
    m = _mask(B, T, [256, 77, 0])
    bias = np.repeat(np.where(m == 0, -1e30, 0.0).astype(np.float32), H, 0)
    scale = 1.0 / math.sqrt(D)
    tq, tk, tv = (torch.from_numpy(a.reshape(B * H, T, D)) for a in (q, k, v))
    got, got_lse = _forward_as_the_kernel_computes_it(
        tq, tk, tv, torch.from_numpy(bias), scale, causal)
    exact, exact_lse = _attention_f64(tq, tk, tv, torch.from_numpy(bias),
                                      scale, causal)
    assert (got.double() - exact).abs().max().item() <= 2e-5
    assert (got_lse.double() - exact_lse).abs().max().item() <= 2e-5
    assert (got[2 * H:] == 0).all() and (got_lse[2 * H:] == 0).all()
    want = np.asarray(jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             kv_mask=jnp.asarray(m), causal=causal,
                             interpret=True))
    np.testing.assert_allclose(got.numpy().reshape(B, H, T, D), want,
                               rtol=RTOL, atol=ATOL)
    s1 = torch.matmul(_tf32(tq), _tf32(tk).transpose(1, 2)) * scale
    s1 = s1 + torch.from_numpy(bias)[:, None, :]
    if causal:
        s1 = s1.masked_fill(torch.ones(T, T, dtype=torch.bool).triu(1),
                            -1e30)
    p1 = torch.softmax(s1, dim=-1)
    tf32_out = torch.matmul(_tf32(p1), _tf32(tv))[:2 * H]
    assert (tf32_out.double() - exact[:2 * H]).abs().max().item() > 2e-5


# ------------------------------------------------------------- bf16, fp16
# The JAX package's kernels take the input dtype: on bf16 or fp16 q, k, v
# the forward feeds both products in that dtype with fp32 sums and rounds p
# to it before P V (flash_attention.py:88-90), O in the input dtype, the lse
# fp32. The port's plain version rounds at the same point; the sums differ
# only in order, so nearly every element is bitwise equal. Before the plain
# version rounded p (it kept p in fp32 for P V), far fewer were: the share
# of bitwise-equal elements is what this test holds (at least 99 %), beside
# every element within twice the dtype's half step (2**-8 in bf16, 2**-11 in
# fp16) of the output's largest magnitude and the lse within 1e-5.
BF16_CASES = {"ragged": dict(lengths=[None, 77]),
              "dead_row": dict(lengths=[-5, 0]),
              "causal": dict(lengths=[None, None], causal=True)}
#: dtype name -> (torch dtype, jnp dtype, the tolerance's share of the max)
HALF = {"bfloat16": (torch.bfloat16, jnp.bfloat16, 2.0 ** -8),
        "float16": (torch.float16, jnp.float16, 2.0 ** -11)}


def half_case(B, H, T, D, case, seed, dtype=torch.bfloat16):
    """(q, k, v, g as float32 numpy rounded to ``dtype``, the (B, T) int32
    mask, causal): the lengths of BF16_CASES, None for T and -n for T -
    n."""
    opts = BF16_CASES[case]
    rs = np.random.RandomState(seed)
    arrs = [torch.from_numpy(rs.randn(B, H, T, D).astype(np.float32))
            .to(dtype).float().numpy() for _ in range(4)]
    lens = [T if n is None else (T + n if n < 0 else n)
            for n in opts["lengths"]]
    return arrs, _mask(B, T, lens), opts.get("causal", False)


def half_agreement(got, want):
    """(max |got - want| / max |want|, share of bitwise-equal elements)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return (float(np.abs(got - want).max() / np.abs(want).max()),
            float((got == want).mean()))


@pytest.mark.parametrize("dtype", sorted(HALF))
@pytest.mark.parametrize("T", [128, 256])
@pytest.mark.parametrize("case", sorted(BF16_CASES))
def test_half_forward_rounds_p_as_the_pallas_kernel_does(T, case, dtype):
    tdt, jdt, rel = HALF[dtype]
    B, H, D = 2, 2, 64
    (q, k, v, _g), mask, causal = half_case(B, H, T, D, case, T, tdt)
    bias = np.where(mask == 0, -1e30, 0.0).astype(np.float32)
    bias3 = np.repeat(bias[:, None], H, 1).reshape(B * H, T)
    j3 = [jnp.asarray(a.reshape(B * H, T, D), jdt) for a in (q, k, v)]
    out_j, lse_j = _fwd_call(*j3, jnp.asarray(np.repeat(bias3[:, None], 8,
                                                        1)),
                             1.0 / math.sqrt(D), causal, T, T,
                             interpret=True)
    t3 = [torch.from_numpy(a.reshape(B * H, T, D)).to(tdt)
          for a in (q, k, v)]
    out, lse = flash_attention_forward(*t3, torch.from_numpy(bias3),
                                       causal=causal)
    assert out.dtype == tdt and lse.dtype == torch.float32
    err, share = half_agreement(out.float(),
                                np.asarray(out_j.astype(jnp.float32)))
    assert err <= rel and share >= 0.99, (err, share)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j)[:, 0],
                               rtol=0, atol=1e-5)
    dead = (mask.sum(1) == 0).repeat(H)
    assert (out[torch.from_numpy(dead)] == 0).all()
    assert (lse[torch.from_numpy(dead)] == 0).all()


def test_fp16_mask_stays_fp32_and_dead_rows_stay_zero():
    """The public API builds the key bias in fp32 from an fp16 mask, as the
    JAX wrapper does (flash_attention.py:432-440): -1e30 would be -inf in
    fp16, and a dead row (m at or below -0.5e30) must still give exact
    zeros, not NaN."""
    B, H, T, D = 2, 2, 64, 32
    q, k, v = (torch.from_numpy(a).half() for a in _qkv(B, H, T, D, 9))
    mask = torch.from_numpy(_mask(B, T, [0, 40])).half()
    out = flash_attention(q, k, v, kv_mask=mask)
    assert out.dtype == torch.float16
    assert torch.isfinite(out).all() and (out[0] == 0).all()
    want = jflash(*(jnp.asarray(t.float().numpy(), jnp.float16)
                    for t in (q, k, v)),
                  kv_mask=jnp.asarray(mask.float().numpy(), jnp.float16),
                  interpret=True)
    err, share = half_agreement(out.float(), np.asarray(want, np.float32))
    assert err <= 2.0 ** -11 and share >= 0.99, (err, share)


# ------------------------------------- the 16-bit forward wrappers' contract
def _no_library():
    raise AssertionError("the kernel library was reached")


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_half_forward_wrappers_refuse_as_the_checks_do(dtype, monkeypatch):
    """flash_attention_fwd_bf16 and _f16 take (BH, T, D) q, k, v of their
    own dtype, contiguous and 16-byte aligned, D in (32, 64, 128), and an
    fp32 (BH, T) bias or None. Before the library is built or reached they
    refuse, with _check_cuda's errors: another dtype or mixed dtypes
    (TypeError), shapes that differ or are not 3-D, a head dim outside the
    three, a transposed view, a view 2 bytes off alignment and a bias of
    another dtype or shape (ValueError); tensors that pass every check but
    lie on the CPU (ValueError: the kernel has no CPU mode). No launch is
    counted."""
    import importlib
    fa = importlib.import_module(
        "incubator_mxnet_tpu_torch.ops.kernels.flash_attention")
    monkeypatch.setattr(fa._build, "library", _no_library)
    dt = getattr(torch, dtype)
    other = torch.float16 if dt == torch.bfloat16 else torch.bfloat16
    fn = getattr(fa, "flash_attention_fwd_" + ("bf16" if dtype == "bfloat16"
                                               else "f16"))
    n0 = fn.launches
    gen = torch.Generator().manual_seed(21)
    q = torch.randn(2, 16, 64, generator=gen).to(dt)
    q48 = torch.randn(2, 16, 48, generator=gen).to(dt)
    qt = q.transpose(0, 1)
    off = torch.empty(q.numel() + 1, dtype=dt)[1:].view(2, 16, 64)
    off.copy_(q)
    assert off.data_ptr() % 16 == 2
    bias = torch.zeros(2, 16)
    cases = [
        ((q, q.to(other), q, None), TypeError, "one dtype"),
        ((q.float(), q.float(), q.float(), None), TypeError, "one dtype"),
        ((q, q[:, :8], q, None), ValueError, "share one"),
        ((q[0], q[0], q[0], None), ValueError, "share one"),
        ((q48, q48, q48, None), ValueError, "head dim 48"),
        ((qt, qt, qt, None), ValueError, "contiguous"),
        ((off, q, q, None), ValueError, "aligned"),
        ((q, q, q, bias.to(dt)), ValueError, "bias must be"),
        ((q, q, q, bias[:, :8]), ValueError, "bias must be"),
        ((q, q, q, bias), ValueError, "CUDA"),
        ((q, q, q, None), ValueError, "CUDA"),
    ]
    for (a, b, c, bb), exc, match in cases:
        with pytest.raises(exc, match=match):
            fn(a, b, c, bb)
    # the public wrapper takes the plain version for CPU tensors
    out, lse = fa.flash_attention_forward(q, q, q, bias)
    assert out.dtype == dt and lse.dtype == torch.float32
    assert fn.launches == n0


@pytest.mark.parametrize("bias", [None, "bias"])
@pytest.mark.parametrize("causal", [False, True])
def test_forward_cost_counts_two_byte_elements(bias, causal):
    """_forward_cost for the 16-bit kernels: q, k, v read and out written at
    2 bytes an element, lse written and the bias read at 4; the operations
    those of two T x T x D products, halved under a causal mask. Only the
    element bytes differ from the fp32 count."""
    import importlib
    fa = importlib.import_module(
        "incubator_mxnet_tpu_torch.ops.kernels.flash_attention")
    BH, T, D = 96, 512, 64
    b = None if bias is None else torch.zeros(BH, T)
    flops, nbytes = fa._forward_cost(BH, T, D, b, causal, 2)
    rows = 1 + (bias is not None)
    assert nbytes == 4 * BH * T * D * 2 + rows * BH * T * 4
    assert flops == 4.0 * BH * T * T * D / (2 if causal else 1)
    f32 = fa._forward_cost(BH, T, D, b, causal)
    assert f32[1] - nbytes == 4 * BH * T * D * 2 and f32[0] == flops
