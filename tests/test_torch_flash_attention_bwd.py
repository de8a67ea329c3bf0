"""The PyTorch port's flash-attention gradients against the JAX package's.

On the CPU the port's autograd Function takes the plain backward (P
recomputed from the forward's lse, as the TPU kernels do); the JAX side
differentiates its Pallas flash attention in interpret mode, as
tests/test_pallas.py does, which runs the _dq_kernel and _dkv_kernel through
the custom VJP. Same numpy inputs from a seed, tolerance rtol = atol = 1e-5
(fp32 both sides, another summation order). The CUDA kernels are held
against the plain backward on a card in tests/test_torch_kernels_cuda.py.

A learned ``kv_bias`` (the TPU kernel's has_dbias path) is held the same way:
its gradient and those of q, k and v against ``jax.grad`` through the JAX
``flash_attention(..., interpret=True)``, for the (B, H, T) and the causal
(B, T) form of tests/test_pallas.py and with a kv_mask, at rtol = atol =
1e-5.

The card holds the kernels to the plain formulas evaluated in float64
(``compute_dtype=torch.float64``). Here that evaluation is held to the JAX
package's gradients at the same 1e-5, the default float32 path is pinned
bit for bit to the formulas as they stood, and the numerical premise of the
kernels' 3xTF32 products (fp32 operands split into two TF32 halves, three
TF32 products) is checked on the CPU by emulation: within 2e-5 of float64
at the training path's ragged shape.
"""

import functools
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from incubator_mxnet_tpu.ops.pallas import flash_attention as jflash
from incubator_mxnet_tpu_torch.ops.kernels import flash_attention as tflash
from incubator_mxnet_tpu_torch.ops.kernels.flash_attention import (
    flash_attention_bwd_dkv, flash_attention_bwd_dkv_dbias,
    flash_attention_bwd_dq)

RTOL = ATOL = 1e-5
# the module (the package's ``flash_attention`` name is the function)
fa = importlib.import_module(
    "incubator_mxnet_tpu_torch.ops.kernels.flash_attention")


@functools.lru_cache(maxsize=None)
def _pallas_case(T, D, causal):
    """Inputs of sum(out * g) with a kv_mask whose first sample has no live
    key and whose second is ragged, and jax.grad of it in q, k, v through
    the JAX flash attention in interpret mode (shared by the tests below)."""
    B, H = 2, 2
    rs = np.random.RandomState(T + D + causal)
    q, k, v, g = (rs.randn(B, H, T, D).astype(np.float32) for _ in range(4))
    mask = (np.arange(T)[None, :] < np.array([[0], [T - 19]])) \
        .astype(np.int32)

    def jloss(q, k, v):
        out = jflash(q, k, v, causal=causal, kv_mask=jnp.asarray(mask),
                     interpret=True)
        return jnp.sum(out * jnp.asarray(g))

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return (q, k, v, g, mask), tuple(np.asarray(w) for w in want)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("D", [32, 64])
@pytest.mark.parametrize("T", [64, 128, 256])
def test_flash_gradients_match_pallas_interpret(T, D, causal):
    """dq, dk, dv of sum(out * g) with a kv_mask whose first sample has no
    live key (its gradients are exact zeros on both sides) and whose second
    is ragged."""
    (q, k, v, g, mask), want = _pallas_case(T, D, causal)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = tflash(*leaves, causal=causal, kv_mask=torch.from_numpy(mask))
    out.backward(torch.from_numpy(g))
    for name, t, w in zip("qkv", leaves, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL, err_msg="d" + name)
        assert (t.grad[0] == 0).all() and (np.asarray(w)[0] == 0).all()



def _mask_bias(mask, H):
    """(B, T) kv_mask -> the (B*H, T) additive bias flash_attention builds."""
    B, T = mask.shape
    neg = torch.zeros(B, T).masked_fill(torch.from_numpy(mask) == 0,
                                        fa._NEG_INF)
    return neg[:, None, :].expand(B, H, T).reshape(B * H, T).contiguous()


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("D", [32, 64])
@pytest.mark.parametrize("T", [64, 128, 256])
def test_float64_backward_matches_pallas_interpret(T, D, causal):
    """The plain backward's formulas in float64 (the card's oracle), from
    the plain forward's out and lse, against the JAX package's gradients of
    the same loss at rtol = atol = 1e-5; float64 results, exact zeros for
    the sample with no live key."""
    (q, k, v, g, mask), want = _pallas_case(T, D, causal)
    B, H, _, _ = q.shape
    q3, k3, v3, g3 = (torch.from_numpy(a).reshape(B * H, T, D)
                      for a in (q, k, v, g))
    bias = _mask_bias(mask, H)
    scale = 1.0 / np.sqrt(D)
    out, lse = fa.flash_attention_reference(q3, k3, v3, bias, scale, causal)
    got = fa.flash_attention_backward_reference(
        q3, k3, v3, out, lse, g3, bias, scale, causal,
        compute_dtype=torch.float64)
    for name, t, w in zip("qkv", got, want):
        assert t.dtype == torch.float64
        np.testing.assert_allclose(t.reshape(B, H, T, D).numpy(), w,
                                   rtol=RTOL, atol=ATOL, err_msg="d" + name)
        assert (t.reshape(B, H, T, D)[0] == 0).all()


def _backward_as_it_stood(q, k, v, out, lse, do, bias, scale, causal):
    """flash_attention_backward_reference's float32 formulas, written out
    as they stood before its compute_dtype argument."""
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    s = s + bias.float()[:, None, :]
    if causal:
        pos = torch.arange(q.shape[1])
        s = s.masked_fill(pos[:, None] < pos[None, :], -1e30)
    p = torch.exp(s - lse.float()[..., None])
    delta = (dof * out.float()).sum(dim=-1)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    ds_bias = p * (dp - delta[..., None])
    ds = ds_bias * scale
    return (torch.matmul(ds, kf), torch.matmul(ds.transpose(-1, -2), qf),
            torch.matmul(p.transpose(-1, -2), dof), ds_bias.sum(dim=-2))


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_float32_backward_is_bitwise_what_it_was(causal):
    """The default compute_dtype (float32), which the CPU path and every
    caller without the argument take, gives the same bits as the formulas
    did before the argument existed, dbias included."""
    rs = np.random.RandomState(21 + causal)
    BH, T, D = 4, 96, 32
    q, k, v, do = (torch.from_numpy(rs.randn(BH, T, D).astype(np.float32))
                   for _ in range(4))
    bias = torch.from_numpy(rs.randn(BH, T).astype(np.float32))
    bias[1, 40:] = -1e30
    scale = 1.0 / np.sqrt(D)
    out, lse = fa.flash_attention_reference(q, k, v, bias, scale, causal)
    got = fa.flash_attention_backward_reference(
        q, k, v, out, lse, do, bias, scale, causal, needs_dbias=True)
    explicit = fa.flash_attention_backward_reference(
        q, k, v, out, lse, do, bias, scale, causal, needs_dbias=True,
        compute_dtype=torch.float32)
    before = _backward_as_it_stood(q, k, v, out, lse, do, bias, scale,
                                   causal)
    for a, b, c in zip(got, explicit, before):
        assert a.dtype == torch.float32
        assert torch.equal(a, b) and torch.equal(a, c)


def _tf32(x):
    """x rounded to TF32's 10 mantissa bits, to nearest with ties away from
    zero, as cvt.rna.tf32.f32 rounds (and as the kernels split)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _mm_3xtf32(a, b):
    """a @ b from TF32 halves: hi = tf32(x), lo = tf32(x - hi), and the
    three products hi*lo + lo*hi + hi*hi in float32 (lo*lo dropped)."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return (torch.matmul(ah, bl) + torch.matmul(al, bh)) + torch.matmul(ah,
                                                                        bh)


def test_tf32_split_rounds_like_cvt_rna():
    """Ties go away from zero; hi keeps 10 mantissa bits; hi + lo is x to
    within 2^-22 of |x|."""
    one_ulp = 2.0 ** -10
    x = torch.tensor([1 + one_ulp / 2, -(1 + one_ulp / 2), 1 + one_ulp / 4,
                      1 + 3 * one_ulp / 4, 0.0, 3.0e-39])
    want = torch.tensor([1 + one_ulp, -(1 + one_ulp), 1.0, 1 + one_ulp, 0.0,
                         _tf32(torch.tensor([3.0e-39]))[0].item()])
    assert torch.equal(_tf32(x), want)
    rs = np.random.RandomState(3)
    y = torch.from_numpy((rs.randn(10000) * 10.0 ** rs.uniform(
        -20, 20, 10000)).astype(np.float32))
    hi = _tf32(y)
    lo = _tf32(y - hi)
    assert ((hi.view(torch.int32) & 0x1FFF) == 0).all()
    err = ((hi.double() + lo.double()) - y.double()).abs()
    assert (err <= 2.0 ** -22 * y.double().abs()).all()


def test_3xtf32_products_keep_the_backward_within_2e5_of_float64():
    """The design's numerical premise, checked on the method and not on the
    kernels (which run only on a card): the backward's five products in
    3xTF32, at the training path's ragged shape (12, 512, 64) with key
    lengths 512, 300, 0, 511, 64, 1, 450, 129 across the rows and the
    forward's dead-row convention (lse 0), stay within 2e-5 of the same
    formulas in float64, as the card's oracle requires. Plain TF32 (one
    product of the hi halves) misses that by orders of magnitude."""
    BH, T, D = 12, 512, 64
    rs = np.random.RandomState(9)
    q, k, v, do = (torch.from_numpy(rs.randn(BH, T, D).astype(np.float32))
                   for _ in range(4))
    lengths = [512, 300, 0, 511, 64, 1, 450, 129]
    bias = torch.zeros(BH, T)
    for i in range(BH):
        bias[i, lengths[i % len(lengths)]:] = fa._NEG_INF
    scale = 1.0 / np.sqrt(D)
    out, lse = fa.flash_attention_reference(q, k, v, bias, scale)
    exact = fa.flash_attention_backward_reference(
        q, k, v, out, lse, do, bias, scale, compute_dtype=torch.float64)

    def backward(mm):
        s = mm(q, k.transpose(-1, -2)) * scale + bias[:, None, :]
        p = torch.exp(s - lse[..., None])
        delta = (do * out).sum(dim=-1)
        ds = p * (mm(do, v.transpose(-1, -2)) - delta[..., None]) * scale
        return (mm(ds, k), mm(ds.transpose(-1, -2), q),
                mm(p.transpose(-1, -2), do))

    errs = [(a.double() - b).abs().max().item()
            for a, b in zip(backward(_mm_3xtf32), exact)]
    assert max(errs) <= 2e-5, errs
    tf32_errs = [(a.double() - b).abs().max().item() for a, b in zip(
        backward(lambda a, b: torch.matmul(_tf32(a), _tf32(b))), exact)]
    assert min(tf32_errs) > 100 * 2e-5, tf32_errs

def test_learned_kv_bias_gradient_raises_on_every_device():
    """A kv_bias that needs a gradient gets one on the CPU (the plain
    backward), and on a device that is neither the CPU nor CUDA the call
    raises, as every other flash call does; a constant kv_bias is taken
    and gets no gradient."""
    q = torch.randn(1, 2, 16, 32, requires_grad=True)
    kb = torch.randn(1, 16, requires_grad=True)
    tflash(q, q, q, kv_bias=kb).sum().backward()
    assert kb.grad is not None and kb.grad.shape == kb.shape
    for dev in ("meta",):
        with pytest.raises(ValueError, match="unsupported device"):
            tflash(q.to(dev), q.to(dev), q.to(dev), kv_bias=kb.to(dev))
    q.grad = None
    kb2 = kb.detach()
    out = tflash(q, q, q, kv_bias=kb2)
    out.sum().backward()
    assert q.grad is not None and kb2.grad is None


def test_cpu_backward_does_not_launch():
    n0 = (flash_attention_bwd_dq.launches, flash_attention_bwd_dkv.launches)
    q = torch.randn(1, 2, 16, 32, requires_grad=True)
    tflash(q, q, q, causal=True).sum().backward()
    assert (flash_attention_bwd_dq.launches,
            flash_attention_bwd_dkv.launches) == n0


DBIAS_CASES = {
    # (bias shape, causal, masked, dtype): tests/test_pallas.py's two, and a
    # mask, in fp32 and on bf16 and fp16 q, k and v
    "bht": ((2, 2, 128), False, False, "float32"),
    "bt_causal": ((2, 128), True, False, "float32"),
    "bht_masked": ((2, 2, 128), False, True, "float32"),
    **{form + suffix: (shape, causal, masked, dtype)
       for suffix, dtype in (("_bf16", "bfloat16"), ("_f16", "float16"))
       for form, shape, causal, masked in (
           ("bht", (2, 2, 128), False, False),
           ("bt_causal", (2, 128), True, False),
           ("bht_masked", (2, 2, 128), False, True))},
}
#: bf16 or fp16 q, k, v: dq, dk and dv as test_half_gradients_round_as_the_
#: pallas_kernels_do holds them (2**-8 or 2**-11 of the largest), with at
#: least DBIAS_SHARE of their elements bitwise equal; the fp32 dbias,
#: summed from the unrounded dS of the same 16-bit inputs on both sides,
#: within DBIAS_BF16_TOL of its largest magnitude (another order of fp32
#: sums over 16-bit products)
DBIAS_BF16_TOL = 1e-4
#: the least share of bitwise-equal gradient elements: fp16's finer grid
#: turns more of the fp32 sums' order differences in dP and delta into a
#: dS rounded one step apart (measured: dk 97.1 % and 97.9 % bitwise equal
#: under sum(out ** 2), at 9.5e-5 and 3.8e-5 of its max, against bf16's 99.1
#: % and more)
DBIAS_SHARE = {"bfloat16": 0.99, "float16": 0.95}


@pytest.mark.parametrize("case", sorted(DBIAS_CASES))
def test_learned_kv_bias_gradients_match_pallas_interpret(case):
    """Gradients of sum(out ** 2) in q, k, v and a learned kv_bias through
    the port's autograd Function (the plain backward with dbias on the
    CPU) against jax.grad through the JAX package's flash_attention in
    interpret mode (its _dkv_kernel with has_dbias). B 2, H 2, T 128,
    D 32; with the mask, sample 1's last 40 keys are padding and their bias
    gradient is exactly 0 on both sides. The bf16 and fp16 cases feed q, k
    and v of that dtype (the bias stays fp32) to both, and hold dq, dk, dv
    in it and dbias in fp32."""
    shape, causal, masked, dtype = DBIAS_CASES[case]
    B, H, T, D = 2, 2, 128, 32
    rs = np.random.RandomState(60 + len(shape) + causal + 2 * masked)
    q, k, v = (rs.randn(B, H, T, D).astype(np.float32) for _ in range(3))
    kb = rs.randn(*shape).astype(np.float32)
    if dtype != "float32":
        return _learned_kv_bias_half(q, k, v, kb, causal, masked, dtype)
    mask = None
    if masked:
        mask = (np.arange(T)[None, :] < np.array([[T], [T - 40]])) \
            .astype(np.int32)

    def jloss(q, k, v, kb):
        out = jflash(q, k, v, causal=causal, kv_bias=kb, interpret=True,
                     kv_mask=None if mask is None else jnp.asarray(mask))
        return jnp.sum(out ** 2)

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in (q, k, v, kb)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, kb)]
    out = tflash(*leaves[:3], causal=causal, kv_bias=leaves[3],
                 kv_mask=None if mask is None else torch.from_numpy(mask))
    (out ** 2).sum().backward()
    for name, t, w in zip(("q", "k", "v", "kv_bias"), leaves, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL, err_msg="d" + name)
    if masked:
        assert (leaves[3].grad[1][..., T - 40:] == 0).all()
        assert (np.asarray(want[3])[1][..., T - 40:] == 0).all()


def _learned_kv_bias_half(q, k, v, kb, causal, masked, dtype):
    tdt, jdt, rel = HALF[dtype]
    B, H, T, _D = q.shape
    mask = None
    if masked:
        mask = (np.arange(T)[None, :] < np.array([[T], [T - 40]])) \
            .astype(np.int32)

    def jloss(q, k, v, kb):
        out = jflash(q, k, v, causal=causal, kv_bias=kb, interpret=True,
                     kv_mask=None if mask is None else jnp.asarray(mask))
        return jnp.sum(out.astype(jnp.float32) ** 2)

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a, jdt) for a in (q, k, v)), jnp.asarray(kb))
    leaves = [torch.from_numpy(a).to(tdt).requires_grad_()
              for a in (q, k, v)] + [torch.from_numpy(kb).requires_grad_()]
    out = tflash(*leaves[:3], causal=causal, kv_bias=leaves[3],
                 kv_mask=None if mask is None else torch.from_numpy(mask))
    (out.float() ** 2).sum().backward()
    for name, t, w in zip(("q", "k", "v"), leaves, want):
        assert t.grad.dtype == tdt, name
        err, share = _bf16_agreement(t.grad.float(),
                                     np.asarray(w.astype(jnp.float32)))
        assert err <= rel and share >= DBIAS_SHARE[dtype], \
            ("d" + name, err, share)
    db, jdb = leaves[3].grad.numpy(), np.asarray(want[3])
    assert leaves[3].grad.dtype == torch.float32
    assert np.abs(db - jdb).max() <= DBIAS_BF16_TOL * np.abs(jdb).max()
    if masked:
        assert (leaves[3].grad[1][..., T - 40:] == 0).all()
        assert (jdb[1][..., T - 40:] == 0).all()


def test_plain_dbias_is_the_row_sum_of_the_unscaled_ds():
    """flash_attention_backward_reference(needs_dbias=True) returns the
    (BH, T) sum over query rows of P * (dP - delta), the cotangent of the
    (BH, T) bias: held against autograd through the plain forward."""
    rs = np.random.RandomState(7)
    BH, T, D = 3, 40, 32
    q, k, v, do = (torch.from_numpy(rs.randn(BH, T, D).astype(np.float32))
                   for _ in range(4))
    bias = torch.from_numpy(rs.randn(BH, T).astype(np.float32))
    bias[0, 30:] = -1e30
    scale = 1.0 / np.sqrt(D)
    b = bias.clone().requires_grad_()
    out, _ = fa.flash_attention_reference(q, k, v, b, scale, causal=True)
    out.backward(do)
    out, lse = fa.flash_attention_reference(q, k, v, bias, scale,
                                            causal=True)
    grads = fa.flash_attention_backward_reference(
        q, k, v, out, lse, do, bias, scale, causal=True, needs_dbias=True)
    assert len(grads) == 4 and grads[3].shape == (BH, T)
    np.testing.assert_allclose(grads[3].numpy(), b.grad.numpy(), rtol=1e-5,
                               atol=1e-6)
    assert (grads[3][0, 30:] == 0).all()
    assert len(fa.flash_attention_backward_reference(
        q, k, v, out, lse, do, bias, scale, causal=True)) == 3


def test_mask_only_backward_asks_for_no_dbias(monkeypatch):
    """A kv_mask alone (BERT's path) keeps the bias out of the graph: the
    backward is asked for no dbias, so on the card it launches the dK/dV
    kernel without it; a learned kv_bias asks for it."""
    asked = []
    real = fa.flash_attention_backward

    def spy(*a, **kw):
        asked.append(a[9] if len(a) > 9 else kw.get("needs_dbias", False))
        return real(*a, **kw)

    monkeypatch.setattr(fa, "flash_attention_backward", spy)
    q = torch.randn(2, 2, 16, 32, requires_grad=True)
    mask = torch.ones(2, 16)
    mask[1, 10:] = 0
    tflash(q, q, q, kv_mask=mask).sum().backward()
    kb = torch.zeros(2, 16, requires_grad=True)
    tflash(q, q, q, kv_mask=mask, kv_bias=kb).sum().backward()
    tflash(q, q, q, kv_mask=mask, kv_bias=kb.detach()).sum().backward()
    assert asked == [False, True, False]
    n0 = flash_attention_bwd_dkv_dbias.launches
    tflash(q, q, q, kv_bias=kb).sum().backward()
    assert flash_attention_bwd_dkv_dbias.launches == n0


# ------------------------------------------------------------- bf16, fp16
#: dtype name -> (torch dtype, jnp dtype, the tolerance's share of the max:
#: twice the dtype's half step)
HALF = {"bfloat16": (torch.bfloat16, jnp.bfloat16, 2.0 ** -8),
        "float16": (torch.float16, jnp.float16, 2.0 ** -11)}


def _half_case(B, H, T, D, case, seed, dtype=torch.bfloat16):
    """(q, k, v, g as float32 numpy rounded to ``dtype``, the (B, T) int32
    mask, causal) of test_torch_flash_attention.py's BF16_CASES."""
    rs = np.random.RandomState(seed)
    arrs = [torch.from_numpy(rs.randn(B, H, T, D).astype(np.float32))
            .to(dtype).float().numpy() for _ in range(4)]
    lens = {"ragged": [T, 77], "dead_row": [T - 5, 0],
            "causal": [T, T]}[case]
    mask = (np.arange(T)[None, :] < np.asarray(lens)[:, None]) \
        .astype(np.int32)
    return arrs, mask, case == "causal"


def _bf16_agreement(got, want):
    """(max |got - want| / max |want|, share of bitwise-equal elements)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return (float(np.abs(got - want).max() / np.abs(want).max()),
            float((got == want).mean()))


@pytest.mark.parametrize("dtype", sorted(HALF))
@pytest.mark.parametrize("T", [128, 256])
@pytest.mark.parametrize("case", ["causal", "dead_row", "ragged"])
def test_half_gradients_round_as_the_pallas_kernels_do(T, case, dtype):
    """bf16 or fp16 q, k, v and cotangent through the public API's autograd
    and through jax.vjp of the JAX flash attention in interpret mode: the
    JAX kernels round p and dS to the input dtype before their second
    products (_recompute_p_ds) and write dq, dk, dv in it; the plain
    version rounds at the same points. Each gradient within twice the
    dtype's half step (2**-8, 2**-11) of its largest magnitude, at least
    99 % of its elements bitwise equal, and a sample whose keys are all
    masked gets exact zeros."""
    tdt, jdt, rel = HALF[dtype]
    B, H, D = 2, 2, 64
    (q, k, v, g), mask, causal = _half_case(B, H, T, D, case, T + 1, tdt)
    jm = jnp.asarray(mask)
    _out, vjp = jax.vjp(lambda a, b, c: jflash(a, b, c, causal=causal,
                                               kv_mask=jm, interpret=True),
                        *(jnp.asarray(a, jdt) for a in (q, k, v)))
    want = vjp(jnp.asarray(g, jdt))
    leaves = [torch.from_numpy(a).to(tdt).requires_grad_()
              for a in (q, k, v)]
    out = tflash(*leaves, causal=causal,
                 kv_mask=torch.from_numpy(mask))
    out.backward(torch.from_numpy(g).to(tdt))
    dead = torch.from_numpy(mask.sum(1) == 0)
    for name, leaf, w in zip(("dq", "dk", "dv"), leaves, want):
        assert leaf.grad.dtype == tdt, name
        err, share = _bf16_agreement(leaf.grad.float(),
                                     np.asarray(w.astype(jnp.float32)))
        assert err <= rel and share >= 0.99, (name, err, share)
        assert (leaf.grad[dead] == 0).all(), name


def test_fp16_overflow_in_the_cotangent_reaches_every_gradient():
    """A cotangent scaled past fp16's range (a loss scale that overflows)
    makes dS inf where the plain version rounds it to fp16, as the JAX
    kernels' astype does: dq, dk and dv come out non-finite in both
    packages, never saturated to 65504. At a scale inside the range both
    stay finite."""
    B, H, T, D = 1, 2, 64, 32
    (q, k, v, g), mask, _causal = _half_case(B, H, T, D, "causal", 3,
                                             torch.float16)
    for scale, finite in ((2.0 ** 2, True), (2.0 ** 40, False)):
        gs = np.clip(g * scale, -6e4, 6e4)   # a finite fp16 cotangent
        if not finite:
            gs[0, 0, 5, :] = np.inf          # an overflowed row upstream
        _out, vjp = jax.vjp(lambda a, b, c: jflash(a, b, c, causal=True,
                                                   interpret=True),
                            *(jnp.asarray(a, jnp.float16)
                              for a in (q, k, v)))
        want = vjp(jnp.asarray(gs, jnp.float16))
        leaves = [torch.from_numpy(a).half().requires_grad_()
                  for a in (q, k, v)]
        tflash(*leaves, causal=True).backward(torch.from_numpy(gs).half())
        for name, leaf, w in zip(("dq", "dk", "dv"), leaves, want):
            got_ok = bool(torch.isfinite(leaf.grad).all())
            want_ok = bool(np.isfinite(np.asarray(w, np.float32)).all())
            assert got_ok == want_ok == finite, (name, scale, got_ok,
                                                 want_ok)
            assert not (leaf.grad.float().abs() == 65504.0).any(), name


# ------------------------------------------ the 16-bit dQ kernels' contract
_HALF_DQ = {torch.bfloat16: "flash_attention_bwd_dq_bf16",
            torch.float16: "flash_attention_bwd_dq_f16"}


def _dq_args(dtype, BH=2, T=16, D=64):
    """(q, k, v, do, out, lse, bias, scale, causal) on the CPU, the 16-bit
    dQ wrappers' arguments."""
    gen = torch.Generator().manual_seed(5)
    q, k, v, do, out = (torch.randn(BH, T, D, generator=gen).to(dtype)
                        for _ in range(5))
    return [q, k, v, do, out, torch.zeros(BH, T), None, 0.125, False]


@pytest.mark.parametrize("dtype", sorted(_HALF_DQ, key=str))
def test_half_dq_wrappers_take_out_and_refuse_as_the_checks_do(dtype):
    """The 16-bit dQ wrappers take (q, k, v, do, out, lse, bias, scale,
    causal), out where the fp32 one takes delta, and return (dq, delta).
    Before any kernel is reached they refuse what _check_bwd_cuda refuses,
    with its errors: mixed dtypes (TypeError), an out that is missing or
    not of q's dtype and shape (ValueError naming out), a do likewise, and
    tensors that do not lie on a CUDA card (ValueError: no CPU mode)."""
    fn = getattr(fa, _HALF_DQ[dtype])
    other = torch.float16 if dtype == torch.bfloat16 else torch.bfloat16
    n0 = fn.launches

    def refused(args):
        with pytest.raises((TypeError, ValueError)) as got:
            fn(*args)
        return got

    args = _dq_args(dtype)
    mixed = list(args)
    mixed[1] = mixed[1].to(other)
    got = refused(mixed)
    assert got.type is TypeError and "one dtype" in str(got.value)
    for i, name in ((4, "out"), (3, "do")):
        for bad in (None, args[i].to(other), args[i][:, :8]):
            wrong = list(args)
            wrong[i] = bad
            got = refused(wrong)
            assert got.type is ValueError
            assert "%s must be a contiguous" % name in str(got.value)
    got = refused(args)
    assert got.type is ValueError and "CUDA" in str(got.value)
    # the same inputs through the check itself give the same errors
    q, k, v, do, out, lse, bias = args[:7]
    with pytest.raises(ValueError, match="out must be a contiguous"):
        fa._check_bwd_cuda(q, k, v, do, lse, None, bias, dtype, None)
    with pytest.raises(ValueError, match="CUDA"):
        fa._check_bwd_cuda(q, k, v, do, lse, None, bias, dtype, out)
    assert fn.launches == n0


def test_fp32_backward_wrappers_refuse_cpu_tensors_before_the_library():
    """The fp32 dQ and dK/dV wrappers keep delta among their arguments and
    refuse CPU tensors with the same error, before any build is tried."""
    gen = torch.Generator().manual_seed(6)
    q = torch.randn(2, 16, 64, generator=gen)
    lse = torch.zeros(2, 16)
    for fn in (flash_attention_bwd_dq, flash_attention_bwd_dkv,
               flash_attention_bwd_dkv_dbias):
        with pytest.raises(ValueError, match="CUDA"):
            fn(q, q, q, q, lse, lse, None, 0.125, False)


@pytest.mark.parametrize("bias", [None, "bias"])
@pytest.mark.parametrize("causal", [False, True])
def test_backward_cost_counts_the_dq_kernels_out_and_delta(bias, causal):
    """_backward_cost's bytes for the 16-bit dQ kernels (reads_out): q, k,
    v, do and the forward's out read and dq written (six (BH, T, D) 16-bit
    tensors), lse read and delta written (two (BH, T) fp32 rows, the same
    two the fp32 dQ kernel reads), the bias read where there is one; the
    operations those of three T x T x D products, halved under a causal
    mask. dK/dV's count is unchanged."""
    BH, T, D = 96, 512, 64
    b = None if bias is None else torch.zeros(BH, T)
    flops, nbytes = fa._backward_cost(BH, T, D, b, causal, 3, 1, 2,
                                      reads_out=True)
    rows = 2 + (bias is not None)
    assert nbytes == 6 * BH * T * D * 2 + rows * BH * T * 4
    assert flops == 2.0 * 3 * BH * T * T * D / (2 if causal else 1)
    old = fa._backward_cost(BH, T, D, b, causal, 3, 1, 2)
    assert nbytes - old[1] == BH * T * D * 2 and flops == old[0]
    dkv = fa._backward_cost(BH, T, D, b, causal, 4, 2, 2, True)
    assert dkv[1] == 6 * BH * T * D * 2 + (rows + 1) * BH * T * 4
