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
"""

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


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("D", [32, 64])
@pytest.mark.parametrize("T", [64, 128, 256])
def test_flash_gradients_match_pallas_interpret(T, D, causal):
    """dq, dk, dv of sum(out * g) with a kv_mask whose first sample has no
    live key (its gradients are exact zeros on both sides) and whose second
    is ragged."""
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
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = tflash(*leaves, causal=causal, kv_mask=torch.from_numpy(mask))
    out.backward(torch.from_numpy(g))
    for name, t, w in zip("qkv", leaves, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL, err_msg="d" + name)
        assert (t.grad[0] == 0).all() and (np.asarray(w)[0] == 0).all()


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
    # (bias shape, causal, masked): tests/test_pallas.py's two, and a mask
    "bht": ((2, 2, 128), False, False),
    "bt_causal": ((2, 128), True, False),
    "bht_masked": ((2, 2, 128), False, True),
}


@pytest.mark.parametrize("case", sorted(DBIAS_CASES))
def test_learned_kv_bias_gradients_match_pallas_interpret(case):
    """Gradients of sum(out ** 2) in q, k, v and a learned kv_bias through
    the port's autograd Function (the plain backward with dbias on the
    CPU) against jax.grad through the JAX package's flash_attention in
    interpret mode (its _dkv_kernel with has_dbias). B 2, H 2, T 128,
    D 32; with the mask, sample 1's last 40 keys are padding and their bias
    gradient is exactly 0 on both sides."""
    shape, causal, masked = DBIAS_CASES[case]
    B, H, T, D = 2, 2, 128, 32
    rs = np.random.RandomState(60 + len(shape) + causal + 2 * masked)
    q, k, v = (rs.randn(B, H, T, D).astype(np.float32) for _ in range(3))
    kb = rs.randn(*shape).astype(np.float32)
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
