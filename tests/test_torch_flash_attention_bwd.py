"""The PyTorch port's flash-attention gradients against the JAX package's.

On the CPU the port's autograd Function takes the plain backward (P
recomputed from the forward's lse, as the TPU kernels do); the JAX side
differentiates its Pallas flash attention in interpret mode, as
tests/test_pallas.py does, which runs the _dq_kernel and _dkv_kernel through
the custom VJP. Same numpy inputs from a seed, tolerance rtol = atol = 1e-5
(fp32 both sides, another summation order). The CUDA kernels are held
against the plain backward on a card in tests/test_torch_kernels_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from incubator_mxnet_tpu.ops.pallas import flash_attention as jflash
from incubator_mxnet_tpu_torch.ops.kernels import flash_attention as tflash
from incubator_mxnet_tpu_torch.ops.kernels.flash_attention import (
    flash_attention_bwd_dkv, flash_attention_bwd_dq)

RTOL = ATOL = 1e-5


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
    """The TPU kernel's has_dbias path is not ported: a kv_bias that needs a
    gradient is refused, while a constant one is taken."""
    q = torch.randn(1, 2, 16, 32, requires_grad=True)
    kb = torch.randn(1, 16, requires_grad=True)
    with pytest.raises(NotImplementedError, match="kv_bias"):
        tflash(q, q, q, kv_bias=kb)
    for dev in ("meta",):
        with pytest.raises(NotImplementedError, match="kv_bias"):
            tflash(q.to(dev), q.to(dev), q.to(dev), kv_bias=kb.to(dev))
    out = tflash(q, q, q, kv_bias=kb.detach())
    out.sum().backward()
    assert q.grad is not None and kb.grad is None


def test_cpu_backward_does_not_launch():
    n0 = (flash_attention_bwd_dq.launches, flash_attention_bwd_dkv.launches)
    q = torch.randn(1, 2, 16, 32, requires_grad=True)
    tflash(q, q, q, causal=True).sum().backward()
    assert (flash_attention_bwd_dq.launches,
            flash_attention_bwd_dkv.launches) == n0
