"""The PyTorch port's paged flash decode against the JAX package.

On the CPU the port takes its plain version (the gathered table, the lengths
mask, dead-row zeroing); the JAX side runs its lax oracle and, at C = 1, the
Pallas decode kernel in interpret mode, as tests/test_generate.py does. Same
numpy inputs from a seed. Tolerances: fp32 atol 1e-5 on o and m and rtol
1e-5 on l (another summation order); bf16 on the plain path atol 3e-2 on o,
as the JAX package holds its own bf16 kernel. The CUDA kernel is held
against the plain version on a card in tests/test_torch_kernels_cuda.py.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from incubator_mxnet_tpu.ops.pallas import flash_decode as jfd
from incubator_mxnet_tpu_torch.ops.kernels import flash_decode as tfd

ATOL = 1e-5
RTOL_L = 1e-5

# jitted once per shape: the lax oracle op by op compiles every primitive
_jax_lax = jax.jit(functools.partial(jfd.paged_flash_decode,
                                     use_kernel=False))
_jax_kernel = jax.jit(functools.partial(jfd.paged_flash_decode,
                                        use_kernel=True, interpret=True))
_jax_causal = jax.jit(functools.partial(jfd.paged_causal_attention,
                                        use_kernel=False))


def _inputs(seed, S, C, H, D, bs, mb, lengths=None):
    """q, pools and a shuffled disjoint table per sequence; one dead row."""
    rs = np.random.RandomState(seed)
    if lengths is None:
        lengths = rs.randint(0, bs * mb + 1, S)
        lengths[0] = 0
    q = rs.randn(S, C, H, D).astype(np.float32)
    kp = rs.randn(S * mb, bs, H, D).astype(np.float32)
    vp = rs.randn(S * mb, bs, H, D).astype(np.float32)
    tables = rs.permutation(S * mb).reshape(S, mb).astype(np.int32)
    return q, kp, vp, tables, np.asarray(lengths, np.int32)


def _port(q, kp, vp, tables, lengths, dtype=torch.float32):
    return tfd.paged_flash_decode(
        torch.from_numpy(q).to(dtype), torch.from_numpy(kp).to(dtype),
        torch.from_numpy(vp).to(dtype), torch.from_numpy(tables),
        torch.from_numpy(lengths))


def _close(port, jax_out, atol=ATOL, rtol_l=RTOL_L):
    o, m, l = (t.float().numpy() for t in port)
    jo, jm, jl = (np.asarray(a, np.float32) for a in jax_out)
    np.testing.assert_allclose(o, jo, atol=atol, rtol=0)
    np.testing.assert_allclose(m, jm, atol=atol, rtol=0)
    np.testing.assert_allclose(l, jl, rtol=rtol_l, atol=1e-6)


@pytest.mark.parametrize("seed,S,C,H,D,bs,mb", [
    (0, 3, 1, 2, 8, 4, 4), (1, 1, 1, 1, 16, 8, 2), (2, 4, 3, 3, 8, 16, 3),
    (3, 2, 8, 2, 64, 16, 4), (4, 5, 32, 2, 32, 16, 3)])
def test_flash_decode_matches_jax_lax(seed, S, C, H, D, bs, mb):
    q, kp, vp, tables, lengths = _inputs(seed, S, C, H, D, bs, mb)
    got = _port(q, kp, vp, tables, lengths)
    want = _jax_lax(q, kp, vp, tables, lengths)
    _close(got, want)
    o, m, l = got
    assert (o[0] == 0).all() and (l[0] == 0).all()      # dead row, exact
    assert (m[0] == np.float32(-1e30)).all()


@pytest.mark.parametrize("seed,S,H,D,bs,mb", [
    (5, 2, 2, 8, 8, 2), (6, 3, 1, 16, 4, 4), (7, 4, 2, 64, 16, 3)])
def test_flash_decode_matches_jax_pallas_interpret(seed, S, H, D, bs, mb):
    """At C = 1 against the TPU kernel itself, in interpret mode; lengths
    cover a dead row, a block boundary and a full table."""
    lengths = [0, bs, bs * mb, 1][:S]
    q, kp, vp, tables, lengths = _inputs(seed, S, 1, H, D, bs, mb, lengths)
    got = _port(q, kp, vp, tables, lengths)
    want = _jax_kernel(q, kp, vp, tables, lengths)
    _close(got, want)


def test_flash_decode_bf16_on_the_plain_path():
    q, kp, vp, tables, lengths = _inputs(8, 2, 1, 2, 8, 8, 2)
    got = _port(q, kp, vp, tables, lengths, dtype=torch.bfloat16)
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == torch.float32
    bf = [jnp.asarray(a, jnp.bfloat16) for a in (q, kp, vp)]
    want = _jax_lax(*bf, tables, lengths)
    _close(got, want, atol=3e-2, rtol_l=2e-2)


@pytest.mark.parametrize("C", [1, 4, 8])
@pytest.mark.parametrize("past", [0, 5, 11])
def test_paged_causal_attention_matches_jax(C, past):
    S, H, D, bs, mb = 2, 2, 8, 4, 4
    q, kp, vp, tables, lengths = _inputs(10 * C + past, S, C, H, D, bs, mb,
                                         [past] * S)
    rs = np.random.RandomState(C + past)
    k_new = rs.randn(S, C, H, D).astype(np.float32)
    v_new = rs.randn(S, C, H, D).astype(np.float32)
    got = tfd.paged_causal_attention(
        *(torch.from_numpy(a) for a in (q, k_new, v_new, kp, vp, tables,
                                        lengths)))
    want = _jax_causal(q, k_new, v_new, kp, vp, tables, lengths)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=ATOL)


def test_flash_decode_wrapper_counts_only_kernel_launches():
    """On the CPU the wrapper takes the plain version and counts nothing."""
    q, kp, vp, tables, lengths = _inputs(9, 2, 1, 2, 8, 4, 2)
    n0 = tfd.paged_flash_decode.launches
    _port(q, kp, vp, tables, lengths)
    assert tfd.paged_flash_decode.launches == n0
    with pytest.raises(ValueError, match="unsupported device"):
        tfd.paged_flash_decode(torch.zeros(1, 1, 1, 32, device="meta"),
                               None, None, None, None)
