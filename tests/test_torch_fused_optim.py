"""The PyTorch port's trainer Adam / AdamW update against the JAX package's.

The JAX side runs ``multi_trainer_adam`` with ``interpret=True``, which runs
the Pallas ``_trainer_adam_kernel`` over the packed buffer; the port's
wrapper takes its plain per-tensor version on the CPU. Same numpy inputs
from a seed; w, m, v within rtol 1e-6, atol 1e-9 (each is a handful of
correctly rounded f32 operations on both sides, and the f32 ``b**t`` of two
libraries may differ in its last bit). The CUDA kernel is held bitwise
against the plain version on a card in tests/test_torch_kernels_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from incubator_mxnet_tpu.ops.pallas import fused_optim as jfo
from incubator_mxnet_tpu_torch.ops.kernels import WRAPPERS
from incubator_mxnet_tpu_torch.ops.kernels import fused_optim as tfo

SIZES = [1, 3, 5, 127, 1000, 4097]
HP = dict(lr=1e-3, wd=0.01, b1=0.9, b2=0.999, eps=1e-8)


def _state(seed, sizes=SIZES):
    rs = np.random.RandomState(seed)
    ws = [rs.randn(n).astype(np.float32) for n in sizes]
    gs = [(rs.randn(n) * 1e-2).astype(np.float32) for n in sizes]
    ms = [(rs.randn(n) * 1e-3).astype(np.float32) for n in sizes]
    vs = [np.abs(rs.randn(n) * 1e-5).astype(np.float32) for n in sizes]
    return ws, gs, ms, vs


def _torch(group):
    return [torch.from_numpy(a.copy()) for a in group]


@pytest.mark.parametrize("adamw", [False, True], ids=["adam", "adamw"])
@pytest.mark.parametrize("t", [1, 7])
def test_plain_update_matches_pallas_interpret(adamw, t):
    ws, gs, ms, vs = _state(t + 10 * adamw)
    want = jfo.multi_trainer_adam(
        [jnp.asarray(a) for a in ws], [jnp.asarray(a) for a in gs],
        [jnp.asarray(a) for a in ms], [jnp.asarray(a) for a in vs],
        t=t, adamw=adamw, interpret=True, **HP)
    tw, tg, tm, tv = (_torch(g) for g in (ws, gs, ms, vs))
    got = tfo.multi_trainer_adam(tw, tg, tm, tv, t=t, adamw=adamw, **HP)
    for what, g_list, w_list in zip("wmv", got, want):
        for i, (a, b) in enumerate(zip(g_list, w_list)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-9,
                                       err_msg="%s[%d] t=%d" % (what, i, t))


def test_update_is_in_place_and_leaves_gradients_alone():
    ws, gs, ms, vs = (_torch(g) for g in _state(3))
    before = [[x.clone() for x in grp] for grp in (ws, gs, ms, vs)]
    ids = [id(x) for x in ws + ms + vs]
    out = tfo.multi_trainer_adam(ws, gs, ms, vs, t=1, adamw=True, **HP)
    assert [id(x) for x in out[0] + out[1] + out[2]] == ids
    assert all(torch.equal(a, b) for a, b in zip(gs, before[1]))
    for now, then in zip((ws, ms, vs), (before[0], before[2], before[3])):
        assert not any(torch.equal(a, b) for a, b in zip(now, then))


def test_bf16_stored_state_lifted_and_rounded_as_in_jax():
    """ShardedTrainer's bf16 moments: lifted to fp32 for the update and
    rounded back, as the JAX package's _apply_fused does around the kernel.
    Both sides round the same f32 values, so the bf16 moments agree to one
    bf16 step where the f32 values straddle a rounding boundary."""
    ws, gs, ms, vs = _state(5)
    ms = [m.astype(jnp.bfloat16) for m in (jnp.asarray(a) for a in ms)]
    vs = [v.astype(jnp.bfloat16) for v in (jnp.asarray(a) for a in vs)]
    nw, nm, nv = jfo.multi_trainer_adam(
        [jnp.asarray(a) for a in ws], [jnp.asarray(a) for a in gs],
        [m.astype(jnp.float32) for m in ms],
        [v.astype(jnp.float32) for v in vs], t=2, adamw=True,
        interpret=True, **HP)
    tw, tg = _torch(ws), _torch(gs)
    tm = [torch.from_numpy(np.array(m.astype(jnp.float32)))
          .to(torch.bfloat16) for m in ms]
    tv = [torch.from_numpy(np.array(v.astype(jnp.float32)))
          .to(torch.bfloat16) for v in vs]
    m32, v32 = [m.float() for m in tm], [v.float() for v in tv]
    tfo.multi_trainer_adam(tw, tg, m32, v32, t=2, adamw=True, **HP)
    for dst, src in zip(tm + tv, m32 + v32):
        dst.copy_(src)
    for a, b in zip(tw, nw):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-9)
    for a, b in zip(tm + tv, nm + nv):
        want = np.asarray(b.astype(jnp.bfloat16).astype(jnp.float32))
        np.testing.assert_allclose(a.float().numpy(), want, rtol=2 ** -8,
                                   atol=0)


def test_cpu_update_does_not_launch_and_is_registered():
    assert WRAPPERS["trainer_adam"] is tfo.multi_trainer_adam
    n0 = tfo.multi_trainer_adam.launches
    ws, gs, ms, vs = (_torch(g) for g in _state(4))
    tfo.multi_trainer_adam(ws, gs, ms, vs, t=3, **HP)
    assert tfo.multi_trainer_adam.launches == n0


def test_scalars_round_as_the_tpu_kernel_does():
    """lr*wd is rounded once from f64; 1 - b and 1 - b**t are f32
    arithmetic on the f32 betas, as in _trainer_adam_kernel."""
    sc = tfo.adam_scalars(3e-4, 0.05, 0.9, 0.999, 1e-8, 10)
    f = np.float32
    assert sc["lrwd"] == f(3e-4 * 0.05)
    assert sc["one_minus_b1"] == f(1) - f(0.9)
    assert sc["bias2"] == f(1) - f(0.999) ** f(10)
    assert all(isinstance(v, np.float32) for v in sc.values())


def test_mismatched_lists_raise_and_empty_lists_pass():
    w = [torch.zeros(3)]
    with pytest.raises(ValueError, match="weights"):
        tfo.multi_trainer_adam(w, [], w, w, t=1, **HP)
    assert tfo.multi_trainer_adam([], [], [], [], t=1, **HP) == ([], [], [])
