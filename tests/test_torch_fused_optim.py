"""The PyTorch port's fused optimizer updates against the JAX package's:
the trainer Adam / AdamW and SGD-momentum kernels, and the eager gluon
seam's flat SGD-momentum, Adam and AdamW.

The JAX side runs ``multi_trainer_adam`` with ``interpret=True``, which runs
the Pallas ``_trainer_adam_kernel`` over the packed buffer; the port's
wrapper takes its plain per-tensor version on the CPU. Same numpy inputs
from a seed; w, m, v within rtol 1e-6, atol 1e-9 (each is a handful of
correctly rounded f32 operations on both sides, and the f32 ``b**t`` of two
libraries may differ in its last bit). The CUDA kernel is held bitwise
against the plain version on a card in tests/test_torch_kernels_cuda.py.

The eager seam: the port's plain flat rules against the JAX package's
``_multi_*_update(..., interpret=True)``, which runs the Pallas
``_sgd_mom_kernel`` / ``_adam_kernel`` / ``_adamw_kernel`` over the packed
buffer on the CPU, with rescale 1/32 and the clip on and off, within
rtol 1e-6 and atol 1e-9: XLA on the CPU contracts a product and the sum
after it into one FMA where the port rounds each on its own, and Adam's
``coef`` and AdamW's ``1 - b**t`` come from torch's f32 ``pow`` on the host
in the port and from XLA's in the JAX package, which may differ in the
last bit.

bf16 and fp16: the port's per-parameter rules and ``_multi_*_update`` seam
on 16-bit tensors against the JAX package's rules (jitted, Python-float
scalars) and its seam in interpret mode. In bf16, bitwise: both round every
scalar to bf16 before it meets a tensor and every operation's f32 result to
bf16, so nothing is left to differ; the fp32 pins above are unchanged. In
fp16 the port rounds each operation on its own, as the JAX source and the
CUDA kernel do, while XLA on a CPU with native fp16 arithmetic contracts a
product into the add after it (one fp16 FMA, rounded once): the port is
held within 2 fp16 steps of the largest magnitude among each element's
inputs and outputs (w, g * rescale, the states, both results), with inf
and NaN at the same places (ROADMAP Queue 3 item 14).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from incubator_mxnet_tpu.ops import _optim_kernels as jseam
from incubator_mxnet_tpu.ops.pallas import fused_optim as jfo
from incubator_mxnet_tpu_torch.ops import _optim_kernels as tseam
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


SGD_HP = dict(lr=0.1, wd=1e-4, momentum=0.9)


@pytest.mark.parametrize("wd", [0.0, 1e-4])
def test_sgd_mom_plain_update_matches_pallas_interpret(wd):
    """multi_trainer_sgd_mom: the plain version against the JAX package's
    _sgd_mom_kernel in interpret mode (rescale 1, clip off), three steps
    from non-zero momenta, within rtol 1e-6 and atol 1e-9. Not bitwise: on
    the CPU, XLA contracts ``momentum * mom - lr * (...)`` into one FMA,
    where the port (and its CUDA kernel) rounds the product on its own, so
    a momentum where the two terms nearly cancel differs by about one ulp of
    ``momentum * mom`` (~1e-10 at these magnitudes)."""
    ws, gs, ms, _ = _state(20 + int(wd > 0))
    hp = dict(SGD_HP, wd=wd)
    jw, jm = [jnp.asarray(a) for a in ws], [jnp.asarray(a) for a in ms]
    tw, tm = _torch(ws), _torch(ms)
    for step in range(3):
        g = [a * (step + 1) for a in gs]
        jw, jm = jfo.multi_trainer_sgd_mom(jw, [jnp.asarray(a) for a in g],
                                           jm, interpret=True, **hp)
        out = tfo.multi_trainer_sgd_mom(tw, _torch(g), tm, **hp)
        assert out[0] is not tw and [id(t) for t in out[0]] \
            == [id(t) for t in tw]
    for what, got, want in (("w", tw, jw), ("mom", tm, jm)):
        for i, (a, b) in enumerate(zip(got, want)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-9, err_msg="%s[%d]" % (what, i))


def test_sgd_mom_scalars_are_f32_and_cpu_update_does_not_launch():
    assert WRAPPERS["trainer_sgd_mom"] is tfo.multi_trainer_sgd_mom
    sc = tfo.sgd_mom_scalars(0.1, 1e-4, 0.9)
    assert sc == dict(lr=np.float32(0.1), wd=np.float32(1e-4),
                      momentum=np.float32(0.9))
    n0 = tfo.multi_trainer_sgd_mom.launches
    ws, gs, ms, _ = (_torch(g) for g in _state(6))
    gs0 = [g.clone() for g in gs]
    tfo.multi_trainer_sgd_mom(ws, gs, ms, **SGD_HP)
    assert tfo.multi_trainer_sgd_mom.launches == n0
    assert all(torch.equal(a, b) for a, b in zip(gs, gs0))
    with pytest.raises(ValueError, match="momenta"):
        tfo.multi_trainer_sgd_mom(ws, gs, ms[:1], **SGD_HP)
    assert tfo.multi_trainer_sgd_mom([], [], [], **SGD_HP) == ([], [])


FLAT = {
    "sgd_mom": (dict(lr=0.1, wd=1e-4, momentum=0.9), 1),
    "adam": (dict(lr=1e-3, wd=1e-4, b1=0.9, b2=0.999, eps=1e-8, t=3), 2),
    "adamw": (dict(lr=1e-3, wd=1e-2, eta=0.5, b1=0.9, b2=0.999, eps=1e-8,
                   t=3), 2),
}


@pytest.mark.parametrize("flavour", sorted(FLAT))
@pytest.mark.parametrize("clip", [-1.0, 0.2], ids=["noclip", "clip"])
def test_flat_plain_rules_match_the_jax_seam_interpret(flavour, clip):
    hp, n_states = FLAT[flavour]
    ws, gs, ms, vs = _state(30 + n_states)
    gs = [g * 500 for g in gs]          # O(1) after 1/32: the clip engages
    groups = [ws, gs, ms] + ([vs] if n_states == 2 else [])
    jout = getattr(jseam, "_multi_%s_update" % flavour)(
        *[[jnp.asarray(a) for a in g] for g in groups], rescale=1.0 / 32,
        clip=clip, interpret=True, **hp)
    tgroups = [_torch(g) for g in groups]
    tout = getattr(tseam, "_multi_%s_update" % flavour)(
        *tgroups, rescale=1.0 / 32, clip=clip, **hp)
    assert [id(t) for t in tout[0]] == [id(t) for t in tgroups[0]]
    for what, got, want in zip("wmv", tout, jout):
        for i, (a, b) in enumerate(zip(got, want)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-9,
                                       err_msg="%s %s[%d]" % (flavour, what,
                                                              i))


def test_flat_wrappers_count_no_cpu_launch_and_refuse_bf16():
    """The flat wrappers, fp32, bf16 and fp16, are registered and launch
    nothing on the CPU; a call that mixes bf16 with fp32 is refused, and
    each 16-bit wrapper takes its own dtype only."""
    for name in ("sgd_mom_flat", "adam_flat", "adamw_flat"):
        assert WRAPPERS[name] is getattr(tfo, "fused_" + name)
        for suffix in ("_bf16", "_f16"):
            assert WRAPPERS[name + suffix] is getattr(
                tfo, "fused_%s%s" % (name, suffix))
            assert WRAPPERS[name + suffix].__name__ == "fused_%s%s" % (
                name, suffix)
    n0 = tfo.fused_adam_flat.launches
    ws, gs, ms, vs = (_torch(g) for g in _state(8))
    tfo.fused_adam_flat(ws, gs, ms, vs, rescale=1.0, clip=-1.0,
                        **FLAT["adam"][0])
    assert tfo.fused_adam_flat.launches == n0
    n0 = tfo.fused_adam_flat_bf16.launches
    bws, bgs, bms, bvs = ([t.bfloat16() for t in g] for g in (ws, gs, ms, vs))
    tfo.fused_adam_flat_bf16(bws, bgs, bms, bvs, rescale=1.0, clip=-1.0,
                             **FLAT["adam"][0])
    assert tfo.fused_adam_flat_bf16.launches == n0
    w = [torch.zeros(3, dtype=torch.bfloat16)]
    with pytest.raises(ValueError, match="mix"):
        tfo.fused_sgd_mom_flat(w, [torch.zeros(3)], w, rescale=1.0,
                               clip=-1.0, **FLAT["sgd_mom"][0])
    with pytest.raises(TypeError, match="bfloat16"):
        tfo.fused_sgd_mom_flat_bf16(ws[:1], gs[:1], ms[:1], rescale=1.0,
                                    clip=-1.0, **FLAT["sgd_mom"][0])
    hws, hgs, hms, hvs = ([t.half() for t in g] for g in (ws, gs, ms, vs))
    n0 = tfo.fused_adam_flat_f16.launches
    tfo.fused_adam_flat_f16(hws, hgs, hms, hvs, rescale=1.0, clip=-1.0,
                            **FLAT["adam"][0])
    assert tfo.fused_adam_flat_f16.launches == n0
    with pytest.raises(TypeError, match="float16"):
        tfo.fused_adamw_flat_f16(bws, bgs, bms, bvs, rescale=1.0, clip=-1.0,
                                 **FLAT["adamw"][0])
    with pytest.raises(ValueError, match="1 w, 2 g"):
        tfo.fused_sgd_mom_flat(ws[:1], gs[:2], ms[:1], rescale=1.0,
                               clip=-1.0, **FLAT["sgd_mom"][0])


def test_clip_lets_a_nan_gradient_through():
    w, m = torch.ones(3), torch.zeros(3)
    g = torch.tensor([float("nan"), 5.0, -5.0])
    tfo.fused_sgd_mom_flat([w], [g], [m], 0.1, 0.0, 0.9, 1.0, 1.0)
    assert torch.isnan(w[0]) and torch.isnan(m[0])
    assert torch.equal(m[1:], torch.tensor([-0.1, 0.1]))


# ----------------------------------------------------------- bf16 and fp16
BF16_SHAPES = [(3, 5), (7,), (2, 2, 4), (1,)]   # tests/test_fused_optim.py
HALF = {"bfloat16": jnp.bfloat16, "float16": jnp.float16}
RULE_HP = dict(lr=0.1, wd=1e-4, rescale=1.0 / 32)
RULES = {
    "sgd": (dict(RULE_HP), 0),
    "sgd_mom": (dict(RULE_HP, momentum=0.9), 1),
    "nag": (dict(RULE_HP, momentum=0.9), 1),
    "adam": (dict(RULE_HP, b1=0.9, b2=0.999, eps=1e-8, t=3), 2),
    "adamw": (dict(RULE_HP, eta=0.5, b1=0.9, b2=0.999, eps=1e-8, t=3), 2),
}
#: fp16 against the JAX rules: steps of the largest magnitude an element
#: may lie apart (sgd_mom's w read 2.0 at most, the rest 1.0 or less)
FP16_STEPS = 2


def _half_state(seed, shapes, dtype="bfloat16", g_scale=1.0):
    """w, g (times g_scale), m (randn) and v (|randn|) cast to ``dtype`` as
    JAX arrays."""
    rs = np.random.RandomState(seed)
    groups = [[rs.randn(*s) for s in shapes] for _ in range(3)]
    groups[1] = [a * g_scale for a in groups[1]]
    groups.append([np.abs(rs.randn(*s)) for s in shapes])
    return [[jnp.asarray(a.astype(np.float32), HALF[dtype]) for a in g]
            for g in groups]


def _t(jarrays):
    dtype = getattr(torch, str(jarrays[0].dtype))
    return [torch.from_numpy(np.asarray(a.astype(jnp.float32)).copy())
            .to(dtype) for a in jarrays]


def _f64(a):
    a = a.double().numpy() if isinstance(a, torch.Tensor) else a
    return np.asarray(jnp.asarray(a).astype(jnp.float32), np.float64)


def _fp16_steps(got, want, inputs):
    """(largest gap in fp16 steps of each element's largest magnitude among
    ``inputs``, ``got`` and ``want``, over the elements where both are
    finite; whether inf and NaN lie at the same places)."""
    a, b = _f64(got), _f64(want)
    same = (np.array_equal(np.isnan(a), np.isnan(b))
            and np.array_equal(np.where(np.isinf(a), a, 0),
                               np.where(np.isinf(b), b, 0)))
    mag = np.maximum(np.abs(a), np.abs(b))
    for x in inputs:
        mag = np.maximum(mag, np.abs(x))
    fin = np.isfinite(a) & np.isfinite(b) & np.isfinite(mag)
    step = np.exp2(np.floor(np.log2(np.maximum(mag[fin], 2.0 ** -14))) - 10)
    gap = np.abs(a[fin] - b[fin]) / step
    return (float(gap.max()) if gap.size else 0.0), same


def _assert_rule(got, want, inputs, what):
    """bf16: bitwise; fp16: within FP16_STEPS of the largest magnitude
    among the element's ``inputs`` and every output of either side (see
    the module docstring)."""
    if got[0].dtype == torch.float16:
        inputs = list(inputs) + [_f64(x) for x in list(got) + list(want)]
        inputs = [np.where(np.isfinite(x), x, 0) for x in inputs]
    for i, (a, b) in enumerate(zip(got, want)):
        assert str(a.dtype)[6:] == str(b.dtype), what
        if a.dtype == torch.bfloat16:
            np.testing.assert_array_equal(a.float().numpy(), _f64(b),
                                          err_msg="%s[%d]" % (what, i))
        else:
            gap, same = _fp16_steps(a, b, inputs)
            assert same and gap <= FP16_STEPS, ("%s[%d]" % (what, i), gap,
                                                same)


def _rule_inputs(jargs, rescale):
    """w, g * rescale and the states (the per-element magnitudes)."""
    out = [_f64(a) for a in jargs]
    out[1] = out[1] * rescale
    return out


@pytest.mark.parametrize("dtype", sorted(HALF))
@pytest.mark.parametrize("clip", [-1.0, 2.0], ids=["noclip", "clip"])
@pytest.mark.parametrize("rule", sorted(RULES))
@pytest.mark.parametrize("shapes", [BF16_SHAPES, [(200000,)]],
                         ids=["seam_shapes", "200k"])
def test_half_rules_match_the_jax_rules(rule, clip, shapes, dtype):
    """Each per-parameter rule on bf16 or fp16 tensors, tensor by tensor,
    against the JAX rule called as the seam's tests call it (Python
    floats): the weight and every state bitwise in bf16, within FP16_STEPS
    in fp16. The 200,000-element vector is the input on which the port once
    differed in bf16 (ROADMAP Queue 3 item 4)."""
    hp, n_states = RULES[rule]
    jw, jg, jm, jv = _half_state(40 + n_states, shapes, dtype)
    jrule = getattr(jseam, "_%s_update" % rule)
    trule = getattr(tseam, "_%s_update" % rule)
    states = [jm, jv][:n_states]
    for i in range(len(shapes)):
        jargs = [jw[i], jg[i]] + [s[i] for s in states]
        targs = _t(jargs)
        want = jrule(*jargs, clip=clip, **hp)
        want = want if isinstance(want, tuple) else (want,)
        got = trule(*targs, clip=clip, **hp)
        got = got if isinstance(got, tuple) else (got,)
        assert got[0] is targs[0]
        _assert_rule(got, want, _rule_inputs(jargs, hp["rescale"]),
                     "%s[%d]" % (rule, i))


#: the inputs on which the fp16 rules were found to differ (ROADMAP Queue 3
#: item 14): one tensor of 3,000 elements from RandomState(0), w randn,
#: g randn * 300, m randn, v |randn|, cast to fp16
FAULT_E_HP = {
    "sgd": dict(lr=0.1, wd=1e-4, rescale=1.0 / 32),
    "sgd_mom": dict(lr=0.1, wd=1e-4, momentum=0.9, rescale=1.0 / 32),
    "nag": dict(lr=0.1, wd=1e-4, momentum=0.9, rescale=1.0 / 32),
    "adam": dict(lr=1e-3, wd=1e-4, b1=0.9, b2=0.999, eps=1e-8, t=3,
                 rescale=1.0 / 32),
    "adamw": dict(lr=1e-3, wd=1e-4, eta=0.5, b1=0.9, b2=0.999, eps=1e-8,
                  t=3, rescale=1.0 / 32),
}


@pytest.mark.parametrize("clip", [-1.0, 2.0], ids=["noclip", "clip"])
@pytest.mark.parametrize("rule", sorted(FAULT_E_HP))
def test_fp16_rules_hold_to_the_jax_rules_on_the_fault_e_inputs(rule, clip):
    """The probe's inputs: |g * rescale| reaches ~40, so that every product
    is large against the sum it enters and the JAX rules' contraction shows
    (hundreds of elements apart in sgd_mom's w and mom, Adam's m and v); the
    port stays within FP16_STEPS of them, inf and NaN at the same places."""
    hp = FAULT_E_HP[rule]
    n_states = RULES[rule][1]
    rs = np.random.RandomState(0)
    n = 3000
    w, g, m = rs.randn(n), rs.randn(n) * 300, rs.randn(n)
    v = np.abs(rs.randn(n))
    jargs = [jnp.asarray(a.astype(np.float16)) for a in [w, g, m, v]]
    jargs = jargs[:2 + n_states]
    want = getattr(jseam, "_%s_update" % rule)(*jargs, clip=clip, **hp)
    want = want if isinstance(want, tuple) else (want,)
    got = getattr(tseam, "_%s_update" % rule)(*_t(jargs), clip=clip, **hp)
    got = got if isinstance(got, tuple) else (got,)
    _assert_rule(got, want, _rule_inputs(jargs, hp["rescale"]), rule)


@pytest.mark.parametrize("rule", ["adam", "adamw"])
def test_fp16_eps_rounds_to_zero_and_v_zero_gives_the_jax_nan_and_inf(rule):
    """eps = 1e-8 is 0 in fp16: where v is 0 after the step, Adam and AdamW
    divide by sqrt(0) + 0, so m = 0 gives NaN and m != 0 gives +-inf in w,
    at the same places as in the JAX rules; the other elements within
    FP16_STEPS."""
    hp = dict(FAULT_E_HP[rule], rescale=1.0)
    z = [0.0] * 4
    w = np.array(z + [1.0, -1.0, 0.5, 2.0] + [0.3, -0.7], np.float16)
    g = np.array(z + [0.0, 0.0, 0.0, 0.0] + [0.5, -0.25], np.float16)
    m = np.array(z + [1.0, -1.0, 0.25, -2.0] + [0.1, 0.2], np.float16)
    v = np.array(z + [0.0] * 4 + [0.01, 0.02], np.float16)
    jargs = [jnp.asarray(a) for a in (w, g, m, v)]
    want = getattr(jseam, "_%s_update" % rule)(*jargs, clip=-1.0, **hp)
    got = getattr(tseam, "_%s_update" % rule)(*_t(jargs), clip=-1.0, **hp)
    w_got = got[0].double().numpy()
    assert np.isnan(w_got[:4]).all()
    assert np.isinf(w_got[4:8]).all() and np.isfinite(w_got[8:]).all()
    _assert_rule(got, want, _rule_inputs(jargs, 1.0), rule)


@pytest.mark.parametrize("dtype", sorted(HALF))
@pytest.mark.parametrize("clip", [-1.0, 2.0], ids=["noclip", "clip"])
@pytest.mark.parametrize("flavour", sorted(FLAT))
def test_half_seam_matches_the_jax_seam_interpret(flavour, clip, dtype):
    """The port's ``_multi_*_update`` on bf16 or fp16 groups (its plain
    version on the CPU: the 16-bit rules tensor by tensor) against the JAX
    seam, whose Pallas kernel runs in interpret mode over the packed
    buffer, two steps, w and every state: bitwise in bf16, within
    FP16_STEPS in fp16 (the gradient times 300, as in the fault-E inputs,
    so that the contraction shows)."""
    hp, n_states = FLAT[flavour]
    hp = dict(hp, rescale=1.0 / 32, clip=clip)
    jw, jg, jm, jv = _half_state(50 + n_states, BF16_SHAPES, dtype,
                                 1.0 if dtype == "bfloat16" else 300.0)
    jgroups = [jw, jg, jm] + ([jv] if n_states == 2 else [])
    tgroups = [_t(g) for g in jgroups]
    for step in range(2):
        jout = getattr(jseam, "_multi_%s_update" % flavour)(
            *jgroups, interpret=True, **hp)
        tout = getattr(tseam, "_multi_%s_update" % flavour)(*tgroups, **hp)
        for i in range(len(BF16_SHAPES)):
            inputs = _rule_inputs([g[i] for g in jgroups], hp["rescale"])
            _assert_rule([o[i] for o in tout], [o[i] for o in jout], inputs,
                         "%s step %d [%d]" % (flavour, step, i))
        if dtype == "float16":      # step 2 from the JAX package's state
            for k, o in zip([0] + list(range(2, len(tgroups))), jout):
                for t_, j in zip(tgroups[k], o):
                    t_.copy_(_t([j])[0])
        jgroups = [jout[0], jg] + list(jout[1:])
