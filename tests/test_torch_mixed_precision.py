"""The port's bf16 and fp16 mixed-precision training against the JAX
package's ShardedTrainer with the same options, on the CPU.

- ``compute_dtype`` bfloat16 or float16 (fp32 masters): a tied 2-layer BERT
  pretraining net of 64 units (T = 16, both packages attend through the
  softmax path), initialized by the JAX package from numpy's global RNG and
  carried to the port by name. Three AdamW steps: losses within rtol 1e-2
  (bf16) or 5e-3 (fp16) and the fp32 masters within 2 * lr * steps of
  JAX's (the most Adam can move an element, so a sign flip of a near-zero
  gradient by rounding noise is tolerated and a wrong update is not), one
  fused launch a step on both sides (the JAX side's Pallas kernel in
  interpret mode). XLA's CPU backend and eager PyTorch round the 16-bit
  values at other points, so the bound is rounding noise, not bit equality.
- fp16 under dynamic loss scaling: a guarded step at a scale that
  overflows fp16 (2**40) is flagged and leaves every parameter and
  optimizer slot bitwise unchanged, in both packages; at the guard's
  default scale (2**16) the step is finite and its loss and masters follow
  the JAX trainer's guarded step.
- ``param_dtype="bfloat16"`` (bf16-stored weights, stochastic rounding),
  mirroring tests/test_opt_state_dtype.py: SR is unbiased and lands on the
  two neighbouring bf16 values; the bf16 trajectory tracks the fp32 one; a
  checkpoint keeps the configured precision; the optimizer state stays
  fp32; and the port's losses stay within 0.1 of the JAX trainer's with the
  same option (the two draw their rounding noise from different streams).
- A small ResNet under ``compute_dtype`` bfloat16 or float16 (convolutions
  and BatchNorm in that dtype, running statistics back to fp32) against the
  JAX trainer: step 1's loss within rtol 1e-2 (bf16) or 5e-3 (fp16). Later
  steps are not held to JAX: at this size (4 images of 32 x 32, BatchNorm over 4 samples) the
  gradients of the BatchNorm scales are sums with heavy cancellation, so
  each package's own bf16 gradients there are far from its fp32 ones (as
  far as the two packages' bf16 gradients are from each other), and lr 0.1
  with momentum carries that into the losses of steps 2 and 3, which
  differ by more than rtol 1e-2.
"""

import functools

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import nd
from incubator_mxnet_tpu.gluon.block import HybridBlock
from incubator_mxnet_tpu.gluon.model_zoo.vision import resnet as jresnet
from incubator_mxnet_tpu.models import bert as jbert
from incubator_mxnet_tpu.parallel import ShardedTrainer as JaxTrainer
from incubator_mxnet_tpu.parallel import make_mesh as jax_mesh
from incubator_mxnet_tpu_torch.gluon.model_zoo.vision.resnet import (
    _ResNet, params_from_jax)
from incubator_mxnet_tpu_torch.models.bert import BERTForPretrain, BERTModel
from incubator_mxnet_tpu_torch.parallel import ShardedTrainer
from incubator_mxnet_tpu_torch.parallel.trainer import _stochastic_round

V = 60
CFG = dict(vocab_size=V, units=64, hidden_size=128, num_layers=2,
           num_heads=2, max_length=32)
B, T = 3, 16
LR = 1e-3
HP = {"learning_rate": LR, "wd": 0.01}
STEPS = 3
BF16 = torch.bfloat16
#: compute dtype -> (torch dtype, the losses' rtol against the JAX trainer:
#: bf16's 1e-2, and fp16's 5e-3 for its three more mantissa bits)
HALF = {"bfloat16": (torch.bfloat16, 1e-2), "float16": (torch.float16, 5e-3)}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's side runs tiny models: one intra-op thread, restored
    after each test (several threads a worker, under parallel test workers,
    spend their time in each small op's barrier)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _JaxStep(HybridBlock):
    def __init__(self, pretrain, **kw):
        super().__init__(**kw)
        with self.name_scope():
            self.pretrain = pretrain

    def hybrid_forward(self, F, ids, types, pos):
        return self.pretrain(ids, types, mlm_positions=pos)


class _Step(nn.Module):
    def __init__(self, pretrain):
        super().__init__()
        self.pretrain = pretrain

    def forward(self, ids, types, pos):
        return self.pretrain(ids, types, mlm_positions=pos)


def _jax_loss(out, mlab, nlab):
    mlm_logits, nsp_logits = out
    logp = jax.nn.log_softmax(mlm_logits.astype(jnp.float32), axis=-1)
    mlm = -jnp.take_along_axis(logp, mlab[:, :, None], axis=-1).mean()
    nlogp = jax.nn.log_softmax(nsp_logits.astype(jnp.float32), axis=-1)
    return mlm - jnp.take_along_axis(nlogp, nlab[:, None], axis=-1).mean()


def _loss(out, mlab, nlab):
    mlm_logits, nsp_logits = out
    logp = torch.log_softmax(mlm_logits.float(), dim=-1)
    mlm = -logp.gather(-1, mlab.long()[:, :, None]).mean()
    nlogp = torch.log_softmax(nsp_logits.float(), dim=-1)
    return mlm - nlogp.gather(-1, nlab.long()[:, None]).mean()


def _batch(seed=1):
    rs = np.random.RandomState(seed)
    n_mask = max(1, int(T * 0.15))
    ids = rs.randint(0, V, (B, T)).astype(np.int32)
    pos = np.stack([rs.permutation(T)[:n_mask] for _ in range(B)]) \
        .astype(np.int32)
    mlab = np.take_along_axis(ids, pos, axis=1)
    masked = ids.copy()
    np.put_along_axis(masked, pos, 3, axis=1)
    nlab = rs.randint(0, 2, (B,)).astype(np.int32)
    return [masked, np.zeros((B, T), np.int32), pos], [mlab, nlab]


def _jax_net(tag):
    np.random.seed(0)
    b = jbert.BERTModel(dropout=0.0, prefix="mpb%s_" % tag, **CFG)
    net = _JaxStep(jbert.BERTForPretrain(bert=b, vocab_size=V,
                                         tie_decoder=True, prefix="mpp_"),
                   prefix="mps%s_" % tag)
    net.initialize(mx.init.Normal(0.02))
    data, _ = _batch()
    net(*(nd.array(a[:1]) for a in data))
    return net


@functools.lru_cache(maxsize=None)
def _jax_run(option, dtype="bfloat16", guarded=None):
    """The JAX net's initial parameters (by structural name), and its
    trainer's losses and parameters after STEPS AdamW steps with
    ``option`` ("compute" or "param") set to ``dtype``; with ``guarded`` (a
    loss scale) the steps are ``step_guarded`` at that scale, and their
    verdicts come back too."""
    mp = pytest.MonkeyPatch()
    mp.setenv("MXTPU_FUSED_OPTIM_INTERPRET", "1")
    try:
        net = _jax_net(option + ("" if dtype == "bfloat16" else dtype))
        by_struct = net._collect_params_with_prefix()
        params = {k[len("pretrain."):]: p.data().asnumpy()
                  for k, p in by_struct.items()}
        kw = {"%s_dtype" % option: dtype}
        tr = JaxTrainer(net, _jax_loss, jax_mesh({"dp": 1},
                                                 devices=jax.devices()[:1]),
                        optimizer="adamw", optimizer_params=dict(HP),
                        data_specs=[P(), P(), P()], label_spec=P(), **kw)
        data, label = _batch()
        losses, fused, bad = [], [], []
        for _ in range(STEPS):
            batch = ([nd.array(a) for a in data],
                     [nd.array(a) for a in label])
            if guarded is None:
                loss = tr.step(*batch)
            else:
                loss, notfinite, _gn = tr.step_guarded(*batch,
                                                       loss_scale=guarded)
                bad.append(bool(notfinite))
            losses.append(float(jax.device_get(loss)))
            fused.append(tr._fused_launches)
        vals = {k: np.asarray(jax.device_get(v).astype(jnp.float32))
                for k, v in tr.param_values.items()}
        after = {k[len("pretrain."):]: vals[p.name]
                 for k, p in by_struct.items()}
    finally:
        mp.undo()
    return dict(params=params, losses=losses, after=after, fused=fused,
                bad=bad)


def _port_trainer(params, **kw):
    pre = BERTForPretrain(bert=BERTModel(device="cpu", dropout=0.0, **CFG),
                          vocab_size=V, tie_decoder=True, device="cpu")
    pre.load_params(params)
    return ShardedTrainer(_Step(pre), _loss, optimizer="adamw",
                          optimizer_params=dict(HP), device="cpu", **kw)


# ------------------------------------------------------------ compute dtype
@pytest.mark.parametrize("dtype", sorted(HALF))
def test_half_compute_trains_like_the_jax_trainer(dtype):
    want = _jax_run("compute", dtype)
    assert want["fused"] == [1] * STEPS
    tr = _port_trainer(want["params"], compute_dtype=dtype)
    data, label = _batch()
    losses = []
    for _ in range(STEPS):
        losses.append(float(tr.step(data, label)))
        assert tr._fused_launches == 1
    np.testing.assert_allclose(losses, want["losses"], rtol=HALF[dtype][1])
    assert losses[-1] < losses[0]
    limit = 2 * LR * STEPS
    for name, v in tr.param_values.items():
        name = name[len("pretrain."):]
        assert v.dtype == torch.float32, name       # the masters stay fp32
        err = np.abs(v.numpy() - want["after"][name]).max()
        assert err <= limit, (name, err, limit)


@pytest.mark.parametrize("dtype", sorted(HALF))
def test_half_compute_runs_the_block_in_its_dtype_and_keeps_the_tie(dtype):
    """Inside the step every floating parameter the block reads is a cast
    to the compute dtype; the tied decoder reads the same cast as the
    embedding (one tensor, its gradient summed once onto the one fp32
    master); outside the step the block holds its fp32 tensors again."""
    tdt = HALF[dtype][0]
    tr = _port_trainer(_jax_run("compute")["params"], compute_dtype=dtype)
    pre = tr._block.pretrain
    seen = {}

    def hook(mod, args, out):
        seen["dec"] = mod.weight
        seen["emb"] = pre.bert.word_embed.weight
        seen["out"] = out.dtype

    h = pre.mlm_decoder.register_forward_hook(hook)
    try:
        tr.step(*_batch())
    finally:
        h.remove()
    assert seen["dec"] is seen["emb"] and seen["dec"].dtype == tdt
    assert seen["out"] == tdt
    assert pre.mlm_decoder.weight is pre.bert.word_embed.weight
    assert pre.bert.word_embed.weight.dtype == torch.float32
    assert pre.bert.word_embed.weight.grad.dtype == torch.float32


@pytest.mark.parametrize("scale", [2.0 ** 12, 2.0 ** 40],
                         ids=["in_range_scale", "overflowing_scale"])
def test_fp16_guarded_steps_follow_the_jax_trainer(scale):
    """``step_guarded`` under fp16 compute in both packages at one loss
    scale for STEPS steps. At 2**40 the scaled gradients overflow fp16 (the
    MLM logits' cotangent alone is ~2**40 / 6), so every step is flagged and
    every parameter and optimizer slot stays bitwise what it was, in both
    packages; at 2**12 the steps are finite and the losses and fp32 masters
    follow the JAX trainer's as unguarded steps do. (At the guard's default
    2**16 this tiny net sits at fp16's edge: the JAX trainer's third step
    overflowed there and was finite at 2**15, the port's was finite.)"""
    want = _jax_run("compute", "float16", scale)
    tr = _port_trainer(want["params"], compute_dtype="float16")
    before = {k: v.clone() for k, v in tr.state_dict().items()}
    data, label = _batch()
    losses, bad = [], []
    for _ in range(STEPS):
        loss, notfinite, _gn = tr.step_guarded(data, label, loss_scale=scale)
        losses.append(float(loss))
        bad.append(notfinite)
    overflow = scale > 2.0 ** 30
    assert bad == want["bad"] == [overflow] * STEPS
    after = tr.state_dict()
    if overflow:
        for k, v in before.items():
            if k != "step":
                assert torch.equal(v, after[k]), k
        for name, v in want["after"].items():
            np.testing.assert_array_equal(v, want["params"][name])
        return
    np.testing.assert_allclose(losses, want["losses"], rtol=HALF["float16"][1])
    limit = 2 * LR * STEPS
    for name, v in tr.param_values.items():
        err = np.abs(v.numpy() - want["after"][name[len("pretrain."):]]).max()
        assert err <= limit, (name, err, limit)


def test_fp16_guardian_backs_off_until_a_step_is_finite():
    """``GuardedTrainer`` over fp16 compute from a guard that starts at
    2**40: each overflowing step is skipped with the state bitwise
    unchanged and halves the scale, until a step is finite and training
    goes on; the scales follow ``NumericGuard``'s replay of the verdicts."""
    from incubator_mxnet_tpu_torch.resilience import (GuardedTrainer,
                                                      NumericGuard)
    tr = _port_trainer(_jax_run("compute")["params"], compute_dtype="float16")
    g = GuardedTrainer(tr, guard=NumericGuard(init_scale=2.0 ** 40,
                                              max_scale=2.0 ** 40),
                       rollback_after=1000, enabled=True)
    replay = NumericGuard(init_scale=2.0 ** 40, max_scale=2.0 ** 40)
    data, label = _batch()
    before = {k: v.clone() for k, v in tr.state_dict().items()}
    losses = []
    for _ in range(40):
        assert g.loss_scale == replay.scale
        skipped = g.skipped_steps
        loss = float(g.step(data, label))
        if g.skipped_steps == skipped:
            assert np.isfinite(loss)
            replay.on_good_step()
            losses.append(loss)
            if len(losses) == 2:
                break
        else:
            assert not losses          # no overflow once a step went well
            replay.on_bad_step()
            now = tr.state_dict()
            assert all(torch.equal(v, now[k]) for k, v in before.items()
                       if k != "step")
    assert len(losses) == 2 and g.skipped_steps >= 10
    assert g.loss_scale == replay.scale < 2.0 ** 30


# ------------------------------------------------------- stochastic rounding
def test_stochastic_round_is_unbiased():
    """64 roundings of 1 + 2**-9 (a quarter of the way between two bf16
    values) average within 0.05 ulp of it, and one rounding lands on the two
    neighbours only."""
    x = torch.full((4096,), 1.0 + 1.0 / 512.0)
    acc = torch.zeros(4096, dtype=torch.float64)
    n = 64
    for i in range(n):
        r = _stochastic_round(x, BF16, torch.Generator().manual_seed(i))
        assert r.dtype == BF16
        acc += r.double()
    mean_err = abs(acc.mean().item() / n - float(x[0]))
    ulp = 2.0 / 256.0
    assert mean_err < 0.05 * ulp, (mean_err, ulp)
    one = _stochastic_round(x, BF16, torch.Generator().manual_seed(99))
    assert set(one.float().tolist()) <= {1.0, 1.0 + 1.0 / 128.0}


def test_stochastic_round_keeps_infinities_nan_and_exact_values():
    x = torch.tensor([float("inf"), float("-inf"), float("nan"), 0.0, -0.0,
                      1.0, -2.5, 3.0e38, -1.0 - 1.0 / 512.0])
    for seed in range(8):
        r = _stochastic_round(x, BF16, torch.Generator().manual_seed(seed))
        assert torch.isposinf(r[0]) and torch.isneginf(r[1])
        assert torch.isnan(r[2])
        assert r[3:7].float().tolist() == [0.0, -0.0, 1.0, -2.5]
        assert r[8].item() in (-1.0, -1.0 - 1.0 / 128.0)
    with pytest.raises(ValueError, match="bfloat16"):
        _stochastic_round(x, torch.float16, torch.Generator())


# ------------------------------------------------------- bf16-stored params
def _fp32_and_bf16_runs(steps):
    params = _jax_run("param")["params"]
    data, label = _batch()
    out = {}
    for kw in ({}, {"param_dtype": "bfloat16"}):
        tr = _port_trainer(params, **kw)
        out[bool(kw)] = (tr, [float(tr.step(data, label))
                              for _ in range(steps)])
    return out


def test_bf16_params_track_the_fp32_trajectory():
    runs = _fp32_and_bf16_runs(15)
    l32, lb16 = runs[False][1], runs[True][1]
    trb = runs[True][0]
    assert abs(l32[0] - lb16[0]) < 2e-2, (l32[0], lb16[0])
    assert lb16[-1] < lb16[0]
    drift = max(abs(a - b) for a, b in zip(l32, lb16))
    assert drift < 0.1, drift
    for n in trb._diff_names:
        assert trb.param_values[n].dtype == BF16, n
    # no fp32 master: the fused launch is off, as in the JAX trainer
    assert trb._fused_launches == 0
    # the optimizer state stays fp32 without opt_state_dtype
    for st in trb._opt_state.values():
        assert all(s.dtype == torch.float32 for s in st)


def test_bf16_params_stay_within_0_1_of_the_jax_trainer():
    want = _jax_run("param")
    tr = _port_trainer(want["params"], param_dtype="bfloat16")
    data, label = _batch()
    losses = [float(tr.step(data, label)) for _ in range(STEPS)]
    assert max(abs(a - b) for a, b in zip(losses, want["losses"])) < 0.1
    assert want["fused"] == [0] * STEPS and tr._fused_launches == 0


def test_bf16_params_checkpoint_keeps_the_configured_precision(tmp_path):
    from incubator_mxnet_tpu_torch.utils.checkpoint import CheckpointManager
    params = _jax_run("param")["params"]
    data, label = _batch()
    tr = _port_trainer(params, param_dtype="bfloat16")
    for _ in range(2):
        tr.step(data, label)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(2, tr.state_dict())
    _step, flat, _, _ = mgr.restore()
    assert flat["param/pretrain.nsp.weight"].dtype == BF16
    assert flat["opt0/pretrain.nsp.weight"].dtype == torch.float32
    tr2 = _port_trainer(params, param_dtype="bfloat16")
    tr2.load_state_dict(flat)
    for n in tr2._diff_names:
        assert tr2.param_values[n].dtype == BF16
        assert torch.equal(tr2.param_values[n], tr.param_values[n]), n
    # an fp32 checkpoint restores into bf16 storage too
    fp32 = {k: (v.float() if v.is_floating_point() else v)
            for k, v in flat.items()}
    tr3 = _port_trainer(params, param_dtype="bfloat16")
    tr3.load_state_dict(fp32)
    assert all(tr3.param_values[n].dtype == BF16 for n in tr3._diff_names)
    l2, l3 = float(tr2.step(data, label)), float(tr3.step(data, label))
    assert l2 == l3


def test_bf16_params_rounding_is_keyed_by_the_step():
    """The same key gives the same rounding; two trainers on the same
    batch stay bitwise equal step for step."""
    params = _jax_run("param")["params"]
    data, label = _batch()
    a = _port_trainer(params, param_dtype="bfloat16")
    b = _port_trainer(params, param_dtype="bfloat16")
    for _ in range(2):
        assert float(a.step(data, label)) == float(b.step(data, label))
    for n, v in a.param_values.items():
        assert torch.equal(v, b.param_values[n]), n


@pytest.mark.parametrize("param_dtype", ["float16", "float32"])
def test_what_mixed_precision_refuses(param_dtype):
    """Parameters stored in anything but bf16 raise the JAX trainer's
    ValueError, in both packages; stochastic rounding takes bf16 only."""
    params = _jax_run("compute")["params"]
    msg = "param_dtype supports bfloat16 only"
    with pytest.raises(ValueError, match=msg):
        JaxTrainer(_jax_net("refuse"), _jax_loss,
                   jax_mesh({"dp": 1}, devices=jax.devices()[:1]),
                   optimizer="adamw", data_specs=[P(), P(), P()],
                   label_spec=P(), param_dtype=param_dtype)
    with pytest.raises(ValueError, match=msg):
        _port_trainer(params, param_dtype=param_dtype)
    with pytest.raises(ValueError, match="bfloat16"):
        _stochastic_round(torch.ones(2), getattr(torch, param_dtype),
                          torch.Generator())


# -------------------------------------------------------------------- ResNet
RESNET = dict(kind="bottleneck", layers=[1, 2], channels=[8, 16, 32],
              preact=False, classes=10)
SGD_HP = {"learning_rate": 0.1, "momentum": 0.9}


def _jax_ce(out, lab):
    logp = jax.nn.log_softmax(out.astype(jnp.float32), axis=-1)
    return -jnp.take_along_axis(logp, lab.astype(jnp.int32)[:, None],
                                axis=-1).mean()


def _ce(out, lab):
    logp = torch.log_softmax(out.float(), dim=-1)
    return -logp.gather(-1, lab.long()[:, None]).mean()


#: compute dtype -> the running statistics' bound against the JAX trainer's
#: after step 1, as a share of their largest magnitude: 2**-6 in bf16 (which
#: the port's fp32 path exceeds) and 2**-9 in fp16 (where the fp32 path
#: lands as close: 1.13e-3 and 1.14e-3 of the max, so fp16's casts are held
#: by the logits' dtype instead)
RESNET_STATS_REL = {"bfloat16": 2.0 ** -6, "float16": 2.0 ** -9}


@pytest.mark.parametrize("dtype", sorted(HALF))
def test_half_compute_resnet_matches_the_jax_trainer(monkeypatch, dtype):
    """Convolutions and BatchNorm's one-pass statistics in bf16 or fp16 on
    both sides; the running statistics written back to fp32. Step 1's loss
    within rtol 1e-2 (bf16) or 5e-3 (fp16) of the JAX trainer's, its logits
    in the compute dtype, and its running statistics within
    RESNET_STATS_REL of their largest magnitude of the JAX trainer's, where
    in bf16 the port's fp32 path (the casts skipped) lands farther than
    that from them; three steps finite, one fused SGD launch a step."""
    tdt, rtol = HALF[dtype]
    monkeypatch.setenv("MXTPU_FUSED_OPTIM_INTERPRET", "1")
    np.random.seed(0)
    net = jresnet._ResNet(**RESNET)
    net.initialize(mx.init.Xavier())
    net(nd.array(np.zeros((1, 3, 32, 32), np.float32)))
    init = {k: p.data().asnumpy()
            for k, p in net._collect_params_with_prefix().items()}
    rs = np.random.RandomState(2)
    x = rs.rand(4, 3, 32, 32).astype(np.float32)
    y = rs.randint(0, 10, (4,)).astype(np.float32)
    jtr = JaxTrainer(net, _jax_ce, jax_mesh({"dp": 1},
                                            devices=jax.devices()[:1]),
                     optimizer="sgd", optimizer_params=dict(SGD_HP),
                     data_specs=P(), label_spec=P(), compute_dtype=dtype)
    want = float(jax.device_get(jtr.step(nd.array(x), nd.array(y))))
    jax_stats = {k: np.asarray(jtr.param_values[p.name])
                 for k, p in net._collect_params_with_prefix().items()
                 if "running" in k}
    port = params_from_jax(init, _ResNet(**RESNET, device="cpu"))
    tr = ShardedTrainer(port, _ce, optimizer="sgd",
                        optimizer_params=dict(SGD_HP), device="cpu",
                        compute_dtype=dtype)
    seen = []
    hook = port.register_forward_hook(lambda m, a, out: seen.append(
        out.dtype))
    got = [float(tr.step(x, y))]
    hook.remove()
    assert seen == [tdt]
    fp32 = ShardedTrainer(params_from_jax(init, _ResNet(**RESNET,
                                                        device="cpu")),
                          _ce, optimizer="sgd", optimizer_params=dict(SGD_HP),
                          device="cpu")
    fp32.step(x, y)
    assert len(jax_stats) == 24

    def worst(trainer):
        return max(np.abs(trainer.param_values[k].numpy() - w).max()
                   / np.abs(w).max() for k, w in jax_stats.items())
    bound = RESNET_STATS_REL[dtype]
    assert worst(tr) <= bound, (worst(tr), bound)
    if dtype == "bfloat16":
        assert bound < worst(fp32), (worst(tr), worst(fp32))
    got += [float(tr.step(x, y)) for _ in range(STEPS - 1)]
    assert abs(got[0] - want) <= rtol * abs(want), (got[0], want)
    assert np.isfinite(got).all() and got[-1] < got[0]
    assert tr._fused_launches == 1
    stats = {n: v for n, v in tr.param_values.items() if "running" in n}
    assert stats and all(v.dtype == torch.float32 for v in stats.values())
    assert not torch.equal(stats["features.1.running_var"],
                           torch.from_numpy(init["features.1.running_var"]))
