"""The PyTorch port's training (ShardedTrainer) against the JAX package's:
BERT pretraining with AdamW, and a small ResNet with SGD and momentum.

A tiny BERTForPretrain (2 layers, units 16, 2 heads, vocab 60, as
tests/test_bert_model.py builds it) is initialized by the JAX package from
numpy's global RNG and carried to the port by name. Forward logits match
at rtol = atol = 1e-5. Three AdamW steps of the bench's objective (MLM
cross-entropy on gathered positions + NSP) run through both trainers, the
JAX one with ``MXTPU_FUSED_OPTIM_INTERPRET=1`` so that its Pallas
``_trainer_adam_kernel`` runs in interpret mode: losses within rtol 1e-5,
parameters within rtol 1e-4 and atol 1e-6, the JAX package's own tolerance
for its interpret-mode trainer (tests/test_fused_optim.py). On the CPU the
JAX model always attends through its einsum path; the port takes its flash
path (and so the flash backward) when ``MXTPU_FLASH_MIN_T`` is lowered.
"""

import functools
import importlib

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
from incubator_mxnet_tpu_torch.models.bert import (BERTForPretrain,
                                                   BERTModel,
                                                   pretrain_param_shapes,
                                                   pretrain_params_from_jax)
from incubator_mxnet_tpu_torch.gluon.model_zoo.vision.resnet import (
    _ResNet, params_from_jax)
from incubator_mxnet_tpu_torch.ops.kernels import launch_counts
from incubator_mxnet_tpu_torch.parallel import ShardedTrainer, make_mesh

V, U = 60, 16
TINY = dict(vocab_size=V, units=U, hidden_size=32, num_layers=2,
            num_heads=2, max_length=32)
B, T = 3, 16
HP = {"learning_rate": 1e-3, "wd": 0.01}
STEPS = 3


class _JaxStep(HybridBlock):
    """bench.py's adapter: positional (ids, types, positions) to the
    keyword-only mlm_positions."""

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
    """bench.py's batch: 15 % of the positions masked with [MASK]."""
    rs = np.random.RandomState(seed)
    n_mask = max(1, int(T * 0.15))
    ids = rs.randint(0, V, (B, T)).astype(np.int32)
    pos = np.stack([rs.permutation(T)[:n_mask] for _ in range(B)]) \
        .astype(np.int32)
    mlab = np.take_along_axis(ids, pos, axis=1)
    masked = ids.copy()
    np.put_along_axis(masked, pos, 3, axis=1)     # [MASK]: 103 in BERT
    nlab = rs.randint(0, 2, (B,)).astype(np.int32)
    return [masked, np.zeros((B, T), np.int32), pos], [mlab, nlab]


def _jax_net(tie, seed=0):
    np.random.seed(seed)
    b = jbert.BERTModel(dropout=0.0, prefix="tb%d_" % tie, **TINY)
    net = _JaxStep(jbert.BERTForPretrain(bert=b, vocab_size=V,
                                         tie_decoder=tie, prefix="tp_"),
                   prefix="ts%d_" % tie)
    net.initialize(mx.init.Normal(0.02))
    data, _ = _batch()
    net(*(nd.array(a[:1]) for a in data))
    return net


def _jax_params(net):
    """{name under the pretraining model: numpy} as the JAX package names
    them (a tied decoder's weight listed under both its names)."""
    return {k[len("pretrain."):]: p.data().asnumpy()
            for k, p in net._collect_params_with_prefix().items()}


def _port_net(params, tie):
    pre = BERTForPretrain(bert=BERTModel(device="cpu", dropout=0.0, **TINY),
                          vocab_size=V, tie_decoder=tie, device="cpu")
    pre.load_params(params)
    return _Step(pre)


@functools.lru_cache(maxsize=None)
def _jax_result(tie):
    """The JAX net's initial parameters, and its trainer's losses and
    parameters (by structural name) after STEPS AdamW steps."""
    mp = pytest.MonkeyPatch()
    mp.setenv("MXTPU_FUSED_OPTIM_INTERPRET", "1")
    try:
        net = _jax_net(tie)
        params = _jax_params(net)
        tr = JaxTrainer(net, _jax_loss, jax_mesh({"dp": 1},
                                                 devices=jax.devices()[:1]),
                        optimizer="adamw", optimizer_params=dict(HP),
                        data_specs=[P(), P(), P()], label_spec=P())
        data, label = _batch()
        losses = [float(jax.device_get(tr.step(
            [nd.array(a) for a in data], [nd.array(a) for a in label])))
            for _ in range(STEPS)]
        assert tr._fused_launches == 1
        by_name = {k: np.asarray(jax.device_get(v))
                   for k, v in tr.param_values.items()}
        after = {k[len("pretrain."):]: by_name[p.name]
                 for k, p in net._collect_params_with_prefix().items()}
    finally:
        mp.undo()
    return dict(tie=tie, net=net, params=params, losses=losses, after=after)


@pytest.fixture(params=[False, True], ids=["untied", "tied"])
def jax_run(request):
    return _jax_result(request.param)


@pytest.fixture
def untied():
    return _jax_result(False)


@pytest.fixture
def tied():
    return _jax_result(True)


def test_parameter_names_and_shapes_match_jax(jax_run):
    net = _port_net(jax_run["params"], jax_run["tie"])
    port = {k[len("pretrain."):]: tuple(p.shape)
            for k, p in net.named_parameters()}
    jshapes = {k: tuple(v.shape) for k, v in jax_run["params"].items()}
    if jax_run["tie"]:
        # one nn.Parameter, listed once; the JAX dict aliases it
        assert "mlm_decoder.weight" not in port
        assert net.pretrain.mlm_decoder.weight \
            is net.pretrain.bert.word_embed.weight
        jshapes.pop("mlm_decoder.weight")
    assert port == jshapes
    assert port == pretrain_param_shapes(V, U, 32, 2, 32,
                                         tie_decoder=jax_run["tie"])


@pytest.mark.parametrize("gather", [True, False], ids=["gather", "full"])
def test_pretrain_logits_match_jax(jax_run, gather):
    net = _port_net(jax_run["params"], jax_run["tie"])
    data, _ = _batch(seed=2)
    ids, types, pos = data
    pre = jax_run["net"].pretrain
    if gather:
        jm, jn = pre(nd.array(ids), nd.array(types),
                     mlm_positions=nd.array(pos))
    else:
        jm, jn = pre(nd.array(ids), nd.array(types))
    with torch.no_grad():
        tm, tn = net.pretrain(torch.from_numpy(ids), torch.from_numpy(types),
                              mlm_positions=torch.from_numpy(pos)
                              if gather else None)
    assert tm.shape == ((B, pos.shape[1], V) if gather else (B, T, V))
    np.testing.assert_allclose(tm.numpy(), jm.asnumpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tn.numpy(), jn.asnumpy(), rtol=1e-5,
                               atol=1e-5)


def _port_train(params, tie, steps=STEPS, **kw):
    net = _port_net(params, tie)
    tr = ShardedTrainer(net, _loss, make_mesh({"dp": 1}, devices=["cpu"]),
                        optimizer="adamw", optimizer_params=dict(HP),
                        data_specs=[None, None, None], device="cpu", **kw)
    data, label = _batch()
    losses = [float(tr.step(data, label)) for _ in range(steps)]
    after = {k[len("pretrain."):]: v.numpy().copy()
             for k, v in tr.param_values.items()}
    return tr, losses, after


def _assert_trained_like_jax(jax_run, losses, after):
    np.testing.assert_allclose(losses, jax_run["losses"], rtol=1e-5)
    assert losses[-1] < losses[0]
    for name, w in after.items():
        np.testing.assert_allclose(w, jax_run["after"][name], rtol=1e-4,
                                   atol=1e-6, err_msg=name)


def test_three_adamw_steps_match_the_jax_trainer(jax_run):
    tr, losses, after = _port_train(jax_run["params"], jax_run["tie"])
    _assert_trained_like_jax(jax_run, losses, after)
    assert tr._fused_launches == 1 and tr._step_count == STEPS
    if jax_run["tie"]:
        # the shared matrix took one update a step, not two
        np.testing.assert_allclose(after["bert.word_embed.weight"],
                                   jax_run["after"]["mlm_decoder.weight"],
                                   rtol=1e-4, atol=1e-6)


def test_flash_path_trains_like_the_jax_einsum_path(tied, monkeypatch):
    """With MXTPU_FLASH_MIN_T at T the port attends (and differentiates)
    through flash attention; the JAX model's einsum path is the oracle."""
    fa = importlib.import_module(
        "incubator_mxnet_tpu_torch.ops.kernels.flash_attention")
    monkeypatch.setenv("MXTPU_FLASH_MIN_T", str(T))
    calls = []
    real = fa.flash_attention_backward
    monkeypatch.setattr(fa, "flash_attention_backward",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    _tr, losses, after = _port_train(tied["params"], True)
    assert len(calls) == STEPS * TINY["num_layers"]
    _assert_trained_like_jax(tied, losses, after)


def test_per_parameter_update_agrees_with_the_fused_one(untied,
                                                        monkeypatch):
    """MXTPU_FUSED_OPTIM=0 selects the per-parameter update, as in the JAX
    package; it reaches the same parameters."""
    monkeypatch.setenv("MXTPU_FUSED_OPTIM", "0")
    tr, losses, after = _port_train(untied["params"], False)
    assert tr._fused_launches == 0
    _assert_trained_like_jax(untied, losses, after)


def test_state_dict_round_trips(untied):
    tr, _losses, _after = _port_train(untied["params"], False, steps=2)
    flat = tr.state_dict()
    names = {k[len("param/"):] for k in flat if k.startswith("param/")}
    assert names == set(tr.param_values)
    assert {k for k in flat if k.startswith("opt0/")} \
        == {"opt0/" + n for n in names}
    assert int(flat["step"]) == 2
    # a fresh trainer restored from it takes the same third step
    tr2, _, _ = _port_train(untied["params"], False, steps=0)
    tr2.load_state_dict({k: v.numpy() for k, v in flat.items()})
    data, label = _batch()
    l1, l2 = float(tr.step(data, label)), float(tr2.step(data, label))
    assert l1 == l2 and tr2._step_count == 3
    for n, v in tr.param_values.items():
        assert torch.equal(v, tr2.param_values[n]), n
    with pytest.raises(KeyError, match="step"):
        tr2.load_state_dict({k: v for k, v in flat.items() if k != "step"})


def test_bf16_optimizer_state_trains_like_jax(untied, monkeypatch):
    """opt_state_dtype='bfloat16': moments stored in bf16, lifted to fp32
    around the update, as the JAX trainer's fused apply does. lr 1e-4 keeps
    a one-step bf16 rounding difference of a moment below the tolerance."""
    monkeypatch.setenv("MXTPU_FUSED_OPTIM_INTERPRET", "1")
    hp = {"learning_rate": 1e-4, "wd": 0.01}
    data, label = _batch()
    net = _jax_net(False, seed=0)
    jtr = JaxTrainer(net, _jax_loss, jax_mesh({"dp": 1},
                                              devices=jax.devices()[:1]),
                     optimizer="adamw", optimizer_params=hp,
                     data_specs=[P(), P(), P()], label_spec=P(),
                     opt_state_dtype="bfloat16")
    jl = [float(jax.device_get(jtr.step([nd.array(a) for a in data],
                                        [nd.array(a) for a in label])))
          for _ in range(STEPS)]
    tr = ShardedTrainer(_port_net(untied["params"], False), _loss,
                        optimizer="adamw", optimizer_params=hp,
                        opt_state_dtype="bfloat16", device="cpu")
    tl = [float(tr.step(data, label)) for _ in range(STEPS)]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    jvals = {k: np.asarray(jax.device_get(v))
             for k, v in jtr.param_values.items()}
    flat = tr.state_dict()
    assert flat["opt0/pretrain.nsp.weight"].dtype == torch.bfloat16
    for k, p in net._collect_params_with_prefix().items():
        if k in tr.param_values:
            np.testing.assert_allclose(tr.param_values[k].numpy(),
                                       jvals[p.name], rtol=1e-4, atol=1e-6,
                                       err_msg=k)


def test_tied_decoder_weight_must_be_the_embedding(tied):
    params = dict(tied["params"])
    state = pretrain_params_from_jax(params, "cpu", tie_decoder=True)
    assert "mlm_decoder.weight" not in state
    params["mlm_decoder.weight"] = params["mlm_decoder.weight"] + 1.0
    with pytest.raises(ValueError, match="tie_decoder"):
        pretrain_params_from_jax(params, "cpu", tie_decoder=True)


def test_cpu_training_launches_no_kernel(untied):
    before = launch_counts()
    _port_train(untied["params"], False, steps=1)
    assert launch_counts() == before


def test_what_this_slice_does_not_carry_raises():
    net = _Step(BERTForPretrain(bert=BERTModel(device="cpu", **TINY),
                                vocab_size=V, device="cpu"))

    def make(**kw):
        return ShardedTrainer(net, _loss, device="cpu", **kw)

    # fp16 compute trains (tests/test_torch_mixed_precision.py); fp16
    # parameters raise the JAX trainer's ValueError
    assert make(compute_dtype="float16")._compute_dtype == torch.float16
    with pytest.raises(ValueError, match="param_dtype supports bfloat16 "
                       "only"):
        make(param_dtype="float16")
    for build, item in ((lambda: make(zero1=True), "item 12"),
                        (lambda: make(grad_accum=2), "item 12"),
                        (lambda: make(rules=[("dense", P("tp"))]),
                         "item 12"),
                        (lambda: _ResNet(**RESNET, remat_stages={"stage1"},
                                         device="cpu"), "item 9")):
        with pytest.raises(NotImplementedError, match=item):
            build()
    with pytest.raises(NotImplementedError, match="item 12"):
        make_mesh({"dp": 2}, devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="unknown optimizer"):
        make(optimizer="lamb")


def test_plain_sgd_steps_downhill():
    """SGD without momentum runs its plain update (the JAX package has no
    kernel for it): w - lr * (g + wd * w)."""
    torch.manual_seed(0)
    lin = nn.Linear(4, 2)
    x, y = torch.randn(8, 4), torch.randn(8, 2)
    w0 = lin.weight.detach().clone()
    tr = ShardedTrainer(lin, lambda out, y: ((out - y) ** 2).mean(),
                        optimizer="sgd",
                        optimizer_params={"learning_rate": 0.1, "wd": 0.01},
                        device="cpu")
    loss0 = float(tr.step(x, y))
    g = lin.weight.grad
    torch.testing.assert_close(lin.weight.detach(),
                               w0 - 0.1 * (g + 0.01 * w0))
    assert float(tr.step(x, y)) < loss0


# ------------------------------------------------------------------ ResNet
RESNET = dict(kind="bottleneck", layers=[1, 2], channels=[8, 16, 32],
              preact=False, classes=10)
SGD_HP = {"learning_rate": 0.1, "momentum": 0.9}


def _resnet_batch(seed=2, B=4, size=32):
    rs = np.random.RandomState(seed)
    return (rs.rand(B, 3, size, size).astype(np.float32),
            rs.randint(0, RESNET["classes"], (B,)).astype(np.float32))


def _jax_ce(out, lab):
    logp = jax.nn.log_softmax(out.astype(jnp.float32), axis=-1)
    return -jnp.take_along_axis(logp, lab.astype(jnp.int32)[:, None],
                                axis=-1).mean()


def _ce(out, lab):
    logp = torch.log_softmax(out.float(), dim=-1)
    return -logp.gather(-1, lab.long()[:, None]).mean()


@functools.lru_cache(maxsize=None)
def _jax_resnet_run(fused):
    """The JAX net's initial state and, after STEPS SGD-momentum steps of
    its ShardedTrainer, the losses and the state by structural name:
    params (parameters and running statistics) and momenta."""
    mp = pytest.MonkeyPatch()
    mp.setenv("MXTPU_FUSED_OPTIM_INTERPRET", "1")
    mp.setenv("MXTPU_FUSED_OPTIM", "1" if fused else "0")
    try:
        np.random.seed(0)
        net = jresnet._ResNet(**RESNET)
        net.initialize(mx.init.Xavier())
        net(nd.array(np.zeros((1, 3, 32, 32), np.float32)))
        by_struct = net._collect_params_with_prefix()
        init = {k: p.data().asnumpy() for k, p in by_struct.items()}
        tr = JaxTrainer(net, _jax_ce, jax_mesh({"dp": 1},
                                               devices=jax.devices()[:1]),
                        optimizer="sgd", optimizer_params=dict(SGD_HP),
                        data_specs=P(), label_spec=P())
        x, y = _resnet_batch()
        losses = [float(jax.device_get(tr.step(nd.array(x), nd.array(y))))
                  for _ in range(STEPS)]
        assert tr._fused_launches == (1 if fused else 0)
        flat = {k: np.asarray(jax.device_get(v))
                for k, v in tr.state_dict().items()}
        params = {k: flat["param/" + p.name] for k, p in by_struct.items()}
        moms = {k: flat["opt0/" + p.name] for k, p in by_struct.items()
                if "opt0/" + p.name in flat}
    finally:
        mp.undo()
    return dict(init=init, losses=losses, params=params, moms=moms)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "per_param"])
def test_three_sgd_momentum_steps_of_a_resnet_match_the_jax_trainer(
        fused, monkeypatch):
    """MXTPU_FUSED_OPTIM=0 selects the per-parameter update on both sides."""
    monkeypatch.setenv("MXTPU_FUSED_OPTIM", "1" if fused else "0")
    want = _jax_resnet_run(fused)
    net = params_from_jax(want["init"], _ResNet(**RESNET, device="cpu"))
    tr = ShardedTrainer(net, _ce, make_mesh({"dp": 1}, devices=["cpu"]),
                        optimizer="sgd", optimizer_params=dict(SGD_HP),
                        device="cpu")
    x, y = _resnet_batch()
    losses = [float(tr.step(x, y)) for _ in range(STEPS)]
    assert tr._fused_launches == (1 if fused else 0)
    np.testing.assert_allclose(losses, want["losses"], rtol=1e-5)
    assert losses[-1] < losses[0]
    flat = tr.state_dict()
    params = {k[len("param/"):]: v.numpy() for k, v in flat.items()
              if k.startswith("param/")}
    moms = {k[len("opt0/"):]: v.numpy() for k, v in flat.items()
            if k.startswith("opt0/")}
    assert set(params) == set(want["params"])
    assert set(moms) == set(want["moms"]) and len(moms) == len(
        tr._diff_names)
    for got, ref in ((params, want["params"]), (moms, want["moms"])):
        for k, v in got.items():
            np.testing.assert_allclose(v, ref[k], rtol=1e-4, atol=1e-6,
                                       err_msg=k)
    # the running statistics moved
    assert not np.array_equal(params["features.1.running_var"],
                              want["init"]["features.1.running_var"])
