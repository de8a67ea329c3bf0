"""ShardedTrainer on one device: forward, loss, backward and one optimizer
update a step.

Counterpart of ``incubator_mxnet_tpu/parallel/trainer.py``. The JAX trainer
compiles the whole step into one XLA program over a mesh; here the step runs
eagerly on one device: ``block(*data)``, ``loss(out, *label)`` averaged in
fp32, ``loss.backward()``, then the update. Adam, AdamW and SGD with
momentum go through the fused multi-tensor kernels
(``ops/kernels/fused_optim.py``, one launch for every parameter); SGD
without momentum runs its plain update, as the JAX package has no kernel
for it. ``MXTPU_FUSED_OPTIM=0`` selects the JAX package's per-parameter
update (``_apply_opt_fp``) instead, as it does there.

Buffers of the block (BatchNorm's running statistics) are the JAX
trainer's aux state: the forward in training mode (``autograd.train_mode()``
around it, which the gluon layers read, and the module's ``train()``)
moves them, and
``param_values``, ``state_dict`` and ``load_state_dict`` carry them beside
the parameters, as do parameters that take no gradient (gluon's
``differentiable=False``).

What this slice does not carry raises NotImplementedError naming its
ROADMAP item: bf16 compute or parameters, ZeRO-1, gradient accumulation,
sharding rules, meshes over more than one device and ``step_guarded``.
"""

import os

import numpy as np
import torch

from .. import autograd
from ..context import resolve_device
from ..ops.kernels.fused_optim import (adam_scalars, multi_trainer_adam,
                                      multi_trainer_sgd_mom)

__all__ = ["ShardedTrainer"]

_DTYPES = {None: None, "float32": torch.float32, "bfloat16": torch.bfloat16,
           torch.float32: torch.float32, torch.bfloat16: torch.bfloat16}


def _not_yet(what, item):
    return NotImplementedError("ShardedTrainer: %s is not ported yet "
                               "(ROADMAP %s)" % (what, item))


def _dtype(name, value):
    if isinstance(value, np.dtype) or (isinstance(value, type)
                                       and issubclass(value, np.generic)):
        value = np.dtype(value).name
    if value not in _DTYPES:
        raise ValueError("%s: unsupported dtype %r" % (name, value))
    return _DTYPES[value]


def _as_tensor(x, device):
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device)


class ShardedTrainer:
    """Train ``block`` (an ``nn.Module`` whose parameters lie on ``device``)
    on ``loss(block(*data), *label)``.

    Arguments follow the JAX ShardedTrainer. ``optimizer`` is 'sgd', 'adam'
    or 'adamw'; ``optimizer_params`` reads learning_rate (0.01), momentum
    (0), wd (0), beta1 (0.9), beta2 (0.999) and epsilon (1e-8).
    ``opt_state_dtype`` 'bfloat16' stores the Adam moments or the SGD
    momentum in bf16, lifted to fp32 around the update. ``data_specs`` and ``label_spec`` place nothing
    on one device; a list of data specs must have one entry per data array.
    ``device=None`` is ``cuda:0`` and raises without CUDA; a given ``mesh``
    must hold that device.
    """

    def __init__(self, block, loss, mesh=None, rules=None, optimizer="sgd",
                 optimizer_params=None, data_specs=None, label_spec=None,
                 dp_axis="dp", compute_dtype=None, zero1=False, grad_accum=1,
                 opt_state_dtype=None, param_dtype=None, device=None):
        self._device = resolve_device(device)
        if mesh is not None and mesh.device != self._device:
            raise ValueError("ShardedTrainer: the mesh holds %s, the trainer "
                             "runs on %s" % (mesh.device, self._device))
        if rules:
            raise _not_yet("parameter sharding rules (tp/ep)",
                           "Queue 1 item 12")
        if _dtype("compute_dtype", compute_dtype) not in (None,
                                                          torch.float32):
            raise _not_yet("compute_dtype %s" % compute_dtype,
                           "Queue 1 item 8, bf16 compute")
        if _dtype("param_dtype", param_dtype) not in (None, torch.float32):
            raise _not_yet("param_dtype %s" % param_dtype,
                           "Queue 1 item 8, bf16-stored parameters")
        if zero1 not in (False, True, "manual", "auto"):
            raise ValueError("zero1 must be False/True/'manual'/'auto', got "
                             "%r" % (zero1,))
        if zero1:
            raise _not_yet("zero1", "Queue 1 item 12")
        if int(grad_accum) < 1:
            raise ValueError("grad_accum must be >= 1")
        if int(grad_accum) > 1:
            raise _not_yet("grad_accum > 1", "Queue 1 item 12")
        if optimizer not in ("sgd", "adam", "adamw"):
            raise ValueError("unknown optimizer %r" % (optimizer,))
        self._block = block
        self._loss = loss
        self._mesh = mesh
        self._opt = optimizer
        self._data_specs = data_specs
        hp = dict(optimizer_params or {})
        self._lr = float(hp.get("learning_rate", 0.01))
        self._momentum = float(hp.get("momentum", 0.0))
        self._wd = float(hp.get("wd", 0.0))
        self._beta1 = float(hp.get("beta1", 0.9))
        self._beta2 = float(hp.get("beta2", 0.999))
        self._eps = float(hp.get("epsilon", 1e-8))
        self._state_dtype = _dtype("opt_state_dtype", opt_state_dtype) \
            or torch.float32
        self._step_count = 0
        self._fused_launches = 0

        params = dict(block.named_parameters())
        for n, p in params.items():
            if p.device != self._device:
                raise ValueError("ShardedTrainer: parameter %s is on %s, the "
                                 "trainer runs on %s" % (n, p.device,
                                                         self._device))
        self._params = params
        self._diff_names = sorted(n for n, p in params.items()
                                  if p.requires_grad)
        self._aux = dict(block.named_buffers())
        # the JAX trainer's _init_opt_state: (mom,) for SGD with momentum,
        # (m, v) for Adam / AdamW, nothing for plain SGD
        slots = 0 if self._plain_sgd else (1 if optimizer == "sgd" else 2)
        self._opt_state = {
            n: tuple(torch.zeros_like(params[n], dtype=self._state_dtype)
                     for _ in range(slots))
            for n in self._diff_names} if slots else {}

    @property
    def _plain_sgd(self):
        return self._opt == "sgd" and self._momentum == 0.0

    # ------------------------------------------------------------ the step
    def _prep_batch(self, data, label):
        datas = list(data) if isinstance(data, (list, tuple)) else [data]
        labels = list(label) if isinstance(label, (list, tuple)) else [label]
        if isinstance(self._data_specs, list) \
                and len(self._data_specs) != len(datas):
            raise ValueError("data_specs has %d entries but step got %d data "
                             "arrays" % (len(self._data_specs), len(datas)))
        return ([_as_tensor(d, self._device) for d in datas],
                [_as_tensor(l, self._device) for l in labels])

    def _run(self, datas, labels):
        """Forward, loss and backward in training mode; the step's loss."""
        for n in self._diff_names:
            self._params[n].grad = None
        was_training = self._block.training
        self._block.train()
        try:
            with torch.enable_grad(), autograd.train_mode():
                out = self._block(*datas)
                loss = self._loss(out, *labels).float().mean()
            loss.backward()
        finally:
            self._block.train(was_training)
        return loss.detach()

    def _apply_all(self, t):
        """The optimizer update of step number ``t`` on every parameter."""
        names = self._diff_names
        ws = [self._params[n].data for n in names]
        gs = [self._params[n].grad if self._params[n].grad is not None
              else torch.zeros_like(w) for n, w in zip(names, ws)]
        self._fused_launches = 0
        with torch.no_grad():
            if self._plain_sgd:
                for w, g in zip(ws, gs):
                    w.copy_(w - self._lr * (g + self._wd * w))
            elif os.environ.get("MXTPU_FUSED_OPTIM", "1") != "0":
                self._apply_fused(names, ws, gs, t)
                self._fused_launches = 1
            else:
                for n, w, g in zip(names, ws, gs):
                    self._apply_opt_fp(w, g, self._opt_state[n], t)

    def _apply_fused(self, names, ws, gs, t):
        """All parameters in one fused launch; bf16 stored state is lifted
        to fp32 for it and rounded back, as the JAX package's
        ``_apply_fused`` does."""
        if not names:
            return
        lift = self._state_dtype != torch.float32
        slots = [[self._opt_state[n][i] for n in names]
                 for i in range(len(self._opt_state[names[0]]))]
        slots32 = [[s.float() for s in slot] for slot in slots] if lift \
            else slots
        if self._opt == "sgd":
            multi_trainer_sgd_mom(ws, gs, slots32[0], self._lr, self._wd,
                                  self._momentum)
        else:
            multi_trainer_adam(ws, gs, slots32[0], slots32[1], self._lr,
                               self._wd, self._beta1, self._beta2,
                               self._eps, t, adamw=self._opt == "adamw")
        if lift:
            for slot, slot32 in zip(slots, slots32):
                for dst, src in zip(slot, slot32):
                    dst.copy_(src)

    def _apply_opt_fp(self, w, g, st, t):
        """The JAX package's per-parameter update (``_apply_opt_fp``):
        Python-float hyper-parameters round to f32 where they meet a tensor,
        1 - beta**t is f32 (as JAX's f32 step number makes it), and the
        divisions are true divisions."""
        if self._opt == "sgd":
            (mom,) = st
            mf = self._momentum * mom.float() - self._lr * (g + self._wd * w)
            w.add_(mf)
            mom.copy_(mf)
            return
        m, v = st
        mf, vf = m.float(), v.float()
        sc = adam_scalars(self._lr, self._wd, self._beta1, self._beta2,
                          self._eps, t)
        bias1, bias2 = (torch.tensor(sc[k], dtype=torch.float32,
                                     device=w.device)
                        for k in ("bias1", "bias2"))
        if self._opt == "adam":
            g = g + self._wd * w
        mf = self._beta1 * mf + (1 - self._beta1) * g
        vf = self._beta2 * vf + (1 - self._beta2) * g * g
        upd = self._lr * (mf / bias1) / (torch.sqrt(vf / bias2) + self._eps)
        if self._opt == "adamw":
            upd = upd + self._lr * self._wd * w
        w.sub_(upd)
        m.copy_(mf)
        v.copy_(vf)

    def step(self, data, label):
        """One train step; returns the loss as a device scalar."""
        datas, labels = self._prep_batch(data, label)
        self._step_count += 1
        loss = self._run(datas, labels)
        self._apply_all(self._step_count)
        return loss

    def step_scan(self, data, label, n_steps, per_step_batches=None):
        """``n_steps`` train steps in a loop; returns the per-step losses
        as a device tensor. ``per_step_batches=True``: every array has a
        leading axis of ``n_steps`` and step i takes slice i; False: every
        step reuses the batch; None: True iff every leading dim is
        ``n_steps`` (and ``n_steps`` > 1)."""
        datas, labels = self._prep_batch(data, label)
        if per_step_batches is None:
            per_step_batches = n_steps > 1 and all(
                a.shape[:1] == (n_steps,) for a in datas + labels)
        losses = []
        for i in range(n_steps):
            d, l = datas, labels
            if per_step_batches:
                d, l = [a[i] for a in datas], [a[i] for a in labels]
            self._step_count += 1
            losses.append(self._run(d, l))
            self._apply_all(self._step_count)
        return torch.stack(losses)

    def step_guarded(self, data, label, loss_scale=1.0):
        raise _not_yet("step_guarded (the numeric guard)",
                       "Queue 1 item 8 and item 13, resilience/")

    # --------------------------------------------------------------- state
    @property
    def param_values(self):
        """{name: tensor} of the parameters and buffers (live, on the
        device)."""
        out = {n: p.data for n, p in self._params.items()}
        out.update(self._aux)
        return out

    def state_dict(self):
        """Flat name -> tensor dict of the full training state in the JAX
        package's layout: ``param/<name>`` (parameters and buffers),
        ``opt0/<name>`` and ``opt1/<name>`` (Adam's m and v, or SGD's
        momentum as ``opt0``) and ``step``."""
        flat = {"param/" + n: v.detach().clone()
                for n, v in self.param_values.items()}
        for n, st in self._opt_state.items():
            for i, s in enumerate(st):
                flat["opt%d/%s" % (i, n)] = s.detach().clone()
        flat["step"] = torch.tensor(self._step_count, dtype=torch.int32)
        return flat

    def load_state_dict(self, flat):
        """Restore ``state_dict()`` output (tensors or arrays). Values are
        cast to the trainer's parameter and state dtypes; a missing key
        raises KeyError."""
        def get(key):
            if key not in flat:
                raise KeyError("checkpoint missing %s" % key)
            return _as_tensor(flat[key], self._device)
        with torch.no_grad():
            for n, v in self.param_values.items():
                v.copy_(get("param/" + n).to(v.dtype).reshape(v.shape))
            for n, st in self._opt_state.items():
                for i, s in enumerate(st):
                    s.copy_(get("opt%d/%s" % (i, n)).to(s.dtype)
                            .reshape(s.shape))
        self._step_count = int(get("step").item())
