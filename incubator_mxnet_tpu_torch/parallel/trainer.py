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

Mixed precision follows the JAX trainer:

- ``compute_dtype="bfloat16"`` or ``"float16"``: the step runs the block on
  casts of the fp32 parameters and auxiliary state to that dtype and on
  copies of the floating data in it, as the JAX trainer casts them inside
  the differentiated function. Each tensor is cast once, so a tied weight
  stays one tensor and its gradient is summed once; the gradients land on
  the fp32 masters through the cast, and the update (the fused launch) is
  the fp32 one. Running statistics written during the step go back to the
  fp32 aux. fp16 has three fewer exponent bits than bf16, so its
  gradients want dynamic loss scaling: ``step_guarded`` with
  ``resilience``'s ``NumericGuard`` scale (``GuardedTrainer``), as in the
  JAX package; the plain ``step`` runs unscaled there too.
- ``param_dtype="bfloat16"``: the differentiable parameters are stored in
  bf16 (aux stays fp32) and the step computes in bf16; any other dtype
  raises the JAX trainer's ValueError. The update lifts each
  parameter and gradient to fp32, runs the per-parameter rules there and
  writes back with stochastic rounding (``_stochastic_round``), its noise
  from a ``torch.Generator`` on the trainer's device seeded from the step's
  key on a stream of its own, as the JAX trainer's ``fold_in(key,
  0x51A57)`` is. The optimizer state stays fp32 unless ``opt_state_dtype``
  says otherwise, and the fused launch is off, as in the JAX trainer.

``step_guarded`` is the numeric guard's step (``resilience.GuardedTrainer``):
the loss is scaled inside the backward and the gradients unscaled, the
global gradient norm is taken in fp32, the finite check runs on the device,
and every parameter, auxiliary tensor and optimizer slot is selected
between its updated and its previous value with ``torch.where``; the host
learns the verdict from one 3-float read. ``device_snapshot`` and
``restore_device_snapshot`` copy the state on the device (the rollback
ring's primitive).

What this slice does not carry raises NotImplementedError naming its
ROADMAP item: ZeRO-1, gradient accumulation, sharding rules and meshes over
more than one device.
"""

import contextlib
import os
import time

import numpy as np
import torch

from .. import autograd
from ..context import resolve_device
from ..ops.kernels.fused_optim import (adam_scalars, multi_trainer_adam,
                                      multi_trainer_sgd_mom)
from ..telemetry import catalog as _cat
from ..telemetry import metrics as _met

__all__ = ["ShardedTrainer"]

_DTYPES = {None: None, "float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, torch.float32: torch.float32,
           torch.bfloat16: torch.bfloat16, torch.float16: torch.float16}

#: the stochastic-rounding stream's tag, the JAX trainer's fold_in constant
_SR_STREAM = 0x51A57


def _stochastic_round(x32, dtype, generator):
    """Stochastically round float32 to bfloat16 (unbiased: E[out] == x), as
    the JAX trainer's ``_stochastic_round``: add uniform noise over the 16
    mantissa bits bf16 drops, then cut them. The bit arithmetic runs on
    int32, whose wrap-around is the JAX version's uint32 one; +-inf stays
    +-inf (the noise never reaches its exponent) and NaN stays NaN. The
    noise is drawn from ``generator``; no torch stream reproduces
    ``jax.random.bits``, so the two agree in distribution, not bit for
    bit."""
    if dtype != torch.bfloat16:
        raise ValueError("stochastic rounding is implemented for bfloat16 "
                         "only, not %s" % (dtype,))
    x32 = x32.float().contiguous()
    noise = torch.randint(0, 1 << 16, x32.shape, generator=generator,
                          device=x32.device, dtype=torch.int32)
    cut = ((x32.view(torch.int32) + noise) & -65536).view(torch.float32)
    return torch.where(torch.isnan(x32), x32, cut).to(dtype)


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
        cdt = _dtype("compute_dtype", compute_dtype)
        pdt = _dtype("param_dtype", param_dtype)
        if pdt is not None and pdt != torch.bfloat16:
            raise ValueError("param_dtype supports bfloat16 only")
        if pdt is not None and cdt is None:
            # bf16-stored weights imply bf16 compute, as in the JAX trainer
            cdt = pdt
        self._compute_dtype = cdt
        self._param_dtype = pdt
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
        self._guard_bufs = None
        self._telemetry_labels = {"zero": "off", "pipeline": "off"}

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
        if pdt is not None:
            # bf16-stored parameters: the differentiable ones only; the
            # module keeps the same Parameter objects
            with torch.no_grad():
                for n in self._diff_names:
                    if params[n].is_floating_point():
                        params[n].data = params[n].data.to(pdt)
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

    @contextlib.contextmanager
    def _in_compute_dtype(self):
        """The block runs on ``compute_dtype`` casts of its floating
        parameters and buffers inside: each distinct tensor is cast once
        (autograd carries the gradient back through the cast), the casts
        stand in for the held tensors in every module's ``_parameters`` and
        ``_buffers`` (gluon blocks read their parameters there too). On
        the way out the held tensors come back, and a cast that the step
        wrote in place (a running statistic) is copied into its fp32
        tensor."""
        cdt = self._compute_dtype
        held = list(self._params.values()) + list(self._aux.values())
        cast = {}
        for t in held:
            if cdt is not None and t.is_floating_point() \
                    and t.dtype != cdt and id(t) not in cast:
                cast[id(t)] = t.to(cdt)
        if not cast:
            yield
            return
        versions = {k: c._version for k, c in cast.items()}
        swapped = []
        for mod in self._block.modules():
            for slot in (mod._parameters, mod._buffers):
                for name, t in slot.items():
                    if t is not None and id(t) in cast:
                        swapped.append((slot, name, t))
                        slot[name] = cast[id(t)]
        try:
            yield
        finally:
            for slot, name, t in swapped:
                slot[name] = t
            with torch.no_grad():
                for a in self._aux.values():
                    c = cast.get(id(a))
                    if c is not None and c._version != versions[id(a)]:
                        a.copy_(c)

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

    def _run(self, datas, labels, scale=None):
        """Forward, loss and backward in training mode; the step's loss.
        With ``scale`` the backward runs on loss * scale and the gradients
        and the returned loss are unscaled on the way out (an overflow
        shows as inf or NaN)."""
        for n in self._diff_names:
            self._params[n].grad = None
        cdt = self._compute_dtype
        if cdt is not None:
            datas = [d.to(cdt) if d.is_floating_point() else d
                     for d in datas]
        was_training = self._block.training
        self._block.train()
        try:
            with torch.enable_grad(), autograd.train_mode(), \
                    self._in_compute_dtype():
                out = self._block(*datas)
                loss = self._loss(out, *labels).float().mean()
            if scale is None:
                loss.backward()
            else:
                # dynamic loss scaling: the scale multiplies inside the
                # differentiated function; callers see the true loss/grads
                scaled = loss * scale
                scaled.backward()
                inv = 1.0 / scale
                with torch.no_grad():
                    for n in self._diff_names:
                        g = self._params[n].grad
                        if g is not None:
                            g.mul_(inv)
                loss = scaled * inv
        finally:
            self._block.train(was_training)
        return loss.detach()

    def _grads(self, ws):
        return [self._params[n].grad if self._params[n].grad is not None
                else torch.zeros_like(w) for n, w in zip(self._diff_names, ws)]

    def _apply_all(self, t, key):
        """The optimizer update of step number ``t`` on every parameter;
        ``key`` seeds the stochastic rounding of bf16-stored ones."""
        names = self._diff_names
        ws = [self._params[n].data for n in names]
        gs = self._grads(ws)
        self._fused_launches = 0
        with torch.no_grad():
            if self._param_dtype is not None:
                self._apply_sr(names, ws, gs, t, key)
            elif self._plain_sgd:
                for w, g in zip(ws, gs):
                    self._apply_one(w, g, (), t)
            elif os.environ.get("MXTPU_FUSED_OPTIM", "1") != "0":
                self._apply_fused(names, ws, gs, t)
                self._fused_launches = 1
            else:
                for n, w, g in zip(names, ws, gs):
                    self._apply_opt_fp(w, g, self._opt_state[n], t)

    def _apply_one(self, w, g, st, t):
        """One parameter's update in place, plain SGD included."""
        if self._plain_sgd:
            w.copy_(w - self._lr * (g + self._wd * w))
        else:
            self._apply_opt_fp(w, g, st, t)

    def _sr_generator(self, key):
        """The stochastic-rounding noise of the step keyed ``key`` (an int):
        a generator on the trainer's device on a stream of its own."""
        seed = (int(key) * 0x9E3779B97F4A7C15 + _SR_STREAM) % (1 << 63)
        return torch.Generator(device=self._device).manual_seed(seed)

    def _apply_sr(self, names, ws, gs, t, key):
        """bf16-stored parameters (the JAX trainer's ``_apply_opt`` with
        ``sr``): each lifted to fp32 with its gradient, updated there, and
        written back with stochastic rounding, the noise drawn in parameter
        order from one generator a step."""
        gen = self._sr_generator(key)
        for n, w, g in zip(names, ws, gs):
            st = self._opt_state.get(n, ())
            if w.dtype != self._param_dtype:
                self._apply_one(w, g, st, t)
                continue
            w32 = w.float()
            self._apply_one(w32, g.float(), st, t)
            w.copy_(_stochastic_round(w32, w.dtype, gen))

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

    def _observe(self, t0, datas):
        """The step's telemetry, as the JAX trainer records it: host time
        (the step's work enqueued), the step and its samples."""
        if t0 is None:
            return
        lbl = self._telemetry_labels
        _cat.trainer_step_seconds.observe(time.perf_counter() - t0, **lbl)
        _cat.trainer_steps.inc(**lbl)
        if datas and datas[0].dim():
            _cat.trainer_samples.inc(int(datas[0].shape[0]))

    def step(self, data, label, key=None):
        """One train step; returns the loss as a device scalar. ``key`` (an
        int, default the step count before the step) seeds the stochastic
        rounding of bf16-stored parameters."""
        t0 = time.perf_counter() if _met.enabled() else None
        datas, labels = self._prep_batch(data, label)
        if key is None:
            key = self._step_count
        self._step_count += 1
        loss = self._run(datas, labels)
        self._apply_all(self._step_count, key)
        self._observe(t0, datas)
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
            key = self._step_count
            self._step_count += 1
            losses.append(self._run(d, l))
            self._apply_all(self._step_count, key)
        return torch.stack(losses)

    def _guarded_state(self):
        """The tensors a step changes and a skipped step must leave as they
        were: the differentiable parameters and every optimizer slot (the
        auxiliary state is taken before the forward, which moves it)."""
        out = [self._params[n].data for n in self._diff_names]
        for n in self._diff_names:
            out += list(self._opt_state.get(n, ()))
        return out

    def _copy_into(self, key, tensors):
        """Copy ``tensors`` into this trainer's persistent buffers of that
        role (made on first use); returns the buffers."""
        if self._guard_bufs is None:
            self._guard_bufs = {}
        bufs = self._guard_bufs.get(key)
        if bufs is None or len(bufs) != len(tensors) or any(
                b.shape != t.shape or b.dtype != t.dtype
                for b, t in zip(bufs, tensors)):
            bufs = [torch.empty_like(t) for t in tensors]
            self._guard_bufs[key] = bufs
        if bufs:
            torch._foreach_copy_(bufs, tensors)
        return bufs

    def step_guarded(self, data, label, loss_scale=1.0, key=None):
        """One numeric-guarded train step (``resilience.GuardedTrainer``'s
        primitive). Returns ``(loss, notfinite, grad_norm)``: the unscaled
        loss as a device scalar (inf or NaN on a bad step), whether the loss
        or the global gradient norm was not finite (the update was then
        skipped on the device: parameters, auxiliary state and optimizer
        slots unchanged), and the fp32 global L2 norm of the unscaled
        gradients as a host float.

        ``loss_scale`` multiplies the loss inside the backward (dynamic
        loss scaling). The verdict never reaches the host before the
        update: the previous state is copied once into persistent buffers,
        the update runs, and each tensor is selected between the two with
        ``torch.where`` on the device's flag; then one 3-float read."""
        t0 = time.perf_counter() if _met.enabled() else None
        datas, labels = self._prep_batch(data, label)
        if key is None:
            key = self._step_count
        self._step_count += 1
        aux = list(self._aux.values())
        aux_old = self._copy_into("aux", aux)
        loss = self._run(datas, labels, scale=float(loss_scale))
        with torch.no_grad():
            ws = [self._params[n].data for n in self._diff_names]
            # the global norm in fp32: one multi-tensor launch of
            # per-tensor norms, then their norm
            norms = torch._foreach_norm(self._grads(ws), 2,
                                        dtype=torch.float32) if ws else []
            gnorm = torch.linalg.vector_norm(torch.stack(norms)) if ws \
                else torch.zeros((), device=self._device)
            ok = torch.isfinite(loss) & torch.isfinite(gnorm)
            live = self._guarded_state()
            old = self._copy_into("state", live)
            self._apply_all(self._step_count, key)
            for t, o in zip(live + aux, old + aux_old):
                torch.where(ok, t, o, out=t)
            stats = torch.stack([1.0 - ok.float(), gnorm,
                                 loss.float()]).cpu()   # the one host read
        self._observe(t0, datas)
        return loss, bool(stats[0] > 0.5), float(stats[1])

    def device_snapshot(self):
        """Copies, on the device, of the full training state (parameters,
        buffers, optimizer slots) and the step counter: the rollback ring's
        primitive."""
        return {
            "step": self._step_count,
            "params": {n: v.detach().clone()
                       for n, v in self.param_values.items()},
            "opt": {n: tuple(s.detach().clone() for s in st)
                    for n, st in self._opt_state.items()},
        }

    def restore_device_snapshot(self, snap):
        """Rewind to a ``device_snapshot()``: copied into the live tensors
        (which the block holds), so one snapshot can be restored again."""
        with torch.no_grad():
            for n, v in self.param_values.items():
                v.copy_(snap["params"][n])
            for n, st in self._opt_state.items():
                for s, src in zip(st, snap["opt"][n]):
                    s.copy_(src)
        self._step_count = int(snap["step"])

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
        cast to the trainer's configured parameter and state dtypes (a
        bf16-parameter trainer stays bf16 from an fp32 checkpoint); a
        missing key raises KeyError."""
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
