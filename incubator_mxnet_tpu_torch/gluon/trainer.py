"""gluon.Trainer — per-iteration parameter updates, the local path.

Counterpart of ``incubator_mxnet_tpu/gluon/trainer.py``: ``step`` (rescale
by ``1 / batch_size``, sync gradients through a local kvstore, apply the
optimizer), ``update``, ``allreduce_grads``, ``set_learning_rate`` and
``save_states`` / ``load_states`` (the JAX package's format, so a file
saved by either package loads in the other). The step hands the whole
step's parameters to the ``Updater`` at once, so SGD with momentum, Adam
and AdamW update every dense fp32 parameter of a group in one launch of the
fused kernel (``ops/kernels/fused_optim.py``).

The dist kvstores, the bucketed overlap pipeline and ``update_on_kvstore``
wait for the scale-out slice (ROADMAP Queue 1 item 12) and raise.
"""

import functools

from .. import optimizer as opt
from .parameter import Parameter, ParameterDict

__all__ = ["Trainer"]


def _as_param_list(params):
    if isinstance(params, (dict, ParameterDict)):
        params = list(params.values())
    if not isinstance(params, (list, tuple)):
        raise ValueError("params must be a ParameterDict or list of "
                         "Parameters")
    bad = [p for p in params if not isinstance(p, Parameter)]
    if bad:
        raise ValueError("invalid parameter %s" % bad[0])
    return list(params)


def _kv_ready(method):
    """Lazily bring the kvstore up before any method that touches it."""
    @functools.wraps(method)
    def wrapped(self, *args, **kwargs):
        if not self._kv_initialized:
            self._init_kvstore()
        return method(self, *args, **kwargs)
    return wrapped


def _dist(what):
    return NotImplementedError("Trainer: %s is not ported yet (ROADMAP "
                               "Queue 1 item 12)" % what)


class Trainer:
    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None):
        self._params = _as_param_list(params)
        self._param2idx = {p.name: i for i, p in enumerate(self._params)}
        if compression_params:
            raise _dist("gradient compression")
        if update_on_kvstore:
            raise _dist("update_on_kvstore")
        hp = optimizer_params or {}
        self._scale = hp.get("rescale_grad", 1.0)
        self._optimizer = self._make_optimizer(optimizer, hp)
        self._updaters = [opt.get_updater(self._optimizer)]
        self._kvstore_arg = kvstore
        self._kvstore = None
        self._update_on_kvstore = update_on_kvstore
        self._kv_initialized = False

    def _make_optimizer(self, optimizer, hp):
        by_index = dict(enumerate(self._params))
        if isinstance(optimizer, opt.Optimizer):
            if hp:
                raise ValueError("optimizer_params must be None when "
                                 "optimizer is an Optimizer instance")
            optimizer.param_dict = by_index
            return optimizer
        return opt.create(optimizer, param_dict=by_index, **hp)

    def _init_kvstore(self):
        from .. import kvstore as kvs
        arg = self._kvstore_arg
        if not arg:
            self._kvstore = None
            self._update_on_kvstore = False
            self._kv_initialized = True
            return
        kv = kvs.create(arg) if isinstance(arg, str) else arg
        if kv.is_dist:
            raise _dist("a dist kvstore")
        self._kvstore = kv
        self._update_on_kvstore = False
        for i, param in enumerate(self._params):
            if param._data is not None:
                kv.init(i, param.data())
        self._kv_initialized = True

    # -- introspection -------------------------------------------------------
    @property
    def learning_rate(self):
        o = self._optimizer
        return o.lr_scheduler(o.num_update) if o.lr_scheduler else o.lr

    @property
    def optimizer(self):
        return self._optimizer

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    # -- gradient sync -------------------------------------------------------
    @_kv_ready
    def allreduce_grads(self):
        self._allreduce_grads()

    def _allreduce_grads(self):
        if self._kvstore is None:
            return
        for i, param in enumerate(self._params):
            if param.grad_req == "null":
                continue
            self._kvstore.push(i, param.grad())
            self._kvstore.pull(i, out=param.grad())

    # -- the step ------------------------------------------------------------
    # rescale before the lazy kvstore init, as the JAX package orders it
    # (a dist store ships the optimizer with the step's scale at init)
    def step(self, batch_size, ignore_stale_grad=False):
        """Rescale by 1/batch_size, sync grads, apply the optimizer."""
        self._check_and_rescale_grad(self._scale / batch_size)
        if not self._kv_initialized:
            self._init_kvstore()
        self._allreduce_grads()
        self._update(ignore_stale_grad)

    def update(self, batch_size, ignore_stale_grad=False):
        self._check_and_rescale_grad(self._scale / batch_size)
        if not self._kv_initialized:
            self._init_kvstore()
        self._update(ignore_stale_grad)

    def _check_and_rescale_grad(self, scale):
        self._optimizer.rescale_grad = scale

    def _update(self, ignore_stale_grad=False):
        live = [(i, p) for i, p in enumerate(self._params)
                if p.grad_req != "null" and p._data is not None]
        # batched apply: fused optimizers put each group of dense fp32
        # parameters through one multi-tensor launch
        self._updaters[0].update_multi(
            [i for i, _ in live],
            [p.grad() for _, p in live],
            [p.data() for _, p in live])

    # -- optimizer-state checkpointing ---------------------------------------
    @_kv_ready
    def save_states(self, fname):
        assert self._optimizer is not None
        with open(fname, "wb") as f:
            f.write(self._updaters[0].get_states())

    @_kv_ready
    def load_states(self, fname):
        with open(fname, "rb") as f:
            self._updaters[0].set_states(f.read())
