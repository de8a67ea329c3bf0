"""Parameter / ParameterDict / Constant of the PyTorch port.

Counterpart of ``incubator_mxnet_tpu/gluon/parameter.py``: a Parameter with
deferred shape inference, ``grad_req``, ``lr_mult`` / ``wd_mult``,
``initialize`` / ``data`` / ``set_data`` / ``grad`` / ``zero_grad``; a
prefix-scoped ParameterDict with sharing, ``save`` and ``load``; and the
non-differentiable Constant.

A Parameter holds ONE NDArray whose tensor is what the blocks that own it
read: a ``torch.nn.Parameter`` (``requires_grad`` iff ``grad_req`` is not
"null"), or a plain tensor for auxiliary state (BatchNorm's running
statistics), registered with each owning block's ``_parameters`` or
``_buffers`` under its attribute name once its shape is known. So
``named_parameters()`` / ``named_buffers()`` of a model give the JAX
package's ``_collect_params_with_prefix()`` keys, and an update written into
the tensor in place is what the next forward reads. The tensor lives on the
``ctx`` of ``initialize`` (None is ``cuda:0`` and raises without CUDA).
"""

import weakref

import numpy as _np
import torch

from .. import initializer as init
from ..base import MXNetError, dtype_torch
from ..context import resolve_device
from ..ndarray import NDArray

__all__ = ["Parameter", "Constant", "ParameterDict",
           "DeferredInitializationError"]


class DeferredInitializationError(MXNetError):
    """Parameter used before its deferred shape was known."""


def _first_ctx(ctx):
    if isinstance(ctx, (list, tuple)):
        if len(ctx) != 1:
            raise NotImplementedError(
                "a Parameter on %d devices: per-device replicas are the "
                "scale-out slice's (ROADMAP Queue 1 item 12)" % len(ctx))
        ctx = ctx[0]
    return resolve_device(ctx)


def _to_tensor(data):
    if isinstance(data, NDArray):
        return data._t.detach()
    if isinstance(data, torch.Tensor):
        return data.detach()
    if hasattr(data, "asnumpy"):        # the JAX package's NDArray
        data = data.asnumpy()
    return torch.as_tensor(_np.array(data))


class Parameter:
    def __init__(self, name, grad_req="write", shape=None, dtype="float32",
                 lr_mult=1.0, wd_mult=1.0, init=None,
                 allow_deferred_init=False, differentiable=True,
                 stype="default", grad_stype="default", aux=False):
        if stype != "default" or grad_stype != "default":
            raise NotImplementedError(
                "Parameter %s: sparse storage (stype=%r, grad_stype=%r) is "
                "not ported yet (ROADMAP Queue 1 item 4)"
                % (name, stype, grad_stype))
        self.name = name
        self._grad_req = grad_req if differentiable else "null"
        # auxiliary state (running statistics) is a buffer of its blocks;
        # a weight that is merely frozen stays a (non-trained) parameter
        self._aux = bool(aux)
        if isinstance(shape, int):
            shape = (shape,)
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = dtype
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.init = init
        self._allow_deferred_init = allow_deferred_init
        self._stype = stype
        self._grad_stype = grad_stype
        self._data = None           # NDArray
        self._deferred_init = None  # (initializer, default_init)
        self._ctx = None            # device of initialize()
        self._owners = []           # (weakref to a Block, attribute name)

    # ------------------------------------------------------------------ meta
    @property
    def grad_req(self):
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req):
        if req not in ("write", "add", "null"):
            raise ValueError("grad_req must be write, add or null, not %r"
                             % (req,))
        self._grad_req = req
        if self._data is not None:
            self._data._mark_variable(None, req)

    def _shape_known(self):
        return self.shape is not None and all(s > 0 for s in self.shape)

    def __repr__(self):
        return "Parameter %s (shape=%s, dtype=%s)" % (self.name, self.shape,
                                                      self.dtype)

    # ------------------------------------------------------ torch registry
    def _add_owner(self, block, attr):
        self._owners.append((weakref.ref(block), attr))

    def _tensor(self):
        return self._data._t if self._data is not None else None

    def _publish(self):
        """Register the current tensor with every live owning block."""
        t = self._tensor()
        live = []
        for ref, attr in self._owners:
            block = ref()
            if block is not None:
                block._bind_param(attr, self, t)
                live.append((ref, attr))
        self._owners = live

    def _new_tensor(self, t):
        """``t`` as this parameter's storage: a ``torch.nn.Parameter`` for
        a weight, the tensor itself for auxiliary state."""
        if self._aux:
            return t
        return torch.nn.Parameter(t, requires_grad=self._grad_req != "null")

    def _adopt(self, t):
        """Take ``t`` (a tensor the owning block's ``_apply`` produced) as
        the data, with a gradient buffer to match."""
        if self._data is None or t is None:
            return
        self._data._t = t
        g = self._data._grad
        if self._grad_req != "null" and (
                g is None or (g._t.shape, g._t.dtype, g._t.device)
                != (t.shape, t.dtype, t.device)):
            self._data._mark_variable(None, self._grad_req)
        self._publish()

    # ------------------------------------------------------------------ init
    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False):
        if default_init is None:
            from .. import initializer as _i
            default_init = _i.Uniform()
        if self._data is not None and not force_reinit:
            return
        self._ctx = _first_ctx(ctx)
        if not self._shape_known():
            if not self._allow_deferred_init:
                raise ValueError(
                    "Cannot initialize Parameter %s because it has invalid "
                    "shape %s and deferred init is not allowed."
                    % (self.name, self.shape))
            self._deferred_init = (init, default_init)
            return
        self._finish_init(init, default_init)

    def _finish_init(self, initializer, default_init):
        t = torch.zeros(self.shape, dtype=dtype_torch(self.dtype),
                        device=self._ctx if self._ctx is not None
                        else resolve_device(None))
        data = NDArray(self._new_tensor(t))
        desc = init.InitDesc(self.name, {"__init__": ""})
        actual = initializer if initializer is not None \
            else (self.init or default_init)
        if isinstance(actual, str):   # e.g. Parameter(init="zeros")
            actual = init.create(actual)
        actual(desc, data)
        self._set_data_arr(data)

    def _set_data_arr(self, data):
        self._data = data
        self._deferred_init = None
        if self._grad_req != "null":
            data._mark_variable(None, self._grad_req)
        self._publish()

    def _finish_deferred_init(self, in_shape_hint=None):
        if self._deferred_init is None:
            raise DeferredInitializationError(
                "Parameter %s has not been initialized" % self.name)
        initializer, default_init = self._deferred_init
        if not self._shape_known():
            raise DeferredInitializationError(
                "Parameter %s shape still unknown: %s"
                % (self.name, self.shape))
        self._finish_init(initializer, default_init)

    def shape_inferred(self, shape):
        """Fill deferred (0/None) dims from an observed input."""
        if self.shape is None:
            self.shape = tuple(shape)
        else:
            new = []
            for s_old, s_new in zip(self.shape, shape):
                if s_old in (0, None, -1):
                    new.append(s_new)
                elif s_new in (0, None, -1) or s_old == s_new:
                    new.append(s_old)
                else:
                    raise ValueError(
                        "Inferred shape %s incompatible with Parameter %s "
                        "declared shape %s" % (shape, self.name, self.shape))
            self.shape = tuple(new)
        if self._deferred_init is not None and self._shape_known():
            self._finish_deferred_init()

    # ------------------------------------------------------------------ data
    def data(self, ctx=None):
        if self._data is None:
            if self._deferred_init is not None:
                raise DeferredInitializationError(
                    "Parameter %s deferred-init pending; run a forward pass "
                    "or provide full shape." % self.name)
            raise RuntimeError(
                "Parameter %s has not been initialized. Call initialize() "
                "first." % self.name)
        return self._data

    def list_data(self):
        return [self.data()]

    def list_ctx(self):
        return [self.data().context] if self._data is not None else []

    def set_data(self, data):
        """Write ``data`` into the parameter's tensor in place (rounded to
        its dtype); an uninitialized parameter takes its shape and lives on
        its ``initialize`` device, else ``cuda:0``."""
        src = _to_tensor(data)
        if self._data is None:
            if self.shape is None or not self._shape_known():
                self.shape = tuple(src.shape)
            dev = self._ctx if self._ctx is not None else resolve_device(None)
            t = src.to(device=dev, dtype=dtype_torch(self.dtype)).clone()
            self._set_data_arr(NDArray(self._new_tensor(t)))
            return
        dst = self._data._t
        with torch.no_grad():
            if tuple(src.shape) == tuple(dst.shape):
                dst.copy_(src)
                return
        t = src.to(device=dst.device, dtype=dst.dtype).clone()
        self.shape = tuple(t.shape)
        self._set_data_arr(NDArray(self._new_tensor(t)))

    def grad(self, ctx=None):
        if self._data is None or self._data._grad is None:
            raise RuntimeError("Parameter %s has no gradient (grad_req=%s)"
                               % (self.name, self._grad_req))
        return self._data._grad

    def list_grad(self):
        return [self.grad()]

    def zero_grad(self):
        if self._data is not None and self._data._grad is not None:
            self._data._grad._t.zero_()

    def reset_ctx(self, ctx):
        """Move the data (and its gradient buffer) to ``ctx``."""
        dev = _first_ctx(ctx)
        self._ctx = dev
        if self._data is not None and self._data._t.device != dev:
            t = self._data._t.detach().to(dev)
            self._set_data_arr(NDArray(self._new_tensor(t)))

    def cast(self, dtype):
        self.dtype = dtype
        if self._data is not None:
            t = self._data._t.detach().to(dtype_torch(dtype))
            self._set_data_arr(NDArray(self._new_tensor(t)))


class Constant(Parameter):
    """Non-differentiable constant parameter (reference: gluon.Constant)."""

    def __init__(self, name, value):
        if not isinstance(value, _np.ndarray):
            value = _np.asarray(value)
        self.value = value

        class CInit(init.Initializer):
            def _init_weight(self2, _, arr):
                self2._set(arr, value)
            _init_default = _init_weight

        super().__init__(name, grad_req="null", shape=value.shape,
                         dtype=str(value.dtype), init=CInit())


class ParameterDict:
    """Prefix-scoped dict of Parameters with sharing (reference:
    parameter.py ParameterDict)."""

    def __init__(self, prefix="", shared=None):
        self._prefix = prefix
        self._params = {}
        self._shared = shared

    @property
    def prefix(self):
        return self._prefix

    def __repr__(self):
        return "ParameterDict(%s)" % ", ".join(self._params)

    def __getitem__(self, key):
        return self._params[key]

    def __iter__(self):
        return iter(self._params)

    def __len__(self):
        return len(self._params)

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    def __contains__(self, key):
        return key in self._params

    def get(self, name, **kwargs):
        """Create-or-retrieve ``prefix + name``."""
        name = self._prefix + name
        param = self._get_impl(name)
        if param is None:
            param = Parameter(name, **kwargs)
            self._params[name] = param
        else:
            for k, v in kwargs.items():
                if k == "shape" and v is not None and param.shape is not None:
                    continue
                if k == "aux":   # role flag lives on _aux
                    if v and not param._aux:
                        param._aux = True
                    continue
                if getattr(param, k, None) in (None, 0) and v is not None:
                    setattr(param, k, v)
        return param

    def get_constant(self, name, value=None):
        name = self._prefix + name
        param = self._get_impl(name)
        if param is None:
            if value is None:
                raise ValueError("No constant named %s" % name)
            param = Constant(name, value)
            self._params[name] = param
        return param

    def _get_impl(self, name):
        if name in self._params:
            return self._params[name]
        if self._shared is not None and name in self._shared._params:
            self._params[name] = self._shared._params[name]
            return self._params[name]
        return None

    def update(self, other):
        for k, v in other.items():
            if k in self._params and self._params[k] is not v:
                raise ValueError("Cannot update self with other because "
                                 "they have different Parameters with the "
                                 "same name %s" % k)
            self._params[k] = v

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        for _, v in self.items():
            v.initialize(init=None, ctx=ctx, default_init=init,
                         force_reinit=force_reinit)

    def zero_grad(self):
        for v in self.values():
            v.zero_grad()

    def reset_ctx(self, ctx):
        for v in self.values():
            v.reset_ctx(ctx)

    def setattr(self, name, value):
        for v in self.values():
            setattr(v, name, value)

    def save(self, filename, strip_prefix=""):
        arg_dict = {}
        for param in self.values():
            weight = param.data()
            if not param.name.startswith(strip_prefix):
                raise ValueError("Prefix %s is to be striped before saving, "
                                 "but Parameter %s does not start with it"
                                 % (strip_prefix, param.name))
            arg_dict[param.name[len(strip_prefix):]] = weight
        from ..ndarray import save as nd_save
        nd_save(filename, arg_dict)

    def load(self, filename, ctx=None, allow_missing=False,
             ignore_extra=False, restore_prefix=""):
        from ..ndarray import load as nd_load
        arg_dict = {restore_prefix + k: v
                    for k, v in nd_load(filename).items()}
        if not allow_missing:
            for name in self.keys():
                if name not in arg_dict:
                    raise IOError("Parameter %s missing in file %s"
                                  % (name, filename))
        for name, v in arg_dict.items():
            if name not in self._params:
                if not ignore_extra:
                    raise IOError("Parameter %s loaded from file %s is not "
                                  "present in this dict" % (name, filename))
                continue
            p = self._params[name]
            if p._data is None and ctx is not None:
                p._ctx = _first_ctx(ctx)
            p.set_data(v)
