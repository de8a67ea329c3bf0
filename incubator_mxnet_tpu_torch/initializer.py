"""Weight initializers of the PyTorch port.

Counterpart of ``incubator_mxnet_tpu/initializer.py`` (Uniform, Normal,
Constant, One, Zero, Orthogonal, Xavier, MSRAPrelu, the ``InitDesc`` name
dispatch, ``register`` / ``create``). Every
initializer draws from numpy's global RNG in the JAX package's order and
writes the draw into the parameter's tensor in place, rounded to its dtype,
so ``np.random.seed(s); net.initialize(mx.init.Xavier())`` gives the JAX
package's weights bitwise. Bilinear, LSTMBias, FusedRNN and Mixed wait for
the layers that use them (ROADMAP Queue 1 items 6 and 10).
"""

import math

import numpy as _np
import torch

__all__ = ["InitDesc", "Initializer", "Uniform", "Normal", "Orthogonal",
           "Xavier", "MSRAPrelu", "Constant", "One", "Zero", "register",
           "create"]

_INIT_REGISTRY = {}
_ALIASES = {"zeros": "zero", "ones": "one", "gaussian": "normal",
            "msra": "msraprelu"}


def register(klass):
    _INIT_REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(name, **kwargs):
    if isinstance(name, Initializer):
        return name
    if name.startswith("["):
        # dumps() JSON form: '["name", {kwargs}]' — how per-variable
        # __init__ attrs ship through the graph (reference: initializer
        # dumps/loads round trip). The spec carries its own kwargs;
        # extras alongside it would be silently dropped otherwise
        # (same contract as registry.py's create)
        if kwargs:
            raise ValueError(
                "create() got keyword arguments %s alongside the JSON "
                "spec form %r — the spec already carries its kwargs"
                % (sorted(kwargs), name))
        import json
        loaded_name, loaded_kwargs = json.loads(name)
        return create(loaded_name, **loaded_kwargs)
    key = name.lower()
    return _INIT_REGISTRY[_ALIASES.get(key, key)](**kwargs)


class InitDesc(str):
    """Name + attrs descriptor passed to initializers (reference surface:
    initializer.py InitDesc)."""

    def __new__(cls, name, attrs=None, global_init=None):
        ret = super().__new__(cls, name)
        ret.attrs = attrs or {}
        ret.global_init = global_init
        return ret


def _fill_role(value):
    """Generate a trivial role hook (bias->0, gamma->1, ...)."""
    def role(self, _desc, arr):
        self._set(arr, _np.full(arr.shape, float(value)))
    return role


# parameter-name suffix -> Initializer hook (first match wins)
_ROLE_DISPATCH = (
    ("weight", "_init_weight"), ("bias", "_init_bias"),
    ("gamma", "_init_gamma"), ("beta", "_init_beta"),
    ("running_mean", "_init_zero"), ("moving_mean", "_init_zero"),
    ("running_var", "_init_one"), ("moving_var", "_init_one"),
)


class Initializer:
    """Base initializer: callable on (InitDesc, NDArray); dispatches on
    the parameter-name suffix via _ROLE_DISPATCH."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def _hp(self, **kwargs):
        """Record hyperparameters once: serialized via dumps() AND set as
        attributes."""
        self._kwargs = kwargs
        self.__dict__.update(kwargs)

    def __call__(self, desc, arr):
        if not isinstance(desc, InitDesc):
            desc = InitDesc(str(desc))
        override = desc.attrs.get("__init__", "")
        if override:
            return create(override)._init_weight(desc, arr)
        name = desc.lower()
        hook = next((h for suffix, h in _ROLE_DISPATCH
                     if name.endswith(suffix)), "_init_default")
        getattr(self, hook)(desc, arr)

    def _set(self, arr, value):
        """Write ``value`` (numpy, drawn in float64) into ``arr``'s tensor
        in place, rounded to its dtype."""
        t = arr._t
        with torch.no_grad():
            t.copy_(torch.from_numpy(_np.array(value, dtype=_np.float64))
                    .to(t.dtype).reshape(t.shape))

    _init_zero = _fill_role(0.0)
    _init_bias = _fill_role(0.0)
    _init_beta = _fill_role(0.0)
    _init_one = _fill_role(1.0)
    _init_gamma = _fill_role(1.0)

    def _init_weight(self, desc, arr):
        raise NotImplementedError

    def _init_default(self, desc, arr):
        self._init_weight(desc, arr)

    def __repr__(self):
        return "%s(%s)" % (type(self).__name__, self._kwargs)

    def dumps(self):
        """JSON [name, kwargs] (reference: Initializer.dumps for shipping
        initializers through kvstore / FusedRNN packing)."""
        import json
        return json.dumps([type(self).__name__.lower(), self._kwargs])


@register
class Uniform(Initializer):
    def __init__(self, scale=0.07):
        self._hp(scale=scale)

    def _init_weight(self, _, arr):
        self._set(arr, _np.random.uniform(-self.scale, self.scale,
                                          arr.shape))


@register
class Normal(Initializer):
    def __init__(self, sigma=0.01):
        self._hp(sigma=sigma)

    def _init_weight(self, _, arr):
        self._set(arr, _np.random.normal(0.0, self.sigma, arr.shape))


@register
class Constant(Initializer):
    def __init__(self, value=0.0):
        self._hp(value=value)

    def _init_weight(self, _, arr):
        self._set(arr, _np.full(arr.shape, self.value))

    # a Constant means "this exact value", regardless of parameter role
    _init_default = _init_weight
    _init_bias = _init_weight
    _init_gamma = _init_weight
    _init_beta = _init_weight


@register
class One(Constant):
    def __init__(self):
        self._hp()
        self.value = 1.0


@register
class Zero(Constant):
    def __init__(self):
        self._hp()
        self.value = 0.0


@register
class Orthogonal(Initializer):
    def __init__(self, scale=1.414, rand_type="uniform"):
        self._hp(scale=scale, rand_type=rand_type)

    def _init_weight(self, _, arr):
        nout = arr.shape[0]
        nin = int(_np.prod(arr.shape[1:])) if len(arr.shape) > 1 else 1
        draw = (_np.random.uniform(-1.0, 1.0, (nout, nin))
                if self.rand_type == "uniform"
                else _np.random.normal(0.0, 1.0, (nout, nin)))
        u, _s, v = _np.linalg.svd(draw, full_matrices=False)
        q = u if u.shape == (nout, nin) else v
        self._set(arr, (self.scale * q).reshape(arr.shape))


@register
class Xavier(Initializer):
    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        self._hp(rnd_type=rnd_type, factor_type=factor_type,
                 magnitude=float(magnitude))

    def _init_weight(self, _, arr):
        shape = arr.shape
        if len(shape) < 2:
            raise ValueError("Xavier requires >= 2D weight")
        rf = float(_np.prod(shape[2:])) if len(shape) > 2 else 1.0
        fan_in, fan_out = shape[1] * rf, shape[0] * rf
        factor = {"avg": (fan_in + fan_out) / 2.0, "in": fan_in,
                  "out": fan_out}[self.factor_type]
        scale = math.sqrt(self.magnitude / factor)
        draw = (_np.random.uniform(-scale, scale, shape)
                if self.rnd_type == "uniform"
                else _np.random.normal(0, scale, shape))
        self._set(arr, draw)


@register
class MSRAPrelu(Xavier):
    def __init__(self, factor_type="avg", slope=0.25):
        super().__init__("gaussian", factor_type, 2.0 / (1 + slope ** 2))
        self._kwargs = {"factor_type": factor_type, "slope": slope}
