"""Block / HybridBlock — the Gluon model API of the PyTorch port.

Counterpart of ``incubator_mxnet_tpu/gluon/block.py``: ``_BlockScope``
naming (``prefix``, ``name_scope``, global per-alias counters, so a prefix
such as ``resnetv10_`` depends on what was built before in the process),
``collect_params(select)``, ``initialize``, ``_collect_params_with_prefix``,
``save_parameters`` / ``load_parameters``, forward hooks and ``summary``.

A Block is a ``torch.nn.Module``: its children are registered in
``_modules`` under their gluon names and its Parameters, once their shapes
are known, in ``_parameters`` (weights) or ``_buffers`` (auxiliary state),
so ``named_parameters()``-based code (``parallel.ShardedTrainer``,
``params_from_jax``) works on a gluon net. ``Block.__call__`` is gluon's
(forward hooks of ``register_forward_hook``), not torch's.

A HybridBlock's forward runs ``hybrid_forward(F, x, ..., **params)`` with
``F`` the ``nd`` namespace. Called with NDArrays, the parameters come as
NDArrays and every operation is recorded under ``autograd.record()``;
called with tensors, they come as tensors and the operations run as plain
PyTorch (the ``ShardedTrainer`` path). A parameter whose shape is still
deferred is completed by the layer's ``_shape_hook`` from the input, as in
the JAX package. Layers read the training flag from
``autograd.is_training()``, not from ``nn.Module.training``.

``hybridize()`` keeps its API and runs the block eagerly, giving the same
numbers; the compiled form (a per-shape cache, such as a CUDA graph, in
place of the JAX package's jitted program) is ROADMAP Queue 1 item 6.
``export`` and ``SymbolBlock`` wait for the symbol frontend (item 10).
"""

import re
import threading
import weakref

import torch

from .. import autograd as _ag
from .. import ndarray as nd
from ..ndarray import NDArray
from .parameter import DeferredInitializationError, Parameter, ParameterDict

__all__ = ["Block", "HybridBlock"]


# ---------------------------------------------------------------------------
# naming (reference: _BlockScope)
# ---------------------------------------------------------------------------

class _BlockScope:
    _current = threading.local()
    _counters = {}

    def __init__(self, block):
        self._block = weakref.ref(block)
        self._counter = {}
        self._old_scope = None

    @staticmethod
    def create(prefix, params, hint):
        current = getattr(_BlockScope._current, "value", None)
        if current is None:
            if prefix is None:
                count = _BlockScope._counters.get(hint, 0)
                prefix = "%s%d_" % (hint, count)
                _BlockScope._counters[hint] = count + 1
            if params is None:
                params = ParameterDict(prefix)
            else:
                params = ParameterDict(params.prefix, params)
            return prefix, params
        block = current._block()
        if prefix is None:
            count = current._counter.get(hint, 0)
            prefix = "%s%d_" % (hint, count)
            current._counter[hint] = count + 1
        if params is None:
            parent = block.params
            params = ParameterDict(parent.prefix + prefix, parent._shared)
        else:
            params = ParameterDict(params.prefix, params)
        return block.prefix + prefix, params

    def __enter__(self):
        if self._block()._empty_prefix:
            return self
        self._old_scope = getattr(_BlockScope._current, "value", None)
        _BlockScope._current.value = self
        return self

    def __exit__(self, *args):
        if self._block()._empty_prefix:
            return False
        _BlockScope._current.value = self._old_scope
        return False


class _HookHandle:
    def __init__(self, hooks, hook):
        self._hooks, self._hook = hooks, hook

    def detach(self):
        if self._hook in self._hooks:
            self._hooks.remove(self._hook)

    remove = detach


# ---------------------------------------------------------------------------
# Block
# ---------------------------------------------------------------------------

class Block(torch.nn.Module):
    """Base class for all layers and models (eager ops)."""

    def __init__(self, prefix=None, params=None):
        torch.nn.Module.__init__(self)
        self._empty_prefix = prefix == ""
        self._prefix, self._params = _BlockScope.create(
            prefix, params, self._alias())
        self._name = self._prefix[:-1] if self._prefix.endswith("_") \
            else self._prefix
        self._scope = _BlockScope(self)
        self._children = {}
        self._reg_params = {}
        self._gluon_forward_hooks = []
        self._gluon_forward_pre_hooks = []

    def _alias(self):
        return self.__class__.__name__.lower()

    @property
    def prefix(self):
        return self._prefix

    @property
    def name(self):
        return self._name

    def name_scope(self):
        return self._scope

    @property
    def params(self):
        return self._params

    def __repr__(self):
        s = "{name}(\n{modstr}\n)"
        modstr = "\n".join("  ({key}): {block}".format(
            key=key, block=_indent(str(block), 2))
            for key, block in self._children.items())
        return s.format(name=self.__class__.__name__, modstr=modstr) \
            if self._children else self.__class__.__name__ + "()"

    def __setattr__(self, name, value):
        if isinstance(value, Parameter):
            reg = self.__dict__.get("_reg_params")
            if reg is not None:
                reg[name] = value
                value._add_owner(self, name)
                self._bind_param(name, value, value._tensor())
            object.__setattr__(self, name, value)
            return
        if isinstance(value, Block):
            children = self.__dict__.get("_children")
            if children is not None:
                children[name] = value
        super().__setattr__(name, value)

    def _bind_param(self, attr, param, tensor):
        """Register ``param``'s tensor (None while its shape is deferred)
        in torch's ``_parameters`` or ``_buffers`` under ``attr``."""
        slot, other = (self._buffers, self._parameters) if param._aux \
            else (self._parameters, self._buffers)
        other.pop(attr, None)
        slot[attr] = tensor

    def _apply(self, fn, *args, **kwargs):
        # .to(), .double(), .cuda(): the Parameters follow the new tensors
        out = super()._apply(fn, *args, **kwargs)
        for attr, p in self._reg_params.items():
            slot = self._buffers if p._aux else self._parameters
            p._adopt(slot.get(attr))
        return out

    def register_child(self, block, name=None):
        name = name or str(len(self._children))
        self._children[name] = block
        self._modules[name] = block

    def register_forward_hook(self, hook):
        """``hook(block, args, out)`` after every call."""
        self._gluon_forward_hooks.append(hook)
        return _HookHandle(self._gluon_forward_hooks, hook)

    def register_forward_pre_hook(self, hook):
        """``hook(block, args)`` before every call."""
        self._gluon_forward_pre_hooks.append(hook)
        return _HookHandle(self._gluon_forward_pre_hooks, hook)

    def collect_params(self, select=None):
        ret = ParameterDict(self._params.prefix)
        if not select:
            ret.update(self.params)
        else:
            pattern = re.compile(select)
            ret._params.update(
                {name: value for name, value in self.params.items()
                 if pattern.match(name)})
        for child in self._children.values():
            sub = child.collect_params(select)
            if not select:
                ret.update(sub)
            else:
                ret._params.update(sub._params)
        return ret

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        """Initialize every parameter on ``ctx`` (None is ``cuda:0``);
        parameters of deferred shape draw at the first forward."""
        self.collect_params().initialize(init, ctx, verbose, force_reinit)

    def hybridize(self, active=True, **kwargs):
        for child in self._children.values():
            child.hybridize(active, **kwargs)

    def cast(self, dtype):
        for child in self._children.values():
            child.cast(dtype)
        for _, param in self.params.items():
            param.cast(dtype)
        for _, param in self._reg_params.items():
            param.cast(dtype)

    def zero_grad(self, set_to_none=None):
        """Zero every parameter's gradient buffer (gluon's meaning)."""
        self.collect_params().zero_grad()

    # -- checkpoint ----------------------------------------------------------
    def save_parameters(self, filename, deduplicate=False):
        params = self._collect_params_with_prefix()
        from ..ndarray import save as nd_save
        nd_save(filename, {k: v.data() for k, v in params.items()})

    def load_parameters(self, filename, ctx=None, allow_missing=False,
                        ignore_extra=False, cast_dtype=False,
                        dtype_source="current"):
        from ..ndarray import load as nd_load
        from .parameter import _first_ctx
        loaded = nd_load(filename)
        params = self._collect_params_with_prefix()
        if not allow_missing:
            for name in params:
                if name not in loaded:
                    raise IOError("Parameter %s is missing in file %s"
                                  % (name, filename))
        for name, value in loaded.items():
            if name not in params:
                if not ignore_extra:
                    raise IOError("Parameter %s in file %s is not present "
                                  "in this Block" % (name, filename))
                continue
            p = params[name]
            if p._data is None and ctx is not None:
                p._ctx = _first_ctx(ctx)
            p.set_data(value)

    # older API names kept for reference-script compatibility
    save_params = save_parameters

    def load_params(self, filename, ctx=None, **kwargs):
        self.load_parameters(filename, ctx=ctx, **kwargs)

    def _collect_params_with_prefix(self, prefix=""):
        if prefix:
            prefix += "."
        ret = {prefix + key: val for key, val in self._reg_params.items()}
        for name, child in self._children.items():
            ret.update(child._collect_params_with_prefix(prefix + name))
        return ret

    # -- forward -------------------------------------------------------------
    def __call__(self, *args, **kwargs):
        for hook in self._gluon_forward_pre_hooks:
            hook(self, args)
        out = self.forward(*args, **kwargs)
        for hook in self._gluon_forward_hooks:
            hook(self, args, out)
        return out

    def forward(self, *args, **kwargs):
        raise NotImplementedError

    def summary(self, *inputs):
        """Print a per-layer summary (reference: block.py summary)."""
        rows = []

        def walk(block, path):
            n_params = 0
            for p in block._reg_params.values():
                if p.shape is not None:
                    size = 1
                    for s in p.shape:
                        size *= s
                    n_params += size
            rows.append((path or block.name, type(block).__name__, n_params))
            for cname, child in block._children.items():
                walk(child, (path + "." if path else "") + cname)

        out = self(*inputs)
        walk(self, "")
        total = sum(r[2] for r in rows)
        lines = ["%-40s %-20s %12s" % ("Layer", "Type", "Params"), "-" * 74]
        lines += ["%-40s %-20s %12d" % r for r in rows]
        lines += ["-" * 74, "Total params: %d" % total]
        print("\n".join(lines))
        return out


def _indent(s, num_spaces):
    lines = s.split("\n")
    first = lines.pop(0)
    return first + ("\n" + "\n".join(" " * num_spaces + line
                                     for line in lines) if lines else "")


# ---------------------------------------------------------------------------
# HybridBlock
# ---------------------------------------------------------------------------

class HybridBlock(Block):
    """A Block written as ``hybrid_forward(F, x, ...)``; ``hybridize()``
    runs it eagerly in this port."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._active = False
        self._flags = {}

    def hybridize(self, active=True, **kwargs):
        self._active = active
        self._flags = kwargs
        super().hybridize(active, **kwargs)

    def infer_shape(self, *args):
        """Finish deferred parameter shapes from example inputs (NDArrays
        or tensors): one forward without recording, in predict mode."""
        pending = [p for p in self.collect_params().values()
                   if p._data is None and p._deferred_init is not None]
        if not pending:
            return
        with _ag.pause(), torch.no_grad():
            self.forward(*args)
        still = [p.name for p in self.collect_params().values()
                 if p._data is None and p._deferred_init is not None]
        if still:
            raise DeferredInitializationError(
                "Could not infer shapes for %s" % still)

    def _shape_hook(self, *args):
        """Per-layer deferred-shape rule; default: nothing to infer."""

    def _param_values(self, nd_mode):
        """NDArrays in nd mode; on tensors, what torch's registry holds
        under each name (``_parameters``/``_buffers``), where a caller may
        have put stand-ins for the step (a trainer's bf16 casts)."""
        vals = {}
        for ln, p in self._reg_params.items():
            d = p.data()
            vals[ln] = d if nd_mode else \
                (self._buffers if p._aux else self._parameters)[ln]
        return vals

    def forward(self, *args, **extra):
        nd_mode = any(isinstance(a, NDArray) for a in args)
        try:
            kwargs = self._param_values(nd_mode)
        except DeferredInitializationError:
            self._shape_hook(*args)
            kwargs = self._param_values(nd_mode)
        return self.hybrid_forward(nd, *args, **{**extra, **kwargs})

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError

    def export(self, path, epoch=0):
        raise NotImplementedError("HybridBlock.export: the symbol frontend "
                                  "is not ported yet (ROADMAP Queue 1 item "
                                  "10)")
