"""The NDArray class of the PyTorch port, and the npz container of
``nd.save`` / ``nd.load``.

Counterpart of ``incubator_mxnet_tpu/ndarray/ndarray.py``. An NDArray is a
thin wrapper over one ``torch.Tensor`` (``_t``): arithmetic, indexing,
``reshape``, ``astype``, ``asnumpy``, ``sum`` / ``mean``, ``copyto``,
``context``, ``wait_to_read``, and ``attach_grad`` / ``grad`` /
``backward``. Every operation runs under
``torch.set_grad_enabled(autograd.is_recording())``: inside
``autograd.record()`` it is recorded by torch autograd, outside it builds no
graph. ``nd.array`` / ``zeros`` / ``ones`` / ``empty`` / ``full`` /
``arange`` take ``ctx`` (a device); ``ctx=None`` is ``cuda:0`` and raises
without CUDA (``context.resolve_device``). The op functions of the ``nd``
namespace are generated from the op registry (``ndarray/register.py``).

``save`` / ``load`` are the npz format only, not the reference's dmlc
binary. The file is an uncompressed npz with a ``__mxtpu_format__`` entry,
``"dict"`` or ``"list"``; a list is stored as ``arr_0``, ``arr_1``, ... .
bfloat16 rides as uint16 under a key ending in ``::bf16``. Files written
here load in the JAX package and the other way round. ``save`` takes
NDArrays, tensors (any device) or array-likes; ``load`` returns CPU
tensors.
"""

import os

import numpy as np
import torch

from .. import autograd as _ag
from ..base import dtype_torch
from ..context import resolve_device

__all__ = ["NDArray", "array", "empty", "zeros", "ones", "full", "arange",
           "save", "load", "waitall", "invoke"]

_NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64,
              torch.float16: np.float16, torch.uint8: np.uint8,
              torch.int8: np.int8, torch.int16: np.int16,
              torch.int32: np.int32, torch.int64: np.int64,
              torch.bool: np.bool_}


def _unwrap(x):
    return x._t if isinstance(x, NDArray) else x


def _wrap(out):
    if isinstance(out, (tuple, list)):
        return tuple(_wrap(o) for o in out)
    return NDArray(out) if isinstance(out, torch.Tensor) else out


def invoke(fn, *args, **kwargs):
    """``fn`` over the tensors of NDArray arguments (positional and
    keyword), recorded iff ``autograd.is_recording()``; tensor results come
    back as NDArrays."""
    args = [_unwrap(a) for a in args]
    kwargs = {k: _unwrap(v) for k, v in kwargs.items()}
    with torch.set_grad_enabled(_ag.is_recording()):
        return _wrap(fn(*args, **kwargs))


def _as_tensor(value, like):
    """A scalar, array-like or NDArray as an operand beside tensor
    ``like``."""
    if isinstance(value, NDArray):
        return value._t
    if isinstance(value, (np.ndarray, list, tuple)):
        return torch.as_tensor(np.asarray(value), device=like.device)
    return value


def _mx_shape(old, new, reverse=False):
    """MXNet's reshape codes 0 (keep this axis) and -1 (infer); with
    ``reverse`` both shapes are read from the right, as the reference's
    ``Reshape`` op reads them."""
    for s in new:
        if s < -1:
            raise NotImplementedError("reshape code %d is not ported yet "
                                      "(ROADMAP Queue 1 item 4)" % s)
    src = list(old)[::-1] if reverse else list(old)
    tgt = list(new)[::-1] if reverse else list(new)
    out = [src[i] if s == 0 else s for i, s in enumerate(tgt)]
    return tuple(out[::-1] if reverse else out)


#: dtypes that jnp.sum (x64 off) sums into int32
_INT32_SUMS = (torch.bool, torch.int8, torch.int16, torch.int32)


def _floating(t):
    """``t`` itself if floating, else as float32 (jnp's mean and sqrt)."""
    return t if t.is_floating_point() else t.float()


def _axes(axis, ndim, exclude=False):
    """The dims a reduction over ``axis`` takes. As the reference's
    ``_reduce`` reads it, ``exclude`` applies only when an axis is given:
    ``axis=None`` reduces every axis."""
    if axis is None:
        return tuple(range(ndim))
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    axes = tuple(a % ndim for a in axes)
    if exclude:
        axes = tuple(a for a in range(ndim) if a not in axes)
    return axes


def _flip_negative_steps(key, t):
    """(key, dims): torch indexing refuses a slice with a negative step, as
    jnp indexing does not. Each such slice over dim d becomes the slice that
    selects the same elements, in the same order, of ``t.flip(d)``; ``dims``
    lists the dims to flip (empty when the key has no negative step)."""
    parts = list(key) if isinstance(key, tuple) else [key]
    if not any(isinstance(k, slice) and k.step is not None and k.step < 0
               for k in parts):
        return key, ()

    def width(k):          # the dims of t that one key entry consumes
        if k is None or k is Ellipsis:
            return 0
        if isinstance(k, torch.Tensor) and k.dtype == torch.bool:
            return k.dim()
        return 1

    rest = t.dim() - sum(width(k) for k in parts)
    dims, d = [], 0
    for i, k in enumerate(parts):
        if k is Ellipsis:
            d += rest
        elif isinstance(k, slice) and k.step is not None and k.step < 0:
            n = t.shape[d]
            start, stop, step = k.indices(n)
            # element n - 1 - j of the flipped dim is element j of t
            parts[i] = slice(n - 1 - start, n - 1 - stop, -step)
            dims.append(d)
            d += 1
        else:
            d += width(k)
    return (tuple(parts) if isinstance(key, tuple) else parts[0]), tuple(dims)


class NDArray:
    """An n-dimensional array on a device: one ``torch.Tensor``."""

    __array_priority__ = 1000.0

    def __init__(self, data, ctx=None, dtype=None):
        if isinstance(data, NDArray):
            data = data._t
        if not isinstance(data, torch.Tensor):
            data = torch.as_tensor(np.asarray(data))
        if dtype is not None:
            data = data.to(dtype_torch(dtype))
        if ctx is not None:
            data = data.to(resolve_device(ctx))
        self._t = data
        self._grad = None        # NDArray gradient buffer (leaf only)
        self._grad_req = None

    # ------------------------------------------------------------------ meta
    @property
    def shape(self):
        return tuple(self._t.shape)

    @property
    def dtype(self):
        if self._t.dtype == torch.bfloat16:
            return "bfloat16"
        return np.dtype(_NP_DTYPES[self._t.dtype])

    @property
    def size(self):
        return self._t.numel()

    @property
    def ndim(self):
        return self._t.dim()

    @property
    def context(self):
        return self._t.device

    ctx = context

    @property
    def stype(self):
        return "default"

    @property
    def grad(self):
        return self._grad

    @property
    def _node(self):
        """The recorded operation that produced this array (its tensor's
        ``grad_fn``), None outside ``autograd.record()``."""
        return self._t.grad_fn

    def __len__(self):
        return self.shape[0]

    def __repr__(self):
        return "\n%s\n<NDArray %s @%s>" % (
            self.asnumpy(), "x".join(str(s) for s in self.shape),
            self.context)

    __str__ = __repr__

    def __bool__(self):
        if self.size != 1:
            raise ValueError("The truth value of an NDArray with multiple "
                             "elements is ambiguous.")
        return bool(self._t)

    def __float__(self):
        return float(self._t)

    def __int__(self):
        return int(self._t)

    def __hash__(self):
        return id(self)

    # ---------------------------------------------------------------- export
    def asnumpy(self):
        """A numpy copy on the host (bfloat16 comes back as float32)."""
        t = self._t.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()

    def asscalar(self):
        if self.size != 1:
            raise ValueError("The current array is not a scalar")
        return self.asnumpy().reshape(())[()]

    def item(self):
        return self.asscalar()

    def astype(self, dtype, copy=True):
        dt = dtype_torch(dtype)
        if not copy and self._t.dtype == dt:
            return self
        return invoke(lambda t: t.to(dt), self)

    def copy(self):
        return NDArray(self._t.detach().clone())

    def copyto(self, other):
        """Copy into the NDArray ``other`` (in place) or onto a device."""
        if isinstance(other, NDArray):
            with torch.no_grad():
                if other.shape == self.shape:
                    other._t.copy_(self._t)
                else:
                    other._t = self._t.detach().to(other.context).clone()
            return other
        if isinstance(other, (torch.device, str)):
            return NDArray(self._t.detach().to(resolve_device(other)).clone())
        raise TypeError("copyto does not support type %s" % type(other))

    def as_in_context(self, context):
        dev = resolve_device(context)
        if dev == self.context:
            return self
        return NDArray(self._t.detach().to(dev))

    as_in_ctx = as_in_context

    def wait_to_read(self):
        if self._t.is_cuda:
            torch.cuda.current_stream(self._t.device).synchronize()

    wait_to_write = wait_to_read

    def detach(self):
        return NDArray(self._t.detach())

    # ------------------------------------------------------------- autograd
    def attach_grad(self, grad_req="write", stype=None):
        """Mark as an autograd leaf with a zero gradient buffer."""
        if stype not in (None, "default"):
            raise NotImplementedError("attach_grad(stype=%r): sparse "
                                      "gradients are not ported yet (ROADMAP "
                                      "Queue 1 item 4)" % stype)
        self._mark_variable(None, grad_req)

    def _mark_variable(self, grad, grad_req):
        if grad_req not in ("write", "add", "null"):
            raise ValueError("grad_req must be write, add or null, not %r"
                             % (grad_req,))
        if self._t.grad_fn is not None:
            self._t = self._t.detach()
        self._grad_req = grad_req
        if grad_req == "null":
            self._grad = None
            self._t.requires_grad_(False)
            return
        if self._t.is_floating_point():   # integers take no gradient
            self._t.requires_grad_(True)
        self._grad = grad if grad is not None else NDArray(
            torch.zeros(self.shape, dtype=self._t.dtype,
                        device=self._t.device))
        _ag._register_leaf(self)

    def _accumulate_grad(self, g, create_graph=False):
        """Write (or, for grad_req "add", add) the gradient ``g``."""
        buf = self._grad
        if create_graph:
            self._grad = NDArray(buf._t + g if self._grad_req == "add"
                                 else g)
            return
        with torch.no_grad():
            if self._grad_req == "add":
                buf._t.add_(g)
            else:
                buf._t.copy_(g)

    def backward(self, out_grad=None, retain_graph=False, train_mode=True,
                 create_graph=False):
        _ag.backward([self], [out_grad] if out_grad is not None else None,
                     retain_graph=retain_graph, train_mode=train_mode,
                     create_graph=create_graph)

    # ------------------------------------------------------------- indexing
    @staticmethod
    def _key(key):
        def one(k):
            if isinstance(k, NDArray):
                k = k._t
            if isinstance(k, torch.Tensor) and k.is_floating_point():
                k = k.long()
            return k
        return tuple(one(k) for k in key) if isinstance(key, tuple) \
            else one(key)

    def __getitem__(self, key):
        key, flips = _flip_negative_steps(self._key(key), self._t)
        if flips:
            return invoke(lambda t: t.flip(flips)[key], self)
        return invoke(lambda t: t[key], self)

    def __setitem__(self, key, value):
        key, flips = _flip_negative_steps(self._key(key), self._t)
        with torch.no_grad():
            if not flips:
                self._t[key] = _as_tensor(value, self._t)
                return
            flipped = self._t.flip(flips)
            flipped[key] = _as_tensor(value, self._t)
            self._t.copy_(flipped.flip(flips))

    # ------------------------------------------------------------ arithmetic
    def _binary(self, other, fn, reverse=False):
        o = _as_tensor(other, self._t)
        if reverse:
            return invoke(lambda t: fn(o, t), self)
        return invoke(lambda t: fn(t, o), self)

    def __add__(self, other):
        return self._binary(other, torch.add)

    __radd__ = __add__

    def __sub__(self, other):
        return self._binary(other, torch.sub)

    def __rsub__(self, other):
        return self._binary(other, lambda a, b: a - b, reverse=True)

    def __mul__(self, other):
        return self._binary(other, torch.mul)

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._binary(other, lambda a, b: a / b)

    def __rtruediv__(self, other):
        return self._binary(other, lambda a, b: a / b, reverse=True)

    def __pow__(self, other):
        return self._binary(other, lambda a, b: a ** b)

    def __rpow__(self, other):
        return self._binary(other, lambda a, b: a ** b, reverse=True)

    def __neg__(self):
        return invoke(torch.neg, self)

    def __abs__(self):
        return invoke(torch.abs, self)

    def _inplace(self, out):
        self._t = out._t
        return self

    def __iadd__(self, other):
        return self._inplace(self.__add__(other))

    def __isub__(self, other):
        return self._inplace(self.__sub__(other))

    def __imul__(self, other):
        return self._inplace(self.__mul__(other))

    def __itruediv__(self, other):
        return self._inplace(self.__truediv__(other))

    def _cmp(self, other, fn):
        o = _as_tensor(other, self._t)
        with torch.no_grad():
            return NDArray(fn(self._t, o).to(self._t.dtype))

    def __eq__(self, other):
        return self._cmp(other, torch.eq)

    def __ne__(self, other):
        return self._cmp(other, torch.ne)

    def __gt__(self, other):
        return self._cmp(other, torch.gt)

    def __ge__(self, other):
        return self._cmp(other, torch.ge)

    def __lt__(self, other):
        return self._cmp(other, torch.lt)

    def __le__(self, other):
        return self._cmp(other, torch.le)

    # --------------------------------------------------- method-style op API
    def reshape(self, *shape, **kwargs):
        if len(shape) == 1 and isinstance(shape[0], (list, tuple)):
            shape = tuple(shape[0])
        shape = shape or tuple(kwargs.get("shape", ()))
        new = _mx_shape(self.shape, shape, kwargs.get("reverse", False))
        return invoke(lambda t: t.reshape(new), self)

    def flatten(self):
        return invoke(lambda t: t.reshape(t.shape[0], -1), self)

    def sum(self, axis=None, keepdims=False, exclude=False):
        dims = _axes(axis, self.ndim, exclude)
        # jnp.sum sums bool and signed integers of up to 32 bits in int32
        acc = torch.int32 if self._t.dtype in _INT32_SUMS else None
        # (torch reads dim=() as every dim; axis=() reduces none)
        return invoke(lambda t: t.sum(dim=dims, keepdim=keepdims, dtype=acc)
                      if dims else t.to(acc or t.dtype), self)

    def mean(self, axis=None, keepdims=False, exclude=False):
        dims = _axes(axis, self.ndim, exclude)
        # jnp.mean of an integer or bool array is float32
        return invoke(lambda t: _floating(t).mean(dim=dims, keepdim=keepdims)
                      if dims else _floating(t), self)

    def max(self, axis=None, keepdims=False):
        dims = _axes(axis, self.ndim)
        return invoke(lambda t: t.amax(dim=dims, keepdim=keepdims), self)

    def norm(self):
        if self._t.is_floating_point():
            return invoke(torch.linalg.vector_norm, self)
        # the reference's sqrt(sum(square(x))): an integer sum of squares,
        # then a float32 square root
        return invoke(lambda t: torch.sqrt(
            (t * t).sum(dtype=torch.int32 if t.dtype in _INT32_SUMS
                        else None).float()), self)

    def softmax(self, axis=-1):
        from . import softmax
        return softmax(self, axis=axis)

    def log_softmax(self, axis=-1):
        from . import log_softmax
        return log_softmax(self, axis=axis)

    def pick(self, index, axis=-1, keepdims=False):
        from . import pick
        return pick(self, index, axis=axis, keepdims=keepdims)


# ---------------------------------------------------------------------------
# creation
# ---------------------------------------------------------------------------

def _shape(shape):
    return tuple(shape) if hasattr(shape, "__len__") else (shape,)


def array(source_array, ctx=None, dtype=None):
    """An NDArray holding a copy of ``source_array`` on ``ctx``. Without a
    dtype, Python lists and scalars become float32, float64 float32 and
    int64 int32, as in the JAX package."""
    from_python = isinstance(source_array, (list, tuple, int, float))
    if isinstance(source_array, NDArray):
        source_array = source_array._t
    if isinstance(source_array, torch.Tensor):
        src = source_array.detach()
    else:
        src = torch.as_tensor(np.asarray(source_array))
    t = src
    if dtype is not None:
        t = t.to(dtype_torch(dtype))
    elif from_python and not t.is_floating_point():
        t = t.float()
    elif t.dtype == torch.float64:
        t = t.float()
    elif t.dtype == torch.int64:
        t = t.int()
    t = t.to(resolve_device(ctx))
    return NDArray(t.clone() if t is src else t)


def empty(shape, ctx=None, dtype=None):
    return zeros(shape, ctx=ctx, dtype=dtype)


def zeros(shape, ctx=None, dtype=None, **_kw):
    return NDArray(torch.zeros(_shape(shape), dtype=dtype_torch(dtype),
                               device=resolve_device(ctx)))


def ones(shape, ctx=None, dtype=None, **_kw):
    return NDArray(torch.ones(_shape(shape), dtype=dtype_torch(dtype),
                              device=resolve_device(ctx)))


def full(shape, val, ctx=None, dtype=None):
    return NDArray(torch.full(_shape(shape), val, dtype=dtype_torch(dtype),
                              device=resolve_device(ctx)))


def arange(start, stop=None, step=1.0, repeat=1, ctx=None, dtype=None):
    if stop is None:
        start, stop = 0, start
    t = torch.arange(start, stop, step, dtype=dtype_torch(dtype),
                     device=resolve_device(ctx))
    if repeat > 1:
        t = t.repeat_interleave(repeat)
    return NDArray(t)


def waitall():
    """Wait for all launched work (reference: MXNDArrayWaitAll)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


_BF16_TAG = "::bf16"


def _to_npz(v):
    """(key suffix, numpy array); bfloat16 is bit-cast to uint16."""
    if isinstance(v, NDArray):
        v = v._t
    if isinstance(v, torch.Tensor):
        t = v.detach().cpu()
        if t.dtype == torch.bfloat16:
            return _BF16_TAG, t.view(torch.int16).numpy().view(np.uint16)
        return "", t.numpy()
    if hasattr(v, "asnumpy"):
        v = v.asnumpy()
    a = np.asarray(v)
    if str(a.dtype) == "bfloat16":
        return _BF16_TAG, a.view(np.uint16)
    return "", a


def _from_npz(key, a):
    if key.endswith(_BF16_TAG):
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        return key[: -len(_BF16_TAG)], t.view(torch.bfloat16)
    return key, torch.from_numpy(np.array(a))


def save(fname, data):
    """Save a dict name -> array or a list of arrays (a single tensor is a
    one-element list)."""
    if isinstance(data, (torch.Tensor, NDArray)):
        data = [data]
    arrays = {}
    if isinstance(data, dict):
        for k, v in data.items():
            tag, a = _to_npz(v)
            if not tag and k.endswith(_BF16_TAG):
                raise ValueError(
                    "key %r ends with the reserved %r suffix but its value "
                    "is %s, not bfloat16 - rename the key"
                    % (k, _BF16_TAG, a.dtype))
            arrays[k + tag] = a
        fmt = "dict"
    else:
        for i, v in enumerate(data):
            tag, a = _to_npz(v)
            arrays["arr_%d%s" % (i, tag)] = a
        fmt = "list"
    np.savez(fname, __mxtpu_format__=fmt, **arrays)
    if not fname.endswith(".npz") and os.path.exists(fname + ".npz"):
        os.replace(fname + ".npz", fname)


def load(fname):
    """A dict name -> CPU tensor, or a list for a list file."""
    with np.load(fname, allow_pickle=False) as f:
        fmt = str(f["__mxtpu_format__"]) if "__mxtpu_format__" in f.files \
            else "dict"
        out = dict(_from_npz(k, f[k]) for k in f.files
                   if k != "__mxtpu_format__")
    if fmt == "list":
        return [out[k] for k in sorted(out, key=lambda k: int(k.split("_")[1]))]
    return out
