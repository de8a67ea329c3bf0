"""Slot-granular dense KV cache for autoregressive decode.

Counterpart of ``incubator_mxnet_tpu/serving/kv_cache.py``: a fixed grid of
``slots`` sequences over entries declared by a spec dict ``name -> (kind,
shape[, dtype])``:

- ``("state", shape)``: one tensor per slot, REPLACED each step; storage
  ``(slots,) + shape``;
- ``("kv", per_step_shape)``: per-position append buffers; storage
  ``(slots, max_len) + per_step_shape``. `append` writes at the slot's
  current length and `advance` commits the position.

The storage is torch tensors on the cache's device. ``generate/paged_kv.py``
(PagedKVCache) mirrors this exact surface and its error messages over a
shared block pool, so the DecodeLoop cannot tell the two apart. ``alloc`` as
a request joins the in-flight batch, ``free`` the moment it retires. The
cache registers itself for the memory plane's KV census
(``telemetry.memz``), which reads its device bytes.
"""

import numpy as np
import torch

from ..context import resolve_device
from ..telemetry import memz as _memz

__all__ = ["KVCache"]

_KINDS = ("state", "kv")


def _torch_dtype(dtype):
    """The torch dtype of a spec's dtype field: a torch dtype, a numpy
    dtype or its name (``"float16"`` is torch.float16). ``"bfloat16"`` (or
    ml_dtypes' numpy type, by its name) is torch.bfloat16 without importing
    ml_dtypes."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if getattr(dtype, "__name__", None) == "bfloat16" \
            or str(dtype) == "bfloat16":
        return torch.bfloat16
    return torch.from_numpy(np.zeros(0, np.dtype(dtype))).dtype


class KVCache:
    """Not thread-safe by itself: the decode loop is the single owner
    (requests never touch the cache directly). ``device=None`` is ``cuda:0``
    and raises without CUDA; pass ``device="cpu"`` for the host. ``name``
    labels it in the KV census."""

    def __init__(self, slots, spec, max_len=512, device=None,
                 name="default"):
        if slots < 1:
            raise ValueError("need at least one slot, got %r" % slots)
        self.device = resolve_device(device)
        self.name = name
        self.slots = int(slots)
        self.max_len = int(max_len)
        self.spec = {}
        self.data = {}
        with torch.inference_mode(False):
            for name, ent in spec.items():
                kind, shape = ent[0], tuple(ent[1])
                dtype = _torch_dtype(ent[2] if len(ent) > 2 else np.float32)
                if kind not in _KINDS:
                    raise ValueError("entry %r: kind must be one of %s, got "
                                     "%r" % (name, _KINDS, kind))
                full = ((self.slots,) + shape if kind == "state"
                        else (self.slots, self.max_len) + shape)
                self.spec[name] = (kind, shape, dtype)
                self.data[name] = torch.zeros(full, dtype=dtype,
                                              device=self.device)
        self.lengths = np.zeros(self.slots, np.int64)
        self._free = list(range(self.slots - 1, -1, -1))
        self._live = set()
        _memz.register_kv_cache(self)

    # ------------------------------------------------------------- slots
    @property
    def in_use(self):
        return len(self._live)

    def alloc(self):
        """Claim a zeroed slot; None when the grid is full."""
        if not self._free:
            return None
        slot = self._free.pop()
        self._live.add(slot)
        self.lengths[slot] = 0
        for name in self.spec:
            self.data[name][slot] = 0
        return slot

    def free(self, slot):
        if slot not in self._live:
            raise ValueError("slot %r is not live" % slot)
        self._live.remove(slot)
        self._free.append(slot)

    # ------------------------------------------------------------ access
    def _check(self, slot):
        if slot not in self._live:
            raise ValueError("slot %r is not live" % slot)

    def _value(self, value, shape, dtype):
        return torch.as_tensor(value, dtype=dtype,
                               device=self.device).reshape(shape)

    def set_state(self, name, slot, value):
        kind, shape, dtype = self.spec[name]
        if kind != "state":
            raise ValueError("%r is a %r entry, not state" % (name, kind))
        self._check(slot)
        self.data[name][slot] = self._value(value, shape, dtype)

    def state(self, name, slot):
        self._check(slot)
        return self.data[name][slot]

    def append(self, name, slot, value):
        """Write `value` at this slot's current position (all kv entries
        share the position counter; call `advance` once per step after every
        entry is written)."""
        kind, shape, dtype = self.spec[name]
        if kind != "kv":
            raise ValueError("%r is a %r entry, not kv" % (name, kind))
        self._check(slot)
        pos = int(self.lengths[slot])
        if pos >= self.max_len:
            raise ValueError("slot %d is full (max_len=%d)"
                             % (slot, self.max_len))
        self.data[name][slot, pos] = self._value(value, shape, dtype)

    def advance(self, slot):
        self._check(slot)
        self.lengths[slot] += 1

    def prefix(self, name, slot):
        """The filled (length, ...) view of a kv entry for one slot."""
        kind = self.spec[name][0]
        if kind != "kv":
            raise ValueError("%r is a %r entry, not kv" % (name, kind))
        self._check(slot)
        return self.data[name][slot, :int(self.lengths[slot])]
