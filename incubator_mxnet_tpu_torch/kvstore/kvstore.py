"""KVStore — key/tensor parameter synchronization, local types only.

Counterpart of ``incubator_mxnet_tpu/kvstore/kvstore.py`` for ``"local"``
and ``"device"`` (one process, one device: the reduce is a sum of the
pushed values). ``pull`` copies into its ``out`` arrays in place, so a
parameter pulled into keeps the tensor its module reads. The dist types,
store-side optimizers (``set_optimizer``, the ``update_on_kvstore`` path),
gradient compression and row-sparse pulls wait for the scale-out slice and
the sparse NDArray (ROADMAP Queue 1 items 12 and 4) and raise.
"""

import torch

from ..ndarray import NDArray

__all__ = ["KVStore", "KVStoreLocal", "KVStoreDevice", "create"]


def create(name="local"):
    """Factory (reference: kvstore.cc:40-72)."""
    name = name.lower()
    if name in ("local", "local_update_cpu", "local_allreduce_cpu"):
        return KVStoreLocal("local")
    if name in ("device", "local_allreduce_device", "nccl"):
        return KVStoreDevice("device")
    if name.startswith("dist"):
        raise NotImplementedError("kvstore %r is not ported yet (ROADMAP "
                                  "Queue 1 item 12)" % name)
    raise ValueError("unknown kvstore type %r" % name)


class KVStore:
    """Single-process store; base of local/device."""

    def __init__(self, name="local"):
        self._type = name
        self._store = {}

    # -- identity ------------------------------------------------------------
    @property
    def type(self):
        return self._type

    @property
    def is_dist(self):
        return False

    @property
    def rank(self):
        return 0

    @property
    def num_workers(self):
        return 1

    def barrier(self):
        pass

    # -- config --------------------------------------------------------------
    def set_gradient_compression(self, compression_params):
        raise NotImplementedError("gradient compression is not ported yet "
                                  "(ROADMAP Queue 1 item 12)")

    def set_optimizer(self, optimizer):
        raise NotImplementedError("store-side optimizers (update_on_kvstore) "
                                  "are not ported yet (ROADMAP Queue 1 item "
                                  "12)")

    # -- data plane ----------------------------------------------------------
    def init(self, key, value):
        if isinstance(key, (list, tuple)):
            for k, v in zip(key, value):
                self.init(k, v)
            return
        self._store[key] = NDArray(value._t)

    def push(self, key, value, priority=0):
        if isinstance(key, (list, tuple)):
            for k, v in zip(key, value):
                self.push(k, v, priority)
            return
        if isinstance(value, (list, tuple)):
            agg = value[0]._t
            for v in value[1:]:
                agg = agg + v._t
        else:
            agg = value._t
        self._store[key] = NDArray(agg)

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        if isinstance(key, (list, tuple)):
            for k, o in zip(key, out):
                self.pull(k, out=o, priority=priority)
            return None
        value = self._store[key]
        if out is None:
            return NDArray(value._t)
        for o in (out if isinstance(out, (list, tuple)) else [out]):
            if o._t is not value._t:
                with torch.no_grad():
                    o._t.copy_(value._t)
        return None

    def pushpull(self, key, value, out=None, priority=0):
        self.push(key, value, priority)
        self.pull(key, out=out if out is not None else value,
                  priority=priority)

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        raise NotImplementedError("row_sparse_pull is not ported yet "
                                  "(ROADMAP Queue 1 item 4)")


class KVStoreLocal(KVStore):
    """The reference's CPU-reduce variant; the same sum here."""


class KVStoreDevice(KVStore):
    """The reference's device-reduce variant; the same sum here."""
