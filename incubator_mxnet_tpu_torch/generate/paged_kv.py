"""Paged KV cache: block-granular allocation behind the KVCache surface, with
the pools on the device.

Counterpart of ``incubator_mxnet_tpu/generate/paged_kv.py`` (PagedAttention,
Kwon et al., SOSP '23). kv entries live in a shared pool of ``num_blocks``
fixed-size blocks, and each slot holds a block table, the ordered list of
pool blocks its sequence occupies. The surface is a superset of
``serving/kv_cache.KVCache`` (alloc / free / append / advance / prefix /
set_state / state, with the same error messages), so the DecodeLoop runs on
either; the paged extras are ``pool``, ``table``, ``tables_array``,
``truncate``, ``blocks_in_use``, ``blocks_free`` and ``fragmentation``.

Where the JAX package keeps the pools in host numpy and hands them to every
forward, here each kv entry's pool is one contiguous tensor on the cache's
device, allocated once: a forward reads it in place, and the step writes its
new K and V into it with one indexed copy per pool (``extend`` maps the
positions, ``write_rows`` copies). The bookkeeping stays on the host:
lengths, block tables and the free lists. ``tables_array`` is built on the
host for the step to upload. A block taken from the free list is zeroed
across every kv entry before it is written, so a partial fill never exposes
a previous sequence's tail. The pools are made outside inference mode, so a
write in or out of ``torch.inference_mode()`` works.

State-kind entries stay dense ``(slots,) + shape``.

Telemetry as in the JAX package: every block-table change updates the pool
gauges (blocks in use and free, free fraction, peak, fragmentation) and the
memory plane's watermark; a pool below a tenth free leaves an
edge-triggered ``gen.kv_pool_pressure`` flight event; an exhausted pool
counts ``gen_kv_pool_exhausted`` and leaves memz's forensics before it
raises. The cache registers itself for memz's KV census, which reads the
pools' device bytes.
"""

import math
import os

import numpy as np
import torch

from ..context import resolve_device
from ..serving.kv_cache import _KINDS, _torch_dtype
from ..telemetry import catalog as _cat
from ..telemetry import flight as _flight
from ..telemetry import memz as _memz

__all__ = ["PagedKVCache", "KVPoolExhausted", "DEFAULT_BLOCK_SIZE"]

#: default block size (positions per block); MXTPU_GEN_BLOCK_SIZE
DEFAULT_BLOCK_SIZE = 16


def _env_int(name, default):
    """An integer setting from the environment: ``default`` when it is
    unset, empty or not an integer, as the JAX package reads its knobs."""
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


class KVPoolExhausted(ValueError):
    """An append found no free block in the paged pool: pressure, not a bug.
    The serving loop sheds the session as a capacity event on this type.
    Carries the pool geometry the handler reports."""

    def __init__(self, message, name=None, slot=None, block=None,
                 num_blocks=None, block_size=None):
        super().__init__(message)
        self.name = name
        self.slot = slot
        self.block = block
        self.num_blocks = num_blocks
        self.block_size = block_size


class PagedKVCache:
    """Drop-in paged replacement for ``serving.kv_cache.KVCache``.

    Not thread-safe by itself: the decode loop is the single owner.

    An argument wins over the environment, as in the JAX package:
    ``block_size=None`` reads ``MXTPU_GEN_BLOCK_SIZE`` (default 16), and
    ``num_blocks=None`` reads ``MXTPU_GEN_NUM_BLOCKS``, which oversubscribes
    every pool of the process; where that is unset or 0 the pool holds
    ``slots * ceil(max_len / block_size)`` blocks, full capacity parity with
    the dense grid. Size it smaller to oversubscribe (appends then raise
    ``KVPoolExhausted``). A kv entry's spec may carry its dtype third
    (``("kv", (H, D), "bfloat16")`` or ``"float16"``); the default is
    float32.
    ``device=None`` is ``cuda:0`` and raises without CUDA; pass
    ``device="cpu"`` for the host.
    """

    def __init__(self, slots, spec, max_len=512, block_size=None,
                 num_blocks=None, name="default", device=None):
        if slots < 1:
            raise ValueError("need at least one slot, got %r" % slots)
        self.device = resolve_device(device)
        self.slots = int(slots)
        self.max_len = int(max_len)
        self.block_size = int(block_size or
                              _env_int("MXTPU_GEN_BLOCK_SIZE",
                                       DEFAULT_BLOCK_SIZE))
        if self.block_size < 1:
            raise ValueError("block_size must be >= 1, got %r"
                             % self.block_size)
        self.max_blocks_per_slot = max(
            1, math.ceil(self.max_len / self.block_size))
        self.num_blocks = int(num_blocks or
                              _env_int("MXTPU_GEN_NUM_BLOCKS", 0) or
                              self.slots * self.max_blocks_per_slot)
        self.name = name
        self.spec = {}
        self.data = {}
        with torch.inference_mode(False):
            for ent_name, ent in spec.items():
                kind, shape = ent[0], tuple(ent[1])
                dtype = _torch_dtype(ent[2] if len(ent) > 2 else np.float32)
                if kind not in _KINDS:
                    raise ValueError("entry %r: kind must be one of %s, got "
                                     "%r" % (ent_name, _KINDS, kind))
                full = ((self.slots,) + shape if kind == "state"
                        else (self.num_blocks, self.block_size) + shape)
                self.spec[ent_name] = (kind, shape, dtype)
                self.data[ent_name] = torch.zeros(full, dtype=dtype,
                                                  device=self.device)
        self._kv_names = [n for n, (k, _s, _d) in self.spec.items()
                          if k == "kv"]
        self.lengths = np.zeros(self.slots, np.int64)
        self._free = list(range(self.slots - 1, -1, -1))
        self._live = set()
        self._free_blocks = list(range(self.num_blocks - 1, -1, -1))
        self._tables = {}          # slot -> [block ids], shared by kv entries
        self._peak_blocks = 0
        self._pressure_noted = False
        _memz.register_kv_cache(self)
        self._note_blocks()

    # ------------------------------------------------------------- slots
    @property
    def in_use(self):
        return len(self._live)

    def alloc(self):
        """Claim a zeroed slot; None when the grid is full. Blocks are
        mapped lazily by `append` / `extend`, so alloc itself never
        exhausts the pool."""
        if not self._free:
            return None
        slot = self._free.pop()
        self._live.add(slot)
        self.lengths[slot] = 0
        self._tables[slot] = []
        for name, (kind, _shape, _dtype) in self.spec.items():
            if kind == "state":
                self.data[name][slot] = 0
        self._note_blocks()
        return slot

    def free(self, slot):
        if slot not in self._live:
            raise ValueError("slot %r is not live" % slot)
        self._live.remove(slot)
        self._free.append(slot)
        self._free_blocks.extend(reversed(self._tables.pop(slot, [])))
        self.lengths[slot] = 0
        self._note_blocks()

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

    def _map_blocks(self, slot, upto):
        """Map pool blocks until `slot`'s table covers `upto` positions;
        the new blocks are zeroed across every kv entry."""
        table = self._tables[slot]
        need = math.ceil(upto / self.block_size) - len(table)
        if need <= 0:
            return
        if need > len(self._free_blocks):
            block = len(table) + len(self._free_blocks)
            _cat.gen_kv_pool_exhausted.inc(name=self.name)
            _memz.on_pool_exhausted(self, slot=slot, block=block)
            raise KVPoolExhausted(
                "paged KV pool exhausted (%d blocks of %d positions); "
                "slot %d needs block %d"
                % (self.num_blocks, self.block_size, slot, block),
                name=self.name, slot=slot, block=block,
                num_blocks=self.num_blocks, block_size=self.block_size)
        fresh = [self._free_blocks.pop() for _ in range(need)]
        idx = torch.tensor(fresh, dtype=torch.long, device=self.device)
        for n in self._kv_names:
            self.data[n].index_fill_(0, idx, 0)
        table.extend(fresh)
        self._note_blocks()

    def append(self, name, slot, value):
        """Write `value` at this slot's current position (all kv entries
        share the position counter; call `advance` once per step after
        every entry is written). Maps a fresh pool block when the position
        crosses a block boundary."""
        kind, shape, dtype = self.spec[name]
        if kind != "kv":
            raise ValueError("%r is a %r entry, not kv" % (name, kind))
        self._check(slot)
        pos = int(self.lengths[slot])
        if pos >= self.max_len:
            raise ValueError("slot %d is full (max_len=%d)"
                             % (slot, self.max_len))
        self._map_blocks(slot, pos + 1)
        bi, off = divmod(pos, self.block_size)
        self.data[name][self._tables[slot][bi], off] = self._value(
            value, shape, dtype)

    def advance(self, slot):
        self._check(slot)
        self.lengths[slot] += 1
        self._note_blocks()

    def extend(self, slot, count):
        """Map blocks for `count` more positions of `slot`, advance it by
        `count`, and return the flat pool rows (``block * block_size +
        offset``) of those positions, oldest first, for ``write_rows``.
        Raises as `append` would, before the slot moves."""
        self._check(slot)
        pos = int(self.lengths[slot])
        if pos + count > self.max_len:
            raise ValueError("slot %d is full (max_len=%d)"
                             % (slot, self.max_len))
        self._map_blocks(slot, pos + count)
        table = self._tables[slot]
        rows = [table[p // self.block_size] * self.block_size
                + p % self.block_size for p in range(pos, pos + count)]
        self.lengths[slot] += count
        self._note_blocks()
        return rows

    def write_rows(self, name, rows, values):
        """Copy `values` (n,) + shape into the kv entry's flat pool rows
        `rows` (a long tensor on the cache's device): one indexed write,
        the values cast to the pool's dtype first (a 16-bit model's K and
        V into an fp32 pool, as the JAX package's numpy pools cast on
        append)."""
        kind, shape, dtype = self.spec[name]
        if kind != "kv":
            raise ValueError("%r is a %r entry, not kv" % (name, kind))
        flat = self.data[name].view((-1,) + shape)
        flat.index_copy_(0, rows, values.reshape((-1,) + shape).to(dtype))

    def prefix(self, name, slot):
        """The filled (length, ...) contents of a kv entry for one slot, as
        a tensor (a gathered copy: pool rows are not contiguous)."""
        kind, shape, dtype = self.spec[name]
        if kind != "kv":
            raise ValueError("%r is a %r entry, not kv" % (name, kind))
        self._check(slot)
        length = int(self.lengths[slot])
        if length == 0:
            return torch.zeros((0,) + shape, dtype=dtype, device=self.device)
        table = self._tables[slot]
        nb = math.ceil(length / self.block_size)
        rows = self.data[name][table[:nb]]          # (nb, bs) + shape
        return rows.reshape((nb * self.block_size,) + shape)[:length]

    # ------------------------------------------------- paged extensions
    def pool(self, name):
        """The (num_blocks, block_size, ...) device tensor of a kv entry."""
        kind = self.spec[name][0]
        if kind != "kv":
            raise ValueError("%r is a %r entry, not kv" % (name, kind))
        return self.data[name]

    def table(self, slot):
        self._check(slot)
        return list(self._tables[slot])

    def tables_array(self, slots=None):
        """Block tables as an (S, max_blocks_per_slot) int32 numpy array for
        the kernel. Unmapped entries pad with block 0: positions past a
        sequence's length are never read. ``slots=None`` covers the full
        grid in slot order."""
        order = list(range(self.slots)) if slots is None else list(slots)
        out = np.zeros((len(order), self.max_blocks_per_slot), np.int32)
        for row, slot in enumerate(order):
            table = self._tables.get(slot, [])
            out[row, :len(table)] = table
        return out

    def truncate(self, slot, new_len):
        """Roll a slot back to ``new_len`` committed positions, freeing
        now-unused blocks (speculative decode rejects a drafted suffix this
        way). No-op when new_len >= current length."""
        self._check(slot)
        new_len = int(new_len)
        if new_len < 0:
            raise ValueError("new_len must be >= 0, got %r" % new_len)
        if new_len >= int(self.lengths[slot]):
            return
        keep = math.ceil(new_len / self.block_size)
        table = self._tables[slot]
        self._free_blocks.extend(reversed(table[keep:]))
        del table[keep:]
        self.lengths[slot] = new_len
        self._note_blocks()

    @property
    def blocks_in_use(self):
        return self.num_blocks - len(self._free_blocks)

    @property
    def blocks_free(self):
        return len(self._free_blocks)

    def fragmentation(self):
        """1 - filled_positions / mapped capacity: the ragged-last-block
        waste. 0.0 when nothing is mapped."""
        mapped = self.blocks_in_use * self.block_size
        if mapped == 0:
            return 0.0
        filled = int(sum(int(self.lengths[s]) for s in self._live))
        return 1.0 - filled / float(mapped)

    def _note_blocks(self):
        in_use = self.blocks_in_use
        free = self.num_blocks - in_use
        if in_use > self._peak_blocks:
            self._peak_blocks = in_use
        _cat.gen_kv_blocks_in_use.set(in_use, name=self.name)
        _cat.gen_kv_blocks_free.set(free, name=self.name)
        _cat.gen_kv_free_fraction.set(free / float(self.num_blocks),
                                      name=self.name)
        _cat.gen_kv_blocks_in_use_peak.set(self._peak_blocks,
                                           name=self.name)
        _cat.gen_kv_fragmentation.set(self.fragmentation(), name=self.name)
        _memz.note_kv(self)
        # near-exhaustion flight event, edge-triggered so a pool parked at
        # 95% does not fill the ring on every append
        low = free < 0.1 * self.num_blocks
        if low and not self._pressure_noted:
            self._pressure_noted = True
            _flight.record("gen.kv_pool_pressure", name=self.name,
                           free=free, total=self.num_blocks)
        elif not low and self._pressure_noted:
            self._pressure_noted = False
