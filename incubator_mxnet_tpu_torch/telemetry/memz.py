"""Device-memory & KV-capacity observability plane with OOM forensics.

Counterpart of ``incubator_mxnet_tpu/telemetry/memz.py``, with the same
surfaces (gauges, /memz payload, post-mortem dump, flight events). It
watches four things:

- **live device memory**: per-device used/limit/peak gauges from the CUDA
  caching allocator (``torch.cuda.memory_stats``; the limit is the card's
  total memory from its properties). Host-process RSS rides along from
  ``/proc/self/statm``. ``sample()`` also keeps process-lifetime high
  watermarks.
- **per-program memory**: ``capture_memory()`` records a served program's
  footprint; ``compilecache/aot.py``'s ``BlockProgram`` hands it the
  allocator's growth across the program's CUDA graph capture (the graph
  pool's bytes: outputs and intermediates), the static inputs and the
  outputs.
- **KV economy**: ``PagedKVCache`` and ``KVCache`` register here at
  construction (weakly: a freed cache leaves the census); ``kv_census``
  reports each pool's device bytes, slots, and for a paged pool its
  size/free/peak/fragmentation and the per-slot block census.
- **OOM forensics**: ``install_oom_hooks()`` chains ``sys.excepthook``: an
  escaping ``torch.cuda.OutOfMemoryError`` or ``KVPoolExhausted`` records
  an ``oom.*`` flight event and atomically dumps a post-mortem (the
  allocator's largest live blocks, per-program footprints, KV census,
  watermarks) to ``MXTPU_MEM_EXPORT``. In-process handled exhaustion (the
  serving shed path) leaves the same forensics via ``on_pool_exhausted()``.

A report never touches the device: the readers go through ``sys.modules``
and read nothing unless ``torch.cuda.is_initialized()``, so a status page
never creates a CUDA context, and nothing here synchronizes the card.

Cheap when off: ``sample()``, ``capture_memory()`` and ``note_kv()`` are
one predicate check. Enable with ``MXTPU_MEMZ=1`` (``MXTPU_MEM_EXPORT=<path>``
implies it) or ``memz.enable()``.
"""

import json
import os
import sys
import threading
import time
import weakref

from . import metrics as _m
from . import catalog as _cat

__all__ = ["enable", "disable", "enabled", "export_path", "sample",
           "device_stats", "device_identity", "host_memory",
           "capture_memory", "normalize_memory", "programs",
           "register_kv_cache", "kv_census", "pool_bytes", "note_kv",
           "watermarks",
           "memz_dict", "render_text", "post_mortem", "dump",
           "record_oom", "on_pool_exhausted", "install_oom_hooks",
           "statusz_entry", "reset"]

_state = {"enabled": False}
_lock = threading.Lock()
_programs = {}          # name -> {argument,output,temp,generated,total}_bytes
_watermarks = {}        # scope -> peak bytes ("device:<d>" | "host_rss")
_kv_caches = []         # weakrefs to live PagedKVCache instances
_oom = {"last_dump": 0.0, "count": 0}
_hooks = {"installed": False}

#: minimum seconds between automatic OOM post-mortem dumps: a shedding
#: serving loop hits exhaustion per admission attempt, and each dump reads
#: the allocator snapshot; the freshest dump within the window wins anyway
#: because the atexit flush writes one more at the end.
_DUMP_MIN_INTERVAL = 5.0


def enable():
    _state["enabled"] = True


def disable():
    _state["enabled"] = False


def enabled():
    return _state["enabled"]


def export_path():
    return os.environ.get("MXTPU_MEM_EXPORT") or None


def _env_int(name, default):
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


# -- live device memory ----------------------------------------------

def _cuda():
    """torch.cuda when this process already holds a CUDA context, else
    None: a report must never create one."""
    torch = sys.modules.get("torch")
    if torch is None:
        return None
    try:
        if not torch.cuda.is_initialized():
            return None
    except Exception:   # noqa: BLE001 — a torch mid-teardown
        return None
    return torch.cuda


def device_stats():
    """Per-device memory readings: ``[{device, platform, kind,
    bytes_in_use, bytes_limit, peak_bytes_in_use, bytes_reserved,
    source}, ...]``. Empty when this process has no CUDA context.
    ``source`` is ``memory_stats`` (the caching allocator)."""
    cuda = _cuda()
    if cuda is None:
        return []
    out = []
    try:
        n = cuda.device_count()
    except Exception:   # noqa: BLE001
        return []
    for i in range(n):
        try:
            stats = cuda.memory_stats(i)
            props = cuda.get_device_properties(i)
        except Exception:   # noqa: BLE001 — a device mid-teardown
            continue
        out.append({
            "device": "cuda:%d" % i, "platform": "gpu",
            "kind": props.name,
            "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "bytes_limit": int(props.total_memory) or None,
            "peak_bytes_in_use": int(
                stats.get("allocated_bytes.all.peak", 0)) or None,
            "bytes_reserved": int(stats.get("reserved_bytes.all.current",
                                            0)),
            "source": "memory_stats"})
    return out


def device_identity():
    """Fleet-capacity identity for /statusz: platform, device kind, count
    and device memory per device. None without a CUDA context."""
    cuda = _cuda()
    if cuda is None:
        return None
    try:
        n = cuda.device_count()
        props = cuda.get_device_properties(0)
    except Exception:   # noqa: BLE001
        return None
    return {"platform": "gpu", "device_kind": props.name,
            "device_count": n,
            "hbm_bytes_per_device": int(props.total_memory) or None}


def host_memory():
    """Host-process memory: current RSS from /proc/self/statm where the
    platform has it, peak RSS from getrusage (stdlib only)."""
    out = {"rss_bytes": None, "peak_rss_bytes": None}
    try:
        import resource
        ru = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        # linux reports KB; darwin reports bytes — normalize to bytes
        out["peak_rss_bytes"] = int(ru) * (1 if sys.platform == "darwin"
                                           else 1024)
    except Exception:   # noqa: BLE001 — no resource module (windows)
        pass
    try:
        with open("/proc/self/statm") as f:
            resident_pages = int(f.read().split()[1])
        out["rss_bytes"] = resident_pages * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        out["rss_bytes"] = out["peak_rss_bytes"]
    return out


def _note_watermark(scope, value):
    if value is None:
        return
    prev = _watermarks.get(scope)
    if prev is None or value > prev:
        _watermarks[scope] = value
        if _m._state["enabled"]:
            _cat.mem_watermark_bytes.set(value, scope=scope)


def sample(now=None):
    """Take one memory sample: set the device/host gauges and advance
    the high watermarks.  The history daemon calls this from
    ``sample_local()`` so the series land in the ring TSDB.  One
    predicate check when the plane is disabled."""
    if not _state["enabled"]:
        return None
    devices = device_stats()
    host = host_memory()
    metrics_on = _m._state["enabled"]
    with _lock:
        for rec in devices:
            dev = rec["device"]
            used = rec.get("bytes_in_use") or 0
            limit = rec.get("bytes_limit")
            _note_watermark("device:%s" % dev,
                            rec.get("peak_bytes_in_use") or used)
            if metrics_on:
                _cat.mem_device_bytes_in_use.set(used, device=dev)
                if limit:
                    _cat.mem_device_bytes_limit.set(limit, device=dev)
                    _cat.mem_hbm_used_fraction.set(used / float(limit),
                                                   device=dev)
                if rec.get("peak_bytes_in_use"):
                    _cat.mem_device_peak_bytes.set(
                        rec["peak_bytes_in_use"], device=dev)
        _note_watermark("host_rss", host.get("rss_bytes"))
        if metrics_on and host.get("rss_bytes"):
            _cat.mem_host_rss_bytes.set(host["rss_bytes"])
    return {"ts": now if now is not None else time.time(),
            "devices": devices, "host": host}


def watermarks():
    """Process-lifetime memory high watermarks by scope."""
    with _lock:
        return dict(_watermarks)


# -- static per-program memory cost -----------------------------------

def normalize_memory(memory):
    """A footprint dict's ``argument``, ``output``, ``temp`` and
    ``generated_code`` byte counts (``*_bytes``, absent = 0) with their
    total."""
    out = {k: int(memory.get(k, 0) or 0)
           for k in ("argument_bytes", "output_bytes", "temp_bytes",
                     "generated_code_bytes")}
    out["total_bytes"] = sum(out.values())
    return out


def capture_memory(name, memory):
    """Record one program's memory footprint under ``name`` (BlockProgram
    calls this once per capture). Re-capturing a name replaces its entry.
    One predicate check when the plane is disabled."""
    if not _state["enabled"]:
        return None
    entry = normalize_memory(memory)
    with _lock:
        _programs[name] = entry
    if _m._state["enabled"]:
        for kind in ("argument", "output", "temp", "generated_code",
                     "total"):
            _cat.mem_program_bytes.set(entry["%s_bytes" % kind],
                                       name=name, kind=kind)
    return entry


def programs(name=None):
    """Captured per-program footprints (one entry per program name)."""
    with _lock:
        if name is not None:
            ent = _programs.get(name)
            return dict(ent) if ent else None
        return {k: dict(v) for k, v in _programs.items()}


# -- KV-block economy --------------------------------------------------

def register_kv_cache(cache):
    """Weakly register a PagedKVCache or KVCache for the census (called by
    its constructor; a garbage-collected cache drops out by itself)."""
    with _lock:
        _kv_caches[:] = [r for r in _kv_caches if r() is not None]
        _kv_caches.append(weakref.ref(cache))


def _live_kv_caches():
    with _lock:
        refs = list(_kv_caches)
    return [c for c in (r() for r in refs) if c is not None]


def note_kv(cache):
    """Advance the pool's block high watermark (called from the cache's
    ``_note_blocks`` hot path).  One predicate check when the plane is
    disabled."""
    if not _state["enabled"]:
        return
    scope = "kv:%s" % cache.name
    in_use = cache.blocks_in_use
    with _lock:
        prev = _watermarks.get(scope)
        if prev is None or in_use > prev:
            _watermarks[scope] = in_use


def pool_bytes(cache):
    """Device bytes of a cache's tensors: {"kv", "state", "total"}."""
    out = {"kv": 0, "state": 0}
    for name, (kind, _shape, _dtype) in cache.spec.items():
        t = cache.data[name]
        out["kv" if kind == "kv" else "state"] += t.numel() * \
            t.element_size()
    out["total"] = out["kv"] + out["state"]
    return out


def kv_census():
    """Per-cache KV economy: device bytes and slots, and for a paged pool
    size/free/peak/fragmentation plus the per-slot census (length and
    mapped blocks), the table an operator reads to see WHO holds the
    pool."""
    out = []
    for cache in _live_kv_caches():
        try:
            nbytes = pool_bytes(cache)
            ent = {"name": getattr(cache, "name", None),
                   "kind": "paged" if hasattr(cache, "num_blocks")
                   else "dense",
                   "device": str(cache.device), "slots": cache.slots,
                   "slots_in_use": cache.in_use, "max_len": cache.max_len,
                   "pool_bytes": nbytes["total"], "kv_bytes": nbytes["kv"],
                   "state_bytes": nbytes["state"]}
            if ent["kind"] == "paged":
                with _lock:
                    peak = _watermarks.get("kv:%s" % cache.name)
                ent.update({
                    "block_size": cache.block_size,
                    "num_blocks": cache.num_blocks,
                    "blocks_in_use": cache.blocks_in_use,
                    "blocks_free": cache.blocks_free,
                    "blocks_in_use_peak": peak,
                    "free_fraction": cache.blocks_free /
                    float(cache.num_blocks),
                    "fragmentation": cache.fragmentation(),
                    "per_slot": [{"slot": s,
                                  "length": int(cache.lengths[s]),
                                  "blocks": len(cache._tables.get(s, ()))}
                                 for s in sorted(cache._live)]})
            out.append(ent)
        except Exception:   # noqa: BLE001 — a cache mutating mid-census
            continue        # (decode loop thread) must not 500 /memz
    return out


# -- surfaces ----------------------------------------------------------

def memz_dict():
    """Full /memz payload (also the diagnose Memory section source)."""
    return {"enabled": _state["enabled"], "ts": time.time(),
            "identity": device_identity(), "devices": device_stats(),
            "host": host_memory(), "watermarks": watermarks(),
            "programs": programs(), "kv": kv_census(),
            "oom_dumps": _oom["count"], "export_path": export_path()}


def _fmt_bytes(n):
    if n is None:
        return "-"
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024.0 or unit == "TiB":
            return "%.1f%s" % (n, unit) if unit != "B" else "%dB" % n
        n /= 1024.0
    return "%d" % n


def render_text(d=None):
    """Human one-screen rendering (``/memz?format=text``)."""
    d = d if d is not None else memz_dict()
    lines = ["memz: %s" % ("enabled" if d.get("enabled") else "disabled")]
    ident = d.get("identity")
    if ident:
        lines.append("  fleet: %s x%d (%s) hbm/device=%s"
                     % (ident["platform"], ident["device_count"],
                        ident["device_kind"],
                        _fmt_bytes(ident["hbm_bytes_per_device"])))
    for rec in d.get("devices") or []:
        lines.append("  %-16s used=%-10s limit=%-10s peak=%-10s [%s]"
                     % (rec["device"], _fmt_bytes(rec.get("bytes_in_use")),
                        _fmt_bytes(rec.get("bytes_limit")),
                        _fmt_bytes(rec.get("peak_bytes_in_use")),
                        rec.get("source")))
    host = d.get("host") or {}
    lines.append("  host rss=%s peak=%s"
                 % (_fmt_bytes(host.get("rss_bytes")),
                    _fmt_bytes(host.get("peak_rss_bytes"))))
    progs = d.get("programs") or {}
    if progs:
        lines.append("  programs (%d):" % len(progs))
        ranked = sorted(progs.items(),
                        key=lambda kv: -kv[1].get("total_bytes", 0))
        for name, ent in ranked[:20]:
            lines.append("    %-32s total=%-10s arg=%-10s out=%-10s "
                         "temp=%s"
                         % (name, _fmt_bytes(ent.get("total_bytes")),
                            _fmt_bytes(ent.get("argument_bytes")),
                            _fmt_bytes(ent.get("output_bytes")),
                            _fmt_bytes(ent.get("temp_bytes"))))
    for pool in d.get("kv") or []:
        if pool.get("kind") != "paged":
            lines.append("  kv cache %-11s bytes=%s slots=%d/%d"
                         % (pool["name"], _fmt_bytes(pool["pool_bytes"]),
                            pool["slots_in_use"], pool["slots"]))
            continue
        lines.append("  kv pool %-12s blocks=%d/%d free=%.0f%% peak=%s "
                     "frag=%.2f slots=%d/%d bytes=%s"
                     % (pool["name"], pool["blocks_in_use"],
                        pool["num_blocks"],
                        100.0 * pool["free_fraction"],
                        pool.get("blocks_in_use_peak") or "-",
                        pool["fragmentation"], pool["slots_in_use"],
                        pool["slots"], _fmt_bytes(pool["pool_bytes"])))
    wm = d.get("watermarks") or {}
    if wm:
        # kv:* watermarks are block counts, everything else is bytes
        lines.append("  watermarks: " + " ".join(
            "%s=%s" % (k, str(int(v)) if k.startswith("kv:")
                       else _fmt_bytes(v))
            for k, v in sorted(wm.items())))
    return "\n".join(lines) + "\n"


def statusz_entry():
    """The ``memz`` section of /statusz — constant when disabled."""
    if not _state["enabled"]:
        return {"enabled": False}
    with _lock:
        n_progs = len(_programs)
    return {"enabled": True, "programs": n_progs,
            "pools": len(_live_kv_caches()), "oom_dumps": _oom["count"],
            "export_path": export_path()}


# -- OOM forensics -----------------------------------------------------

def _live_buffer_table(top=None):
    """Ranked table of the caching allocator's live blocks
    (``torch.cuda.memory_snapshot``): who holds the memory, largest
    first. Empty without a CUDA context."""
    cuda = _cuda()
    if cuda is None:
        return {"count": 0, "total_bytes": 0, "top": []}
    try:
        segments = cuda.memory_snapshot()
    except Exception:   # noqa: BLE001
        return {"count": 0, "total_bytes": 0, "top": []}
    rows, total = [], 0
    for seg in segments:
        for blk in seg.get("blocks", ()):
            if blk.get("state") != "active_allocated":
                continue
            nbytes = int(blk.get("size", 0))
            rows.append({"nbytes": nbytes,
                         "device": "cuda:%s" % seg.get("device"),
                         "segment_type": seg.get("segment_type")})
            total += nbytes
    rows.sort(key=lambda r: -r["nbytes"])
    top = top if top is not None else _env_int("MXTPU_MEM_TOP_BUFFERS", 64)
    return {"count": len(rows), "total_bytes": total, "top": rows[:top]}


def post_mortem(reason=None):
    """The forensic picture at (or near) the moment of death: ranked
    live buffers, per-program footprints, KV block census, watermarks."""
    return {"ts": time.time(), "pid": os.getpid(), "reason": reason,
            "argv": sys.argv, "identity": device_identity(),
            "devices": device_stats(), "host": host_memory(),
            "watermarks": watermarks(),
            "live_buffers": _live_buffer_table(),
            "programs": programs(), "kv": kv_census()}


def dump(path=None, reason=None):
    """Write the post-mortem as JSON (atomic: tmp + rename).  ``path``
    defaults to ``MXTPU_MEM_EXPORT``; no-op (returns None) when neither
    is set."""
    path = path or export_path()
    if not path:
        return None
    pm = post_mortem(reason=reason)
    tmp = "%s.tmp.%d" % (path, os.getpid())
    with open(tmp, "w") as f:
        json.dump(pm, f, indent=2, default=str)
        f.write("\n")
    os.replace(tmp, path)
    _oom["count"] += 1
    return path


def record_oom(kind, error=None, throttle=True, **attrs):
    """One OOM observation: ``oom.<kind>`` flight event + counter +
    (throttled) post-mortem dump.  Safe to call from except blocks —
    never raises."""
    from . import flight as _flight
    _flight.record("oom.%s" % kind,
                   error=str(error)[:200] if error is not None else None,
                   **attrs)
    if _m._state["enabled"]:
        _cat.oom_events.inc(kind=kind)
    if not export_path():
        return None
    now = time.monotonic()
    if throttle and now - _oom["last_dump"] < _DUMP_MIN_INTERVAL:
        return None
    _oom["last_dump"] = now
    try:
        return dump(reason="oom.%s" % kind)
    except OSError:
        return None


def on_pool_exhausted(cache, slot=None, block=None):
    """Called by PagedKVCache at its exhaustion raise site: flight
    event + forensics without requiring the exception to escape (the
    serving shed path handles it in-process)."""
    record_oom("kv_pool", pool=cache.name, slot=slot, block=block,
               num_blocks=cache.num_blocks, block_size=cache.block_size)


def _is_resource_exhausted(exc_type, exc):
    if exc_type.__name__ == "KVPoolExhausted":
        return "kv_pool"
    if exc_type.__name__ == "OutOfMemoryError" or \
            "CUDA out of memory" in str(exc):
        return "resource_exhausted"
    return None


def install_oom_hooks():
    """Chain sys.excepthook so an escaping torch.cuda.OutOfMemoryError /
    KVPoolExhausted leaves forensics (flight's crash hooks dump the
    event ring; this dumps the memory picture).  No-op unless
    MXTPU_MEM_EXPORT is set."""
    if _hooks["installed"] or not export_path():
        return
    _hooks["installed"] = True

    prev_excepthook = sys.excepthook

    def _memz_excepthook(exc_type, exc, tb):
        kind = _is_resource_exhausted(exc_type, exc)
        if kind is not None:
            try:
                record_oom(kind, error=exc, throttle=False)
            except Exception:   # noqa: BLE001 — forensics must never
                pass            # mask the original crash
        prev_excepthook(exc_type, exc, tb)

    sys.excepthook = _memz_excepthook


def reset():
    """Drop captured programs/watermarks/pool registrations (keeps
    enablement) — test isolation helper."""
    with _lock:
        _programs.clear()
        _watermarks.clear()
        del _kv_caches[:]
    _oom["last_dump"] = 0.0
    _oom["count"] = 0


def _init_from_env():
    if os.environ.get("MXTPU_MEMZ", "") in ("1", "true", "on"):
        enable()
    if export_path():
        enable()
        install_oom_hooks()


_init_from_env()
