"""Runtime telemetry of the PyTorch port: metrics, exporters, request
tracing, the flight recorder, debug endpoints, costs and the memory plane.

Counterpart of ``incubator_mxnet_tpu/telemetry/``, with the same instrument
names, labels, knobs and wire formats:

- ``metrics``: thread-safe labeled Counter/Gauge/Histogram registry, one
  flag check per call site when disabled (``MXTPU_METRICS``).
- ``export``: Prometheus text exposition and JSON renderers, and a
  periodic flusher (``MXTPU_METRICS_EXPORT`` / ``_INTERVAL`` / ``_FORMAT``).
- ``tracing``: spans whose trace/parent ids ride the RPC meta dict, head
  sampling at the request root (``MXTPU_TRACE_SAMPLE``), retroactive
  ``record_span``, a bounded ring (``MXTPU_TRACE_MAX_SPANS``) and
  journey timelines.
- ``catalog``: the instruments of the rpc, serving, deploy, generation,
  costs and memory code; a CUDA graph capture counts as a compile.
- ``flight``: the flight-recorder ring of structured events
  (``MXTPU_FLIGHT``, ``MXTPU_FLIGHT_EXPORT``).
- ``debugz``: a per-process HTTP debug server (``MXTPU_DEBUGZ_PORT``).
- ``costs``: FLOPs and bytes per served program, counted once at its
  eager first call (``MXTPU_COSTS=1``), and the MFU gauges against the
  H100's peaks (``MXTPU_PEAK_TFLOPS`` / ``MXTPU_PEAK_GBS``).
- ``memz``: the CUDA allocator's gauges and watermarks, per-program
  footprints, the KV census and OOM forensics (``MXTPU_MEMZ``,
  ``MXTPU_MEM_EXPORT``).
- ``lockdep``: the lock-order and blocking-under-lock witness
  (``MXTPU_LOCKDEP=1``).

The JAX package's fleet plane (``aggregate``, ``history``, ``health``) is
not ported yet.
"""

from . import lockdep   # FIRST: MXTPU_LOCKDEP=1 must patch the lock
from . import metrics   # constructors before sibling modules (and the
from . import tracing   # rest of the package) create their locks
from . import export
from . import catalog
from . import flight
from . import debugz
from . import costs
from . import memz

from .metrics import (enable, disable, enabled, counter, gauge, histogram,
                      snapshot, reset)
from .export import (render_prometheus, render_json, flush, start_flusher,
                     stop_flusher)
from .tracing import (span, current, inject, extract, from_meta,
                      merge_traces, recent_spans, request_span,
                      record_span, build_timeline, render_timeline)

__all__ = ["metrics", "tracing", "export", "catalog", "flight",
           "debugz", "costs", "memz", "lockdep",
           "enable", "disable", "enabled", "counter", "gauge", "histogram",
           "snapshot", "reset",
           "render_prometheus", "render_json", "flush", "start_flusher",
           "stop_flusher",
           "span", "current", "inject", "extract", "from_meta",
           "merge_traces", "recent_spans", "request_span", "record_span",
           "build_timeline", "render_timeline"]
