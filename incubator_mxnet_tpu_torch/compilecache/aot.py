"""One CUDA graph per served shape: the port's counterpart of the JAX
package's AOT ``BlockProgram`` (``incubator_mxnet_tpu/compilecache/aot.py``).

A ``BlockProgram`` holds a ``name``, static input tensors, the outputs of one
capture and a ``torch.cuda.CUDAGraph``. ``__call__(*arrays)`` copies the
inputs into the static buffers and replays; the outputs are the capture's
tensors, which the next replay of any graph of the same pool may overwrite,
so a caller copies them out (or consumes them on the stream) before it
calls again. Tensors that the forward reads in place (parameters, a KV
cache's pools) are read at the addresses they had at capture: they may be
rewritten in place (a live weight swap) but never replaced.

The first call of a program runs its forward eagerly on a side stream on the
real inputs (the warm-up: kernels get built and modules loaded outside
capture) and returns that result; then the forward is captured, in
``thread_local`` mode so that other threads (other tenants' schedulers, RPC
handlers) keep using the card. Every later call replays. A capture that
fails raises ``CaptureError`` naming the program: there is no eager fallback
on CUDA. Captures are serialized across threads by one lock
(``capture_lock()``), which a deploy's pinning of host memory takes too.

Launch counts stay true: a kernel wrapper called during the capture does not
run its kernel, so its call is recorded instead of counted
(``_build.recording_launches``), and each replay adds the record. The
warm-up's launches are real and count as they run.

A CUDA graph has no serialized form, so ``dump()`` raises, and
``ServedModel.export_executables()`` exports nothing.

Telemetry: a capture is the port's compile. Each one is counted, with its
seconds, under ``mxtpu_jit_compiles_total{where=...}`` and
``mxtpu_jit_compile_seconds_total`` inside the ``compiling(where)`` region
that labels it (``where`` is the program's, "serving" for served
programs), so a weight swap's zero recaptures read over ``serve.metrics``.
The memory plane records the program's footprint: its static inputs, its
outputs and the allocator's growth across the capture (the graph pool's
bytes). Under ``MXTPU_COSTS=1`` the warm-up call is counted
(``telemetry.costs.count``): the aten products, and the hand kernels' work
by formula, since a replay cannot be counted. A failed count still serves
the call and is counted as a failure. Nothing is instrumented inside the
captured forward: it would fire once, at capture, and never at replay.
"""

import threading
import time

import torch

from ..ops.kernels import _build
from ..telemetry import catalog as _cat
from ..telemetry import costs as _costs
from ..telemetry import memz as _memz

__all__ = ["BlockProgram", "CaptureError", "capture_lock"]

_capture_lock = threading.Lock()


def capture_lock():
    """The process's capture lock, which every warm-up and capture holds.
    Work on another thread that must not overlap a capture (pinning host
    memory: ``serving.loader.load_generation_params``) takes it too."""
    return _capture_lock


class CaptureError(RuntimeError):
    """A served shape's forward could not be captured into a CUDA graph."""


class BlockProgram:
    """One served shape's forward as a CUDA graph.

    name : the program's name (``encode/r8xb128/token_ids``, ...);
    fn : ``fn(*static_inputs) -> tensor or tuple of tensors``, a forward
        that reads no host value and makes no host-device copy;
    example_inputs : tensors shaped and typed as the calls' inputs, on one
        CUDA device; the static buffers are made like them;
    pool : a ``torch.cuda.graph_pool_handle()`` shared by programs that
        never replay concurrently (one family's), or None for a pool of its
        own;
    bound : objects the graph reads in place (a cache), kept alive with it;
    counts : a dict with "captured" and "replayed" keys that the program
        adds to (its family's ``ServedModel.graph_counts``);
    where : the compile label its capture counts under;
    samples : samples (tokens) one call consumes, for the tokens/s gauge of
        ``telemetry.costs``."""

    def __init__(self, name, fn, example_inputs, pool=None, bound=(),
                 counts=None, where="other", samples=None):
        self.name = name
        self.where = where
        self.samples = samples
        self.cost = None            # the counted work (MXTPU_COSTS=1)
        self._fn = fn
        self.device = example_inputs[0].device
        if self.device.type != "cuda":
            raise ValueError("%s: a CUDA graph needs CUDA inputs, got %s"
                             % (name, self.device))
        with torch.inference_mode():
            self.inputs = [torch.empty_like(t) for t in example_inputs]
        self.pool = pool
        self.bound = tuple(bound)
        self.counts = counts if counts is not None else {
            "captured": 0, "replayed": 0}
        self.graph = None
        self.outputs = None
        self.launches = {}          # kernel wrapper -> launches a replay

    def __call__(self, *arrays):
        if len(arrays) != len(self.inputs):
            raise TypeError("%s takes %d input arrays, got %d"
                            % (self.name, len(self.inputs), len(arrays)))
        with torch.inference_mode():
            for dst, src in zip(self.inputs, arrays):
                if tuple(src.shape) != tuple(dst.shape):
                    raise TypeError("%s: input of shape %s, the program's "
                                    "is %s" % (self.name, tuple(src.shape),
                                               tuple(dst.shape)))
                dst.copy_(src)
            if self.graph is None:
                return self._warm_up_and_capture()
            self.graph.replay()
        _build.add_launches(self.launches)
        self.counts["replayed"] += 1
        return self.outputs

    def _warm_up_and_capture(self):
        cur = torch.cuda.current_stream(self.device)
        with _capture_lock:
            side = torch.cuda.Stream(self.device)
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                result, self.cost = _costs.run_counted(
                    self.name, self._fn, self.inputs, self.samples)
            cur.wait_stream(side)
            for t in (result if isinstance(result, (tuple, list))
                      else (result,)):
                t.record_stream(cur)    # the caller reads it on its stream
            graph = torch.cuda.CUDAGraph()
            allocated = torch.cuda.memory_allocated(self.device)
            t0 = time.perf_counter()
            with _cat.compiling(self.where):
                try:
                    with _build.recording_launches() as record:
                        with torch.cuda.graph(
                                graph, pool=self.pool,
                                capture_error_mode="thread_local"):
                            outputs = self._fn(*self.inputs)
                except Exception as e:
                    raise CaptureError(
                        "cannot capture %s into a CUDA graph on %s (%s: %s)"
                        % (self.name, self.device, type(e).__name__, e)) \
                        from e
                _cat.note_compile(time.perf_counter() - t0)
            grown = torch.cuda.memory_allocated(self.device) - allocated
        self.graph, self.outputs = graph, outputs
        self.launches = dict(record)
        self.counts["captured"] += 1
        out_bytes = sum(t.numel() * t.element_size() for t in (
            outputs if isinstance(outputs, (tuple, list)) else (outputs,)))
        _memz.capture_memory(self.name, {
            "argument_bytes": sum(t.numel() * t.element_size()
                                  for t in self.inputs),
            "output_bytes": out_bytes,
            "temp_bytes": max(0, grown - out_bytes)})
        return result

    def dump(self):
        """A CUDA graph has no serialized form: always raises."""
        raise NotImplementedError(
            "%s is a CUDA graph, which has no serialized form; it is "
            "captured again on demand" % self.name)
