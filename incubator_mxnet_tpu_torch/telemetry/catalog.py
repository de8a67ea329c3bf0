"""Central catalog of the port's metric instruments.

Counterpart of ``incubator_mxnet_tpu/telemetry/catalog.py``, of the
instruments that the port's rpc layer, failpoints, trainer, resilience
layer, serving plane, deploy plane, generation engine, cost accounting,
memory plane and observability plane touch. Names, labels, help texts and histogram edges are the JAX
package's, except where the port counts something else (the compile
counters count CUDA graph captures), and then the help text says so. Every
instrumented module imports its instruments from here, so the metric
surface is one greppable list.

All instruments are registered at import; a registered but disabled
instrument never mutates (see metrics.py).
"""

import contextlib
import threading

from . import metrics as _m

# -- RPC transport (kvstore/rpc.py) ----------------------------------
rpc_bytes_sent = _m.counter(
    "mxtpu_rpc_bytes_sent_total", "Wire bytes written by send_msg")
rpc_bytes_received = _m.counter(
    "mxtpu_rpc_bytes_received_total", "Wire bytes read by recv_msg")
rpc_client_requests = _m.counter(
    "mxtpu_rpc_client_requests_total",
    "Client RPCs by op and status (ok|error)")
rpc_client_seconds = _m.histogram(
    "mxtpu_rpc_client_seconds", "Client RPC round-trip latency by op")
rpc_retries = _m.counter(
    "mxtpu_rpc_retries_total", "call_idempotent retry attempts by op")
rpc_reconnects = _m.counter(
    "mxtpu_rpc_reconnects_total", "Connection re-establishments after loss")
rpc_server_requests = _m.counter(
    "mxtpu_rpc_server_requests_total",
    "Server-handled RPCs by op and status (ok|error)")
rpc_server_seconds = _m.histogram(
    "mxtpu_rpc_server_seconds", "Server handler latency by op")
rpc_dedup_hits = _m.counter(
    "mxtpu_rpc_dedup_hits_total",
    "Idempotent requests answered from the server DedupCache")
rpc_deadline_dropped = _m.counter(
    "mxtpu_rpc_deadline_dropped_total",
    "Requests NACKed by Server because their _deadline expired before "
    "the handler ran, by op")

# -- compiles: CUDA graph captures (compilecache/aot.py) -------------
jit_compiles = _m.counter(
    "mxtpu_jit_compiles_total",
    "CUDA graph captures of served programs (the port's compiles), by "
    "where (serving|other): BlockProgram counts each capture inside the "
    "compiling() region that labels it")
jit_compile_seconds = _m.counter(
    "mxtpu_jit_compile_seconds_total",
    "Cumulative seconds of CUDA graph capture (warm-up call excluded), "
    "by where")

# -- fault injection (utils/failpoints.py) ---------------------------
failpoints_triggered = _m.counter(
    "mxtpu_failpoints_triggered_total", "Failpoint firings by name")


# -- trainer (parallel/trainer.py) -----------------------------------
trainer_steps = _m.counter(
    "mxtpu_trainer_steps_total",
    "Optimizer steps by zero/pipeline mode labels")
trainer_step_seconds = _m.histogram(
    "mxtpu_trainer_step_seconds", "ShardedTrainer.step wall time")
trainer_samples = _m.counter(
    "mxtpu_trainer_samples_total",
    "Leading-dim samples consumed by step/step_scan (tokens/sec numerator)")

# -- resilience (resilience/) ----------------------------------------
guard_skipped_steps = _m.counter(
    "mxtpu_guard_skipped_steps_total",
    "Optimizer updates skipped by the numeric guard (non-finite "
    "loss/grad-norm)")
guard_loss_scale = _m.gauge(
    "mxtpu_guard_loss_scale", "Current dynamic loss scale")
guard_rollbacks = _m.counter(
    "mxtpu_guard_rollbacks_total",
    "Last-good rewinds by source (ring|checkpoint)")
rollback_snapshots = _m.counter(
    "mxtpu_rollback_snapshots_total",
    "Device-state snapshots taken into the rollback ring")
watchdog_fires = _m.counter(
    "mxtpu_watchdog_fires_total", "Watchdog deadline expiries by phase")


# -- serving plane (serving/) ----------------------------------------
serving_requests = _m.counter(
    "mxtpu_serving_requests_total",
    "Serving requests by model and status (ok|shed|error)")
serving_request_seconds = _m.histogram(
    "mxtpu_serving_request_seconds",
    "End-to-end admission->completion latency by model "
    "(the per-model p50/p99 source)")
serving_queue_seconds = _m.histogram(
    "mxtpu_serving_queue_seconds",
    "Time a request waited before joining a forward batch, by model")
serving_batch_occupancy = _m.histogram(
    "mxtpu_serving_batch_occupancy",
    "Rows per executed forward batch by model — >1 means concurrent "
    "requests were coalesced (continuous batching is working)",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256))
serving_forward_seconds = _m.histogram(
    "mxtpu_serving_forward_seconds",
    "Forward/decode step wall time by model and shape bucket")
serving_ttft_seconds = _m.histogram(
    "mxtpu_serving_ttft_seconds",
    "Time-to-first-token by model: arrival to first committed decode "
    "token. Dominated by queue wait + prefill, so the edges run finer "
    "than the default latency buckets at the low end and stop at 30s",
    buckets=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
             1.0, 2.5, 5.0, 10.0, 30.0))
serving_tpot_seconds = _m.histogram(
    "mxtpu_serving_tpot_seconds",
    "Time-per-output-token by model: inter-token gap for tokens after "
    "the first. One decode step is sub-millisecond on small models, so "
    "the edges extend down to 50us where the defaults would saturate",
    buckets=(0.00005, 0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005,
             0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5))
serving_shed = _m.counter(
    "mxtpu_serving_shed_total",
    "Requests shed by model and stage (queue|join|overload|decode|"
    "draining|capacity) — capacity = the paged KV pool was exhausted, "
    "shed-on-pressure rather than a bug")
serving_decode_steps = _m.counter(
    "mxtpu_serving_decode_steps_total",
    "Autoregressive decode steps executed by model")
serving_decode_slots = _m.gauge(
    "mxtpu_serving_decode_slots_in_use",
    "KV-cache slots currently held by live decode sequences, by model")
serving_models = _m.gauge(
    "mxtpu_serving_models_loaded", "Models currently loaded in the server")
serving_generation = _m.gauge(
    "mxtpu_serving_generation",
    "Checkpoint generation currently live in this server, by model — "
    "the rollout coordinator and the deploy_generation_skew rule read "
    "this to see replicas agree after a rolling weight push")
deploy_inflight = _m.gauge(
    "mxtpu_deploy_inflight",
    "1 while a drain->swap->re-admit deploy is running on this server")
deploy_swaps = _m.counter(
    "mxtpu_deploy_swaps_total",
    "Live weight swaps attempted, by model and outcome (ok|error)")
deploy_seconds = _m.histogram(
    "mxtpu_deploy_seconds",
    "Wall time of one live deploy (drain through re-admit), by model — "
    "the admission outage a rolling weight push costs per replica")


# -- generative engine (generate/) -----------------------------------
gen_prefill_seconds = _m.histogram(
    "mxtpu_gen_prefill_seconds",
    "Chunked-prefill wall time per sequence by model (prompt ingestion "
    "before the first decode step)")
gen_decode_seconds = _m.histogram(
    "mxtpu_gen_decode_seconds",
    "Decode-phase wall time per engine step by model (one plain step "
    "or one speculative propose+verify round)")
gen_tokens_committed = _m.counter(
    "mxtpu_gen_tokens_committed_total",
    "Tokens committed to sequences by model and phase (prefill|decode) "
    "— the numerator of tokens/sec")
gen_spec_proposed = _m.counter(
    "mxtpu_gen_spec_proposed_total",
    "Draft tokens proposed to the target model by speculative rounds")
gen_spec_accepted = _m.counter(
    "mxtpu_gen_spec_accepted_total",
    "Draft tokens accepted by target verification (accept-rate "
    "numerator; denominator is gen_spec_proposed)")
gen_kv_blocks_in_use = _m.gauge(
    "mxtpu_gen_kv_blocks_in_use",
    "Paged-KV pool blocks currently mapped into live slot block tables")
gen_kv_blocks_free = _m.gauge(
    "mxtpu_gen_kv_blocks_free",
    "Paged-KV pool blocks on the free list (allocation headroom)")
gen_kv_fragmentation = _m.gauge(
    "mxtpu_gen_kv_fragmentation",
    "Unused fraction of mapped paged-KV block capacity "
    "(1 - filled_positions / (blocks_in_use * block_size)); high values "
    "mean many ragged last blocks")
gen_kv_free_fraction = _m.gauge(
    "mxtpu_gen_kv_free_fraction",
    "Free fraction of the paged-KV pool (blocks_free / num_blocks) — "
    "the kv_pool_pressure WARN signal and the autoscaler's headroom "
    "input, by pool name")
gen_kv_blocks_in_use_peak = _m.gauge(
    "mxtpu_gen_kv_blocks_in_use_peak",
    "Pool-lifetime high watermark of mapped paged-KV blocks, by pool "
    "name — how close this pool has ever come to exhaustion")
gen_kv_pool_exhausted = _m.counter(
    "mxtpu_gen_kv_pool_exhausted_total",
    "KVPoolExhausted raises (an append found no free block), by pool "
    "name — the kv_pool_pressure PAGE signal; shed-on-pressure is this "
    "counter moving, a bug is this counter moving with free blocks left")


# -- observability plane (tracing ring, flight, debugz, costs) --------
telemetry_spans_dropped = _m.counter(
    "mxtpu_telemetry_spans_dropped_total",
    "Finished trace spans evicted from the bounded retention ring "
    "(MXTPU_TRACE_MAX_SPANS) to admit newer ones")
flight_events = _m.counter(
    "mxtpu_flight_events_total",
    "Flight-recorder events recorded, by event type")
debugz_requests = _m.counter(
    "mxtpu_debugz_requests_total",
    "Debugz HTTP requests served, by path and status")
lockdep_violations = _m.counter(
    "mxtpu_lockdep_violations_total",
    "Runtime lockdep witness violations by kind (order = lock-order "
    "cycle observed across threads, blocking = lock held across a "
    "blocking operation); see telemetry/lockdep.py")
model_flops_per_exec = _m.gauge(
    "mxtpu_model_flops_per_executable",
    "FLOPs of one run of the named program, counted at its eager first "
    "call: aten products (FlopCounterMode) plus the hand kernels' "
    "products by formula")
model_bytes_per_exec = _m.gauge(
    "mxtpu_model_bytes_per_executable",
    "Bytes accessed by one run of the named program, counted at its "
    "eager first call: every aten op's operands and results plus the "
    "hand kernels' reads and writes by formula")
model_achieved_tflops = _m.gauge(
    "mxtpu_model_achieved_tflops",
    "Achieved TFLOP/s over the last observed execution of the named "
    "executable")
model_flops_utilization = _m.gauge(
    "mxtpu_model_flops_utilization",
    "Achieved FLOP/s as a fraction of the MXTPU_PEAK_TFLOPS roofline "
    "(MFU) for the named executable")
model_tokens_per_sec = _m.gauge(
    "mxtpu_model_tokens_per_sec",
    "Samples/tokens consumed per second by the named executable")
costs_capture_errors = _m.counter(
    "mxtpu_costs_capture_errors_total",
    "Programs whose cost count failed under MXTPU_COSTS=1, by name: the "
    "batch is still served, the program has no MFU reading, and a "
    "costs.capture_failed flight event says why")


# -- device-memory plane (telemetry/memz.py) -------------------------
mem_device_bytes_in_use = _m.gauge(
    "mxtpu_mem_device_bytes_in_use",
    "Device memory currently allocated, by device — from the CUDA "
    "caching allocator (torch.cuda.memory_stats)")
mem_device_bytes_limit = _m.gauge(
    "mxtpu_mem_device_bytes_limit",
    "Device memory capacity, by device (torch.cuda.mem_get_info total)")
mem_device_peak_bytes = _m.gauge(
    "mxtpu_mem_device_peak_bytes",
    "Allocator-reported peak bytes in use since process start, by device")
mem_hbm_used_fraction = _m.gauge(
    "mxtpu_mem_hbm_used_fraction",
    "bytes_in_use / bytes_limit, by device — the mxtop HBM%% column "
    "and the first thing to look at before an OOM")
mem_host_rss_bytes = _m.gauge(
    "mxtpu_mem_host_rss_bytes",
    "Host-process resident set size (the Python side of the memory "
    "story: numpy staging buffers, pinned copies, the framework itself)")
mem_watermark_bytes = _m.gauge(
    "mxtpu_mem_watermark_bytes",
    "Process-lifetime memory high watermark, by scope "
    "(device:<name> | host_rss)")
mem_program_bytes = _m.gauge(
    "mxtpu_mem_program_bytes",
    "Per-program memory footprint of a captured CUDA graph, by program "
    "name and kind (argument|output|temp|generated_code|total) — "
    "captured by BlockProgram from the allocator around the capture")
oom_events = _m.counter(
    "mxtpu_oom_events_total",
    "Out-of-memory observations by kind (kv_pool = paged pool "
    "exhausted, resource_exhausted = torch.cuda.OutOfMemoryError) — each "
    "one left an oom.* flight event and, with MXTPU_MEM_EXPORT set, "
    "a post-mortem dump")


# -- compile (capture) accounting ------------------------------------
# The JAX package folds jax.monitoring's backend-compile events into the
# mxtpu_jit_* counters through a hook. The port's counterpart of a compile
# is a CUDA graph capture, which it makes itself: compilecache/aot.py's
# BlockProgram calls note_compile() once per capture, inside the
# compiling(where) region that labels it, and the counters count while
# the metrics are enabled (ModelServer enables them).
_compile_ctx = threading.local()


@contextlib.contextmanager
def compiling(where):
    """Label the captures made inside the region: each is counted under
    ``mxtpu_jit_compiles_total{where=...}``. Nestable; captures outside
    any region fall under where="other"."""
    prev = getattr(_compile_ctx, "where", None)
    _compile_ctx.where = where
    try:
        yield
    finally:
        _compile_ctx.where = prev


def compile_events(where=None):
    """Current capture count: ``where=None`` sums every label."""
    if where is not None:
        return jit_compiles.value(where=where)
    return sum(jit_compiles.snapshot().values())


def note_compile(seconds):
    """One capture of ``seconds``, under the current compiling() label."""
    where = getattr(_compile_ctx, "where", None) or "other"
    jit_compiles.inc(where=where)
    jit_compile_seconds.inc(seconds, where=where)
