"""Continuous-batching autoregressive decode over a fixed slot grid.

Counterpart of ``incubator_mxnet_tpu/serving/decode.py``. The decode batch is
a FIXED grid of KV-cache slots: requests are admitted into free slots BETWEEN
steps, run however many steps they need, and release their slot the moment
they finish (iteration-level join and leave, as in Orca). The step contract
is model-agnostic:

    step_fn(tokens, cache, active) -> logits

with ``tokens (slots,) int32`` (the pad token in inactive rows), ``cache``
the KV cache (the step reads and writes its entries for ALL slots at once;
inactive rows compute values that are never observed) and ``active (slots,)
bool``; logits come back as a (slots, V) array. Without a ``prefill_fn`` a
prompt is fed one token per step through the same path; with one (the
gpt_decoder family) the prompt prefix is committed in chunked forwards at
admission and the grid only feeds the last prompt token. Those prefills run
on the loop's thread without the loop's lock: the slot is reserved under
the lock, prefilled, then published (the JAX package prefills under its
lock, so a ``submit``, ``stats`` or ``drain`` waits for a whole admission
pass there). Sampling is greedy argmax.

Deadline shed: at join the loop estimates ``steps * EWMA(step seconds)``;
mid-generation an expired deadline retires the slot (stage "decode") unless
the sequence finished on that very step. KV pool exhaustion sheds as stage
"capacity". ``stats()`` carries the loop's own counts.

Telemetry as in the JAX package: queue wait, prefill time, step time,
batch occupancy, TTFT and TPOT go to the serving histograms; decode steps,
committed tokens and results to the counters; sheds and slot retirements
to the flight ring; and a head-sampled request gets its ``serve.queue``,
``serve.join``, ``decode.prefill`` and one ``decode.step`` span per grid
step after the fact. Every instrument sits here, around the family's step
and prefill calls, never inside them: a family may replay the step as a
CUDA graph, where anything inside would fire once, at capture. The step's
logits come back as numpy, so its time covers the device work.
"""

import collections
import os
import threading
import time

import numpy as np

from ..telemetry import catalog as _cat
from ..telemetry import flight as _fl
from ..telemetry import tracing as _tr
from .scheduler import Request, shed_request

__all__ = ["DecodeRequest", "DecodeLoop", "check_token_ids"]


def check_token_ids(tokens, vocab_size):
    """Refuse token ids outside [0, vocab_size) on the host: on the card an
    out-of-range embedding index is a device fault, not an error."""
    tokens = np.asarray(tokens)
    if tokens.size and (tokens.min() < 0 or tokens.max() >= vocab_size):
        raise ValueError("token ids must lie in [0, %d), got [%d, %d]"
                         % (vocab_size, tokens.min(), tokens.max()))
    return tokens


def _is_capacity_error(e):
    """KV pool exhaustion is pressure, not a bug. Imported lazily: generate
    imports serving.loader, which would otherwise cycle back here."""
    from ..generate.paged_kv import KVPoolExhausted
    return isinstance(e, KVPoolExhausted)


class DecodeRequest(Request):
    """Generate up to `max_new_tokens` after `prompt` (1-D int tokens);
    stops early at `eos_id`. Result: {"tokens": generated int32 array}."""

    def __init__(self, model, prompt, max_new_tokens, eos_id=None,
                 deadline=None):
        prompt = np.asarray(prompt, np.int32).ravel()
        if prompt.size < 1:
            raise ValueError("prompt must hold at least one token")
        super().__init__(model, {"tokens": prompt.reshape(1, -1)},
                         deadline=deadline)
        self.prompt = prompt
        self.max_new_tokens = int(max_new_tokens)
        self.eos_id = eos_id


class _Seq:
    """Per-slot progress: prompt feeding, then greedy generation off the
    model's logits."""

    def __init__(self, req):
        self.req = req
        self.fed = 0
        self.generated = []
        self.last_tok = None    # monotonic time of the last committed token
        #                         (TTFT on the first, TPOT gaps after)

    def next_input(self):
        if self.fed < self.req.prompt.size:
            return int(self.req.prompt[self.fed])
        return self.generated[-1]

    def consume(self, logits):
        """Account one executed step; once the whole prompt is in, the
        step's logits predict the next token."""
        self.fed += 1
        if self.fed >= self.req.prompt.size:
            self.generated.append(int(np.argmax(logits)))

    @property
    def finished(self):
        if len(self.generated) >= self.req.max_new_tokens:
            return True
        return (self.req.eos_id is not None and self.generated
                and self.generated[-1] == self.req.eos_id)


class DecodeLoop:
    """One per served generative model; owns its KV cache exclusively.

    A ``prefill_fn`` comes with the family's ``prefill_chunk``, the prompt
    positions it commits per forward, which the admission estimate counts;
    None reads ``MXTPU_GEN_PREFILL_CHUNK`` (default 32), at least 1.
    Requests ask for at most ``max_new_tokens_cap`` tokens; None reads
    ``MXTPU_SERVE_MAX_NEW_TOKENS`` (default 64). An argument wins over the
    environment, as in the JAX package."""

    def __init__(self, name, step_fn, cache, pad_token=0,
                 max_new_tokens_cap=None, prefill_fn=None,
                 prefill_chunk=None):
        self.name = name
        self._step_fn = step_fn
        self._cache = cache
        self._prefill_fn = prefill_fn
        self._prefill_chunk = max(1, int(
            prefill_chunk if prefill_chunk is not None
            else os.environ.get("MXTPU_GEN_PREFILL_CHUNK", "32") or 32))
        self._pad = int(pad_token)
        self._cap = int(max_new_tokens_cap if max_new_tokens_cap is not None
                        else os.environ.get("MXTPU_SERVE_MAX_NEW_TOKENS",
                                            "64"))
        self._cond = threading.Condition()
        self._pending = collections.deque()
        self._active = {}               # slot -> _Seq
        self._stopping = False
        self._draining = False
        self._in_step = False           # a step_fn call is running now
        self._admitting = {}            # slot -> _Seq reserved, prefilling
        self._steps = 0
        self._prefills = 0
        self._tokens = {"prefill": 0, "decode": 0}
        self._retired = collections.Counter()     # slot retirements by reason
        self._shed_stages = collections.Counter()
        self._ewma_step = None
        self._thread = threading.Thread(
            target=self._run, name="serve-decode-%s" % name, daemon=True)

    # ---------------------------------------------------------- admission
    def submit(self, req):
        if req.max_new_tokens > self._cap:
            req.max_new_tokens = self._cap
        now = time.monotonic()
        if req.deadline is not None and now >= req.deadline:
            self._shed(req, "queue", "deadline expired before admission")
            return req
        if req.prompt.size + req.max_new_tokens > self._cache.max_len:
            req.fail(ValueError(
                "prompt %d + max_new_tokens %d exceeds the KV cache "
                "max_len %d" % (req.prompt.size, req.max_new_tokens,
                                self._cache.max_len)))
            return req
        with self._cond:
            if self._stopping:
                req.fail(RuntimeError("decode loop %r is stopped"
                                      % self.name))
                return req
            if self._draining:
                self._shed(req, "draining",
                           "model is draining for a weight swap; retry")
                return req
            self._pending.append(req)
            self._cond.notify_all()
        return req

    def _shed(self, req, stage, detail=""):
        if req.shed(stage, detail):     # no double count if already done
            self._shed_stages[stage] += 1
            shed_request(self.name, req, stage, detail)

    # ---------------------------------------------------------- lifecycle
    def start(self):
        self._thread.start()
        return self

    def stop(self, timeout=5.0):
        with self._cond:
            self._stopping = True
            self._cond.notify_all()
        if self._thread.ident is not None:      # started
            self._thread.join(timeout)
        with self._cond:
            while self._pending:
                self._pending.popleft().fail(
                    RuntimeError("decode loop %r stopped" % self.name))
            for slot, seq in list(self._active.items()):
                seq.req.fail(RuntimeError("decode loop %r stopped"
                                          % self.name))
                self._cache.free(slot)
            self._active.clear()
            # a slot still prefilling is the loop thread's to free
            for seq in self._admitting.values():
                seq.req.fail(RuntimeError("decode loop %r stopped"
                                          % self.name))

    # ------------------------------------------------------ drain/re-admit
    @property
    def draining(self):
        return self._draining

    def drain(self, timeout=30.0):
        """Fence the decode plane. New submits shed with the RETRIABLE
        "draining" stage; queued requests are shed at once; ACTIVE sequences
        get `timeout` seconds to finish, and stragglers are then shed and
        their slots freed on the loop's next retire pass. True when the grid
        is empty and no step is in flight.

        An admission pass reserves its slots under the loop's lock and runs
        their prompts' chunked prefills outside it, on the loop's thread
        (hundreds of ms for a few long prompts); the reserved slots count as
        in flight. The window starts once that pass is over: a deadline
        taken before it would leave the sessions being admitted none of
        their window (the JAX package's drain takes its deadline before it
        can take the lock, which its admission pass holds through the
        prefills). So `timeout` bounds the windows, not the call: a drain
        that arrives during an admission pass first waits for that pass's
        prefills, and its wall time is at most that pass plus twice
        `timeout`."""
        with self._cond:
            self._draining = True
            while self._pending:
                self._shed(self._pending.popleft(), "draining",
                           "drained before admission; retry")
            self._cond.notify_all()
            while self._admitting:
                self._cond.wait(0.05)
            deadline = time.monotonic() + float(timeout)
            while self._active or self._in_step:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                self._cond.wait(min(left, 0.05))
            for seq in list(self._active.values()):
                self._shed(seq.req, "draining",
                           "fenced at the drain deadline; the session "
                           "re-prefills on retry")
            while self._active or self._in_step:
                left = deadline + float(timeout) - time.monotonic()
                if left <= 0:
                    return False
                self._cond.wait(min(left, 0.05))
        return True

    def admit(self):
        """Re-open admission after a drain()."""
        with self._cond:
            self._draining = False
            self._cond.notify_all()

    def reset_service_estimates(self):
        """Forget the EWMA step time (warm-up steps skew it)."""
        with self._cond:
            self._ewma_step = None

    def stats(self):
        """Queue and grid state, grid steps and prefill calls run, tokens
        committed by phase, slot retirements by reason and sheds by
        stage."""
        with self._cond:
            return {"pending": len(self._pending),
                    "active": len(self._active),
                    "draining": self._draining,
                    "steps": self._steps,
                    "prefills": self._prefills,
                    "tokens": dict(self._tokens),
                    "retired": dict(self._retired),
                    "shed": dict(self._shed_stages),
                    "step_ewma_s": self._ewma_step}

    # -------------------------------------------------------- decode loop
    def _est_steps(self, req):
        """Forwards a request still needs: with a prefill_fn the prompt
        prefix lands in ceil((P-1)/chunk) chunked forwards plus one step for
        the last prompt token; without, one step per prompt token; plus
        max_new decode steps either way."""
        if self._prefill_fn is not None and req.prompt.size > 1:
            chunks = -(-(req.prompt.size - 1) // self._prefill_chunk)
            return chunks + 1 + req.max_new_tokens
        return req.prompt.size + req.max_new_tokens

    def _admit_locked(self):
        """Join point, under the loop's lock: fill free slots from the FIFO
        between steps. A request whose prompt prefix needs the family's
        chunked prefill has its slot reserved (in flight for a drain) and
        is returned, [(slot, seq, t_adm)], for ``_prefill_reserved`` to run
        without the lock; any other joins the grid at once."""
        reserved = []
        if self._draining:
            return reserved
        now = time.monotonic()
        est = self._ewma_step or 0.0
        while self._pending and self._cache.in_use < self._cache.slots:
            req = self._pending[0]
            if req.done:                # cancelled while queued
                self._pending.popleft()
                continue
            if req.deadline is not None and \
                    now + est * self._est_steps(req) > req.deadline:
                self._pending.popleft()
                self._shed(req, "join", "full generation can't meet "
                           "the deadline")
                continue
            slot = self._cache.alloc()
            if slot is None:
                break
            self._pending.popleft()
            seq = _Seq(req)
            _cat.serving_queue_seconds.observe(
                time.monotonic() - req.arrival, model=self.name,
                exemplar=req.trace[0] if req.trace else None)
            t_adm = None
            if req.trace:
                # retroactive queue span: arrival -> slot grant
                t_adm = time.time()
                _tr.record_span(
                    "serve.queue", req.trace[0], parent_id=req.trace[1],
                    t0=t_adm - (time.monotonic() - req.arrival), t1=t_adm,
                    sampled=True, model=self.name, request_id=req.id)
            if self._prefill_fn is not None and req.prompt.size > 1:
                self._admitting[slot] = seq
                reserved.append((slot, seq, t_adm))
            else:
                self._join_locked(slot, seq, t_adm)
        _cat.serving_decode_slots.set(len(self._active), model=self.name)
        return reserved

    def _join_locked(self, slot, seq, t_adm):
        """The sequence enters the step grid at ``slot``."""
        req = seq.req
        if req.trace:
            # join span: slot grant -> active in the step grid (the
            # chunked prefill, when it ran, sits inside this window)
            _tr.record_span(
                "serve.join", req.trace[0], parent_id=req.trace[1],
                t0=t_adm, t1=time.time(), sampled=True,
                model=self.name, request_id=req.id, slot=slot)
        self._active[slot] = seq

    def _prefill_reserved(self, reserved):
        """The reserved slots' chunked prefills of their prompt prefixes,
        on the loop's thread (so never beside a grid step on the same
        cache) and without the loop's lock, so that ``submit``, ``stats``
        and ``drain`` are not held up by them. Each sequence is then
        published to the grid under the lock, or failed, or shed; one that
        was cancelled, fenced by a drain or stopped meanwhile gives its
        slot back."""
        for slot, seq, t_adm in reserved:
            req = seq.req
            error = None
            t0 = time.perf_counter()
            try:
                self._prefill_fn(slot, req.prompt[:-1], self._cache)
            except Exception as e:  # noqa: BLE001 - a broken prefill
                # fails this request, not the serving loop
                error = e
            dt = time.perf_counter() - t0
            if error is None:
                _cat.gen_prefill_seconds.observe(
                    dt, model=self.name,
                    exemplar=req.trace[0] if req.trace else None)
                _cat.serving_forward_seconds.observe(
                    dt, model=self.name, bucket="prefill")
                _cat.gen_tokens_committed.inc(
                    req.prompt.size - 1, model=self.name, phase="prefill")
                if req.trace:
                    t1 = time.time()
                    _tr.record_span(
                        "decode.prefill", req.trace[0],
                        parent_id=req.trace[1], t0=t1 - dt, t1=t1,
                        sampled=True, model=self.name, request_id=req.id,
                        prefill_tokens=int(req.prompt.size - 1),
                        chunk=self._prefill_chunk, slot=slot)
            with self._cond:
                del self._admitting[slot]
                if error is not None:
                    if _is_capacity_error(error):
                        self._shed(req, "capacity", str(error))
                    elif req.fail(error):
                        self._retired["error"] += 1
                        _cat.serving_requests.inc(model=self.name,
                                                  status="error")
                    self._cache.free(slot)
                elif req.done or self._stopping:
                    req.fail(RuntimeError("decode loop %r stopped"
                                          % self.name))
                    self._cache.free(slot)
                else:
                    seq.fed = req.prompt.size - 1
                    self._prefills += 1
                    self._tokens["prefill"] += req.prompt.size - 1
                    self._join_locked(slot, seq, t_adm)
                _cat.serving_decode_slots.set(len(self._active),
                                              model=self.name)
                self._cond.notify_all()     # wake a waiting drain()

    def _run(self):
        slots = self._cache.slots
        while True:
            with self._cond:
                while (not self._stopping and not self._pending
                        and not self._active):
                    self._cond.wait(0.1)
                if self._stopping:
                    return
                reserved = self._admit_locked()
                active = {} if reserved else dict(self._active)
                if active:
                    self._in_step = True
            if reserved:
                self._prefill_reserved(reserved)
                continue
            if not active:
                continue
            tokens = np.full(slots, self._pad, np.int32)
            mask = np.zeros(slots, bool)
            for slot, seq in active.items():
                tokens[slot] = seq.next_input()
                mask[slot] = True
            t0 = time.perf_counter()
            try:
                logits = np.asarray(self._step_fn(tokens, self._cache, mask))
            except Exception as e:  # noqa: BLE001 - a broken step fails
                # the in-flight sequences, not the serving loop; pool
                # exhaustion sheds them as a capacity event (freeing their
                # blocks is the relief)
                capacity = _is_capacity_error(e)
                with self._cond:
                    for slot, seq in list(self._active.items()):
                        if capacity:
                            self._shed(seq.req, "capacity", str(e))
                        elif seq.req.fail(e):
                            self._retired["error"] += 1
                            _cat.serving_requests.inc(model=self.name,
                                                      status="error")
                        self._cache.free(slot)
                    self._active.clear()
                    self._in_step = False
                    self._cond.notify_all()
                continue
            dt = time.perf_counter() - t0
            _cat.serving_decode_steps.inc(model=self.name)
            _cat.serving_batch_occupancy.observe(len(active),
                                                 model=self.name)
            _cat.serving_forward_seconds.observe(dt, model=self.name,
                                                 bucket="decode")
            now = time.monotonic()
            step_tokens = {"prefill": 0, "decode": 0}
            t_wall = None               # epoch stamp, taken once, lazily
            with self._cond:
                self._ewma_step = dt if self._ewma_step is None else \
                    0.7 * self._ewma_step + 0.3 * dt
                self._steps += 1
                # token accounting in the retire pass, after consume, so the
                # final step of a retiring sequence counts too
                for slot, seq in list(self._active.items()):
                    before = len(seq.generated)
                    seq.consume(logits[slot])
                    new_tok = len(seq.generated) > before
                    phase = "decode" if new_tok else "prefill"
                    self._tokens[phase] += 1
                    step_tokens[phase] += 1
                    if new_tok:
                        ex = seq.req.trace[0] if seq.req.trace else None
                        if before == 0:
                            _cat.serving_ttft_seconds.observe(
                                now - seq.req.arrival, model=self.name,
                                exemplar=ex)
                        elif seq.last_tok is not None:
                            _cat.serving_tpot_seconds.observe(
                                now - seq.last_tok, model=self.name,
                                exemplar=ex)
                        seq.last_tok = now
                    if seq.req.trace:
                        if t_wall is None:
                            t_wall = time.time()
                        _tr.record_span(
                            "decode.step", seq.req.trace[0],
                            parent_id=seq.req.trace[1], t0=t_wall - dt,
                            t1=t_wall, sampled=True, model=self.name,
                            request_id=seq.req.id, slot=slot,
                            tokens_committed=int(new_tok),
                            generated=len(seq.generated))
                    if seq.req.done:    # cancelled mid-flight: release
                        reason = "cancelled"
                    elif seq.finished:
                        # finished beats the deadline check: this step paid
                        # for the final token, so it is delivered
                        reason = "ok"
                        if seq.req.complete({"tokens": np.asarray(
                                seq.generated, np.int32)}):
                            _cat.serving_requests.inc(model=self.name,
                                                      status="ok")
                            _cat.serving_request_seconds.observe(
                                now - seq.req.arrival, model=self.name,
                                exemplar=seq.req.trace[0]
                                if seq.req.trace else None)
                    elif seq.req.deadline is not None \
                            and now > seq.req.deadline:
                        reason = "deadline"
                        self._shed(seq.req, "decode",
                                   "deadline passed mid-generation")
                    else:
                        continue
                    self._retired[reason] += 1
                    attrs = {"model": self.name, "reason": reason,
                             "request_id": seq.req.id, "slot": slot,
                             "generated": len(seq.generated)}
                    if seq.req.trace:
                        attrs["trace_id"] = seq.req.trace[0]
                    _fl.record("serving.retire", **attrs)
                    self._cache.free(slot)
                    del self._active[slot]
                _cat.serving_decode_slots.set(len(self._active),
                                              model=self.name)
                self._in_step = False
                self._cond.notify_all()     # wake a waiting drain()
            for phase, n in step_tokens.items():
                if n:
                    _cat.gen_tokens_committed.inc(n, model=self.name,
                                                  phase=phase)
