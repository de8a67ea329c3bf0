"""Generation engine: chunked prefill, sampling, speculative decoding.

Counterpart of ``incubator_mxnet_tpu/generate/engine.py``. The engine owns
sequences end to end: it allocates paged-KV slots, ingests prompts in chunks
of ``prefill_chunk`` positions, runs batched greedy or temperature decode,
and, given a draft model, Leviathan-style speculative decoding:

    round:  the draft proposes d_1..d_k one token at a time
            the target scores [ctx[-1], d_1..d_k] in ONE (k+1)-wide forward
            accept a = the longest prefix with d_j == argmax(target row j-1)
            commit d_1..d_a plus the target's own next token t_a
            truncate both caches to the committed length

Every committed token is the argmax of a target distribution given the
previously committed tokens, which is what plain greedy commits, so
speculative greedy output equals plain greedy output token for token (pinned
in the tests, inside the port). All cache mutation happens here; the model
adapter (``GPTPagedLM``) is a forward over device tensors. Logits come to the
host for sampling. ``last_stats`` carries the counts and times.

Telemetry as in the JAX package: a ``gen.prefill`` span per sequence and a
``gen.decode_step`` span per plain step (one per speculative round, after
the fact, with its proposed and accepted counts), the prefill and decode
histograms, committed tokens by phase, and the speculative proposed and
accepted counters. The times are taken around forwards whose logits reach
the host, so they cover the device work.
"""

import time

import numpy as np
import torch

from ..context import resolve_device
from ..models.gpt import GPTDecoder, gpt_config
from ..serving.decode import check_token_ids
from ..telemetry import catalog as _cat
from ..telemetry import tracing as _tr
from .family import _CONFIG_KEYS, PREFILL_CHUNK, commit_chunk, gpt_cache_spec
from .paged_kv import PagedKVCache, _env_int

__all__ = ["GenerateEngine", "GPTPagedLM"]


class GPTPagedLM:
    """Adapter over ``gpt_forward_paged`` on ``device`` (None: ``cuda:0``,
    raising without CUDA; ``"cpu"`` for the plain path).

    ``params`` is a flat JAX-named dict (numpy arrays, ml_dtypes bfloat16
    arrays, tensors or NDArrays); float32, bfloat16 and float16 weights keep
    their dtype, and the model computes in it
    (``models/gpt.params_from_jax``).
    ``forward(tokens, lengths, tables, k_pools, v_pools)`` takes host
    tokens, lengths and tables and device pools, and returns device tensors
    ``(logits (S, C, V), new_k, new_v)``."""

    def __init__(self, params, config, device=None):
        self.device = resolve_device(device)
        self.config = gpt_config(config)
        self.num_layers = self.config["num_layers"]
        self.model = GPTDecoder(
            device=self.device,
            **{k: self.config[k] for k in _CONFIG_KEYS}).load_params(params)

    def cache_spec(self):
        return gpt_cache_spec(self.config)

    def make_cache(self, slots, max_len=None, **kw):
        return PagedKVCache(slots, self.cache_spec(),
                            max_len=max_len or self.config["max_len"],
                            device=self.device, **kw)

    def forward(self, tokens, lengths, tables, k_pools, v_pools):
        dev = self.device
        tokens = check_token_ids(tokens, self.config["vocab_size"])
        with torch.inference_mode():
            return self.model.forward_paged(
                torch.as_tensor(np.asarray(tokens, np.int32), device=dev),
                torch.as_tensor(np.asarray(lengths, np.int32), device=dev),
                torch.as_tensor(np.asarray(tables, np.int32), device=dev),
                k_pools, v_pools)


class GenerateEngine:
    """Drives one model (plus an optional draft) over paged KV caches.

    model / draft: adapters with ``num_layers`` and ``forward(...)`` (the
    ``GPTPagedLM`` contract). ``spec_k`` > 0 with a draft turns on
    speculative decoding, greedy only: temperature sampling with a draft
    raises, since the accept rule compares draft tokens to the target's
    argmax. ``spec_k=None`` reads ``MXTPU_GEN_SPEC_K`` (default 4) and
    ``prefill_chunk=None`` reads ``MXTPU_GEN_PREFILL_CHUNK`` (default 32),
    as in the JAX package; an argument wins.
    """

    def __init__(self, model, cache, draft=None, draft_cache=None,
                 spec_k=None, prefill_chunk=None, temperature=0.0,
                 seed=0, name="gpt"):
        if (draft is None) != (draft_cache is None):
            raise ValueError("draft model and draft cache come together")
        self.model = model
        self.cache = cache
        self.draft = draft
        self.draft_cache = draft_cache
        self.spec_k = int(spec_k if spec_k is not None
                          else _env_int("MXTPU_GEN_SPEC_K", 4))
        self.prefill_chunk = int(
            prefill_chunk if prefill_chunk is not None
            else _env_int("MXTPU_GEN_PREFILL_CHUNK", PREFILL_CHUNK))
        if self.prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        self.temperature = float(temperature)
        self.name = name
        self._rng = np.random.RandomState(seed)
        if self.draft is not None and self.temperature > 0:
            raise ValueError(
                "speculative decoding is greedy-only: the accept rule "
                "compares draft tokens to target argmax; run with "
                "temperature=0 or drop the draft model")
        self.last_stats = {}

    # ---------------------------------------------------------- plumbing
    def _forward(self, adapter, cache, slots, tokens):
        """One adapter forward for `slots` (list) feeding `tokens` (S, C);
        returns (logits, new_k, new_v) WITHOUT committing."""
        lengths = cache.lengths[list(slots)].astype(np.int32)
        tables = cache.tables_array(slots)
        kps = [cache.pool("k%d" % i) for i in range(adapter.num_layers)]
        vps = [cache.pool("v%d" % i) for i in range(adapter.num_layers)]
        return adapter.forward(tokens, lengths, tables, kps, vps)

    @staticmethod
    def _commit(adapter, cache, counts, new_k, new_v):
        """Commit ``[(slot, row, n)]`` chunk positions, one indexed write
        per pool."""
        with torch.inference_mode():
            commit_chunk(cache, adapter.num_layers, new_k, new_v, counts)

    def _step(self, adapter, cache, slots, tokens, commit=True):
        """Feed one token per slot ((S, 1)); commit K/V; return the (S, V)
        next-token logits on the host."""
        logits, nk, nv = self._forward(adapter, cache, slots, tokens)
        if commit:
            self._commit(adapter, cache,
                         [(slot, row, 1) for row, slot in enumerate(slots)],
                         nk, nv)
        return logits[:, -1].float().cpu().numpy()

    def _prefill(self, adapter, cache, slot, tokens_1d):
        """Chunked prompt ingestion: commit K/V for every prompt token in
        forwards of at most ``prefill_chunk`` positions."""
        chunk = self.prefill_chunk
        for start in range(0, len(tokens_1d), chunk):
            piece = np.asarray(tokens_1d[start:start + chunk], np.int32)[None]
            _logits, nk, nv = self._forward(adapter, cache, [slot], piece)
            self._commit(adapter, cache, [(slot, 0, piece.shape[1])], nk, nv)

    def _sample(self, logits_row):
        if self.temperature <= 0:
            return int(np.argmax(logits_row))
        z = logits_row.astype(np.float64) / self.temperature
        z -= z.max()
        p = np.exp(z)
        p /= p.sum()
        return int(self._rng.choice(len(p), p=p))

    # ---------------------------------------------------------- generate
    def generate(self, prompts, max_new_tokens, eos_id=None):
        """Generate continuations for ``prompts`` (lists of int token ids);
        returns a list of generated-token lists (prompt excluded). Stats for
        the run land in ``self.last_stats``."""
        prompts = [list(map(int, p)) for p in prompts]
        if not prompts:
            return []
        for p in prompts:
            if not p:
                raise ValueError("empty prompt")
            if len(p) + max_new_tokens > self.cache.max_len:
                raise ValueError(
                    "prompt (%d) + max_new_tokens (%d) exceeds cache "
                    "max_len (%d)" % (len(p), max_new_tokens,
                                      self.cache.max_len))
        stats = {"prefill_seconds": 0.0, "decode_seconds": 0.0,
                 "prefill_tokens": 0, "decode_tokens": 0,
                 "proposed": 0, "accepted": 0}
        seqs = []      # per sequence: dict(ctx, slot, dslot, out, done)
        try:
            for p in prompts:
                slot = self.cache.alloc()
                if slot is None:
                    raise ValueError("no free KV slot for prompt %d"
                                     % len(seqs))
                dslot = None
                if self.draft is not None:
                    dslot = self.draft_cache.alloc()
                    if dslot is None:
                        raise ValueError("no free draft KV slot")
                seqs.append({"ctx": list(p), "slot": slot, "dslot": dslot,
                             "out": [], "done": False})

            # prefill: commit ctx[:-1]; the last prompt token is fed by the
            # first decode step (its logits choose token 1)
            t0 = time.monotonic()
            for s in seqs:
                t_seq = time.monotonic()
                with _tr.span("gen.prefill", model=self.name,
                              slot=s["slot"],
                              tokens=max(len(s["ctx"]) - 1, 0)):
                    if len(s["ctx"]) > 1:
                        self._prefill(self.model, self.cache, s["slot"],
                                      s["ctx"][:-1])
                        if self.draft is not None:
                            self._prefill(self.draft, self.draft_cache,
                                          s["dslot"], s["ctx"][:-1])
                        stats["prefill_tokens"] += len(s["ctx"]) - 1
                _cat.gen_prefill_seconds.observe(
                    time.monotonic() - t_seq, model=self.name)
            stats["prefill_seconds"] = time.monotonic() - t0

            t1 = time.monotonic()
            if self.draft is not None and self.spec_k > 0:
                for s in seqs:
                    self._speculative_loop(s, max_new_tokens, eos_id, stats)
            else:
                self._plain_loop(seqs, max_new_tokens, eos_id, stats)
            stats["decode_seconds"] = time.monotonic() - t1
            _cat.gen_tokens_committed.inc(
                stats["prefill_tokens"], model=self.name, phase="prefill")
            _cat.gen_tokens_committed.inc(
                stats["decode_tokens"], model=self.name, phase="decode")
            self.last_stats = stats
            return [s["out"] for s in seqs]
        finally:
            for s in seqs:
                if s["slot"] is not None and s["slot"] in self.cache._live:
                    self.cache.free(s["slot"])
                if (s["dslot"] is not None
                        and s["dslot"] in self.draft_cache._live):
                    self.draft_cache.free(s["dslot"])

    # ------------------------------------------------------ plain decode
    def _plain_loop(self, seqs, max_new_tokens, eos_id, stats):
        """Batched autoregressive decode: one (S, 1) forward per step over
        the still-active rows."""
        while True:
            live = [s for s in seqs if not s["done"]]
            if not live:
                return
            t0 = time.monotonic()
            with _tr.span("gen.decode_step", model=self.name,
                          rows=len(live)) as sp:
                tokens = np.asarray([[s["ctx"][-1]] for s in live],
                                    np.int32)
                logits = self._step(self.model, self.cache,
                                    [s["slot"] for s in live], tokens)
                for row, s in enumerate(live):
                    tok = self._sample(logits[row])
                    s["ctx"].append(tok)
                    s["out"].append(tok)
                    stats["decode_tokens"] += 1
                    if tok == eos_id or len(s["out"]) >= max_new_tokens:
                        s["done"] = True
                sp.set_attr("tokens_committed", len(live))
            _cat.gen_decode_seconds.observe(time.monotonic() - t0,
                                            model=self.name)

    # ------------------------------------------------ speculative decode
    def _speculative_loop(self, s, max_new_tokens, eos_id, stats):
        """Draft-propose / target-verify rounds for ONE sequence.

        Between rounds, with n = len(ctx), the target cache holds exactly
        n-1 committed positions; the draft cache holds at most n-1 after
        truncation, and the catch-up loop feeds ctx[m:], whose final feed
        (always ctx[-1]) yields the draft's first proposal."""
        ctx, slot, dslot = s["ctx"], s["slot"], s["dslot"]
        while not s["done"]:
            t0 = time.monotonic()
            n = len(ctx)
            # never commit past max_new_tokens (a round lands at most k+1
            # tokens) and never let the (k+1)-wide verify overflow the cache;
            # k == 0 is a plain 1-wide target step
            remaining = max_new_tokens - len(s["out"])
            k = max(0, min(self.spec_k, remaining - 1,
                           self.cache.max_len - n))
            drafts = []
            if k > 0:
                # 1) draft catch-up: feed every committed token the draft
                #    cache is missing; the last feed returns d_1's logits
                m = int(self.draft_cache.lengths[dslot])
                d_logits = None
                while m < n:
                    d_logits = self._step(
                        self.draft, self.draft_cache, [dslot],
                        np.asarray([[ctx[m]]], np.int32))[0]
                    m += 1
                # 2) propose d_2..d_k autoregressively
                drafts.append(int(np.argmax(d_logits)))
                for _ in range(k - 1):
                    d_logits = self._step(
                        self.draft, self.draft_cache, [dslot],
                        np.asarray([[drafts[-1]]], np.int32))[0]
                    drafts.append(int(np.argmax(d_logits)))
            # 3) the target verifies all k in ONE (1, k+1) forward; row j is
            #    its next-token distribution after ctx + drafts[:j]
            verify = np.asarray([[ctx[-1]] + drafts], np.int32)
            logits, nk, nv = self._forward(self.model, self.cache, [slot],
                                           verify)
            self._commit(self.model, self.cache, [(slot, 0, k + 1)], nk, nv)
            rows = logits[0].float().cpu().numpy()
            target = [int(np.argmax(rows[j])) for j in range(k + 1)]
            # 4) the longest accepted prefix plus the target's own token
            a = 0
            while a < k and drafts[a] == target[a]:
                a += 1
            commit = drafts[:a] + [target[a]]
            stats["proposed"] += k
            stats["accepted"] += a
            _cat.gen_spec_proposed.inc(k, model=self.name)
            _cat.gen_spec_accepted.inc(a, model=self.name)
            # 5) roll both caches back to the committed history
            for tok in commit:
                ctx.append(tok)
                s["out"].append(tok)
                stats["decode_tokens"] += 1
                if tok == eos_id or len(s["out"]) >= max_new_tokens:
                    s["done"] = True
                    break
            self.cache.truncate(slot, len(ctx) - 1)
            self.draft_cache.truncate(dslot, len(ctx) - 1)
            dt = time.monotonic() - t0
            _cat.gen_decode_seconds.observe(dt, model=self.name)
            cur = _tr.current()
            if cur is not None:
                # one span per propose+verify round, with its accounting
                t1w = time.time()
                _tr.record_span(
                    "gen.decode_step", cur.trace_id,
                    parent_id=cur.span_id, t0=t1w - dt, t1=t1w,
                    sampled=cur.sampled, model=self.name, speculative=True,
                    proposed=k, accepted=a, tokens_committed=len(commit))
