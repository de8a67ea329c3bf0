"""The PyTorch port's generation path against the JAX package, on the CPU.

- ``generate/paged_kv.py`` against the dense ``serving/kv_cache.py`` and
  against the JAX package's PagedKVCache: the same op sequences give the
  same lengths, tables and contents, and the same errors with the same
  messages (full slot, dead slot, exhausted pool, truncate).
- ``generate/engine.py``: greedy tokens equal to the JAX engine's on the
  same weights; speculative decoding equal to greedy token for token inside
  the port; prefill-chunk invariance.
- ``serving/decode.py``: retire accounting (P + N - 1 grid steps), the
  family prefill path, failures that fail a request and not the loop.
- ``ModelServer(device="cpu")`` serving a checkpoint written by the JAX
  package's ``export_gpt_for_serving``, with tokens equal to the JAX
  engine's greedy tokens; and the port's own export.
- The generation plane's five knobs read alike by both packages; a bf16
  or fp16 GPT's greedy tokens against the JAX engine's over fp32 pools and
  pools of its dtype (equal wherever the top-2 margin exceeds twice the
  logits' bound); a bf16 checkpoint, which the JAX family cannot load,
  served in fp32; an fp16 checkpoint served in fp16 by both packages, with
  the JAX family's swap rule (an fp16 generation swaps in, an fp32 one is
  refused).
"""

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import generate as jgen
from incubator_mxnet_tpu import nd
from incubator_mxnet_tpu import serving as jserving
from incubator_mxnet_tpu.models import gpt as jgpt
from incubator_mxnet_tpu_torch import generate as tgen
from incubator_mxnet_tpu_torch import serving
from incubator_mxnet_tpu_torch.models.gpt import GPTDecoder
from incubator_mxnet_tpu_torch.serving.decode import DecodeLoop, DecodeRequest
from incubator_mxnet_tpu_torch.serving.kv_cache import KVCache

TCFG = {"vocab_size": 29, "units": 24, "num_layers": 2, "num_heads": 2,
        "max_len": 64}
DCFG = {"vocab_size": 29, "units": 12, "num_layers": 1, "num_heads": 2,
        "max_len": 64}


def _params(cfg, seed, scale=0.05):
    rs = np.random.RandomState(seed)
    return {n: (rs.randn(*s) * scale).astype(np.float32)
            for n, s in jgpt.gpt_param_shapes(jgpt.gpt_config(cfg)).items()}


def _kv_spec(layers=1, H=2, D=4):
    spec = {}
    for i in range(layers):
        spec["k%d" % i] = ("kv", (H, D))
        spec["v%d" % i] = ("kv", (H, D))
    return spec


@pytest.fixture(scope="module")
def target_lm():
    return tgen.GPTPagedLM(_params(TCFG, 7), TCFG, device="cpu")


@pytest.fixture(scope="module")
def draft_lm():
    return tgen.GPTPagedLM(_params(DCFG, 8), DCFG, device="cpu")


# ------------------------------------------------------- paged KV cache
def test_paged_kv_is_dropin_for_dense_and_matches_jax():
    """One op sequence against the port's dense and paged caches and the
    JAX package's paged cache: alloc order, lengths, tables and contents
    agree."""
    spec = {"h": ("state", (3,)), "k0": ("kv", (2, 4)), "v0": ("kv", (2, 4))}
    dense = KVCache(3, spec, max_len=10, device="cpu")
    paged = tgen.PagedKVCache(3, spec, max_len=10, block_size=4,
                              device="cpu")
    ref = jgen.PagedKVCache(3, spec, max_len=10, block_size=4)
    caches = (dense, paged, ref)
    rs = np.random.RandomState(0)
    for step in range(7):
        if step == 0:
            assert [c.alloc() for c in caches] == [0, 0, 0]
            assert [c.alloc() for c in caches] == [1, 1, 1]
        if step == 3:
            for c in caches:
                c.free(0)
            assert [c.alloc() for c in caches] == [0, 0, 0]   # LIFO reuse
        for slot in (0, 1):
            k = rs.randn(2, 4).astype(np.float32)
            v = rs.randn(2, 4).astype(np.float32)
            for c in caches:
                c.append("k0", slot, k)
                c.append("v0", slot, v)
                c.advance(slot)
        h = rs.randn(3).astype(np.float32)
        for c in caches:
            c.set_state("h", 1, h)
    for slot in (0, 1):
        assert int(dense.lengths[slot]) == int(paged.lengths[slot]) \
            == int(ref.lengths[slot])
        assert paged.table(slot) == ref.table(slot)
        for name in ("k0", "v0"):
            want = ref.prefix(name, slot)
            np.testing.assert_array_equal(dense.prefix(name, slot).numpy(),
                                          want)
            np.testing.assert_array_equal(paged.prefix(name, slot).numpy(),
                                          want)
    np.testing.assert_array_equal(paged.state("h", 1).numpy(),
                                  ref.state("h", 1))
    np.testing.assert_array_equal(paged.tables_array(), ref.tables_array())
    np.testing.assert_array_equal(paged.pool("k0").numpy(), ref.pool("k0"))
    assert paged.in_use == dense.in_use == 2
    assert paged.fragmentation() == pytest.approx(ref.fragmentation())


def _raises_like(fn_port, fn_ref):
    with pytest.raises(Exception) as ours:
        fn_port()
    with pytest.raises(Exception) as theirs:
        fn_ref()
    assert type(ours.value).__name__ == type(theirs.value).__name__
    assert str(ours.value) == str(theirs.value)


def test_paged_kv_guards_match_jax_errors():
    port = tgen.PagedKVCache(1, _kv_spec(), max_len=4, block_size=4,
                             device="cpu")
    ref = jgen.PagedKVCache(1, _kv_spec(), max_len=4, block_size=4)
    z = np.zeros((2, 4), np.float32)
    _raises_like(lambda: port.append("k0", 0, z),
                 lambda: ref.append("k0", 0, z))           # not live
    _raises_like(lambda: port.free(99), lambda: ref.free(99))
    assert port.alloc() == ref.alloc() == 0
    assert port.alloc() is None and ref.alloc() is None     # grid full
    with pytest.raises(KeyError):
        port.append("nope", 0, 0)
    for c in (port, ref):
        for _ in range(4):
            c.append("k0", 0, z)
            c.append("v0", 0, z)
            c.advance(0)
    _raises_like(lambda: port.append("k0", 0, z),
                 lambda: ref.append("k0", 0, z))           # full
    spec = {"h": ("state", (2,)), "k0": ("kv", (2, 4))}
    mport = tgen.PagedKVCache(1, spec, max_len=4, device="cpu")
    mref = jgen.PagedKVCache(1, spec, max_len=4)
    mport.alloc()
    mref.alloc()
    for call in (lambda c: c.set_state("k0", 0, z),
                 lambda c: c.append("h", 0, np.zeros(2)),
                 lambda c: c.prefix("h", 0),
                 lambda c: c.pool("h")):
        _raises_like(lambda: call(mport), lambda: call(mref))


def test_paged_kv_exhaustion_truncate_and_reuse_match_jax():
    """The JAX pool-exhaustion walk on both caches: the same typed error
    and message, truncate freeing a suffix block, and a reused block zeroed
    past its first position."""
    port = tgen.PagedKVCache(2, _kv_spec(), max_len=8, block_size=2,
                             num_blocks=3, device="cpu")
    ref = jgen.PagedKVCache(2, _kv_spec(), max_len=8, block_size=2,
                            num_blocks=3)
    z = np.ones((2, 4), np.float32)
    for c in (port, ref):
        a, b = c.alloc(), c.alloc()
        for _ in range(4):
            c.append("k0", a, z * 9)
            c.append("v0", a, z * 9)
            c.advance(a)
        for _ in range(2):
            c.append("k0", b, z)
            c.append("v0", b, z)
            c.advance(b)
        assert c.blocks_free == 0
    _raises_like(lambda: port.append("k0", 1, z),
                 lambda: ref.append("k0", 1, z))
    with pytest.raises(tgen.KVPoolExhausted) as ei:
        port.append("k0", 1, z)
    assert (ei.value.slot, ei.value.block, ei.value.num_blocks) == (1, 1, 3)
    with pytest.raises(tgen.KVPoolExhausted):
        port.extend(1, 3)
    assert int(port.lengths[1]) == 2            # extend moved nothing
    for c in (port, ref):
        c.truncate(0, 1)
        assert int(c.lengths[0]) == 1 and c.blocks_free == 1
        c.append("k0", 1, z * 2)
        c.append("v0", 1, z * 2)
        c.advance(1)
        c.truncate(0, 99)                       # past the length: no-op
        assert int(c.lengths[0]) == 1
    blk = port.table(1)[-1]
    assert blk == ref.table(1)[-1]
    np.testing.assert_array_equal(port.pool("k0").numpy(), ref.pool("k0"))
    assert (port.pool("k0")[blk, 1] == 0).all()  # stale tail zeroed
    _raises_like(lambda: port.truncate(0, -1), lambda: ref.truncate(0, -1))


def test_extend_and_write_rows_commit_like_appends():
    """The bulk commit (extend + one indexed write per pool) lands what a
    run of appends lands."""
    spec = _kv_spec(layers=1)
    bulk = tgen.PagedKVCache(2, spec, max_len=16, block_size=4, device="cpu")
    one = tgen.PagedKVCache(2, spec, max_len=16, block_size=4, device="cpu")
    rs = np.random.RandomState(1)
    vals = torch.from_numpy(rs.randn(7, 2, 4).astype(np.float32))
    for c in (bulk, one):
        c.alloc()
        c.alloc()
        c.append("k0", 1, np.ones((2, 4)))
        c.advance(1)
    rows = bulk.extend(0, 7)
    bulk.write_rows("k0", torch.tensor(rows), vals)
    for i in range(7):
        one.append("k0", 0, vals[i])
        one.advance(0)
    assert rows == [b * 4 + o for b in bulk.table(0) for o in range(4)][:7]
    np.testing.assert_array_equal(bulk.prefix("k0", 0).numpy(),
                                  one.prefix("k0", 0).numpy())
    assert bulk.table(0) == one.table(0)
    with pytest.raises(ValueError, match=r"slot 0 is full \(max_len=16\)"):
        bulk.extend(0, 10)


# --------------------------------------------------------------- engine
def test_engine_greedy_matches_jax_engine(target_lm):
    prompts = [[3, 5, 7, 2, 11, 1, 4, 9, 8, 6, 2], [9, 8], [4]]
    jlm = jgen.GPTPagedLM(_params(TCFG, 7), TCFG)
    want = jgen.GenerateEngine(
        jlm, jlm.make_cache(4, max_len=64), prefill_chunk=4).generate(
            prompts, max_new_tokens=10)
    got = tgen.GenerateEngine(
        target_lm, target_lm.make_cache(4, max_len=64),
        prefill_chunk=4).generate(prompts, max_new_tokens=10)
    assert got == want
    assert len(set(sum(got, []))) >= 3          # not one repeated token


def test_engine_prefill_chunk_invariance(target_lm):
    prompts = [[3, 5, 7, 2, 11, 1, 4, 9, 8, 6, 2], [9, 8]]
    outs = [tgen.GenerateEngine(target_lm,
                                target_lm.make_cache(4, max_len=64),
                                prefill_chunk=chunk).generate(
                                    prompts, max_new_tokens=8)
            for chunk in (1, 3, 32)]
    assert outs[0] == outs[1] == outs[2]


def test_engine_speculative_equals_plain_greedy(target_lm, draft_lm):
    """Inside the port, speculative decoding commits the tokens plain greedy
    commits, including at exact cache capacity, where the verify width
    shrinks instead of overflowing the pool."""
    prompts = [[3, 5, 7, 2, 11, 1, 4], [9, 8]]
    plain = tgen.GenerateEngine(
        target_lm, target_lm.make_cache(4, max_len=64)).generate(
            prompts, max_new_tokens=12)
    spec = tgen.GenerateEngine(
        target_lm, target_lm.make_cache(4, max_len=64), draft=draft_lm,
        draft_cache=draft_lm.make_cache(4, max_len=64), spec_k=3)
    assert spec.generate(prompts, max_new_tokens=12) == plain
    assert spec.last_stats["proposed"] > 0
    assert spec.last_stats["decode_tokens"] == 24
    tight = tgen.GenerateEngine(
        target_lm, target_lm.make_cache(2, max_len=19), draft=draft_lm,
        draft_cache=draft_lm.make_cache(2, max_len=19), spec_k=3)
    assert tight.generate(prompts, max_new_tokens=12) == plain
    selfspec = tgen.GenerateEngine(
        target_lm, target_lm.make_cache(2, max_len=64), draft=target_lm,
        draft_cache=target_lm.make_cache(2, max_len=64), spec_k=4)
    assert selfspec.generate(prompts[:1], max_new_tokens=12) == plain[:1]
    st = selfspec.last_stats
    assert st["proposed"] > 0 and st["accepted"] == st["proposed"]


#: as tests/test_torch_gpt.py's bound on a 16-bit GPT's logits against the
#: JAX package's: 2**-5 (bf16) or 2**-8 (fp16) of the row's largest |logit|
BF16_ROW_TOL = 2.0 ** -5
FP16_ROW_TOL = 2.0 ** -8
ROW_TOL = {"bfloat16": BF16_ROW_TOL, "float16": FP16_ROW_TOL}
BF16_CFG = {"vocab_size": 64, "units": 32, "num_layers": 2, "num_heads": 2,
            "max_len": 64}


def _half_np(dtype):
    """The numpy type of a 16-bit dtype name (ml_dtypes' for bfloat16)."""
    if dtype == "bfloat16":
        import ml_dtypes
        return ml_dtypes.bfloat16
    return np.float16


def _half_spec(cfg, dtype="bfloat16"):
    H = cfg["num_heads"]
    spec = {}
    for i in range(cfg["num_layers"]):
        for n in ("k%d" % i, "v%d" % i):
            spec[n] = ("kv", (H, cfg["units"] // H), dtype)
    return spec


def _first_diff_at_a_near_tie(got, want, margin_logits, tol):
    """Each sequence's tokens equal the reference's up to the first that
    differs, whose reference row (``margin_logits(i, j)``) must have a
    top-2 margin of at most twice ``tol`` of its largest |logit|."""
    for i, (g, w) in enumerate(zip(got, want)):
        assert len(g) == len(w), (i, g, w)
        j = next((j for j, (a, b) in enumerate(zip(g, w)) if a != b), None)
        if j is None:
            continue
        logits = np.asarray(margin_logits(i, j), np.float32)
        top = np.sort(logits)[::-1]
        assert top[0] - top[1] <= 2 * tol * np.abs(logits).max(), \
            (i, j, g, w)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("pools", ["float32", "half"])
def test_half_engine_greedy_matches_jax_engine(pools, dtype):
    """GenerateEngine.generate in each package over the same bf16 (ml_dtypes
    numpy) or fp16 weights, fp32 pools (the default spec) or pools of the
    weights' dtype: greedy tokens equal wherever the step's top-2 margin
    exceeds twice ROW_TOL of its row's largest |logit| (read from the JAX
    package's full-sequence forward on the JAX engine's context); the
    first token that differs must sit at a narrower margin."""
    cfg = BF16_CFG
    params = {n: a.astype(_half_np(dtype))
              for n, a in _params(cfg, 21, 0.5).items()}
    jlm = jgen.GPTPagedLM(params, cfg)
    tlm = tgen.GPTPagedLM(params, cfg, device="cpu")
    if pools == "half":
        jcache = jgen.PagedKVCache(3, _half_spec(cfg, dtype), max_len=64)
        tcache = tgen.PagedKVCache(3, _half_spec(cfg, dtype), max_len=64,
                                   device="cpu")
        assert tcache.pool("k0").dtype == getattr(torch, dtype)
    else:
        jcache, tcache = jlm.make_cache(3, max_len=64), tlm.make_cache(3)
    prompts = [[3, 5, 7, 2, 11, 1, 4], [5], [i % 64 for i in range(1, 20)]]
    want = jgen.GenerateEngine(jlm, jcache, prefill_chunk=4).generate(
        prompts, max_new_tokens=8)
    got = tgen.GenerateEngine(tlm, tcache, prefill_chunk=4).generate(
        prompts, max_new_tokens=8)
    assert all(len(g) == len(w) == 8 for g, w in zip(got, want))
    _first_diff_at_a_near_tie(
        got, want, lambda i, j: jgen_logits(params, cfg,
                                            prompts[i] + want[i][:j]),
        ROW_TOL[dtype])


def jgen_logits(params, cfg, context):
    """The JAX package's full-sequence logits of the next token after
    ``context``, as float32 numpy."""
    import jax.numpy as jnp
    out = jgpt.gpt_logits({n: jnp.asarray(a) for n, a in params.items()},
                          cfg, jnp.asarray([context], jnp.int32))
    return np.asarray(out[0, -1].astype(jnp.float32))


def test_engine_guards_eos_and_sampling(target_lm, draft_lm):
    with pytest.raises(ValueError, match="greedy-only"):
        tgen.GenerateEngine(target_lm, target_lm.make_cache(2),
                            draft=draft_lm,
                            draft_cache=draft_lm.make_cache(2),
                            temperature=0.7)
    with pytest.raises(ValueError, match="come together"):
        tgen.GenerateEngine(target_lm, target_lm.make_cache(2),
                            draft=draft_lm)
    eng = tgen.GenerateEngine(target_lm, target_lm.make_cache(2, max_len=8))
    with pytest.raises(ValueError, match="exceeds cache max_len"):
        eng.generate([[1, 2, 3]], max_new_tokens=6)
    with pytest.raises(ValueError, match="empty prompt"):
        eng.generate([[]], max_new_tokens=2)
    assert eng.cache.in_use == 0
    eng = tgen.GenerateEngine(target_lm, target_lm.make_cache(2, max_len=64))
    out = eng.generate([[3, 5, 7]], max_new_tokens=10)[0]
    eos = out[2]
    got = eng.generate([[3, 5, 7]], max_new_tokens=10, eos_id=eos)[0]
    assert got == out[:out.index(eos) + 1] and got[-1] == eos
    hot = tgen.GenerateEngine(target_lm, target_lm.make_cache(2, max_len=64),
                              temperature=1.0, seed=3)
    toks = hot.generate([[3, 5, 7]], max_new_tokens=10)[0]
    assert len(toks) == 10 and all(0 <= t < TCFG["vocab_size"] for t in toks)
    assert eng.cache.in_use == 0 and hot.cache.in_use == 0


# ------------------------------------------------------ decode loop
def _counting_step(vocab=10):
    def step(tokens, cache, active):
        logits = np.zeros((tokens.shape[0], vocab), np.float32)
        for slot in range(tokens.shape[0]):
            if active[slot]:
                logits[slot, (int(tokens[slot]) + 1) % vocab] = 1.0
        return logits
    return step


def _paged_state_cache(slots=1):
    return tgen.PagedKVCache(slots, {"h": ("state", (1,))}, max_len=64,
                             device="cpu")


def test_decode_loop_retire_accounting():
    """Prompt P, max_new N without a prefill_fn: P - 1 prompt feeds plus N
    decode steps = P + N - 1 grid steps, the last token counted on the
    retiring step."""
    cache = _paged_state_cache()
    loop = DecodeLoop("acct", _counting_step(), cache, pad_token=0).start()
    try:
        r = loop.submit(DecodeRequest("acct", [1, 2, 3], max_new_tokens=4))
        np.testing.assert_array_equal(r.wait(10.0)["tokens"], [4, 5, 6, 7])
        r2 = loop.submit(DecodeRequest("acct", [7], max_new_tokens=5,
                                       eos_id=9))
        np.testing.assert_array_equal(r2.wait(10.0)["tokens"], [8, 9])
    finally:
        loop.stop()
    st = loop.stats()
    assert st["steps"] == (3 + 4 - 1) + (1 + 2 - 1)
    assert st["tokens"] == {"prefill": 2, "decode": 6}
    assert st["retired"] == {"ok": 2}
    assert cache.in_use == 0 and cache.blocks_in_use == 0


def test_decode_loop_family_prefill_and_failures():
    calls = []

    def prefill(slot, tokens, cache):
        calls.append((slot, list(map(int, tokens))))
        if int(tokens[0]) == 13:
            raise RuntimeError("prefill exploded")
        if int(tokens[0]) == 14:
            raise tgen.KVPoolExhausted("pool exhausted", slot=slot)

    cache = _paged_state_cache()
    loop = DecodeLoop("pf", _counting_step(), cache, pad_token=0,
                      prefill_fn=prefill, prefill_chunk=8).start()
    try:
        r = loop.submit(DecodeRequest("pf", [1, 2, 3, 4], max_new_tokens=3))
        np.testing.assert_array_equal(r.wait(10.0)["tokens"], [5, 6, 7])
        bad = loop.submit(DecodeRequest("pf", [13, 2], max_new_tokens=2))
        with pytest.raises(RuntimeError, match="prefill exploded"):
            bad.wait(10.0)
        full = loop.submit(DecodeRequest("pf", [14, 2], max_new_tokens=2))
        with pytest.raises(serving.ShedError) as ei:
            full.wait(10.0)
        assert ei.value.stage == "capacity"
        ok = loop.submit(DecodeRequest("pf", [5], max_new_tokens=2))
        np.testing.assert_array_equal(ok.wait(10.0)["tokens"], [6, 7])
        late = loop.submit(DecodeRequest("pf", [5], max_new_tokens=2,
                                         deadline=0.0))
        with pytest.raises(serving.ShedError, match="queue"):
            late.wait(10.0)
        too_long = loop.submit(DecodeRequest("pf", [1] * 60,
                                             max_new_tokens=8))
        with pytest.raises(ValueError, match="exceeds the KV cache"):
            too_long.wait(10.0)
    finally:
        loop.stop()
    assert calls[0] == (0, [1, 2, 3])               # the prefix only
    st = loop.stats()
    assert st["steps"] == 3 + 2 and st["prefills"] == 1
    assert st["shed"] == {"capacity": 1, "queue": 1}
    assert cache.in_use == 0


#: the generation plane's five knobs, each set alone, together, with values
#: the readers refuse, and under explicit arguments (which win)
KNOB_CASES = {
    "unset": ({}, False),
    "block_size": ({"MXTPU_GEN_BLOCK_SIZE": "8"}, False),
    "num_blocks": ({"MXTPU_GEN_BLOCK_SIZE": "8",
                    "MXTPU_GEN_NUM_BLOCKS": "5"}, False),
    "prefill_chunk": ({"MXTPU_GEN_PREFILL_CHUNK": "12"}, False),
    "prefill_chunk_zero": ({"MXTPU_GEN_PREFILL_CHUNK": "0"}, False),
    "spec_k": ({"MXTPU_GEN_SPEC_K": "2"}, False),
    "max_new_tokens": ({"MXTPU_SERVE_MAX_NEW_TOKENS": "7"}, False),
    "not_integers": ({"MXTPU_GEN_BLOCK_SIZE": "x", "MXTPU_GEN_NUM_BLOCKS":
                      "", "MXTPU_GEN_SPEC_K": "y"}, False),
    "all_with_arguments": ({"MXTPU_GEN_BLOCK_SIZE": "8",
                            "MXTPU_GEN_NUM_BLOCKS": "5",
                            "MXTPU_GEN_PREFILL_CHUNK": "12",
                            "MXTPU_GEN_SPEC_K": "2",
                            "MXTPU_SERVE_MAX_NEW_TOKENS": "7"}, True),
}


def _knob_reading(pkg_gen, pkg_family, loop_cls, cache_kw, family_args,
                  explicit):
    """What one package makes of the environment: the paged cache's block
    size and block count, the gpt family's prefill chunk, the engine's
    spec_k and chunk, the DecodeLoop's chunk and new-token cap (a refusal
    reads as its exception type)."""
    def attempt(fn):
        try:
            return fn()
        except ValueError as e:
            return type(e).__name__
    kw = dict(block_size=4, num_blocks=9) if explicit else {}
    cache = pkg_gen.PagedKVCache(2, {"k0": ("kv", (2, 4))}, max_len=64,
                                 **cache_kw, **kw)
    served = pkg_family(*family_args)
    ekw = dict(spec_k=3, prefill_chunk=5) if explicit else {}
    engine = attempt(lambda: pkg_gen.GenerateEngine(object(), cache, **ekw))
    lkw = dict(prefill_chunk=6, max_new_tokens_cap=9) if explicit else {}
    loop = attempt(lambda: loop_cls("k", lambda *a: None, cache, **lkw))
    return {"block_size": cache.block_size, "num_blocks": cache.num_blocks,
            "family_chunk": served.prefill_chunk,
            "engine": engine if isinstance(engine, str)
            else (engine.spec_k, engine.prefill_chunk),
            "loop": loop if isinstance(loop, str)
            else (loop._prefill_chunk, loop._cap)}


@pytest.mark.parametrize("case", sorted(KNOB_CASES))
def test_generation_knobs_read_as_in_jax(case, monkeypatch):
    """MXTPU_GEN_BLOCK_SIZE, MXTPU_GEN_NUM_BLOCKS, MXTPU_GEN_PREFILL_CHUNK,
    MXTPU_GEN_SPEC_K and MXTPU_SERVE_MAX_NEW_TOKENS read by both packages
    with the same precedence (argument, then environment, then default):
    the paged cache's geometry, the gpt family's chunk, the engine's spec_k
    and chunk, and the DecodeLoop's chunk and cap come out equal."""
    from incubator_mxnet_tpu.serving import decode as jdecode
    from incubator_mxnet_tpu.serving import loader as jloader
    from incubator_mxnet_tpu_torch.serving import loader as tloader
    env, explicit = KNOB_CASES[case]
    for name in ("MXTPU_GEN_BLOCK_SIZE", "MXTPU_GEN_NUM_BLOCKS",
                 "MXTPU_GEN_PREFILL_CHUNK", "MXTPU_GEN_SPEC_K",
                 "MXTPU_SERVE_MAX_NEW_TOKENS"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    params = _params(DCFG, 1)
    port = _knob_reading(tgen, tloader.SERVING_FAMILIES["gpt_decoder"],
                         DecodeLoop, {"device": "cpu"},
                         (DCFG, params, False, "cpu"), explicit)
    ref = _knob_reading(jgen, jloader.SERVING_FAMILIES["gpt_decoder"],
                        jdecode.DecodeLoop, {}, (DCFG, params, False),
                        explicit)
    assert port == ref
    if case == "num_blocks":
        assert (port["block_size"], port["num_blocks"]) == (8, 5)
    if case == "all_with_arguments":
        assert port["engine"] == (3, 5) and port["loop"] == (6, 9)


def test_decode_loop_drain_and_admit():
    cache = _paged_state_cache(2)
    loop = DecodeLoop("dr", _counting_step(), cache).start()
    try:
        assert loop.drain(timeout=1.0) is True
        shed = loop.submit(DecodeRequest("dr", [1], max_new_tokens=2))
        with pytest.raises(serving.ShedError, match="draining"):
            shed.wait(1.0)
        loop.admit()
        r = loop.submit(DecodeRequest("dr", [1], max_new_tokens=2))
        np.testing.assert_array_equal(r.wait(10.0)["tokens"], [2, 3])
    finally:
        loop.stop()


# ------------------------------------------------- serving: gpt family
def _jax_gpt(prefix, **over):
    cfg = dict(vocab_size=37, units=16, num_layers=1, num_heads=2,
               max_len=64)
    cfg.update(over)
    m = jgpt.GPTDecoder(prefix=prefix, **cfg)
    m.initialize(mx.init.Normal(0.05))
    m(nd.array(np.zeros((1, 4), np.int32)))
    return m, cfg


def test_port_serves_a_jax_written_checkpoint(tmp_path):
    """ModelServer(device="cpu") loads a gpt_decoder checkpoint that the JAX
    package exported (with a draft) and serves the JAX engine's greedy
    tokens, prompts with and without a prefix."""
    model, cfg = _jax_gpt("xgpt_")
    draft, _ = _jax_gpt("xgptd_", units=8)
    ckpt = str(tmp_path / "gpt_serve")
    jgen.export_gpt_for_serving(ckpt, cfg, model, draft=draft)
    params = {k: np.asarray(v.data()._data)
              for k, v in model._collect_params_with_prefix().items()}
    jlm = jgen.GPTPagedLM(params, cfg)
    prompts = [[3, 5, 7, 2, 11, 1, 4], [5], [i % 37 for i in range(1, 40)]]
    want = jgen.GenerateEngine(jlm, jlm.make_cache(3, max_len=64)).generate(
        prompts, max_new_tokens=8)
    srv = serving.ModelServer(device="cpu")
    srv.load("gpt", directory=ckpt, slots=2, cache_len=64).start()
    try:
        with serving.ServingClient(srv.addr) as c:
            got = [c.decode("gpt", np.asarray(p, np.int32),
                            max_new_tokens=8).tolist() for p in prompts]
            assert c.models()["gpt"]["modes"] == ["decode"]
            st = c.stats()["gpt"]["decode"]
            with pytest.raises(serving.ServingError, match="no encode path"):
                c.infer("gpt", {"tokens": np.zeros((1, 2), np.int32)})
            with pytest.raises(serving.ServingError, match=r"\[0, 37\)"):
                c.decode("gpt", np.asarray([3, 37], np.int32))
    finally:
        srv.stop()
    assert got == want
    # each prompt's prefix commits at admission; the requests run one after
    # another, so each takes exactly N grid steps
    assert st["prefills"] == 2 and st["tokens"]["prefill"] == 6 + 38
    assert st["steps"] == 3 * 8


def test_bf16_checkpoint_serves_in_fp32_where_jax_cannot_load_it(tmp_path):
    """A gpt_decoder checkpoint of bf16 weights (the JAX package's own
    export of a cast model): the JAX serving family cannot load it
    (``jnp.asarray`` of the restored bf16 NDArrays raises TypeError in
    ``_PagedProgramSet``), so there is no reference to match, and the port
    serves it as it served every checkpoint, widened to fp32 (ROADMAP
    Queue 3). Its logits equal the port's fp32 model on the widened
    weights."""
    model, cfg = _jax_gpt("xbf_")
    model.cast("bfloat16")
    ckpt = str(tmp_path / "gpt_bf16")
    jgen.export_gpt_for_serving(ckpt, cfg, model)
    with pytest.raises(TypeError):
        jserving.load_served_model(ckpt)
    served = serving.load_served_model(ckpt, device="cpu")
    assert all(p.dtype == torch.float32
               for p in served.model.parameters())
    params = {k: np.asarray(v.data()._data, np.float32)
              for k, v in model._collect_params_with_prefix().items()}
    want = GPTDecoder(device="cpu", **cfg).load_params(params)
    tokens = torch.tensor([[3, 5, 7, 2]])
    np.testing.assert_array_equal(served.model(tokens).numpy(),
                                  want(tokens).numpy())


def _served_greedy(served, prompts, n):
    """Greedy tokens of each prompt through a served model's own prefill
    and grid step (one active slot), with each step's logits row."""
    cache = served.make_cache(2, 64)
    toks, rows = [], []
    for prompt in prompts:
        slot = cache.alloc()
        served.prefill_fn(slot, np.asarray(prompt[:-1], np.int32), cache)
        grid = np.zeros(2, np.int32)
        active = np.arange(2) == slot
        seq, out = list(prompt), []
        for _ in range(n):
            grid[slot] = seq[-1]
            out.append(np.asarray(served.step_fn(grid, cache, active))[slot])
            seq.append(int(np.argmax(out[-1])))
        toks.append(seq[len(prompt):])
        rows.append(out)
        cache.free(slot)
    return toks, rows


def _fp16_jax_checkpoint(directory, scales=(1.0,)):
    """A gpt_decoder checkpoint that the JAX package exports from its
    GPTDecoder (vocab 37, 16 units, 1 layer, 2 heads, Normal(0.05)) cast to
    float16, one generation for each of ``scales`` (the weights times it,
    rounded to fp16)."""
    np.random.seed(11)
    model, cfg = _jax_gpt("xf16_")
    base = {n: np.asarray(p.data()._data)
            for n, p in model._collect_params_with_prefix().items()}
    for scale in scales:
        for n, p in model._collect_params_with_prefix().items():
            p.set_data(nd.array(base[n] * scale))
        model.cast("float16")
        jgen.export_gpt_for_serving(directory, cfg, model)
        model.cast("float32")


def test_fp16_checkpoint_serves_in_fp16_as_in_jax(tmp_path):
    """An fp16 gpt_decoder checkpoint that the JAX package exported: both
    families serve it in fp16 (the JAX family's ``jnp.asarray`` keeps the
    dtype; the port's parameters stay fp16 and its served step returns fp16
    logits), over the default fp32 pools. The port's ModelServer gives,
    through ServingClient.decode, the JAX served model's greedy tokens
    wherever the top-2 margin of the JAX family's step exceeds twice
    FP16_ROW_TOL of its row's largest |logit|, and every step's logits row
    of the port's served model is within FP16_ROW_TOL of the JAX one's
    largest while the two agree."""
    ckpt = str(tmp_path / "gpt_fp16")
    _fp16_jax_checkpoint(ckpt)
    jserved = jserving.load_served_model(ckpt)
    served = serving.load_served_model(ckpt, device="cpu")
    assert all(p.dtype == torch.float16 for p in served.model.parameters())
    prompts = [[3, 5, 7, 2, 11, 1, 4], [5], [i % 37 for i in range(1, 40)]]
    want, jrows = _served_greedy(jserved, prompts, 8)
    got_rows, rows = _served_greedy(served, prompts, 8)
    assert jrows[0][0].dtype == np.float16 and rows[0][0].dtype == np.float16
    for i, (g, w) in enumerate(zip(got_rows, want)):
        for j, (a, b) in enumerate(zip(rows[i], jrows[i])):
            if g[:j] != w[:j]:
                break
            b = np.asarray(b, np.float32)
            assert np.abs(np.asarray(a, np.float32) - b).max() \
                <= FP16_ROW_TOL * np.abs(b).max(), (i, j)
    srv = serving.ModelServer(device="cpu")
    srv.load("gpt", directory=ckpt, slots=2, cache_len=64).start()
    try:
        with serving.ServingClient(srv.addr) as c:
            got = [c.decode("gpt", np.asarray(p, np.int32),
                            max_new_tokens=8).tolist() for p in prompts]
    finally:
        srv.stop()
    _first_diff_at_a_near_tie(got, want, lambda i, j: jrows[i][j],
                              FP16_ROW_TOL)


def test_fp16_served_swap_follows_the_jax_rule(tmp_path):
    """On an fp16 served model both families take a live swap of a second
    fp16 generation (in place in the port: the same tensors, now equal to
    a fresh load of generation 1, and the next step's logits within
    FP16_ROW_TOL of the JAX family's row max) and refuse an fp32
    generation of the same shapes with GenerationMismatchError (dtype
    drift), leaving the served weights as they were."""
    ckpt = str(tmp_path / "gpt_fp16_gens")
    _fp16_jax_checkpoint(ckpt, scales=(1.0, 1.2))
    served = serving.load_served_model(ckpt, device="cpu", generation=0)
    jserved = jserving.load_served_model(ckpt, generation=0)
    ptrs = [p.data_ptr() for p in served.model.parameters()]
    params1, _ = serving.load_generation_params(ckpt, 1)
    jparams1, _ = jserving.load_generation_params(ckpt, 1)
    served.swap_params(params1, 1)
    jserved.swap_params(jparams1, 1)
    assert ptrs == [p.data_ptr() for p in served.model.parameters()]
    fresh = serving.load_served_model(ckpt, device="cpu", generation=1)
    for a, b in zip(fresh.model.parameters(), served.model.parameters()):
        assert a.dtype == b.dtype == torch.float16 and torch.equal(a, b)
    _, rows = _served_greedy(served, [[4, 9, 2, 7]], 2)
    _, jrows = _served_greedy(jserved, [[4, 9, 2, 7]], 2)
    want = np.asarray(jrows[0][0], np.float32)
    assert np.abs(np.asarray(rows[0][0], np.float32) - want).max() \
        <= FP16_ROW_TOL * np.abs(want).max()
    fp32 = {k: np.asarray(v, np.float32) for k, v in params1.items()}
    jfp32 = {k: np.asarray(v.asnumpy() if hasattr(v, "asnumpy") else v,
                           np.float32) for k, v in jparams1.items()}
    before = {n: p.clone() for n, p in served.model.named_parameters()}
    with pytest.raises(serving.GenerationMismatchError, match="drifted"):
        served.swap_params(fp32, 2)
    with pytest.raises(jserving.GenerationMismatchError, match="drifted"):
        jserved.swap_params(jfp32, 2)
    assert served.generation == 1
    for n, p in served.model.named_parameters():
        assert torch.equal(p, before[n])


def test_port_export_loads_in_both_packages(tmp_path):
    m = GPTDecoder(device="cpu", seed=2, vocab_size=31, units=16,
                   num_layers=1, num_heads=2, max_len=32)
    d = GPTDecoder(device="cpu", seed=3, vocab_size=31, units=8,
                   num_layers=1, num_heads=2, max_len=32)
    ckpt = str(tmp_path / "port_gpt")
    tgen.export_gpt_for_serving(ckpt, m.config, m, draft=d)
    served = serving.load_served_model(ckpt, device="cpu")
    assert served.has_decode and not served.has_encode
    assert served.draft is not None and served.generation == 0
    ref = jserving.load_served_model(ckpt)
    assert ref.family == "gpt_decoder" and ref.has_decode
    prompt = [4, 9, 2, 7, 1]
    lm = tgen.GPTPagedLM(dict(m.named_parameters()), m.config, device="cpu")
    port_tokens = tgen.GenerateEngine(lm, lm.make_cache(1, max_len=32)) \
        .generate([prompt], max_new_tokens=6)
    jparams = {k: v.detach().numpy() for k, v in m.named_parameters()}
    jlm = jgen.GPTPagedLM(jparams, m.config)
    assert jgen.GenerateEngine(jlm, jlm.make_cache(1, max_len=32)).generate(
        [prompt], max_new_tokens=6) == port_tokens

    class NoConfig:
        def named_parameters(self):
            return iter(())
    with pytest.raises(ValueError, match="draft model carries no config"):
        tgen.export_gpt_for_serving(str(tmp_path / "x"), m.config, m,
                                    draft=NoConfig())
