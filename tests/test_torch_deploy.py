"""The PyTorch port's live weight push against the JAX package, on the CPU:
the serving half of the reference's ``tests/test_deploy.py``.

- Generations: the port's exports publish a monotonic pointer that the JAX
  package reads from the same directory, and retained generations load in
  both packages alike (rollback is re-pointing).
- ``ServedModel.swap_params``: aval drift and missing params raise
  ``GenerationMismatchError`` and leave the weights serving; after a swap
  the ``bert_encoder`` and ``lstm_lm`` (fp32 and int8) families give the
  JAX package's outputs at that generation on the same numpy inputs,
  rtol = atol = 1e-5, and every parameter and int8 buffer keeps its
  address (what keeps a captured CUDA graph valid on the card).
- The drain/re-admit state machine of ``ContinuousBatcher`` and
  ``DecodeLoop`` (draining sheds are retriable), the client's retry on
  ``Draining``, and ``ModelServer.deploy`` (pointer-following, no-op,
  rollback, a missing generation failing before the drain).
"""

import threading
import time

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import nd
from incubator_mxnet_tpu import serving as jserving
from incubator_mxnet_tpu.models.bert import BERTModel as JaxBERT
from incubator_mxnet_tpu.models.lstm_lm import RNNModel as JaxRNNModel
from incubator_mxnet_tpu_torch import serving
from incubator_mxnet_tpu_torch.serving import kv_cache, scheduler
from incubator_mxnet_tpu_torch.serving.decode import DecodeLoop, DecodeRequest

RTOL = ATOL = 1e-5
BERT_CFG = dict(vocab_size=40, units=8, hidden_size=16, num_layers=1,
                num_heads=2, max_length=32)
LM_CFG = dict(mode="lstm", vocab_size=40, num_embed=16, num_hidden=16,
              num_layers=2, tie_weights=True)


def _scale_jax_params(model, factor):
    for _n, p in model._collect_params_with_prefix().items():
        p.set_data(nd.array(np.asarray(p.data()._data) * factor))


def _jax_bert():
    np.random.seed(0)
    m = JaxBERT(prefix="dp_", dropout=0.0, **BERT_CFG)
    m.initialize(mx.init.Normal(0.02))
    m(nd.array(np.zeros((1, 4), np.int32)))
    return m


def _export_bert_generations(directory, n):
    """Generations 0..n-1 written by the JAX package, each with distinct
    weights."""
    m = _jax_bert()
    for g in range(n):
        if g:
            _scale_jax_params(m, 1.1)
        jserving.export_for_serving(directory, "bert_encoder", BERT_CFG, m)


def _ids(rows=1, length=6, seed=0):
    return np.random.RandomState(seed).randint(
        1, BERT_CFG["vocab_size"], (rows, length)).astype(np.int32)


@pytest.fixture(scope="module")
def bert_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("bert_gens"))
    _export_bert_generations(d, 2)
    return d


# ===================================================== generation pointer
def test_generation_pointer_publish_and_monotonic(tmp_path):
    from incubator_mxnet_tpu_torch.models.bert import BERTModel
    d = str(tmp_path)
    m = BERTModel(device="cpu", dropout=0.0, **BERT_CFG)
    assert serving.read_generation(d) is None
    serving.export_for_serving(d, "bert_encoder", BERT_CFG, m)
    ptr = serving.read_generation(d)
    assert ptr["generation"] == 0 and ptr["step"] == 0
    serving.export_for_serving(d, "bert_encoder", BERT_CFG, m)
    assert serving.read_generation(d)["generation"] == 1
    assert serving.generation_steps(d) == {0: 0, 1: 1}
    with pytest.raises(ValueError, match="monotonic"):
        serving.export_for_serving(d, "bert_encoder", BERT_CFG, m,
                                   generation=1)
    serving.export_for_serving(d, "bert_encoder", BERT_CFG, m, generation=5)
    assert serving.read_generation(d)["generation"] == 5
    assert serving.generation_steps(d)[5] == 2
    # the JAX package reads the same pointer and the same retained set
    assert jserving.read_generation(d)["generation"] == 5
    assert jserving.generation_steps(d) == serving.generation_steps(d)


def test_rollback_retention_and_pointer_repoint(tmp_path):
    d = str(tmp_path)
    _export_bert_generations(d, 3)
    params0, meta0 = serving.load_generation_params(d, 0)
    assert meta0.get("generation") == 0 and params0
    with pytest.raises(FileNotFoundError, match="not retained"):
        serving.load_generation_params(d, 99)
    # a rollback is re-pointing the pointer at a retained generation, by
    # either package
    serving.publish_generation(d, 1, serving.generation_steps(d)[1])
    assert serving.load_served_model(d, device="cpu").generation == 1
    assert jserving.load_served_model(d).generation == 1
    p_ptr, _ = serving.load_generation_params(d)
    p_jax, _ = jserving.load_generation_params(d, 1)
    assert sorted(p_ptr) == sorted(p_jax)
    for k in p_jax:
        np.testing.assert_array_equal(p_ptr[k].numpy(),
                                      np.asarray(p_jax[k].asnumpy()))


# ======================================================== in-place swaps
def test_swap_params_aval_drift_raises_and_keeps_weights(bert_dir):
    served = serving.load_served_model(bert_dir, device="cpu")
    ids = _ids()
    out1 = served.encode_fn({"token_ids": ids}, 8)["pooled"]
    params0, _ = serving.load_generation_params(bert_dir, 0)
    bad_shape = dict(params0)
    k = sorted(bad_shape)[0]
    bad_shape[k] = np.zeros((3, 3), np.float32)
    with pytest.raises(serving.GenerationMismatchError, match="drifted"):
        served.swap_params(bad_shape, 2)
    bad_dtype = dict(params0)
    bad_dtype[k] = params0[k].double()
    with pytest.raises(serving.GenerationMismatchError, match="drifted"):
        served.swap_params(bad_dtype, 2)
    missing = dict(params0)
    missing.pop(k)
    with pytest.raises(serving.GenerationMismatchError, match="missing"):
        served.swap_params(missing, 2)
    # failed swaps are all-or-nothing: generation and weights untouched
    assert served.generation == 1
    np.testing.assert_array_equal(
        served.encode_fn({"token_ids": ids}, 8)["pooled"], out1)


def test_bert_swap_matches_jax_at_each_generation_in_place(bert_dir):
    served = serving.load_served_model(bert_dir, device="cpu", generation=0)
    ptrs = {n: p.data_ptr() for n, p in served.model.named_parameters()}
    rs = np.random.RandomState(3)
    arrays = {"token_ids": rs.randint(1, 40, (2, 8)).astype(np.int32),
              "token_types": rs.randint(0, 2, (2, 8)).astype(np.int32),
              "valid_mask": (np.arange(8)[None] < np.array([[8], [5]]))
              .astype(np.float32)}
    outs = {}
    for gen in (1, 0, 1):
        params, _ = serving.load_generation_params(bert_dir, gen)
        served.swap_params(params, gen)
        assert served.generation == gen
        got = served.encode_fn(arrays, 8)["pooled"]
        want = jserving.load_served_model(bert_dir, generation=gen) \
            .encode_fn(arrays, 8)["pooled"]
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        outs.setdefault(gen, got)
    assert not np.allclose(outs[0], outs[1])     # the weights really moved
    assert ptrs == {n: p.data_ptr()
                    for n, p in served.model.named_parameters()}
    assert served.export_executables() == {}
    assert served.bind_executable("encode/r1xb8/token_ids", b"x") is False


def _jax_lm():
    np.random.seed(3)
    m = JaxRNNModel(prefix="jl_", dropout=0.0, **LM_CFG)
    m.initialize(mx.init.Normal(0.3))
    m(nd.array(np.zeros((1, 2), np.int32)), m.begin_state(batch_size=2))
    return m


@pytest.fixture(scope="module")
def lm_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("lm_gens"))
    m = _jax_lm()
    jserving.export_for_serving(d, "lstm_lm", LM_CFG, m)
    _scale_jax_params(m, 1.3)
    jserving.export_for_serving(d, "lstm_lm", LM_CFG, m)
    return d


def _lm_buffers(served):
    ptrs = [p.data()._t.data_ptr()
            for p in served.model.collect_params().values()]
    head = served.int8_head
    if head is not None:
        ptrs += [head._qw.data_ptr(), head._w_amax.data_ptr(),
                 head._bias.data_ptr()]
    return ptrs


@pytest.mark.parametrize("quantize", [False, True], ids=["fp32", "int8"])
def test_lstm_swap_matches_jax_at_the_new_generation(lm_dir, quantize):
    """One grid step after a swap to generation 1 against the JAX family
    loaded at generation 1, from the same state; the int8 head is
    re-quantized in place (codes and amax equal a fresh head's)."""
    served = serving.load_served_model(lm_dir, quantize=quantize,
                                       device="cpu", generation=0)
    ptrs = _lm_buffers(served)
    params1, _ = serving.load_generation_params(lm_dir, 1)
    served.swap_params(params1, 1)
    assert served.generation == 1 and _lm_buffers(served) == ptrs
    jserved = jserving.load_served_model(lm_dir, quantize=quantize,
                                         generation=1)
    rs = np.random.RandomState(7)
    tokens = rs.randint(0, 40, 4).astype(np.int32)
    h = (rs.randn(4, 2, 16) * 0.5).astype(np.float32)
    tc, jc = served.make_cache(4, 8), jserved.make_cache(4, 8)
    for _ in range(4):
        tc.alloc()
        jc.alloc()
    for name in ("h", "c"):
        tc.data[name].copy_(torch.from_numpy(h))
        jc.data[name][:] = h
    active = np.ones(4, bool)
    got = served.step_fn(tokens, tc, active)
    want = jserved.step_fn(tokens, jc, active)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    for name in ("h", "c"):
        np.testing.assert_allclose(tc.data[name].numpy(), jc.data[name],
                                   rtol=RTOL, atol=ATOL)
    if quantize:
        fresh = serving.load_served_model(lm_dir, quantize=True,
                                          device="cpu", generation=1)
        for buf in ("_qw", "_w_amax", "_bias"):
            assert torch.equal(getattr(served.int8_head, buf),
                               getattr(fresh.int8_head, buf))
    # drift in one tensor moves nothing: the same step gives the same rows
    bad = dict(params1)
    bad["rnn.l0_i2h_weight"] = torch.zeros(3, 3)
    with pytest.raises(serving.GenerationMismatchError, match="drifted"):
        served.swap_params(bad, 2)
    assert served.generation == 1
    for name in ("h", "c"):
        tc.data[name].copy_(torch.from_numpy(h))
    np.testing.assert_array_equal(served.step_fn(tokens, tc, active), got)


# ================================================== drain state machine
def test_batcher_drain_serves_out_then_sheds_retriable():
    release = threading.Event()

    def slow(batch, bucket):
        release.wait(10)
        return {"y": batch["x"] * 2}

    b = scheduler.ContinuousBatcher("m", slow, max_batch=2, buckets=(4,),
                                    max_wait_ms=0)
    b.start()
    try:
        inflight = b.submit(scheduler.Request(
            "m", {"x": np.zeros((1, 4), np.float32)}))
        time.sleep(0.2)                 # the worker is blocked in forward
        queued = b.submit(scheduler.Request(
            "m", {"x": np.ones((1, 4), np.float32)}))
        done = {}
        t = threading.Thread(
            target=lambda: done.setdefault("ok", b.drain(timeout=10.0)))
        t.start()
        time.sleep(0.15)
        assert b.draining
        shed = b.submit(scheduler.Request(
            "m", {"x": np.zeros((1, 4), np.float32)}))
        with pytest.raises(serving.ShedError) as ei:
            shed.wait(1.0)
        assert ei.value.stage == "draining"
        release.set()
        t.join(10)
        assert done["ok"] is True
        # in-flight AND already-queued work was served, not shed
        np.testing.assert_array_equal(inflight.wait(5.0)["y"],
                                      np.zeros((1, 4)))
        np.testing.assert_array_equal(queued.wait(5.0)["y"],
                                      np.full((1, 4), 2.0))
        assert b.stats()["draining"] is True
        b.admit()
        assert b.draining is False
        ok = b.submit(scheduler.Request(
            "m", {"x": np.ones((1, 4), np.float32)}))
        assert ok.wait(5.0)["y"].shape == (1, 4)
    finally:
        release.set()
        b.stop()


def test_batcher_drain_deadline_sheds_leftover_queue():
    release = threading.Event()

    def slow(batch, bucket):
        release.wait(10)
        return {"y": batch["x"]}

    b = scheduler.ContinuousBatcher("m", slow, max_batch=1, buckets=(4,),
                                    max_wait_ms=0)
    b.start()
    try:
        first = b.submit(scheduler.Request(
            "m", {"x": np.zeros((1, 4), np.float32)}))
        time.sleep(0.2)
        stuck = b.submit(scheduler.Request(
            "m", {"x": np.zeros((1, 4), np.float32)}))
        # the forward does not return within the drain window: the queued
        # request is shed retriable, and drain says a forward still runs
        assert b.drain(timeout=0.3) is False
        with pytest.raises(serving.ShedError) as ei:
            stuck.wait(1.0)
        assert ei.value.stage == "draining"
        release.set()
        first.wait(5.0)                 # the in-flight one still lands
    finally:
        release.set()
        b.stop()


def _counting_step(vocab=10, delay=0.0):
    def step(tokens, cache, active):
        if delay:
            time.sleep(delay)
        logits = np.zeros((tokens.shape[0], vocab), np.float32)
        for slot in range(tokens.shape[0]):
            if active[slot]:
                cache.data["h"][slot] += 1
                logits[slot, (int(tokens[slot]) + 1) % vocab] = 1.0
        return logits
    return step


def _toy_cache(slots=2, max_len=64):
    return kv_cache.KVCache(slots, {"h": ("state", (1,))}, max_len=max_len,
                            device="cpu")


def test_decode_drain_fences_active_sessions_retriable():
    cache = _toy_cache(slots=1)
    loop = DecodeLoop("lm", _counting_step(delay=0.05), cache, pad_token=0)
    loop.start()
    try:
        long = loop.submit(DecodeRequest("lm", [1], max_new_tokens=60))
        time.sleep(0.3)                 # admitted, mid-generation
        pend = loop.submit(DecodeRequest("lm", [2], max_new_tokens=2))
        assert loop.drain(timeout=0.4) is True
        with pytest.raises(serving.ShedError) as e1:
            pend.wait(1.0)
        assert e1.value.stage == "draining"
        with pytest.raises(serving.ShedError) as e2:
            long.wait(5.0)
        assert e2.value.stage == "draining"
        deadline = time.monotonic() + 5.0
        while cache.in_use and time.monotonic() < deadline:
            time.sleep(0.02)
        assert cache.in_use == 0
        shed = loop.submit(DecodeRequest("lm", [3], max_new_tokens=2))
        with pytest.raises(serving.ShedError) as e3:
            shed.wait(1.0)
        assert e3.value.stage == "draining"
        loop.admit()
        ok = loop.submit(DecodeRequest("lm", [3], max_new_tokens=2))
        np.testing.assert_array_equal(ok.wait(10.0)["tokens"], [4, 5])
    finally:
        loop.stop()


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_decode_drain_window_starts_once_it_holds_the_loop(pkg):
    """A drain that arrives while an admission pass holds the loop's lock
    (its prompt's chunked prefill, 1.5 s here; hundreds of ms for a few
    long prompts on the card) waits for that pass. The port's window starts
    once the drain holds the lock, so the admitted session finishes inside
    it and the drain succeeds; the JAX package's deadline was taken before
    the wait, so the session is fenced and the drain reports a step still
    in flight (ROADMAP, reference faults)."""
    from incubator_mxnet_tpu.serving import decode as jdecode
    from incubator_mxnet_tpu.serving import kv_cache as jkv

    def slow_prefill(slot, tokens, cache):
        time.sleep(1.5)

    if pkg == "port":
        loop_cls, req_cls, cache = DecodeLoop, DecodeRequest, _toy_cache()
    else:
        loop_cls, req_cls = jdecode.DecodeLoop, jdecode.DecodeRequest
        cache = jkv.KVCache(2, {"h": ("state", (1,))}, max_len=64)
    loop = loop_cls("lm", _counting_step(delay=0.05), cache, pad_token=0,
                    prefill_fn=slow_prefill, prefill_chunk=8)
    loop.start()
    try:
        r = loop.submit(req_cls("lm", [1, 2, 3], max_new_tokens=4))
        time.sleep(0.2)                 # admitted, its prefill under way
        t0 = time.monotonic()
        # the lock comes free after the prefill, while the first of the
        # session's four 50 ms steps runs: past the reference's two windows
        ok = loop.drain(timeout=0.5)
        assert time.monotonic() - t0 >= 1.1     # waited for the admission
        if pkg == "port":
            assert ok is True
            np.testing.assert_array_equal(r.wait(5.0)["tokens"],
                                          [4, 5, 6, 7])
        else:
            assert ok is False
            with pytest.raises(jserving.ShedError, match="draining"):
                r.wait(5.0)
    finally:
        loop.stop()


def test_decode_prefill_runs_outside_the_loop_lock():
    """While an admission pass prefills a prompt (1 s here), a ``submit``
    and a ``stats`` return within tens of ms: the slot is reserved under
    the loop's lock and prefilled outside it, on the loop's thread. The
    reference prefills under its lock, so both wait for the pass there
    (ROADMAP, reference faults); this holds the port only. A drain sent
    meanwhile sees the reserved slot in flight and waits for the session."""
    started = threading.Event()

    def slow_prefill(slot, tokens, cache):
        started.set()
        time.sleep(1.0)

    loop = DecodeLoop("lm", _counting_step(delay=0.01), _toy_cache(),
                      pad_token=0, prefill_fn=slow_prefill, prefill_chunk=8)
    loop.start()
    try:
        first = loop.submit(DecodeRequest("lm", [1, 2, 3], max_new_tokens=4))
        assert started.wait(5.0)
        t0 = time.monotonic()
        second = loop.submit(DecodeRequest("lm", [7], max_new_tokens=2))
        st = loop.stats()
        waited = time.monotonic() - t0
        assert waited < 0.05, waited
        assert st["active"] == 0 and st["prefills"] == 0
        assert loop.drain(timeout=2.0) is True
        assert time.monotonic() - t0 >= 0.9       # the prefill, then steps
        np.testing.assert_array_equal(first.wait(5.0)["tokens"],
                                      [4, 5, 6, 7])
        # queued behind the reserved slot when the drain came: shed, retriable
        with pytest.raises(serving.ShedError, match="draining"):
            second.wait(5.0)
        assert loop.stats()["prefills"] == 1
    finally:
        loop.stop()


def test_decode_drain_waits_for_natural_finish():
    loop = DecodeLoop("lm", _counting_step(delay=0.01), _toy_cache(),
                      pad_token=0)
    loop.start()
    try:
        r = loop.submit(DecodeRequest("lm", [1], max_new_tokens=4))
        time.sleep(0.05)
        assert loop.drain(timeout=10.0) is True
        np.testing.assert_array_equal(r.wait(5.0)["tokens"], [2, 3, 4, 5])
    finally:
        loop.stop()


# ==================================================== client retry plane
def test_client_rotates_replicas_on_draining(monkeypatch):
    c = serving.ServingClient(["a:1", "b:2"], retry_draining=5,
                              retry_backoff_ms=1)
    calls = []

    def fake_call(meta, payload=b"", deadline_ms=None):
        calls.append(c._cur)
        if len(calls) < 3:
            raise serving.Draining("mid-swap")
        return {"ok": True}, b""

    monkeypatch.setattr(c, "_call", fake_call)
    meta, _ = c._call_retrying({"op": "serve.infer"})
    assert meta["ok"]
    assert calls == [0, 1, 0]           # rotated through the replicas


def test_client_draining_retry_respects_deadline(monkeypatch):
    c = serving.ServingClient("a:1", retry_draining=10 ** 6,
                              retry_backoff_ms=20)

    def always_draining(meta, payload=b"", deadline_ms=None):
        raise serving.Draining("mid-swap")

    monkeypatch.setattr(c, "_call", always_draining)
    t0 = time.monotonic()
    with pytest.raises(serving.DeadlineExceeded) as ei:
        c._call_retrying({"op": "serve.infer"}, deadline_ms=150)
    assert ei.value.stage == "draining"
    assert time.monotonic() - t0 < 5.0


def test_client_single_replica_backs_off_then_recovers(monkeypatch):
    c = serving.ServingClient(("a", 1), retry_draining=5,
                              retry_backoff_ms=1)
    attempts = []

    def fake_call(meta, payload=b"", deadline_ms=None):
        attempts.append(1)
        if len(attempts) < 3:
            raise serving.Draining("mid-swap")
        return {"ok": True}, b""

    monkeypatch.setattr(c, "_call", fake_call)
    meta, _ = c._call_retrying({"op": "serve.infer"})
    assert meta["ok"] and len(attempts) == 3


# ============================================ pinning vs CUDA graph capture
def test_deploy_pins_under_the_capture_lock_and_reads_outside_it(
        bert_dir, monkeypatch):
    """A deploy pins the next generation's weights holding the CUDA graph
    capture lock (no capture of a served shape overlaps the pinning) and
    reads the checkpoint from disk without it (a capture waits no longer
    than the pinning). A CPU server pins nothing, so the server's load is
    made to pin and ``pin_memory`` records the lock and copies."""
    from incubator_mxnet_tpu_torch.compilecache import aot
    from incubator_mxnet_tpu_torch.serving import loader
    from incubator_mxnet_tpu_torch.serving import server as server_mod
    lock = aot.capture_lock()
    held = {"read": [], "pin": []}
    restore = loader.CheckpointManager.restore
    load = server_mod.load_generation_params

    def read(self, *args, **kw):
        held["read"].append(lock.locked())
        return restore(self, *args, **kw)

    def pin(self):
        held["pin"].append(lock.locked())
        return self.clone()

    n_params = len(load(bert_dir, 1)[0])
    srv = serving.ModelServer(device="cpu")
    srv.load("bert", directory=bert_dir, generation=0, max_wait_ms=0,
             buckets=(8,))
    srv.start()
    try:
        monkeypatch.setattr(loader.CheckpointManager, "restore", read)
        monkeypatch.setattr(torch.Tensor, "pin_memory", pin)
        monkeypatch.setattr(server_mod, "load_generation_params",
                            lambda d, g, pin=False: load(d, g, pin=True))
        r = srv.deploy("bert", generation=1)
        assert r["generation"] == 1 and r["previous"] == 0
    finally:
        srv.stop()
    assert held["read"] == [False]
    assert len(held["pin"]) == n_params > 0 and all(held["pin"])
    assert not lock.locked()


# ============================================ in-process serve.deploy op
def test_server_deploy_swap_rollback_and_noop(bert_dir):
    srv = serving.ModelServer(device="cpu")
    srv.load("bert", directory=bert_dir, generation=0, max_wait_ms=0,
             buckets=(8,))
    srv.start()
    ids = _ids()
    want = {g: jserving.load_served_model(bert_dir, generation=g)
            .encode_fn({"token_ids": np.pad(ids, ((0, 0), (0, 2)))},
                       8)["pooled"] for g in (0, 1)}
    try:
        with serving.ServingClient(srv.addr) as c:
            assert c.generation("bert") == {"generation": 0,
                                            "draining": False}
            r = c.deploy("bert")        # follows the pointer (gen 1)
            assert r["generation"] == 1 and r["previous"] == 0 \
                and not r.get("noop")
            assert all(r[k] >= 0 for k in ("drain_ms", "swap_ms",
                                           "admit_ms"))
            np.testing.assert_allclose(
                c.infer("bert", {"token_ids": ids})["pooled"], want[1],
                rtol=RTOL, atol=ATOL)
            assert c.deploy("bert", generation=1)["noop"] is True
            back = c.deploy("bert", generation=0)   # rollback direction
            assert back["generation"] == 0 and back["previous"] == 1
            np.testing.assert_allclose(
                c.infer("bert", {"token_ids": ids})["pooled"], want[0],
                rtol=RTOL, atol=ATOL)
            # a missing generation fails BEFORE the drain
            with pytest.raises(serving.ServingError, match="not retained"):
                c.deploy("bert", generation=42)
            assert c.generation() == {"bert": {"generation": 0,
                                               "draining": False}}
            assert c.drain("bert")["drained"] is True
            assert c.generation("bert")["draining"] is True
            with serving.ServingClient(srv.addr, retry_draining=0) as c2:
                with pytest.raises(serving.Draining):
                    c2.infer("bert", {"token_ids": ids})
            c.admit("bert")
            assert c.generation("bert")["draining"] is False
            st = c.stats()["bert"]
            assert st["generation"] == 0 and st["batch"]["draining"] is False
            assert st["graphs"] == {"captured": 0, "replayed": 0,
                                    "programs": 0}
        with pytest.raises(FileNotFoundError):
            srv.deploy("bert", generation=42)
        with pytest.raises(serving.ServingError, match="not loaded"):
            with serving.ServingClient(srv.addr) as c:
                c.generation("other")
    finally:
        srv.stop()
