"""The PyTorch port's request tracing against the JAX package's, on the CPU.

- ``build_timeline``, ``render_timeline`` and ``merge_traces`` give equal
  results for the same span records and chrome dumps (duplicates, orphan
  parents, empty input).
- Head sampling is decided at the root and rides the rpc meta, across the
  packages too: a JAX-stamped meta continues as a port span and back.
- One decode request on a tiny GPT (a checkpoint the JAX package exported,
  served by both packages' ``ModelServer`` on the CPU) yields the same span
  names and counts, and the same counter values (``serving_requests``,
  ``gen_tokens_committed``, ``serving_decode_steps``, the TTFT and TPOT
  counts); the port's spans alone give TTFT and TPOT that agree with its
  histograms, and ``ServingClient.tracez`` returns the stitched tree.
"""

import json
import time

import numpy as np
import pytest

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import nd
from incubator_mxnet_tpu import serving as jserving
from incubator_mxnet_tpu import telemetry as jtel
from incubator_mxnet_tpu.generate import export_gpt_for_serving
from incubator_mxnet_tpu.models.gpt import GPTDecoder
from incubator_mxnet_tpu.telemetry import catalog as jcat
from incubator_mxnet_tpu.telemetry import tracing as jtr
from incubator_mxnet_tpu_torch import serving as tserving
from incubator_mxnet_tpu_torch import telemetry as ttel
from incubator_mxnet_tpu_torch.telemetry import catalog as tcat
from incubator_mxnet_tpu_torch.telemetry import tracing as ttr

GPT_CFG = dict(vocab_size=37, units=16, num_layers=1, num_heads=2,
               max_len=64)
SPANS = [
    {"name": "root", "trace_id": "t", "span_id": "r", "ts_us": 0.0,
     "dur_us": 100.0, "model": "m"},
    {"name": "child", "trace_id": "t", "span_id": "c", "parent_id": "r",
     "ts_us": 10.0, "dur_us": 20.0},
    {"name": "child", "trace_id": "t", "span_id": "c", "parent_id": "r",
     "ts_us": 10.0, "dur_us": 20.0},                     # duplicate id
    {"name": "orphan", "trace_id": "t", "span_id": "o",
     "parent_id": "missing", "ts_us": 30.0, "dur_us": 5.0},
    {"name": "late", "trace_id": "t", "span_id": "l", "parent_id": "c",
     "ts_us": 15.0, "dur_us": 90.0, "tokens_committed": 1},
    {"name": "other", "trace_id": "u", "span_id": "x", "ts_us": 1.0,
     "dur_us": 1.0},
]


@pytest.mark.parametrize("trace_id", [None, "t", "u", "absent"])
def test_timelines_equal_the_jax_packages(trace_id):
    want = jtr.build_timeline([dict(s) for s in SPANS], trace_id=trace_id)
    got = ttr.build_timeline([dict(s) for s in SPANS], trace_id=trace_id)
    assert got == want
    assert ttr.render_timeline(got) == jtr.render_timeline(want)
    assert ttr.build_timeline([]) == jtr.build_timeline([])


def test_merge_traces_equals_the_jax_packages(tmp_path):
    ev = {"name": "serve.queue", "ph": "X", "ts": 1, "dur": 2,
          "args": {"span_id": "dup"}}
    paths = []
    for i, data in enumerate(({"traceEvents": [ev, {"name": "other",
                                                    "ph": "X", "ts": 5}]},
                              {"traceEvents": [dict(ev), "junk"]},
                              {"not_a_trace": True})):
        p = tmp_path / ("in%d.json" % i)
        p.write_text(json.dumps(data))
        paths.append(str(p))
    got = ttr.merge_traces(paths, str(tmp_path / "port.json"))
    want = jtr.merge_traces(paths, str(tmp_path / "jax.json"))
    assert got == want
    assert (tmp_path / "port.json").read_text() == \
        (tmp_path / "jax.json").read_text()
    assert ttr.merge_traces([], str(tmp_path / "empty.json")) == []


def test_sampling_rides_the_meta_across_the_packages():
    prev = (jtr.sample_rate(), ttr.sample_rate())
    try:
        assert ttr.set_sample_rate(7.0) == 1.0
        assert ttr.set_sample_rate(0.0) == 0.0
        assert ttr.request_span("client.infer") is ttr.NULL_SPAN
        ttr.set_sample_rate(1.0)
        with ttr.request_span("client.infer", model="m") as sp:
            meta = ttr.inject({"op": "serve.infer"})
        assert sp.sampled and sp.parent_id is None
        assert meta == {"op": "serve.infer", ttr.TRACE_KEY: sp.trace_id,
                        ttr.PARENT_KEY: sp.span_id, ttr.SAMPLED_KEY: 1}
        # the JAX package's server continues the port's sampled journey
        child = jtr.from_meta("rpc.serve.infer", meta)
        assert child.sampled and child.trace_id == sp.trace_id
        # and the other way round
        jtr.set_sample_rate(1.0)
        with jtr.request_span("client.decode") as jsp:
            jmeta = jtr.inject({"op": "serve.decode"})
        back = ttr.from_meta("rpc.serve.decode", jmeta)
        assert back.sampled and back.trace_id == jsp.trace_id
        assert back.parent_id == jsp.span_id
        # an unsampled plain span stamps no sampled flag
        ttel.enable()
        with ttr.span("client.infer"):
            plain = ttr.inject({})
        assert ttr.SAMPLED_KEY not in plain
        assert ttr.from_meta("rpc.x", {}) is ttr.NULL_SPAN
    finally:
        jtr.set_sample_rate(prev[0])
        ttr.set_sample_rate(prev[1])
        ttel.disable()


def test_record_span_and_the_bounded_ring():
    ttr.clear_spans()
    t1 = time.time()
    rec = ttr.record_span("serve.queue", "tid123", parent_id="p1",
                          t0=t1 - 0.25, t1=t1, sampled=True, model="m")
    assert rec["trace_id"] == "tid123" and rec["parent_id"] == "p1"
    assert abs(rec["dur_us"] - 250_000) < 1_000
    assert [s["name"] for s in ttr.spans_for_trace("tid123")] == \
        ["serve.queue"]
    ttel.enable()
    dropped = tcat.telemetry_spans_dropped.value()
    try:
        ttr._resize(16)
        for i in range(20):
            ttr.record_span("s%d" % i, "ring")
        assert [s["name"] for s in ttr.recent_spans()] == \
            ["s%d" % i for i in range(4, 20)]
        # the ring held serve.queue and 20 more went in
        assert tcat.telemetry_spans_dropped.value() == dropped + 5
    finally:
        ttr._resize(4096)
        ttr.clear_spans()
        ttel.disable()


# ------------------------------------------------- one decode request
def _export_tiny_gpt(directory):
    model = GPTDecoder(prefix="tj_", **GPT_CFG)
    model.initialize(mx.init.Normal(0.05))
    model(nd.array(np.zeros((1, 4), np.int32)))
    export_gpt_for_serving(directory, GPT_CFG, model)


def _names(spans, trace_id):
    out = {}
    for s in spans:
        if s.get("trace_id") == trace_id:
            out[s["name"]] = out.get(s["name"], 0) + 1
    return out


def _counters(cat):
    return {"requests_ok": cat.serving_requests.value(model="gpt",
                                                      status="ok"),
            "committed_prefill": cat.gen_tokens_committed.value(
                model="gpt", phase="prefill"),
            "committed_decode": cat.gen_tokens_committed.value(
                model="gpt", phase="decode"),
            "decode_steps": cat.serving_decode_steps.value(model="gpt"),
            "ttft": cat.serving_ttft_seconds.count(model="gpt"),
            "tpot": cat.serving_tpot_seconds.count(model="gpt"),
            "prefill": cat.gen_prefill_seconds.count(model="gpt"),
            "queue": cat.serving_queue_seconds.count(model="gpt")}


def _serve_one(server, client_cls, tracing, prompt, **load):
    server.load("gpt", **load)
    server.start()
    client = client_cls(server.addr)
    try:
        out = client.decode("gpt", prompt, max_new_tokens=4)
        tid = client.last_trace_id
        remote = client.tracez(tid)
        stats = client.stats()["gpt"]
    finally:
        client.close()
        server.stop()
    return out, tid, tracing.spans_for_trace(tid), remote, stats


@pytest.fixture
def sampled():
    prev = (jtr.sample_rate(), ttr.sample_rate())
    for tr, tel in ((jtr, jtel), (ttr, ttel)):
        tr.set_sample_rate(1.0)
        tr.clear_spans()
        tel.reset()
    yield
    jtr.set_sample_rate(prev[0])
    ttr.set_sample_rate(prev[1])
    jtel.disable()
    ttel.disable()


def test_one_decode_request_same_spans_and_counters(tmp_path, sampled):
    ckpt = str(tmp_path / "gpt")
    _export_tiny_gpt(ckpt)
    prompt = np.array([3, 5, 7, 2, 11, 1], np.int32)
    jout, jtid, jspans, _jremote, _ = _serve_one(
        jserving.ModelServer(), jserving.ServingClient, jtr, prompt,
        directory=ckpt, slots=2, cache_len=64)
    tout, ttid, tspans, tremote, tstats = _serve_one(
        tserving.ModelServer(device="cpu"), tserving.ServingClient, ttr,
        prompt, directory=ckpt, slots=2, cache_len=64)
    assert tout.tolist() == jout.tolist()
    assert jtid and ttid
    names = _names(tspans, ttid)
    assert names == _names(jspans, jtid)
    assert names["decode.step"] == 4 and names["client.decode"] == 1
    for required in ("serve.queue", "serve.join", "decode.prefill",
                     "rpc.serve.decode"):
        assert names[required] == 1, required
    assert _counters(tcat) == _counters(jcat)
    assert _counters(tcat) == {"requests_ok": 1, "committed_prefill": 5,
                               "committed_decode": 4, "decode_steps": 4,
                               "ttft": 1, "tpot": 3, "prefill": 1,
                               "queue": 1}
    assert tstats["requests"] == {"ok": 1, "shed": 0, "error": 0}
    assert tstats["mean_batch_occupancy"] == 1.0
    assert 0 < tstats["p50_s"] <= tstats["p99_s"]

    # one stitched tree under the client root, which serve.tracez returns
    # (client and server share one ring in this process)
    tl = ttr.build_timeline(tspans, trace_id=ttid)
    assert [r["name"] for r in tl["roots"]] == ["client.decode"]
    assert {s["trace_id"] for s in tl["spans"]} == {ttid}
    assert tremote == tl

    # TTFT and TPOT from the spans alone agree with the histograms
    steps = sorted((s for s in tspans if s["name"] == "decode.step"),
                   key=lambda s: s["ts_us"])
    arrival = next(s["ts_us"] for s in tspans if s["name"] == "serve.queue")
    ttft_span = (steps[0]["ts_us"] + steps[0]["dur_us"] - arrival) / 1e6
    assert abs(ttft_span - tcat.serving_ttft_seconds.sum(model="gpt")) < 0.2
    ends = [s["ts_us"] + s["dur_us"] for s in steps]
    tpot_span = (ends[-1] - ends[0]) / 3 / 1e6
    tpot_hist = tcat.serving_tpot_seconds.sum(model="gpt") / 3
    assert abs(tpot_span - tpot_hist) < 0.1
    assert sum(s["tokens_committed"] for s in steps) == 4
    ex = tcat.serving_ttft_seconds.exemplars(model="gpt")
    assert any(e["trace_id"] == ttid for e in ex.values())
