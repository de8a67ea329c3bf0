"""The PyTorch port's observability plane on the CPU: costs, the flight
recorder, the debug endpoints, the memory plane and the profiler.

- ``telemetry.costs``: the FLOPs of a small BERT program counted on the
  plain path (dense and flash attention) equal the analytic count of its
  products, and a served encode under ``MXTPU_COSTS=1`` records them and
  an MFU; the MFU formula; the H100 default peaks and their knobs; a
  failed count is counted and left on the flight ring.
- ``telemetry.flight``: the ring, identity stamps and the JSONL dump, in
  the JAX package's format.
- ``telemetry.debugz``: every endpoint answers in-process; none creates a
  CUDA context.
- ``telemetry.memz``: the KV census of a small ``PagedKVCache`` equals the
  JAX package's census of the same operations, and its pool bytes are the
  pools' own; no device readings without a CUDA context.
- ``profiler``: host events, aggregate stats and the torch.profiler window.
"""

import json
import os
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from incubator_mxnet_tpu.generate import paged_kv as jpaged
from incubator_mxnet_tpu.telemetry import flight as jflight
from incubator_mxnet_tpu.telemetry import memz as jmemz
from incubator_mxnet_tpu_torch import profiler, serving
from incubator_mxnet_tpu_torch import telemetry as ttel
from incubator_mxnet_tpu_torch.generate import paged_kv as tpaged
from incubator_mxnet_tpu_torch.models.bert import BERTModel
from incubator_mxnet_tpu_torch.telemetry import catalog as tcat
from incubator_mxnet_tpu_torch.telemetry import costs, debugz, flight, memz
from incubator_mxnet_tpu_torch.telemetry import tracing

BERT = dict(vocab_size=50, units=32, hidden_size=64, num_layers=2,
            num_heads=2, max_length=64)


def bert_flops(B, T, units, hidden_size, num_layers):
    """The products of one BERT forward: per layer the Q, K, V and output
    projections and the two feed-forward matmuls, attention's QK^T and PV
    over every key; and the pooler."""
    per_layer = 2 * B * T * units * (4 * units + 2 * hidden_size) \
        + 4 * B * T * T * units
    return num_layers * per_layer + 2 * B * units * units


@pytest.mark.parametrize("flash_min_t", ["512", "16"],
                         ids=["dense", "flash"])
def test_bert_program_flops_equal_the_analytic_count(monkeypatch,
                                                     flash_min_t):
    monkeypatch.setenv("MXTPU_FLASH_MIN_T", flash_min_t)
    model = BERTModel(dropout=0.0, device="cpu", **BERT)
    B, T = 3, 16
    ids = torch.randint(0, BERT["vocab_size"], (B, T),
                        generator=torch.Generator().manual_seed(0))
    mask = torch.ones(B, T)
    mask[1, 10:] = 0
    with torch.inference_mode():
        (seq, pooled), cost = costs.count(
            lambda i, m: model(i, None, m), ids, mask)
        want_seq, want_pooled = model(ids, None, mask)
    assert torch.equal(pooled, want_pooled) and torch.equal(seq, want_seq)
    assert cost["flops"] == cost["aten_flops"] == bert_flops(
        B, T, BERT["units"], BERT["hidden_size"], BERT["num_layers"])
    assert cost["kernel_flops"] == 0 and cost["kernels"] == {}
    assert cost["bytes"] > seq.numel() * 4


def test_kernel_formulas_add_up_under_counting_costs():
    from incubator_mxnet_tpu_torch.ops.kernels import _build

    def fake_kernel():
        pass
    fake_kernel.launches = 0
    with _build.counting_costs() as acc:
        for _ in range(3):
            _build.count_launch(fake_kernel, lambda: (10.0, 4.0))
        _build.count_launch(fake_kernel)            # no formula
        with pytest.raises(RuntimeError, match="already being counted"):
            _build.counting_costs().__enter__()
    assert acc == {"flops": 30.0, "bytes": 12.0,
                   "kernels": {"fake_kernel": [3, 30.0, 12.0]}}
    assert fake_kernel.launches == 4
    nbytes, live, dense = costs.flash_forward_cost(12, 512, 64, [512] * 8)
    assert dense == live == 4 * 8 * 12 * 512 * 512 * 64
    assert nbytes == (4 * 8 * 12 * 512 * 64 + 8 * 12 * 512) * 4
    assert costs.flash_decode_cost(8, 1, 12, 64, 100, 64)[1] == \
        4 * 12 * 64 * 100
    assert costs.int8_matmul_cost(8, 16, 32) == (8 * 32 + 16 * 32
                                                 + 4 * 8 * 16,
                                                 2 * 8 * 16 * 32)


@pytest.mark.parametrize("q_bytes,kv_bytes", [(4, 4), (2, 2), (2, 4)])
def test_flash_decode_cost_counts_each_dtype_bytes(q_bytes, kv_bytes):
    """The decode formula's bytes at each dtype pair the kernels take (fp32,
    bf16 q over bf16 pools, bf16 q over fp32 pools): the live K and V rows
    at the pools' element size, q and o at q's, m, l, tables and lengths
    at 4; the operations do not depend on the dtype. The fp32 default is
    the pair (4, 4)."""
    S, C, H, D, live, mb = 8, 1, 12, 64, 3000, 64
    nbytes, flops = costs.flash_decode_cost(S, C, H, D, live, mb, q_bytes,
                                            kv_bytes)
    assert nbytes == (2 * live * H * D * kv_bytes
                      + 2 * S * C * H * D * q_bytes
                      + 4 * (2 * S * C * H + S * mb + S))
    assert flops == 4 * C * H * D * live
    if (q_bytes, kv_bytes) == (4, 4):
        assert costs.flash_decode_cost(S, C, H, D, live, mb) == (nbytes,
                                                                 flops)


def test_mfu_formula_and_the_h100_default_peaks(monkeypatch):
    monkeypatch.delenv("MXTPU_PEAK_TFLOPS", raising=False)
    monkeypatch.delenv("MXTPU_PEAK_GBS", raising=False)
    assert costs.peak_flops() == 67e12
    assert costs.peak_bytes() == 3.35e12
    assert costs.mfu(67e12, 2.0) == pytest.approx(0.5)
    assert costs.mfu(1.0, 0.0) == 0.0
    monkeypatch.setenv("MXTPU_PEAK_TFLOPS", "1")
    monkeypatch.setenv("MXTPU_PEAK_GBS", "bad")
    assert costs.peak_flops() == 1e12 and costs.peak_bytes() == 3.35e12
    ttel.enable()
    try:
        costs.capture("obs_exec", {"flops": 5e11, "bytes": 1.0},
                      samples_per_exec=100)
        costs.observe("obs_exec", seconds=1.0)
        assert tcat.model_flops_utilization.value(
            name="obs_exec") == pytest.approx(0.5)
        assert tcat.model_tokens_per_sec.value(
            name="obs_exec") == pytest.approx(100.0)
        assert tcat.model_flops_per_exec.value(name="obs_exec") == 5e11
        costs.observe("never_captured", 1.0)        # a dict miss
        flight.enable()
        failed = tcat.costs_capture_errors.value(name="obs_bad")
        costs.capture_failed("obs_bad", RuntimeError("boom"))
        assert tcat.costs_capture_errors.value(name="obs_bad") == failed + 1
        assert flight.events(1)[0]["event"] == "costs.capture_failed"
        assert "boom" in flight.events(1)[0]["attrs"]["error"]
    finally:
        costs.reset()
        flight.disable()
        flight.clear()
        ttel.disable()


def test_served_encode_records_its_program_cost(tmp_path, monkeypatch):
    """The eager served path counts each program once under MXTPU_COSTS=1,
    and the batcher turns a forward's time into the program's MFU."""
    from incubator_mxnet_tpu_torch.serving import loader
    monkeypatch.setenv("MXTPU_COSTS", "1")
    model = BERTModel(dropout=0.0, device="cpu", seed=3, **BERT)
    params = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    served = loader.SERVING_FAMILIES["bert_encoder"](dict(BERT), params,
                                                     None, "cpu")
    srv = serving.ModelServer(device="cpu")
    srv.load("bert", served=served, buckets=(16, 32), max_batch=4)
    srv.start()
    costs.reset()
    try:
        with serving.ServingClient(srv.addr) as c:
            for T in (5, 12, 20):
                c.infer("bert", {"token_ids": np.ones((2, T), np.int64)})
            metrics = c.metrics()
    finally:
        srv.stop()
    got = costs.captured()
    assert sorted(got) == ["encode/r2xb16/token_ids",
                           "encode/r2xb32/token_ids"]
    for bucket in (16, 32):
        ent = got["encode/r2xb%d/token_ids" % bucket]
        assert ent["flops"] == bert_flops(2, bucket, BERT["units"],
                                          BERT["hidden_size"],
                                          BERT["num_layers"])
        assert ent["samples"] == 2 * bucket
        mfu = tcat.model_flops_utilization.value(
            name="encode/r2xb%d/token_ids" % bucket)
        assert 0 < mfu < 1
    assert 'mxtpu_model_flops_per_executable{name="encode/r2xb16/' \
        'token_ids"}' in metrics
    costs.reset()


def test_flight_ring_identity_and_dump_match_the_jax_format(tmp_path):
    for fl in (flight, jflight):
        fl.clear()
        fl.enable()
        fl.set_identity("serving", 0)
    try:
        for fl in (flight, jflight):
            fl.record("serving.shed", model="m", stage="queue",
                      request_id=7)
            fl.record("deploy.swap", model="m", generation=2)
        strip = [{k: v for k, v in e.items() if k != "ts"}
                 for e in flight.events()]
        assert strip == [{k: v for k, v in e.items() if k != "ts"}
                         for e in jflight.events()]
        assert flight.events(1)[0]["event"] == "deploy.swap"
        path = flight.dump(str(tmp_path / "flight.jsonl"), reason="test")
        lines = [json.loads(ln) for ln in open(path)]
        assert [e["event"] for e in lines] == ["serving.shed",
                                               "deploy.swap", "flight.dump"]
        assert lines[-1]["attrs"] == {"reason": "test"}
        assert flight.dump() is None or os.environ.get("MXTPU_FLIGHT_EXPORT")
    finally:
        for fl in (flight, jflight):
            fl.disable()
            fl.clear()


def test_debugz_endpoints_in_process():
    ttel.enable()
    flight.enable()
    prev_rate = tracing.sample_rate()
    tracing.set_sample_rate(1.0)
    try:
        with tracing.request_span("dbz_root") as root:
            with tracing.span("dbz_span"):
                pass
        flight.record("dbz_event")
        debugz.set_identity("serving", 0)
        assert debugz.start(0) is debugz.start(0)
        debugz.set_status("models", lambda: ["m1"])
        port = debugz.port()

        def get(path):
            with urllib.request.urlopen(
                    "http://127.0.0.1:%d%s" % (port, path), timeout=10) as r:
                return r.status, r.read().decode("utf-8")

        status = json.loads(get("/statusz")[1])
        assert status["role"] == "serving" and status["models"] == ["m1"]
        assert status["telemetry_enabled"] is True
        assert "cuda_devices" not in status       # no context here
        assert status["memz"] == memz.statusz_entry()
        st, body = get("/metrics")
        assert st == 200 and "# TYPE mxtpu_rpc_retries_total counter" in body
        assert "mxtpu_rpc_retries_total" in json.loads(get(
            "/metrics.json")[1])
        assert any(s["name"] == "dbz_span"
                   for s in json.loads(get("/tracez")[1])["spans"])
        tl = json.loads(get("/tracez?trace_id=%s" % root.trace_id)[1])
        assert [r["name"] for r in tl["timeline"]["roots"]] == ["dbz_root"]
        assert "dbz_span" in get("/tracez?trace_id=%s&format=text"
                                 % root.trace_id)[1]
        st, body = get("/threadz")
        assert st == 200 and "MainThread" in body
        events = json.loads(get("/flightz")[1])["events"]
        assert any(e["event"] == "dbz_event" for e in events)
        assert "kv" in json.loads(get("/memz")[1])
        assert get("/memz?format=text")[1].startswith("memz:")
        for path, code in (("/alertz", 501), ("/nonesuch", 404)):
            with pytest.raises(urllib.error.HTTPError) as e:
                get(path)
            assert e.value.code == code
        assert "/memz" in get("/")[1]
        assert tcat.debugz_requests.value(path="/statusz", status="200") >= 1
    finally:
        debugz.stop()
        tracing.set_sample_rate(prev_rate)
        flight.disable()
        flight.clear()
        ttel.disable()
    assert not debugz.active()
    assert not torch.cuda.is_initialized()


def _kv_ops(cache):
    """One sequence of cache operations, the same for both packages."""
    a, b = cache.alloc(), cache.alloc()
    for _ in range(5):
        cache.append("k0", a, np.ones((2, 4), np.float32))
        cache.append("v0", a, np.ones((2, 4), np.float32))
        cache.advance(a)
    for _ in range(9):
        cache.append("k0", b, np.ones((2, 4), np.float32))
        cache.append("v0", b, np.ones((2, 4), np.float32))
        cache.advance(b)
    cache.truncate(b, 3)
    c = cache.alloc()
    cache.free(a)
    return c


def test_kv_census_matches_the_jax_package_and_the_pool_bytes():
    for mz in (memz, jmemz):
        mz.reset()
        mz.enable()
    spec = {"k0": ("kv", (2, 4)), "v0": ("kv", (2, 4))}
    try:
        tcache = tpaged.PagedKVCache(3, spec, max_len=16, block_size=4,
                                     num_blocks=7, name="tiny",
                                     device="cpu")
        jcache = jpaged.PagedKVCache(3, spec, max_len=16, block_size=4,
                                     num_blocks=7, name="tiny")
        _kv_ops(tcache)
        _kv_ops(jcache)
        (got,), (want,) = memz.kv_census(), jmemz.kv_census()
        shared = {k: v for k, v in got.items() if k in want}
        assert shared == want
        assert got["pool_bytes"] == got["kv_bytes"] == 2 * 7 * 4 * 2 * 4 * 4
        assert got["pool_bytes"] == sum(t.numel() * t.element_size()
                                        for t in tcache.data.values())
        assert got["blocks_in_use_peak"] == 5 and got["kind"] == "paged"
        assert memz.watermarks()["kv:tiny"] == 5
        assert "kv pool tiny" in memz.render_text()
        assert memz.device_stats() == [] and memz.device_identity() is None
        pm = memz.post_mortem(reason="test")
        assert pm["kv"][0]["name"] == "tiny"
        assert pm["live_buffers"] == {"count": 0, "total_bytes": 0,
                                      "top": []}
        assert memz.capture_memory("prog", {"argument_bytes": 8,
                                            "output_bytes": 4,
                                            "temp_bytes": 16}) == {
            "argument_bytes": 8, "output_bytes": 4, "temp_bytes": 16,
            "generated_code_bytes": 0, "total_bytes": 28}
        small = tpaged.PagedKVCache(1, spec, max_len=16, block_size=4,
                                    num_blocks=1, name="small",
                                    device="cpu")
        slot = small.alloc()
        flight.enable()
        with pytest.raises(tpaged.KVPoolExhausted):
            for _ in range(8):
                small.append("k0", slot, np.ones((2, 4), np.float32))
                small.advance(slot)
        assert [e["event"] for e in flight.events()][-2:] == [
            "gen.kv_pool_pressure", "oom.kv_pool"]
        assert memz._is_resource_exhausted(
            torch.cuda.OutOfMemoryError, torch.cuda.OutOfMemoryError(
                "CUDA out of memory")) == "resource_exhausted"
    finally:
        flight.disable()
        flight.clear()
        for mz in (memz, jmemz):
            mz.reset()
            mz.disable()
    assert not torch.cuda.is_initialized()


def test_dense_cache_is_in_the_census():
    memz.reset()
    cache = serving.KVCache(2, {"h": ("state", (3, 5))}, max_len=8,
                            device="cpu", name="lm")
    cache.alloc()
    (ent,) = [e for e in memz.kv_census() if e["name"] == "lm"]
    assert ent["kind"] == "dense" and ent["slots_in_use"] == 1
    assert ent["pool_bytes"] == ent["state_bytes"] == 2 * 3 * 5 * 4
    memz.reset()


def test_profiler_host_events_and_the_device_window(tmp_path):
    profiler.set_config(filename=str(tmp_path / "profile.json"),
                        use_xplane=True, xplane_dir=str(tmp_path / "dev"))
    try:
        profiler.start()
        with profiler.Task("task"):
            torch.ones(64, 64) @ torch.ones(64, 64)
        with profiler.scope("scoped"):
            pass
        profiler.Counter("ctr").increment(3)
        profiler.stop()
        profiler.dump()
    finally:
        profiler.set_config(use_xplane=False)
    events = json.load(open(tmp_path / "profile.json"))["traceEvents"]
    assert {"task", "ctr", "start", "stop"} <= {e["name"] for e in events}
    assert json.loads(profiler.dumps(format="json"))["task"]["count"] == 1
    info = profiler.device_trace()
    assert info["kernel_launches"] == info["kernel_events"] == 0
    assert info["complete"] is True and os.path.exists(info["path"])
    with pytest.raises(RuntimeError, match="dist kvstore"):
        profiler.start(profile_process="server")
