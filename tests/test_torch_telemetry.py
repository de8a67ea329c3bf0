"""The PyTorch port's metrics registry and exporters against the JAX
package's, on the CPU.

- The same sequence of counter, gauge and histogram operations through both
  packages' registries gives byte-identical ``render_prometheus`` text and
  equal ``render_json`` (labels that need escaping, float and int values,
  default and custom bucket edges, exemplars).
- The periodic flusher writes the rendering to its file; the disabled path
  changes nothing; name and bucket collisions raise the same errors.
- Every instrument of the port's catalog is the JAX package's instrument of
  the same name, kind and bucket edges.
- The lockdep witness catches an ABBA order and a lock held across the rpc
  layer's blocking chokepoint, as the JAX package's does.
"""

import json
import threading
import time

import pytest

from incubator_mxnet_tpu.telemetry import catalog as jcat
from incubator_mxnet_tpu.telemetry import export as jexport
from incubator_mxnet_tpu.telemetry import metrics as jmet
from incubator_mxnet_tpu_torch import telemetry as ttel
from incubator_mxnet_tpu_torch.telemetry import catalog as tcat
from incubator_mxnet_tpu_torch.telemetry import export as texport
from incubator_mxnet_tpu_torch.telemetry import flight as tflight
from incubator_mxnet_tpu_torch.telemetry import lockdep as tlockdep
from incubator_mxnet_tpu_torch.telemetry import metrics as tmet
from incubator_mxnet_tpu_torch.telemetry import tracing as ttracing

PACKAGES = ((jmet, jexport), (tmet, texport))


class _Clock:
    """A fixed ``time`` for the exemplar timestamps."""

    @staticmethod
    def time():
        return 1234.5


@pytest.fixture
def fresh(monkeypatch):
    """Both registries empty, enabled, with a fixed exemplar clock; the
    catalogs' registrations come back afterwards."""
    was = [m.enabled() for m, _ in PACKAGES]
    for m, _ in PACKAGES:
        monkeypatch.setattr(m, "_registry", {})
        monkeypatch.setattr(m, "time", _Clock)
        m.enable()
    yield
    for (m, _), on in zip(PACKAGES, was):
        (m.enable if on else m.disable)()


def _drive(m):
    """One sequence of operations on a registry."""
    c = m.counter("t_requests_total", "Requests by model and status")
    c.inc(model="bert", status="ok")
    c.inc(3, model="bert", status="ok")
    c.inc(model='we"ird\\na\nme', status="shed")
    c.inc(2.5)
    g = m.gauge("t_slots", "Slots in use")
    g.set(4, model="gpt")
    g.inc(2, model="gpt")
    g.dec(1.5, model="gpt")
    g.set(0.125)
    h = m.histogram("t_seconds", "Latency")
    for v in (0.0001, 0.003, 0.2, 7.0, 100.0):
        h.observe(v, model="bert", exemplar="tid%d" % int(v * 1e4))
    e = m.histogram("t_occupancy", "Rows per batch",
                    buckets=(8, 1, 4, 2))
    for v in (1, 3, 3, 8, 9):
        e.observe(v, model="gpt")
    m.counter("t_empty_total", "")           # registered, never moved
    return c, g, h, e


def test_same_operations_render_byte_identical(fresh):
    for m, _ in PACKAGES:
        _drive(m)
    jtext, ttext = (x.render_prometheus() for _, x in PACKAGES)
    assert ttext.encode() == jtext.encode()
    assert 'model="we\\"ird\\\\na\\nme"' in ttext
    jjson, tjson = (x.render_json() for _, x in PACKAGES)
    assert json.loads(tjson) == json.loads(jjson)
    assert tjson == jjson
    snap = json.loads(tjson)["t_seconds"]["series"]["model=bert"]
    assert snap["exemplars"]["+Inf"] == {"trace_id": "tid1000000",
                                         "value": 100.0, "ts": 1234.5}


def test_quantiles_counts_and_sums_agree(fresh):
    (_c1, _g1, jh, je), (_c2, _g2, th, te) = (_drive(m)
                                              for m, _ in PACKAGES)
    for q in (0.0, 0.25, 0.5, 0.9, 0.99, 1.0):
        assert th.quantile(q, model="bert") == jh.quantile(q, model="bert")
        assert te.quantile(q, model="gpt") == je.quantile(q, model="gpt")
    assert th.count(model="bert") == 5 and th.sum(model="bert") == \
        jh.sum(model="bert")
    assert te.buckets == je.buckets == (1, 2, 4, 8)
    assert th.quantile(0.5, model="none") is None
    with pytest.raises(ValueError, match="quantile"):
        th.quantile(1.5)


@pytest.mark.parametrize("fmt", ["prom", "json"])
def test_flusher_writes_the_rendering(fresh, tmp_path, fmt):
    _drive(tmet)
    path = str(tmp_path / ("metrics." + fmt))
    texport.start_flusher(path, interval=0.02, fmt=fmt)
    try:
        deadline = time.monotonic() + 10
        while not (tmp_path / ("metrics." + fmt)).exists():
            assert time.monotonic() < deadline, "flusher never wrote"
            time.sleep(0.01)
    finally:
        texport.stop_flusher()
    want = texport.render_json() if fmt == "json" \
        else texport.render_prometheus()
    with open(path) as f:
        assert f.read() == want
    with pytest.raises(ValueError, match="MXTPU_METRICS_FORMAT"):
        texport.start_flusher(path, fmt="xml")


def test_disabled_path_changes_nothing(fresh):
    c, g, h, _e = _drive(tmet)
    before = texport.render_prometheus()
    tmet.disable()
    c.inc(model="bert", status="ok")
    g.set(99, model="gpt")
    h.observe(1.0, model="bert")
    assert texport.render_prometheus() == before
    assert ttracing.span("idle") is ttracing.NULL_SPAN
    tmet.enable()
    with pytest.raises(ValueError, match="delta must be >= 0"):
        c.inc(-1)


def test_registry_collisions_raise_as_in_the_jax_package(fresh):
    errors = []
    for m, _ in PACKAGES:
        m.counter("t_clash", "a counter")
        with pytest.raises(ValueError) as kind:
            m.gauge("t_clash")
        m.histogram("t_edges", buckets=(0.5, 2.0))
        assert m.histogram("t_edges", buckets=(2.0, 0.5)) is \
            m.histogram("t_edges")
        with pytest.raises(ValueError) as edges:
            m.histogram("t_edges", buckets=(0.1, 9.0))
        errors.append((str(kind.value), str(edges.value)))
    assert errors[0] == errors[1]
    assert "already registered as counter" in errors[1][0]


def test_catalog_instruments_are_the_jax_packages():
    ported = [inst for inst in tmet.instruments()
              if inst.name.startswith("mxtpu_")
              and inst.name != "mxtpu_costs_capture_errors_total"]
    # 56 of the serving plane, the trainer's three and the resilience
    # layer's five
    assert len(ported) == 64
    jax_reg = {inst.name: inst for inst in jmet.instruments()}
    for inst in ported:
        ref = jax_reg.get(inst.name)
        assert ref is not None, inst.name
        assert ref.kind == inst.kind, inst.name
        assert getattr(ref, "buckets", None) == getattr(inst, "buckets",
                                                        None), inst.name
    # the port's compile counters count CUDA graph captures, and say so
    assert "CUDA graph" in tcat.jit_compiles.help
    assert jcat.jit_compiles.name == tcat.jit_compiles.name


def test_compile_accounting_labels_captures_by_region():
    ttel.enable()
    try:
        before = tcat.compile_events("serving")
        other = tcat.compile_events("other")
        with tcat.compiling("serving"):
            tcat.note_compile(0.25)
            with tcat.compiling("warmup"):
                tcat.note_compile(0.5)
            tcat.note_compile(0.25)
        tcat.note_compile(1.0)
        assert tcat.compile_events("serving") == before + 2
        assert tcat.compile_events("other") == other + 1
        assert tcat.jit_compile_seconds.value(where="warmup") >= 0.5
    finally:
        ttel.disable()


# -------------------------------------------------------------- lockdep
@pytest.fixture
def witness():
    tmet.reset()
    tmet.enable()
    tflight.clear()
    tflight.enable()
    tlockdep.install()
    tlockdep.reset()
    try:
        yield
    finally:
        tlockdep.uninstall()
        tlockdep.reset()
        tflight.disable()
        tflight.clear()
        tmet.disable()


def _in_thread(fn):
    t = threading.Thread(target=fn)
    t.start()
    t.join(10)
    assert not t.is_alive()


def test_lockdep_witnesses_abba_and_blocking_under_a_lock(witness):
    import socket

    from incubator_mxnet_tpu_torch.kvstore import rpc
    a = threading.Lock()    # two construction sites: two lock classes
    b = threading.Lock()
    exempt = tlockdep.allow_blocking(threading.Lock())

    def ab():
        with a:
            with b:
                pass

    def ba():
        with b:
            with a:
                pass

    _in_thread(ab)
    _in_thread(ba)
    kinds = [v["kind"] for v in tlockdep.violations()]
    assert kinds == ["order"]
    left, right = socket.socketpair()
    try:
        with exempt:                    # the rpc connection lock's case
            rpc.send_msg(left, {"op": "x"})
        assert [v["kind"] for v in tlockdep.violations()] == ["order"]
        with a:                         # any other lock: reported
            rpc.send_msg(left, {"op": "y"})
        vs = tlockdep.violations()
        assert [v["kind"] for v in vs] == ["order", "blocking"]
        assert vs[1]["desc"] == "rpc.send"
        assert rpc.recv_msg(right)[0]["op"] == "x"
    finally:
        left.close()
        right.close()
    assert tcat.lockdep_violations.value(kind="blocking") == 1
    assert any(e["event"] == "lockdep.violation" for e in tflight.events())
    assert tlockdep.statusz_entry()["violations"] == 2
