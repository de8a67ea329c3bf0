"""chip_smoke.py's measurement helpers, on the CPU with fake clocks.

The script itself runs only on a CUDA card. What is checked here needs no
card: that a reading below a row's bound (which no card can beat: a
torch.profiler trace that lost device events) is retaken with CUDA events
and flagged if it stays below, with the lower of a row's two bounds where it
has a tensor-core bound beside the CUDA-core one; that the SDPA backend is
named from its kernels; and that every ``__global__`` kernel of the port's
CUDA sources maps to its kernel's class in ``--profile``'s device time
breakdown.
"""

import json
import math
import pathlib
import re
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402

# the bytes that take 1 ms at the card's memory rate: a 1 ms bound
ONE_MS_OF_BYTES = int(chip_smoke.HBM_BYTES_PER_S / 1e3)


def _fake_clocks(monkeypatch, profiler, events):
    """device_ms and call_ms that return, for each function, the time the
    test gives it; records which clock read which function."""
    seen = []

    def device_ms(torch_, fn, inputs, iters=20):
        seen.append(("profiler", fn.__name__))
        return profiler[fn.__name__], "profiler"

    def call_ms(torch_, fn, inputs, iters=50, warmup=5):
        seen.append(("events", fn.__name__))
        return events[fn.__name__]

    monkeypatch.setattr(chip_smoke, "device_ms", device_ms)
    monkeypatch.setattr(chip_smoke, "call_ms", call_ms)
    return seen


def kernel(x):
    return x


def plain(x):
    return x


def library(x):
    return x


def _measure(library_fn=library):
    return chip_smoke.measure(
        torch, "k", (4,), 0.0, 0.0, (torch.zeros(4),), kernel, plain,
        library_fn, ONE_MS_OF_BYTES, 0)


def test_measure_retakes_readings_below_the_bound_on_cuda_events(
        monkeypatch):
    seen = _fake_clocks(monkeypatch,
                        profiler=dict(kernel=1.5, plain=0.4, library=0.3),
                        events=dict(kernel=9.0, plain=2.0, library=0.6))
    row = _measure()
    assert row["bound_ms"] == pytest.approx(1.0)
    assert row["bound_by"] == "bytes"
    # the kernel read above its bound: the profiler's number stands
    assert (row["ms"], row["timed_by"]) == (1.5, "profiler")
    # the plain version read below: retaken on CUDA events, now above
    assert (row["plain_ms"], row["plain_timed_by"]) == (2.0, "events")
    # the library read below twice: kept, but flagged as no time
    assert (row["library_ms"], row["library_timed_by"]) == (0.6, "events")
    assert row["below_bound"] is True
    assert row["below_bound_columns"] == ["library_ms"]
    assert ("events", "kernel") not in seen
    assert ("events", "plain") in seen and ("events", "library") in seen


def test_measure_keeps_profiler_readings_at_or_above_the_bound(monkeypatch):
    seen = _fake_clocks(monkeypatch,
                        profiler=dict(kernel=1.0, plain=3.0),
                        events=dict(kernel=0.1, plain=0.1))
    row = _measure(library_fn=None)
    assert (row["ms"], row["timed_by"]) == (1.0, "profiler")
    assert (row["plain_ms"], row["plain_timed_by"]) == (3.0, "profiler")
    assert (row["library_ms"], row["library_timed_by"]) == (None, None)
    assert row["below_bound"] is False
    assert row["below_bound_columns"] == []
    assert all(clock == "profiler" for clock, _ in seen)


def test_measure_refuses_an_error_over_its_tolerance(monkeypatch):
    _fake_clocks(monkeypatch, profiler=dict(kernel=1.0, plain=1.0),
                 events=dict(kernel=1.0, plain=1.0))
    with pytest.raises(AssertionError, match="max error"):
        chip_smoke.measure(torch, "k", (4,), 1e-3, 1e-4,
                           (torch.zeros(4),), kernel, plain, None,
                           ONE_MS_OF_BYTES, 0)


def test_bound_check_flags_only_columns_below_the_bound():
    assert chip_smoke.bound_check(1.0, ms=1.0, plain_ms=None,
                                  library_ms=2.0) == dict(
        below_bound=False, below_bound_columns=[])
    assert chip_smoke.bound_check(1.0, ms=0.5, plain_ms=0.9,
                                  library_ms=2.0) == dict(
        below_bound=True, below_bound_columns=["ms", "plain_ms"])



def test_measure_with_a_tensor_core_bound_retakes_only_below_the_lower(
        monkeypatch):
    """A row whose work may run on the tensor cores (3xTF32 at a third of
    the TF32 rate) carries both bounds: bound_ms at the fp32 CUDA-core rate
    and tc_bound_ms at the tensor-core rate. A reading between the two is a
    time and stands; only one below the lower bound is retaken and
    flagged."""
    flops = 67e9                       # 1 ms at 67 TFLOP/s
    tc_ms = flops / chip_smoke.TF32X3_FLOPS_PER_S * 1e3
    # 0.1 ms of bytes: both bounds are set by the operations, and the
    # bytes are enough that two cold copies suffice
    bytes_moved = ONE_MS_OF_BYTES // 10
    assert chip_smoke.TF32X3_FLOPS_PER_S == pytest.approx(494.7e12 / 3)
    assert tc_ms == pytest.approx(3 * 67 / 494.7)       # 0.406 ms
    seen = _fake_clocks(monkeypatch,
                        profiler=dict(kernel=0.6, plain=0.2, library=0.3),
                        events=dict(kernel=9.0, plain=0.3, library=0.5))
    row = chip_smoke.measure(
        torch, "k", (4,), 0.0, 0.0, (torch.zeros(4),), kernel, plain,
        library, bytes_moved, flops,
        tc_peak_flops=chip_smoke.TF32X3_FLOPS_PER_S)
    assert row["bound_ms"] == pytest.approx(1.0)
    assert row["bound_by"] == "operations"
    assert row["tc_bound_ms"] == pytest.approx(tc_ms)
    # between the bounds: below the CUDA-core bound, above the tensor cores'
    assert (row["ms"], row["timed_by"]) == (0.6, "profiler")
    # below both: retaken, and the retake's 0.3 is still below
    assert (row["plain_ms"], row["plain_timed_by"]) == (0.3, "events")
    assert (row["library_ms"], row["library_timed_by"]) == (0.5, "events")
    assert row["below_bound_columns"] == ["plain_ms"]
    assert ("events", "kernel") not in seen


def test_measure_without_a_tensor_core_bound_has_no_tc_field(monkeypatch):
    _fake_clocks(monkeypatch, profiler=dict(kernel=2.0, plain=2.0),
                 events=dict(kernel=2.0, plain=2.0))
    row = _measure(library_fn=None)
    assert "tc_bound_ms" not in row


def test_pair_bound_of_the_flash_backward_at_the_training_shape():
    """The dense pair's five products at (96, 512, 64): 16.1 GFLOP, 0.24 ms
    on the fp32 CUDA cores and 97.6 us as 3xTF32 on the tensor cores."""
    BH, T, D = 96, 512, 64
    flops = 5 * 2 * BH * T * T * D
    pair_bytes = 8 * BH * T * D * 4 + BH * T * 4
    ms, by = chip_smoke.bound(pair_bytes, flops)
    tc, tc_by = chip_smoke.bound(pair_bytes, flops,
                                 chip_smoke.TF32X3_FLOPS_PER_S)
    assert (by, tc_by) == ("operations", "operations")
    assert ms == pytest.approx(0.2404, abs=1e-4)
    assert tc == pytest.approx(0.0976, abs=1e-4)


@pytest.mark.parametrize("names, backend", [
    (["fmha_cutlassB_f32_aligned_64x64_k64_sm80(AttentionBackwardKernel)"],
     "efficient (CUTLASS fmha)"),
    (["void pytorch_flash::flash_bwd_dq_dk_dv_loop_seqk_parallel_kernel"],
     "flash"),
    (["cudnn_generated_fort_native_sdpa_sm90_flash_bprop"], "cudnn"),
    (["ampere_sgemm_128x64_nn", "softmax_warp_backward"],
     "math (matmuls and softmax)")])
def test_sdpa_backend_is_named_from_its_kernels(names, backend):
    assert chip_smoke.sdpa_backend(names) == backend

# ------------------------------------------------------ profile classes
GLOBAL = re.compile(r"(?:template\s*<([^>]*)>\s*)?__global__\s+void\s+"
                    r"(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(")
# kernel classes of the port's hand kernels in --profile's breakdown
PORT_CLASSES = {"layer_norm", "softmax", "flash_attention_fwd",
                "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
                "trainer_adam", "sgd_mom (trainer or flat)", "adamw_flat",
                "adam_flat", "fused_bottleneck", "flash_decode",
                "int8_matmul", "noop", "flash_attention_fwd_bf16",
                "flash_attention_bwd_dq_bf16", "flash_attention_bwd_dkv_bf16"}


def _profiled_names(path):
    """The names a trace gives the file's kernels: each __global__'s name,
    and for a kernel templated on an update functor (`class Op`), one name
    per functor the file defines (a struct with a call operator), as the
    demangled instantiation spells it."""
    src = path.read_text()
    kernels = GLOBAL.findall(src)
    assert kernels, "no __global__ kernel found in %s" % path.name
    functors = re.findall(r"struct (\w+) \{[^}]*?operator\(\)", src)
    out = []
    for params, name in kernels:
        if "class Op" in params:
            assert functors
            out += ["%s<2, %s<F32>, F32>" % (name, f) for f in functors]
        else:
            out.append(name)
    return out


def _sources():
    return sorted((REPO / "incubator_mxnet_tpu_torch" / "csrc").glob("*.cu"))


def test_every_cuda_source_has_a_global_kernel_found_by_the_scan():
    found = {p.name: _profiled_names(p) for p in _sources()
             if "__global__" in p.read_text()}
    assert "int8_mm_tma_kernel" in found["int8_matmul.cu"]
    assert "fused_bottleneck_tc_kernel" in found["fused_bottleneck.cu"]
    assert "fused_bottleneck_f32_kernel" in found["fused_bottleneck.cu"]
    assert len(found["fused_optim.cu"]) >= 4


@pytest.mark.parametrize("path", [p for p in _sources()
                                  if "__global__" in p.read_text()],
                         ids=lambda p: p.name)
def test_kernel_class_maps_every_global_kernel_to_its_kernel(path):
    for name in _profiled_names(path):
        cls = chip_smoke._kernel_class("void (anonymous namespace)::%s("
                                       "int, float*)" % name)
        assert cls in PORT_CLASSES, (path.name, name, cls)


def test_kernel_class_tells_library_kernels_apart():
    assert chip_smoke._kernel_class(
        "sm90_xmma_gemm_s8s8_s32_tn_n_tilesize128x256x128") == "matmul"
    assert chip_smoke._kernel_class(
        "cudnn::fprop_implicit_gemm_bf16") == "conv"
    assert chip_smoke._kernel_class("Memcpy DtoD") == "copy"
    assert chip_smoke._kernel_class("elementwise_kernel") == "other"


# ------------------------------------------------ the flash forward rows
def test_flash_forward_bounds_at_the_serving_shape():
    """(8 * 12, 512, 64): ragged with key lengths 512, 300, 0, 511, 64, 1,
    450 and 129, 3.09 GFLOP over the live keys, 46.2 us on the fp32 CUDA
    cores and 18.8 us as 3xTF32 on the tensor cores; dense, 6.44 GFLOP,
    96.2 and 39.1 us. Operations bound both: the bytes take 15 us."""
    from incubator_mxnet_tpu_torch.telemetry.costs import flash_forward_cost
    tc = chip_smoke.TF32X3_FLOPS_PER_S
    nbytes, live, dense = flash_forward_cost(
        12, 512, 64, [512, 300, 0, 511, 64, 1, 450, 129])
    assert live == pytest.approx(3.094e9, rel=1e-3)
    assert chip_smoke.bound(nbytes, live) == (pytest.approx(0.0462,
                                                            abs=1e-4),
                                              "operations")
    assert chip_smoke.bound(nbytes, live, tc)[0] == pytest.approx(
        0.0188, abs=1e-4)
    nbytes, live, dense = flash_forward_cost(12, 512, 64, [512] * 8)
    assert live == dense == pytest.approx(6.442e9, rel=1e-3)
    assert chip_smoke.bound(nbytes, dense)[0] == pytest.approx(0.0962,
                                                               abs=1e-4)
    assert chip_smoke.bound(nbytes, dense, tc)[0] == pytest.approx(
        0.0391, abs=1e-4)
    assert nbytes / chip_smoke.HBM_BYTES_PER_S == pytest.approx(1.5e-5,
                                                                rel=0.05)


def test_flash_forward_rows_on_the_cpu_dense_then_ragged(monkeypatch):
    """The rows' drive at a small shape on the CPU (the plain versions,
    fake clocks): a dense row, then a ragged one with a fully masked
    sample; both with the tensor-core bound beside the CUDA-core one, the
    live-key share, and the SDPA backend named from the kernel names a
    trace of its call gives (faked here: the CPU has no device trace)."""
    monkeypatch.setattr(chip_smoke, "device_ms",
                        lambda torch_, fn, inputs, iters=20: (1.0,
                                                              "profiler"))
    monkeypatch.setattr(chip_smoke, "device_kernel_names",
                        lambda torch_, fn, inputs: [
                            "fmha_cutlassF_f32_aligned_64x64_rf_sm80"])
    gen = torch.Generator().manual_seed(0)
    rows = chip_smoke.flash_forward_rows(
        torch, torch.device("cpu"),
        lambda *shape: torch.randn(*shape, generator=gen),
        B=2, H=2, T=100, D=32, lengths=(100, 0))
    assert [r["name"] for r in rows] == ["flash_attention_fwd"] * 2
    dense, ragged = rows
    assert dense["lengths"] == [100, 100] and ragged["lengths"] == [100, 0]
    assert (dense["live_key_share"], ragged["live_key_share"]) == (1.0, 0.5)
    for r in rows:
        assert r["max_abs_err"] == 0.0     # the CPU runs the plain version
        assert r["tc_bound_ms"] <= r["bound_ms"]
        assert r["library_backend"] == "efficient (CUTLASS fmha)"
        assert r["ms"] == r["plain_ms"] == r["library_ms"] == 1.0
    # half the keys live: the CUDA-core work halves and the bytes bind
    assert (dense["bound_by"], ragged["bound_by"]) == ("operations", "bytes")


# ------------------------------------- LayerNorm and int8 decode rows
def _randn_cpu(seed=0):
    gen = torch.Generator().manual_seed(seed)
    return lambda *shape: torch.randn(*shape, generator=gen)


def test_layer_norm_rows_name_shape_route_floor_and_gap(monkeypatch):
    """The LayerNorm rows at the main paths' row counts (a decode grid
    step's 8, a prefill chunk's 32, full batches of the two serving
    buckets), on the CPU with fake clocks: each names the route the wrapper
    picks for its tensors (CPU allocations are 64-byte aligned, so the
    16-byte warp route), and carries the launch floor and its gap over
    max(bound, floor)."""
    monkeypatch.setattr(chip_smoke, "device_ms",
                        lambda torch_, fn, inputs, iters=20: (0.01,
                                                              "profiler"))
    rows = chip_smoke.layer_norm_rows(torch, torch.device("cpu"),
                                      _randn_cpu(), floor_ms=0.002)
    assert [r["shape"] for r in rows] == [[8, 768], [32, 768], [1024, 768],
                                          [4096, 768]]
    assert [r["kernel_route"] for r in rows] == ["warp"] * 4
    for r in rows:
        assert r["name"] == "layer_norm" and r["max_abs_err"] == 0.0
        assert r["tolerance"] == 1e-5 and r["bound_by"] == "bytes"
        R, C = r["shape"]
        assert r["bound_ms"] == pytest.approx(
            (2 * R * C + 2 * C) * 4 / chip_smoke.HBM_BYTES_PER_S * 1e3)
        assert r["floor_ms"] == 0.002
        assert r["gap_ms"] == pytest.approx(
            0.01 - max(r["bound_ms"], 0.002))
    # a decode step's LayerNorm: its bytes are far below the floor
    assert rows[0]["bound_ms"] < 0.0001 and rows[-1]["bound_ms"] > 0.002


def test_int8_decode_row_times_int_mm_on_a_padded_a(monkeypatch):
    """The int8 decode row on the CPU (the plain version, fake clocks) at a
    small decode-like shape: exact, route and floor named, and its library
    column torch._int_mm on A zero-padded to 24 rows, labelled so; a row
    above 16 rows takes no padding and no floor."""
    monkeypatch.setattr(chip_smoke, "device_ms",
                        lambda torch_, fn, inputs, iters=20: (0.003,
                                                              "profiler"))
    seen = []
    real = torch._int_mm
    monkeypatch.setattr(torch, "_int_mm",
                        lambda a, b: seen.append(tuple(a.shape)) or real(a, b))
    rows = chip_smoke.int8_matmul_rows(
        torch, torch.device("cpu"), floor_ms=0.002,
        cases=(("decode", "small", (8, 64, 40, 50)),
               ("wide", "tma", (32, 64, 40, None))))
    dec, wide = rows
    assert dec["shape"] == [8, 64, 40] and dec["case"] == "decode"
    assert dec["kernel_route"] == "small" and dec["max_abs_err"] == 0.0
    assert dec["library_rows"] == chip_smoke.INT_MM_MIN_ROWS == 24
    assert "zero-padded to 24 rows" in dec["library_note"]
    assert dec["floor_ms"] == 0.002
    assert dec["gap_ms"] == pytest.approx(0.003 - max(dec["bound_ms"],
                                                      0.002))
    assert (24, 64) in seen
    assert wide["library_rows"] == 32 and "floor_ms" not in wide
    assert "padded" not in wide["library_note"]


def test_trace_ms_counts_launches_a_call_and_refuses_a_lossy_trace():
    """A trace's time a call: each name's mean duration times its launches
    a call (a name seen less than every other call, a one-off, counts its
    share); a trace that kept fewer than half the calls' events of the
    name with the most device time is refused (None: device_ms retakes it
    with CUDA events), as is an empty one."""
    iters = 20
    assert chip_smoke.trace_ms({"k": (20, 20 * 400.0)}, iters) == 0.4
    assert chip_smoke.trace_ms({"k": (40, 40 * 100.0),
                                "one_off": (1, 50.0)}, iters) == \
        pytest.approx((2 * 100.0 + 50.0 / 20) / 1e3)
    assert chip_smoke.trace_ms({"k": (7, 7 * 450.0)}, iters) is None
    assert chip_smoke.trace_ms({"k": (7, 7 * 450.0), "copy": (20, 200.0)},
                               iters) is None
    assert chip_smoke.trace_ms({}, iters) is None


# --------------------------------------------------- the bottleneck rows
SMALL_BLOCK = dict(B=2, H=9, W=7, C=16, M=8)


def test_bottleneck_rows_fp32_carries_the_3xtf32_bound(monkeypatch):
    """The bottleneck rows on the CPU (the plain version, fake clocks) at a
    small shape: fp32 first, then fp16 (its own row,
    `fused_bottleneck_f16`), then bf16 (the `fused_bottleneck` row the
    kernels line keeps); each names its route, the 16-bit rows are held
    at 2 steps of their mantissa and bounded at the 16-bit peak with
    2-byte elements, and only the fp32 row carries the bound of its work
    at the 3xTF32 tensor-core rate beside the CUDA-core one."""
    monkeypatch.setattr(chip_smoke, "device_ms",
                        lambda torch_, fn, inputs, iters=20: (1.0,
                                                              "profiler"))
    rows = chip_smoke.bottleneck_rows(torch, torch.device("cpu"),
                                      shape=SMALL_BLOCK)
    f32, f16, bf16 = rows
    assert [r["dtype"] for r in rows] == ["float32", "float16", "bfloat16"]
    assert [r["kernel_route"] for r in rows] == ["fp32", "fp16", "bf16"]
    assert [r["name"] for r in rows] == [
        "fused_bottleneck", "fused_bottleneck_f16", "fused_bottleneck"]
    assert f32["tolerance"] == 1e-4 and f32["max_abs_err"] == 0.0
    for row, rel in ((f16, 2 * 2 ** -11), (bf16, 2 * 2 ** -8)):
        assert row["tolerance"] == rel * row["ref_max_abs"]
        nbytes, flops = chip_smoke.block_cost(elem_bytes=2, **SMALL_BLOCK)
        assert row["bound_ms"] == chip_smoke.bound(
            nbytes, flops, chip_smoke.BF16_FLOPS_PER_S)[0]
    nbytes, flops = chip_smoke.block_cost(elem_bytes=4, **SMALL_BLOCK)
    assert f32["bound_ms"] == chip_smoke.bound(nbytes, flops)[0]
    assert f32["tc_bound_ms"] == chip_smoke.bound(
        nbytes, flops, chip_smoke.TF32X3_FLOPS_PER_S)[0]
    assert f32["tc_bound_ms"] <= f32["bound_ms"]
    assert "tc_bound_ms" not in bf16


def test_bottleneck_phase_checks_a_bf16_and_an_fp32_stack(capsys):
    """The bottleneck drive on the CPU at a small shape: one stack in bf16,
    one in fp32 and one in fp16 from the same draws, each checked against
    the plain stack (fp32 at 1e-4, fp16 at 2 * 2**-11 of its max) and on
    its route, and logged on its own line with its route; the launch counts
    come back by path (launch counts and times only on the card)."""
    counts = chip_smoke.bottleneck_phase(torch, torch.device("cpu"),
                                         shape=SMALL_BLOCK, K=3)
    assert sorted(counts) == ["bottleneck", "bottleneck_fp16",
                              "bottleneck_fp32"]
    lines = [json.loads(line.split(": ", 1)[1])
             for line in capsys.readouterr().out.splitlines()
             if line.startswith("bottleneck: ")]
    assert [(r["dtype"], r["kernel_route"]) for r in lines] == [
        ("bfloat16", "bf16"), ("float32", "fp32"), ("float16", "fp16")]
    assert lines[1]["tolerance"] == 1e-4
    assert 0 < lines[2]["tolerance"] < lines[0]["tolerance"] / 4
    assert all(r["K"] == 3 and r["max_abs_err"] == 0.0 for r in lines)


def test_bottleneck_phase_fails_on_a_wrong_route_or_a_wide_error(
        monkeypatch):
    """A stack whose route is not its dtype's, or whose error passes its
    tolerance, fails the phase."""
    cpu = torch.device("cpu")
    monkeypatch.setattr(chip_smoke, "BLOCK_ROUTE",
                        dict(chip_smoke.BLOCK_ROUTE, float16="bf16"))
    with pytest.raises(AssertionError, match="float16 stack of 2: route "
                       "fp16, expected bf16"):
        chip_smoke.bottleneck_phase(torch, cpu, shape=SMALL_BLOCK, K=2)
    monkeypatch.undo()
    monkeypatch.setattr(chip_smoke, "block_tolerance",
                        lambda torch_, ref: -1.0)
    with pytest.raises(AssertionError, match="max error 0.0 > -1"):
        chip_smoke.bottleneck_phase(torch, cpu, shape=SMALL_BLOCK, K=2)


def test_every_kernels_entry_reads_a_launch_counter():
    """Each entry of the kernels line reads its launches from a wrapper's
    count: its own, or (an fp16 bottleneck, counted on fused_bottleneck)
    the wrapper KERNEL_COUNTED_ON names, over the paths that launch it; the
    rtc kernel's launches are the rtc phase's own count."""
    from incubator_mxnet_tpu_torch.ops.kernels import WRAPPERS
    for name in chip_smoke.KERNEL_META:
        counter, paths = chip_smoke.KERNEL_COUNTED_ON.get(name, (name, None))
        assert counter in WRAPPERS or name == "rtc_axpy", name
        if paths is not None:
            assert name not in WRAPPERS and paths
    for name in ("sgd_mom_flat_f16", "adam_flat_f16", "adamw_flat_f16",
                 "fused_bottleneck_f16"):
        assert name in chip_smoke.KERNEL_META


# ------------------------------------------------ graphs and the deploy phase
class _FakeServed:
    """A served model whose output depends on whether its graphs are on."""

    def __init__(self, drift=0.0):
        self.graphs = True
        self.drift = drift
        self.programs, self.decode_programs = {}, {}

    def call(self):
        rows = torch.arange(12.0).reshape(3, 4) + 1
        if self.graphs:
            rows = rows * (1 + self.drift)
        return {"pooled": rows.numpy(), "seq": rows.numpy()[None]}


def test_replay_vs_eager_holds_each_row_and_restores_the_graphs():
    served = _FakeServed()
    assert chip_smoke.replay_vs_eager("same", served, served.call) == 0.0
    assert served.graphs is True
    served = _FakeServed(drift=1e-3)
    with pytest.raises(AssertionError, match="replayed graph"):
        chip_smoke.replay_vs_eager("drift", served, served.call)
    assert served.graphs is True
    # relative to each row's own max: a row of small values is not hidden
    # behind a large one
    got = [[1.0, 2.0], [1e-3, 2e-3 * (1 + 1e-5)]]
    assert chip_smoke.row_rel_diff(got, [[1.0, 2.0], [1e-3, 2e-3]]) \
        == pytest.approx(1e-5)


def test_no_recapture_compares_each_program_graph():
    class Prog:
        def __init__(self):
            self.graph = object()

    served = _FakeServed()
    served.programs = {(1, 128, ("token_ids",)): Prog()}
    served.decode_programs = {8: Prog(), 4: None}
    before = chip_smoke.program_ids(served)
    assert len(before) == 2
    served.programs[(2, 128, ("token_ids",))] = Prog()     # a new shape
    chip_smoke.check_no_recapture("m", before, chip_smoke.program_ids(served))
    served.decode_programs[8] = Prog()                      # captured again
    with pytest.raises(AssertionError, match="captured again"):
        chip_smoke.check_no_recapture("m", before,
                                      chip_smoke.program_ids(served))


def test_run_deploy_storm_deploys_partway_on_the_cpu(tmp_path):
    """The deploy phase's client side against an in-process CPU server:
    every request comes back, the deploy goes out after ``deploy_after``
    replies, and each client makes at least ``rounds`` passes and one more
    that began after the deploy's reply."""
    import numpy as np
    from incubator_mxnet_tpu_torch.models.bert import BERTModel
    from incubator_mxnet_tpu_torch.serving import (ModelServer,
                                                   export_for_serving)
    cfg = dict(vocab_size=50, units=16, hidden_size=32, num_layers=1,
               num_heads=2, max_length=32)
    d = str(tmp_path)
    for g in range(2):
        export_for_serving(d, "bert_encoder", cfg,
                           BERTModel(device="cpu", dropout=0.0, seed=g, **cfg))
    rs = np.random.RandomState(0)
    reqs = [{"token_ids": rs.randint(0, 50, (1, n)).astype(np.int32)}
            for n in (3, 9, 16, 5)]
    srv = ModelServer(device="cpu").load("bert", directory=d, generation=0,
                                         buckets=(16,), max_wait_ms=0).start()
    try:
        records, deployed = chip_smoke.run_deploy_storm(
            tuple(srv.addr), "bert", reqs, 2, 3, 4, 1)
        assert srv.generations()["bert"]["generation"] == 1
    finally:
        srv.stop()
    assert deployed["reply"]["generation"] == 1
    assert deployed["start"] <= deployed["end"]
    for i in range(4):
        assert sum(1 for r in records if r[0] == i) >= 3
        assert any(r[0] == i and r[1] > deployed["end"] for r in records)
    assert len([r for r in records if r[2] < deployed["start"]]) >= 4
    assert all(r[3]["pooled"].shape == (1, 16) for r in records)


# ----------------------------------------------------- the telemetry phase
def test_prom_samples_read_back_what_the_registry_rendered(monkeypatch):
    """The telemetry phase reads serve.metrics as Prometheus text: every
    series of a rendering comes back with its labels (escapes undone) and
    its value, histograms as their _bucket / _sum / _count series."""
    from incubator_mxnet_tpu_torch.telemetry import export, metrics
    monkeypatch.setattr(metrics, "_registry", {})
    was = metrics.enabled()
    metrics.enable()
    try:
        c = metrics.counter("t_total", "help")
        c.inc(3, model='a"b\\c\nd', status="ok")
        c.inc(2.5)
        h = metrics.histogram("t_seconds", buckets=(0.1, 1.0))
        h.observe(0.05, model="m")
        h.observe(3.0, model="m")
        metrics.gauge("t_flops").set(1.5e12, name="encode/r8xb128/x+y")
        samples = chip_smoke.prom_samples(export.render_prometheus())
    finally:
        (metrics.enable if was else metrics.disable)()
    assert chip_smoke.prom_value(samples, "t_total", model='a"b\\c\nd',
                                 status="ok") == 3.0
    assert chip_smoke.prom_value(samples, "t_total") == 2.5
    assert chip_smoke.prom_value(samples, "t_seconds_count", model="m") == 2
    assert chip_smoke.prom_value(samples, "t_seconds_sum", model="m") == 3.05
    assert chip_smoke.prom_value(samples, "t_seconds_bucket", model="m",
                                 le="0.1") == 1
    assert chip_smoke.prom_value(samples, "t_seconds_bucket", model="m",
                                 le="+Inf") == 2
    assert chip_smoke.prom_value(samples, "t_absent") == 0.0
    assert chip_smoke.prom_series(samples, "t_flops") == {
        "encode/r8xb128/x+y": 1.5e12}
    with pytest.raises(AssertionError, match="Prometheus"):
        chip_smoke.prom_samples("not a sample line")


def _timeline(prompt_len, steps, drop=None):
    """A decode request's stitched timeline: the client root, the server's
    rpc span, queue, join, prefill (with a prompt prefix) and one step a
    token, 10 ms apart."""
    from incubator_mxnet_tpu_torch.telemetry import tracing
    spans = [dict(name="client.decode", span_id="c", ts_us=0.0,
                  dur_us=1e6),
             dict(name="rpc.serve.decode", span_id="r", parent_id="c",
                  ts_us=1e3, dur_us=9e5),
             dict(name="serve.queue", span_id="q", parent_id="r",
                  ts_us=2e3, dur_us=3e3),
             dict(name="serve.join", span_id="j", parent_id="r",
                  ts_us=5e3, dur_us=1e3)]
    if prompt_len > 1:
        spans.append(dict(name="decode.prefill", span_id="p",
                          parent_id="r", ts_us=5e3, dur_us=5e2))
    spans += [dict(name="decode.step", span_id="s%d" % k, parent_id="r",
                   ts_us=1e4 * (k + 1), dur_us=2e3) for k in range(steps)]
    spans = [dict(sp, trace_id="t") for sp in spans if sp["name"] != drop]
    return tracing.build_timeline(spans, trace_id="t")


def test_journey_gives_ttft_and_tpot_from_the_spans_alone():
    ttft, gaps = chip_smoke.journey(_timeline(5, 4), 5, 4)
    assert ttft == pytest.approx((1e4 + 2e3 - 2e3) / 1e6)
    assert gaps == pytest.approx([0.01] * 3)
    ttft1, _ = chip_smoke.journey(_timeline(1, 2), 1, 2)   # no prefix
    assert ttft1 == pytest.approx(0.01)


@pytest.mark.parametrize("drop,steps,msg", [
    (None, 3, "spans"),                     # a step short
    ("serve.join", 4, "spans"),
    ("decode.prefill", 4, "spans"),
    ("client.decode", 4, "roots"),          # the server's half alone
])
def test_journey_refuses_a_broken_tree(drop, steps, msg):
    with pytest.raises(AssertionError, match=msg):
        chip_smoke.journey(_timeline(5, steps, drop), 5, 4)


def test_analytic_counts_match_the_counted_programs_on_the_cpu():
    """The phase's analytic references: BERT's products equal what
    telemetry.costs counts on the plain path, and the gpt family's pool
    bytes equal a paged cache's tensors."""
    import numpy as np
    from incubator_mxnet_tpu_torch.generate.family import gpt_cache_spec
    from incubator_mxnet_tpu_torch.generate.paged_kv import PagedKVCache
    from incubator_mxnet_tpu_torch.models.bert import BERTModel
    from incubator_mxnet_tpu_torch.models.gpt import gpt_config
    from incubator_mxnet_tpu_torch.telemetry import costs
    cfg = dict(vocab_size=50, units=32, hidden_size=64, num_layers=2,
               num_heads=2, max_length=64)
    model = BERTModel(device="cpu", dropout=0.0, **cfg)
    ids = torch.from_numpy(np.ones((2, 24), np.int64))
    with torch.inference_mode():
        _out, cost = costs.count(lambda i: model(i), ids)
    assert cost["flops"] == chip_smoke.bert_encode_flops(2, 24, 32, 64, 2)
    gcfg = dict(vocab_size=50, units=48, num_layers=3, num_heads=3,
                max_len=64)
    cache = PagedKVCache(3, gpt_cache_spec(gpt_config(gcfg)), max_len=40,
                         block_size=16, device="cpu")
    assert sum(t.numel() * t.element_size() for t in cache.data.values()) \
        == chip_smoke.gpt_pool_bytes(gcfg, 3, 40, 16)


def test_check_compiles_allows_only_the_captures_it_counted():
    before = {"graphs": {"captured": 4}}
    chip_smoke.check_compiles("gpt", [9.0, 9.0], before, before)
    chip_smoke.check_compiles("bert", [9.0, 11.0], before,
                              {"graphs": {"captured": 6}})
    with pytest.raises(AssertionError, match="moved by 1"):
        chip_smoke.check_compiles("gpt", [9.0, 10.0], before, before)


# ------------------------------------------------------------- bf16 phase
@pytest.mark.parametrize("name,cls", [
    ("void (anonymous namespace)::ln_warp_kernel<__nv_bfloat16, 8, 3>("
     "__nv_bfloat16 const*)", "layer_norm_bf16"),
    ("void (anonymous namespace)::ln_warp_kernel<float, 4, 6>(float const*)",
     "layer_norm"),
    ("void (anonymous namespace)::softmax_warp_kernel<__nv_bfloat16, 4>("
     "__nv_bfloat16 const*)", "softmax_bf16"),
    ("void (anonymous namespace)::flash_fwd_bf16_kernel<64>(__nv_bfloat16 "
     "const*)", "flash_attention_fwd_bf16"),
    ("void (anonymous namespace)::flash_bwd_dkv_kernel<64, true>(float "
     "const*)", "flash_attention_bwd_dkv"),
    ("void (anonymous namespace)::flash_bwd_dkv_bf16_kernel<64>("
     "__nv_bfloat16 const*)", "flash_attention_bwd_dkv_bf16")])
def test_kernel_class_gives_the_bf16_flavours_classes_of_their_own(name,
                                                                   cls):
    assert chip_smoke._kernel_class(name) == cls


@pytest.mark.parametrize("name,cls", [
    ("void (anonymous namespace)::ln_warp_kernel<__half, 8, 3>(__half "
     "const*)", "layer_norm_f16"),
    ("void (anonymous namespace)::softmax_warp_kernel<__half, 4>(__half "
     "const*)", "softmax_f16"),
    ("void (anonymous namespace)::flash_fwd_b16_kernel<__half, 64>(__half "
     "const*)", "flash_attention_fwd_f16"),
    ("void (anonymous namespace)::flash_bwd_dq_b16_kernel<__half, 64>("
     "__half const*)", "flash_attention_bwd_dq_f16"),
    ("void (anonymous namespace)::flash_bwd_dkv_b16_kernel<__half, 64, "
     "false>(__half const*)", "flash_attention_bwd_dkv_f16"),
    ("void (anonymous namespace)::flash_fwd_b16_kernel<__nv_bfloat16, 64>("
     "__nv_bfloat16 const*)", "flash_attention_fwd_bf16"),
    ("void (anonymous namespace)::flash_bwd_dkv_b16_kernel<__nv_bfloat16, "
     "64, true>(__nv_bfloat16 const*)", "flash_attention_bwd_dkv_bf16"),
    ("void (anonymous namespace)::flash_decode_kernel<64, 1, __half, "
     "float>(__half const*)", "flash_decode_f16"),
    ("void (anonymous namespace)::flash_decode_kernel<64, 32, "
     "__nv_bfloat16, __nv_bfloat16>(__nv_bfloat16 const*)",
     "flash_decode_bf16"),
    ("void (anonymous namespace)::flash_decode_kernel<64, 8, float, "
     "float>(float const*)", "flash_decode"),
    # the 16-bit backward on wgmma and TMA: its maps come first in the
    # argument list, its element type in the template arguments
    ("void (anonymous namespace)::flash_bwd_dq_wg_kernel<__nv_bfloat16, "
     "64>(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
     "__nv_bfloat16 const*, __nv_bfloat16 const*, float const*)",
     "flash_attention_bwd_dq_bf16"),
    ("void (anonymous namespace)::flash_bwd_dq_wg_kernel<__half, 128>("
     "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
     "__half const*, __half const*, float const*)",
     "flash_attention_bwd_dq_f16"),
    ("void (anonymous namespace)::flash_bwd_dkv_wg_kernel<__nv_bfloat16, "
     "64, false>(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
     "CUtensorMap_st, float const*, float const*, float const*)",
     "flash_attention_bwd_dkv_bf16"),
    ("void (anonymous namespace)::flash_bwd_dkv_wg_kernel<__nv_bfloat16, "
     "64, true>(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
     "CUtensorMap_st, float const*, float const*, float const*)",
     "flash_attention_bwd_dkv_bf16"),
    ("void (anonymous namespace)::flash_bwd_dkv_wg_kernel<__half, 32, "
     "false>(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
     "CUtensorMap_st, float const*, float const*, float const*)",
     "flash_attention_bwd_dkv_f16"),
    ("void (anonymous namespace)::flash_bwd_dkv_wg_kernel<__half, 64, "
     "true>(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
     "CUtensorMap_st, float const*, float const*, float const*)",
     "flash_attention_bwd_dkv_f16")])
def test_kernel_class_gives_the_fp16_flavours_classes_of_their_own(name,
                                                                   cls):
    """The 16-bit flash kernels are one template over the element type:
    the profiler's demangled name carries the type, which picks the
    class."""
    assert chip_smoke._kernel_class(name) == cls


# the 16-bit forward on wgmma and TMA: its four maps first, its element type
# in the template arguments
@pytest.mark.parametrize("name,cls", [
    ("void (anonymous namespace)::flash_fwd_wg_kernel<__nv_bfloat16, 64>("
     "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
     "float const*, float*, int, int, float, int)",
     "flash_attention_fwd_bf16"),
    ("void (anonymous namespace)::flash_fwd_wg_kernel<__half, 64>("
     "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
     "float const*, float*, int, int, float, int)",
     "flash_attention_fwd_f16"),
    ("void (anonymous namespace)::flash_fwd_wg_kernel<__half, 128>("
     "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
     "float const*, float*, int, int, float, int)",
     "flash_attention_fwd_f16"),
    ("void (anonymous namespace)::flash_fwd_wg_kernel<__nv_bfloat16, 32>("
     "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
     "float const*, float*, int, int, float, int)",
     "flash_attention_fwd_bf16"),
    ("void (anonymous namespace)::flash_fwd_kernel<64>(float const*, "
     "float const*, float const*, float const*, float*, float*, int, "
     "float, int)", "flash_attention_fwd")])
def test_kernel_class_names_the_wgmma_forward_by_its_element_type(name, cls):
    assert chip_smoke._kernel_class(name) == cls


@pytest.mark.parametrize("name,cls", [
    ("void (anonymous namespace)::softmax_vec_kernel<__nv_bfloat16, 16, 1>("
     "__nv_bfloat16 const*, __nv_bfloat16*, int, int)", "softmax_bf16"),
    ("void (anonymous namespace)::softmax_vec_kernel<__half, 32, 4>(__half "
     "const*, __half*, int, int)", "softmax_f16"),
    ("void (anonymous namespace)::softmax_block_kernel<__half>(__half "
     "const*, __half*, int)", "softmax_f16"),
    ("void (anonymous namespace)::softmax_warp_kernel<float, 4>(float "
     "const*, float*, int, int)", "softmax")])
def test_kernel_class_names_each_softmax_route_by_its_element_type(name,
                                                                   cls):
    assert chip_smoke._kernel_class(name) == cls


def test_softmax_routes_phase_holds_each_route_on_the_cpu():
    """The phase's drive on the CPU (the plain version): each case takes
    the route it names from its addresses and row length, and the checks
    (NaN row, -inf positions, each element's limit) pass with 0 error."""
    out = chip_smoke.softmax_routes_phase(torch, torch.device("cpu"),
                                          rows=8)
    assert sorted(out) == ["bfloat16", "float16"]
    for cases in out.values():
        assert {n: r for n, (r, _e, _s) in cases.items()} == {
            "scalar": "scalar", "long": "long", "vec": "vec",
            "view": "scalar", "vec_small": "vec", "vec_tail": "vec"}
        assert all(e == 0.0 for _r, e, _s in cases.values())


def test_softmax_routes_phase_fails_on_a_wrong_route(monkeypatch):
    from incubator_mxnet_tpu_torch.ops.kernels import fused_norm
    monkeypatch.setattr(fused_norm, "_softmax_route",
                        lambda C, x, y, elem_bytes: "scalar")
    with pytest.raises(AssertionError, match="route scalar, want long"):
        chip_smoke.softmax_routes_phase(torch, torch.device("cpu"), rows=8)


def test_exp_floor_counts_one_ex2_a_live_score(monkeypatch):
    """The forward rows' exp floor: the live scores' ex2 at 16 a clock on
    each SM at its highest clock (nvidia-smi's clocks.max.sm); none off the
    card. (96, 512, 512) scores on 132 SMs at 1980 MHz: 6.02 us."""
    assert chip_smoke.exp_floor(torch, torch.device("cpu"), 10) is None

    class Props:
        multi_processor_count = 132

    class Run:
        stdout = "1980\n"
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: Props())
    monkeypatch.setattr(chip_smoke.subprocess, "run", lambda *a, **k: Run())
    got = chip_smoke.exp_floor(torch, torch.device("cuda", 0),
                               96 * 512 * 512)
    assert got["sms"] == 132 and got["sm_clock_mhz"] == 1980.0
    assert got["ms"] == pytest.approx(96 * 512 * 512 / (16 * 132 * 1.98e9)
                                      * 1e3)
    assert got["ms"] == pytest.approx(6.018e-3, rel=1e-3)


def test_fp16_forward_rows_hold_an_inf_in_v_to_its_head(monkeypatch,
                                                         one_torch_thread):
    """The fp16 forward rows plant an inf in one head's V: that head's O
    must be non-finite and every other head's bits unchanged (the row says
    so); a forward that let the inf reach another head fails the row."""
    import importlib
    fa = importlib.import_module(
        "incubator_mxnet_tpu_torch.ops.kernels.flash_attention")
    monkeypatch.setattr(chip_smoke, "device_ms",
                        lambda torch_, fn, inputs, iters=20: (1.0,
                                                              "profiler"))
    monkeypatch.setattr(chip_smoke, "device_kernel_names",
                        lambda torch_, fn, inputs: ["flash_fwd_kernel"])
    monkeypatch.setattr(chip_smoke, "cold_copies",
                        lambda torch_, inputs, nbytes: [inputs])
    cpu = torch.device("cpu")
    rows = chip_smoke.half_flash_rows(torch, cpu, _randn_cpu(3), "float16",
                                      B=1, H=3, T=40, D=32, lengths=(40,))
    fwd = [r for r in rows if r["name"] == "flash_attention_fwd_f16"]
    assert fwd and all(r["inf_in_v_stays_in_its_head"] for r in fwd)
    assert all(r["exp_floor"] is None and r.get("waves") is None
               for r in fwd)
    plain = fa.flash_attention_reference

    def leaky(q, k, v, bias=None, scale=1.0, causal=False):
        out, lse = plain(q, k, v, bias, scale, causal)
        if not bool(torch.isfinite(v).all()):
            out = out.clone()
            out[0, 0] = float("inf")      # another head than the planted one
        return out, lse
    monkeypatch.setattr(fa, "flash_attention_reference", leaky)
    with pytest.raises(AssertionError, match="did not stay in that head"):
        chip_smoke.half_flash_rows(torch, cpu, _randn_cpu(3), "float16",
                                   B=1, H=3, T=40, D=32, lengths=(40,))


@pytest.fixture
def one_torch_thread():
    """Tiny shapes: one intra-op thread, restored after the test (several
    threads a worker, under parallel test workers, spend their time in each
    small op's barrier)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_bf16_kernel_rows_on_the_cpu(monkeypatch, one_torch_thread):
    """The bf16 rows' drive at small shapes on the CPU (the plain versions,
    fake clocks): LayerNorm, softmax, and the flash forward, dQ and dK/dV
    dense then ragged, each marked bf16, its bytes counted at 2 bytes an
    element (the lse, delta and bias at 4), its operations at the bf16
    rate. LayerNorm, softmax and the forward are held element by element
    (no single tolerance; the share of its own limit that the worst
    element reaches), the gradients to BF16_REL_TOL of their largest
    magnitude."""
    monkeypatch.setattr(chip_smoke, "device_ms",
                        lambda torch_, fn, inputs, iters=20: (1.0,
                                                              "profiler"))
    monkeypatch.setattr(chip_smoke, "device_kernel_names",
                        lambda torch_, fn, inputs: ["flash_fwd_kernel"])
    # on the CPU there is no L2 to keep cold: one copy of the inputs
    monkeypatch.setattr(chip_smoke, "cold_copies",
                        lambda torch_, inputs, nbytes: [inputs])
    cpu = torch.device("cpu")
    rows = chip_smoke.half_norm_rows(torch, cpu, _randn_cpu(1), R=16, C=64,
                                     softmax_shape=(2, 2, 16))
    assert rows[1]["kernel_route"] == "vec"
    rows += chip_smoke.half_flash_rows(torch, cpu, _randn_cpu(2), B=2, H=2,
                                       T=100, D=32, lengths=(100, 0))
    assert [r["name"] for r in rows] == [
        "layer_norm_bf16", "softmax_bf16"] + [
        "flash_attention_fwd_bf16", "flash_attention_bwd_dq_bf16",
        "flash_attention_bwd_dkv_bf16"] * 2
    for r in rows:
        assert r["dtype"] == "bfloat16" and r["max_abs_err"] == 0.0
        if r["name"].startswith("flash_attention_bwd"):
            assert r["tolerance"] > 0
        else:
            assert r["tolerance"] is None and r["tolerance_share"] == 0.0
            assert r["tolerance_rule"].startswith("each element")
    ln = rows[0]
    assert ln["bound_ms"] == pytest.approx(
        (2 * 16 * 64 + 2 * 64) * 2 / chip_smoke.HBM_BYTES_PER_S * 1e3)
    fwd_dense, fwd_ragged = rows[2], rows[5]
    nbytes = (4 * 2 * 2 * 100 * 32 * 2 + 2 * 2 * 100 * 4)
    ops = 4 * 2 * 2 * 100 * 100 * 32
    assert fwd_dense["bound_ms"] == pytest.approx(max(
        nbytes / chip_smoke.HBM_BYTES_PER_S,
        ops / chip_smoke.BF16_FLOPS_PER_S) * 1e3)
    assert fwd_ragged["live_key_share"] == 0.5
    assert rows[3]["pair_library_backend"] == "flash"


def test_fp16_kernel_rows_on_the_cpu(monkeypatch, one_torch_thread):
    """The fp16 rows' drive at small shapes on the CPU (the plain versions,
    fake clocks): the bf16 rows' five kernels under their fp16 names, each
    marked float16, its bytes at 2 bytes an element and its operations at
    the fp16 rate; LN, softmax and the forward held element by element
    under fp16's rules (2**-10 of each element's own value plus floors
    a step apart from bf16's), the gradients to FP16_REL_TOL of their
    largest magnitude, and an inf planted in dO non-finite in every
    gradient (dense and ragged)."""
    monkeypatch.setattr(chip_smoke, "device_ms",
                        lambda torch_, fn, inputs, iters=20: (1.0,
                                                              "profiler"))
    monkeypatch.setattr(chip_smoke, "device_kernel_names",
                        lambda torch_, fn, inputs: ["flash_fwd_kernel"])
    monkeypatch.setattr(chip_smoke, "cold_copies",
                        lambda torch_, inputs, nbytes: [inputs])
    cpu = torch.device("cpu")
    rows = chip_smoke.half_norm_rows(torch, cpu, _randn_cpu(1), "float16",
                                     R=16, C=64, softmax_shape=(2, 2, 16))
    assert rows[1]["kernel_route"] == "vec"
    rows += chip_smoke.half_flash_rows(torch, cpu, _randn_cpu(2), "float16",
                                       B=2, H=2, T=100, D=32,
                                       lengths=(100, 0))
    assert [r["name"] for r in rows] == [
        "layer_norm_f16", "softmax_f16"] + [
        "flash_attention_fwd_f16", "flash_attention_bwd_dq_f16",
        "flash_attention_bwd_dkv_f16"] * 2
    for r in rows:
        assert r["dtype"] == "float16" and r["max_abs_err"] == 0.0
        if r["name"].startswith("flash_attention_bwd"):
            assert r["pair_dO_inf_nonfinite"] == [True, True, True]
            assert r["tolerance"] > 0
        else:
            assert r["tolerance"] is None and r["tolerance_share"] == 0.0
            assert "2**-10 of its own value" in r["tolerance_rule"]
    assert chip_smoke.FP16_LN_FLOOR == 2.0 ** -19
    assert chip_smoke.FP16_SOFTMAX_FLOOR == 1e-6 / 8
    nbytes = (4 * 2 * 2 * 100 * 32 * 2 + 2 * 2 * 100 * 4)
    ops = 4 * 2 * 2 * 100 * 100 * 32
    assert rows[2]["bound_ms"] == pytest.approx(max(
        nbytes / chip_smoke.HBM_BYTES_PER_S,
        ops / chip_smoke.FP16_FLOPS_PER_S) * 1e3)


def test_bf16_each_holds_every_element_to_its_own_limit():
    """Softmax rows whose small probabilities were flushed to 0 stay within
    BF16_REL_TOL of the largest probability everywhere, but not within a
    bf16 step of each element's own value; the helper names how many
    elements fall outside."""
    gen = torch.Generator().manual_seed(3)
    s = (3 * torch.randn(4, 128, generator=gen)).to(torch.bfloat16)
    want = torch.softmax(s.float(), dim=-1).to(torch.bfloat16).float()
    limit = chip_smoke.BF16_STEP * want.abs() + chip_smoke.BF16_SOFTMAX_FLOOR
    err, share = chip_smoke.bf16_each("softmax", want.clone(), want, limit,
                                      "same")
    assert (err, share) == (0.0, 0.0)
    old = chip_smoke.BF16_REL_TOL * want.abs().max()
    flushed = want.masked_fill(want < old, 0.0)
    assert (flushed != want).float().mean() > 0.5
    assert (flushed - want).abs().max() <= old
    with pytest.raises(AssertionError, match="elements beyond"):
        chip_smoke.bf16_each("softmax", flushed, want, limit, "flushed")
    one_step = want + chip_smoke.BF16_STEP * want.abs()
    assert chip_smoke.bf16_each("softmax", one_step, want, limit,
                                "a step")[1] <= 1.0


@pytest.fixture
def gluon_names_unchanged():
    """Gluon names blocks from per-alias counters global to the process
    (``_BlockScope``); a test here that builds the port's ResNets and no JAX
    ones restores them, so that a later test in the same process that
    compares the two packages' names sees both counters where it would."""
    from incubator_mxnet_tpu_torch.gluon.block import _BlockScope
    saved = dict(_BlockScope._counters)
    yield
    _BlockScope._counters.clear()
    _BlockScope._counters.update(saved)


def test_train_bf16_phase_checks_each_path_on_the_cpu(capsys,
                                                      gluon_names_unchanged,
                                                      one_torch_thread):
    """The train_bf16 drive on the CPU at a tiny size (launch counts and
    times only on the card): step 1 of a 2-layer model against itself on
    the CPU, the full model's step 1 against its own fp32 step 1, the
    measured steps, the numeric guard (a skipped step leaves every tensor
    bitwise, a finite one equals step on a restored twin), bf16-stored
    parameters against the fp32 trajectory, and a small ResNet (its step 1
    at one unit a stage against itself on the CPU, beside the CPU's own
    spread under a perturbed batch); each on a line of its own, the timing
    line last."""
    cpu = torch.device("cpu")
    by_path = chip_smoke.train_bf16_phase(
        torch, cpu, dict(vocab_size=300, units=64, hidden_size=128,
                         num_layers=2, num_heads=2, max_length=512),
        shapes=((128, 4), (512, 2)), steps=2,
        resnet_cfg=dict(kind="bottleneck", layers=[1, 1],
                        channels=[8, 16, 32], classes=10),
        resnet_shape=(4, 32), resnet_steps=2, resnet_check=(2, 32))
    assert sorted(by_path) == ["train_bf16", "train_bf16_params",
                               "train_bf16_resnet"]
    lines = {}
    for line in capsys.readouterr().out.splitlines():
        phase, _, body = line.partition(": ")
        lines.setdefault(phase, []).append(json.loads(body))
    short, flash = lines["train_bf16"]
    assert (short["flash"], flash["flash"]) == (False, True)
    assert short["guard"] is None and short["param_dtype"] is None
    guard = flash["guard"]
    assert guard["inf_scale_notfinite"] and guard["twin_bitwise"]
    assert flash["param_dtype"]["dtypes"] == ["torch.bfloat16"]
    assert flash["param_dtype"]["drift"] < chip_smoke.BF16_PARAM_DRIFT
    for line in lines["train_bf16"]:
        assert line["step1"]["layers"] == chip_smoke.BF16_CHECK_LAYERS
        assert abs(line["loss_step1"] - line["fp32_loss_step1"]) \
            <= chip_smoke.BF16_VS_FP32_LOSS
    (resnet,) = lines["resnet_bf16"]
    assert len(resnet["losses"]) == 2
    step1 = resnet["step1"]
    assert step1["layers"] == [1, 1] and step1["loss"] == step1["cpu_loss"]
    assert step1["logits"] == ["torch.bfloat16"]
    assert step1["grads"] > 0 and step1["stats"] > 0
    assert step1["grad_worst_gap"][0][1] == 0.0
    assert step1["grad_cos"] == pytest.approx(1.0)
    assert step1["bn_grad_norm_ratio"] == [1.0, 1.0]
    assert step1["cpu_spread"]["grad_cos"] < 1.0
    assert step1["cpu_spread"]["fp32_grad_gap_max"] > 0.0
    (timing,) = lines["train_bf16_timing"]
    assert sorted(timing) == ["bert_T128_B4", "bert_T512_B2", "card",
                              "resnet_B4"]


def test_train_fp16_phase_checks_each_path_on_the_cpu(capsys,
                                                      one_torch_thread):
    """The train_fp16 drive on the CPU at a tiny size (launch counts and
    times only on the card): step 1 of a 2-layer model against itself on
    the CPU, the full model's plain step 1 against its own fp32 step 1, the
    measured GuardedTrainer steps at the default guard with their scales
    and verdicts, and the forced overflow from 2**40 (each skipped step
    leaves every tensor bitwise, the scale halves until a step is finite);
    each shape on a line of its own, the timing line last, its bf16 and
    fp32 columns from the lines it is given."""
    cpu = torch.device("cpu")
    cfg = dict(vocab_size=300, units=64, hidden_size=128, num_layers=2,
               num_heads=2, max_length=512)
    bf16 = {(128, 4): dict(step_ms_median=7.0, tokens_per_s=1.0,
                           launches={})}
    by_path = chip_smoke.train_fp16_phase(
        torch, cpu, cfg, shapes=((128, 4), (512, 2)), steps=2, bf16=bf16)
    assert sorted(by_path) == ["train_fp16"]
    lines = {}
    for line in capsys.readouterr().out.splitlines():
        phase, _, body = line.partition(": ")
        lines.setdefault(phase, []).append(json.loads(body))
    short, flash = lines["train_fp16"]
    assert (short["flash"], flash["flash"]) == (False, True)
    for line in (short, flash):
        assert line["step1"]["layers"] == chip_smoke.BF16_CHECK_LAYERS
        assert line["step1"]["loss"] == line["step1"]["cpu_loss"]
        assert abs(line["loss_step1_diff"]) <= chip_smoke.FP16_VS_FP32_LOSS
        assert line["scales"] == [[2.0 ** 16] * 2] * 2
        assert line["skipped"] == [False, False]
        assert line["replayed_scales"] == [2.0 ** 16] * 2
        over = line["forced_overflow"]
        assert over["state_bitwise"] and over["skipped"] >= 10
        assert over["scales"][0] == chip_smoke.FP16_OVERFLOW_SCALE
        assert over["scales"][-1] == over["finite_scale"]
        assert all(math.isfinite(x) for x in over["losses_after"])
        assert line["launches_against_bf16"] is None     # only on the card
    (timing,) = lines["train_fp16_timing"]
    assert timing["bert_T128_B4"]["bf16_step_ms_median"] == 7.0
    assert timing["bert_T512_B2"]["bf16_step_ms_median"] is None


def test_train_fp16_phase_fails_on_a_guard_that_cannot_back_off(
        monkeypatch, one_torch_thread):
    """A forced overflow that cannot reach a finite step within its budget
    of skipped steps, and a step 1 that parts from fp32's, each fail the
    phase."""
    cpu = torch.device("cpu")
    cfg = dict(vocab_size=300, units=64, hidden_size=128, num_layers=1,
               num_heads=2, max_length=128)
    monkeypatch.setattr(chip_smoke, "FP16_OVERFLOW_MAX_STEPS", 3)
    with pytest.raises(AssertionError, match="forced overflow: 4 skipped "
                       ".*a finite step not reached"):
        chip_smoke.train_fp16_phase(torch, cpu, cfg, shapes=((128, 2),),
                                    steps=1)
    monkeypatch.setattr(chip_smoke, "FP16_OVERFLOW_MAX_STEPS", 40)
    with pytest.raises(AssertionError, match="fp16 step 1 loss"):
        chip_smoke.train_fp16_phase(
            torch, cpu, cfg, shapes=((128, 2),), steps=1,
            fp32={(128, 2): dict(loss_step1=1.0)})


RESNET_TINY = dict(kind="bottleneck", layers=[1, 1], channels=[8, 16, 32],
                   classes=10)


def test_train_fp16_phase_trains_a_resnet_under_the_guard(
        capsys, gluon_names_unchanged, one_torch_thread):
    """Given a ResNet configuration, the train_fp16 drive adds ResNet v1 in
    fp16 on the CPU at a tiny size: its step 1 at one unit a stage against
    itself on the CPU under the guard's back-off from 2**16 (logits fp16,
    running statistics fp32), the full model's step 1 against its fp32
    step 1, the measured guarded steps with their scales and verdicts; a
    `resnet_fp16` line, its launch counts by path, and a ResNet entry in
    the timing line beside bf16's."""
    cpu = torch.device("cpu")
    cfg = dict(vocab_size=300, units=64, hidden_size=128, num_layers=1,
               num_heads=2, max_length=128)
    bf16 = {"resnet": dict(step_ms_median=5.0, images_per_s=800.0)}
    by_path = chip_smoke.train_fp16_phase(
        torch, cpu, cfg, shapes=((128, 2),), steps=1, bf16=bf16,
        resnet_cfg=RESNET_TINY, resnet_shape=(4, 32), resnet_steps=2,
        resnet_check=(2, 32))
    assert sorted(by_path) == ["train_fp16", "train_fp16_resnet"]
    lines = {}
    for line in capsys.readouterr().out.splitlines():
        phase, _, body = line.partition(": ")
        lines.setdefault(phase, []).append(json.loads(body))
    (resnet,) = lines["resnet_fp16"]
    assert len(resnet["losses"]) == 2 and all(
        math.isfinite(x) for x in resnet["losses"])
    assert resnet["loss_step1_rel_diff"] <= chip_smoke.RESNET_FP16_LOSS_RTOL
    assert [v["scale"] for v in resnet["verdicts"]][0] == 2.0 ** 16
    step1 = resnet["step1"]
    assert step1["dtype"] == "float16" and step1["logits"] == [
        "torch.float16"]
    assert step1["loss"] == step1["cpu_loss"] and step1["stats"] > 0
    assert step1["loss_scales"]["cpu"][0] <= 2.0 ** 16
    assert step1["grad_cos"] == pytest.approx(1.0)
    timing = lines["train_fp16_timing"][0]["resnet_B4"]
    assert timing["bf16_images_per_s"] == 800.0
    assert timing["fp16_images_per_s"] == resnet["images_per_s"]


def test_resnet_fp16_fails_on_a_step1_that_parts_from_fp32(
        monkeypatch, gluon_names_unchanged, one_torch_thread):
    """A full-depth fp16 step 1 farther from the fp32 step 1 than its rtol
    fails the phase, on its own `resnet_fp16` failure."""
    monkeypatch.setitem(chip_smoke.RESNET_HALF, "float16",
                        (chip_smoke.RESNET_FP16_CHECK_RTOL,
                         chip_smoke.RESNET_FP16_REL, -1.0))
    with pytest.raises(AssertionError, match="resnet_fp16: ResNet float16 "
                       "step 1 loss"):
        chip_smoke.train_fp16_phase(
            torch, torch.device("cpu"), dict(
                vocab_size=300, units=64, hidden_size=128, num_layers=1,
                num_heads=2, max_length=128), shapes=(), steps=1,
            resnet_cfg=RESNET_TINY, resnet_shape=(2, 32), resnet_steps=1,
            resnet_check=(2, 32))


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_seam_half_phase_checks_each_flavour_on_the_cpu(capsys, dtype,
                                                        gluon_names_unchanged):
    """The seam drive on the CPU over a small ResNet's shapes (launch
    counts only on the card): each flavour's w and states equal to the
    plain version's, the CPU's difference counted (NaN against NaN is
    none), v's subnormal elements counted before and after; a `seam_bf16`
    or `seam_fp16` line."""
    chip_smoke.seam_half_phase(torch, torch.device("cpu"), dtype,
                               cfg=RESNET_TINY)
    what = chip_smoke.SEAM_HALF[dtype][0]
    (line,) = [json.loads(l.split(": ", 1)[1])
               for l in capsys.readouterr().out.splitlines()
               if l.startswith(what + ": ")]
    assert line["dtype"] == dtype and line["rescale"] == 1.0 / 128
    for name in ("sgd_mom", "adam", "adamw"):
        assert line[name]["bitwise_plain"]
        assert line[name]["cpu_elements_differ"] == 0
    before, after = line["adam"]["v_subnormal"]
    if dtype == "float16":      # v at 1e-6: mostly fp16 subnormals
        assert before > line["elements"] // 2 and after > 0
        assert line["adam"]["w_nonfinite"] > 0      # eps rounds to 0
    else:
        assert before == after == 0
        assert line["adam"]["w_nonfinite"] == 0


def test_seam_half_phase_fails_when_kernel_and_plain_differ(
        monkeypatch, gluon_names_unchanged):
    """A seam call that moves a weight the plain version does not fails
    the phase, naming the flavour and the dtype."""
    from incubator_mxnet_tpu_torch.ops import _optim_kernels as seam
    call = seam._multi_sgd_mom_update

    def nudged(ws, *args, **kwargs):
        out = call(ws, *args, **kwargs)
        ws[0].view(-1)[0] += 1
        return out
    monkeypatch.setattr(seam, "_multi_sgd_mom_update", nudged)
    with pytest.raises(AssertionError, match="seam_fp16: sgd_mom: the "
                       "float16 kernel and its plain version differ"):
        chip_smoke.seam_half_phase(torch, torch.device("cpu"), "float16",
                                   cfg=RESNET_TINY)


# ----------------------------------------------------------- generate_bf16
GEN_CFG = dict(vocab_size=300, units=64, num_layers=2, num_heads=2,
               max_len=256)


def test_generate_bf16_phase_checks_each_run_on_the_cpu(capsys,
                                                        one_torch_thread):
    """The generate_bf16 drive on the CPU at a tiny size (launch counts only
    on the card): the CPU check over bf16 and fp32 pools, each run's first
    batch held token by token against the full-sequence forward, the
    2-layer-drafted and the self-drafted speculative runs, the latter above
    its acceptance floor; the knobs set for the first run only."""
    cpu = torch.device("cpu")
    before = {k: chip_smoke.os.environ.get(k)
              for k in chip_smoke.GEN_BF16_KNOBS}
    by_path = chip_smoke.generate_half_phase(
        torch, cpu, cfg=GEN_CFG, draft_cfg=dict(GEN_CFG, num_layers=1),
        prompt_lengths=[1, 8, 17, 31, 33, 64, 100], max_new=8, slots=4,
        cache_len=256)
    assert sorted(by_path) == ["generate_bf16", "generate_bf16_fp32_pools",
                               "generate_bf16_self_spec",
                               "generate_bf16_spec"]
    assert {k: chip_smoke.os.environ.get(k)
            for k in chip_smoke.GEN_BF16_KNOBS} == before
    (line,) = [json.loads(l.partition(": ")[2])
               for l in capsys.readouterr().out.splitlines()
               if l.startswith("generate_bf16: ")]
    for check in ("cpu_check", "cpu_check_fp32_pools"):
        assert line[check]["logits_gap_over_max"] == 0.0
        assert line[check]["token_diffs"] == []
    for run in ("bf16_pools", "fp32_pools", "speculative",
                "self_speculative"):
        forced = line[run]["teacher_forced"]
        assert forced["tokens"] == 4 * 8
        assert forced["worst_short_over_top"] <= 2 * \
            chip_smoke.GEN_BF16_ROW_TOL
    assert (line["bf16_pools"]["block_size"],
            line["bf16_pools"]["prefill_chunk"]) == (32, 16)
    spec, self_spec = line["speculative"], line["self_speculative"]
    assert (spec["draft_layers"], self_spec["draft_layers"]) == (1, 2)
    assert self_spec["acceptance"] >= chip_smoke.GEN_BF16_SELF_ACCEPT
    assert self_spec["accepted"] > 0


def test_generate_fp16_phase_checks_each_run_and_the_served_round_on_the_cpu(
        capsys, tmp_path, one_torch_thread):
    """The generate_fp16 drive on the CPU at a tiny size (launch counts only
    on the card): the bf16 phase's runs and checks in fp16 at
    GEN_FP16_ROW_TOL, then the served round: an fp16 checkpoint served in
    fp16 through ModelServer, every served token held to the CPU's
    full-sequence forward, one sequence's logits within the row bound, a
    live deploy of a second fp16 generation (its weights in place, a
    request after it held to them) and an fp32 generation refused. cuBLAS's
    fp16 setting is restored after."""
    matmul = torch.backends.cuda.matmul
    old = matmul.allow_fp16_reduced_precision_reduction
    by_path = chip_smoke.generate_fp16_phase(
        torch, torch.device("cpu"), cfg=GEN_CFG,
        draft_cfg=dict(GEN_CFG, num_layers=1),
        prompt_lengths=[1, 8, 17, 31, 33, 64, 100], max_new=8, slots=4,
        cache_len=256, directory=str(tmp_path / "gpt_fp16"))
    assert matmul.allow_fp16_reduced_precision_reduction == old
    assert sorted(by_path) == ["decode_fp16", "generate_fp16",
                               "generate_fp16_fp32_pools",
                               "generate_fp16_self_spec",
                               "generate_fp16_spec"]
    lines = {l.partition(": ")[0]: json.loads(l.partition(": ")[2])
             for l in capsys.readouterr().out.splitlines()
             if l.startswith(("generate_fp16: ", "decode_fp16: "))}
    gen, served = lines["generate_fp16"], lines["decode_fp16"]
    tol = chip_smoke.GEN_FP16_ROW_TOL
    for check in ("cpu_check", "cpu_check_fp32_pools"):
        assert gen[check]["logits_gap_over_max"] == 0.0
    for run in ("fp16_pools", "fp32_pools", "speculative",
                "self_speculative"):
        assert gen[run]["teacher_forced"]["tokens"] == 4 * 8
        assert gen[run]["teacher_forced"]["worst_short_over_top"] <= 2 * tol
    assert gen["self_speculative"]["acceptance"] >= \
        chip_smoke.GEN_BF16_SELF_ACCEPT
    assert gen["fp16_reduced_precision_reduction"] is False
    assert served["requests"] == 4 and served["tokens_generated"] == 4 * 8
    assert served["teacher_forced"]["tokens"] == 4 * 8
    assert 0 <= served["logits_gap_over_max"] <= tol
    assert served["deploy"]["teacher_forced"]["tokens"] == 8
    assert served["pools"] == "float32"
    assert served["graphs"]["captured"] == 0       # no graphs on the CPU


def test_generate_timing_sets_each_path_beside_the_others():
    records = {"bfloat16": {"half_pools": dict(tokens_per_s=400.0,
                                               step_ms=20.0),
                            "fp32_pools": dict(tokens_per_s=390.0,
                                               step_ms=20.5)},
               "float16": {"half_pools": dict(tokens_per_s=410.0,
                                              step_ms=19.5),
                           "served": dict(tokens_per_s=900.0,
                                          step_ewma_ms=2.0, p50_ms=300.0,
                                          requests=8)}}
    fp32 = dict(tokens_per_s=850.0, step_ewma_ms=2.5, p50_ms=400.0,
                requests=16, extra=1)
    out = chip_smoke.generate_timing(records, fp32, True)
    assert out == {
        "engine_bf16_bf16_pools": dict(tokens_per_s=400.0, step_ms=20.0),
        "engine_bf16_fp32_pools": dict(tokens_per_s=390.0, step_ms=20.5),
        "engine_fp16_fp16_pools": dict(tokens_per_s=410.0, step_ms=19.5),
        "served_fp32": dict(tokens_per_s=850.0, step_ewma_ms=2.5,
                            p50_ms=400.0, requests=16),
        "served_fp16": dict(tokens_per_s=900.0, step_ewma_ms=2.0,
                            p50_ms=300.0, requests=8),
        "fp16_reduced_precision_reduction_elsewhere": True}


def _greedy(params, prompt, steps):
    from incubator_mxnet_tpu_torch.models.gpt import gpt_logits
    seq = list(prompt)
    for _ in range(steps):
        seq.append(int(gpt_logits(params, GEN_CFG, torch.tensor(
            [seq]))[0, -1].float().argmax()))
    return seq[len(prompt):]


def test_teacher_forced_refuses_a_token_far_below_the_top(one_torch_thread):
    """The full-sequence greedy tokens pass (each is its row's top); a token
    swapped for its row's lowest fails, and a sequence seen once is not
    computed again."""
    params = chip_smoke.gpt_half_params(torch, GEN_CFG, 5)
    forced = chip_smoke.TeacherForced(torch, GEN_CFG, params)
    prompts = [[3, 1, 4], [15]]
    outs = [_greedy(params, p, 5) for p in prompts]
    got = forced.check("greedy", prompts, outs)
    assert got == dict(worst_short_over_top=0.0, not_argmax=0, tokens=10)
    assert len(forced.seen) == 2
    forced.check("again", prompts, outs)
    assert len(forced.seen) == 2
    from incubator_mxnet_tpu_torch.models.gpt import gpt_logits
    row = gpt_logits(params, GEN_CFG, torch.tensor(
        [prompts[0] + outs[0][:2]]))[0, -1].float()
    bad = outs[0][:2] + [int(row.argmin())]
    with pytest.raises(AssertionError, match="sequence 0 step 2"):
        forced.check("swapped", prompts[:1], [bad])


@pytest.mark.parametrize("got,margin,ok", [
    ([[1, 2, 3]], 0.0, True),          # the same tokens
    ([[1, 2, 9]], 0.05, True),          # parts at a near tie: 5 % <= 2/32
    ([[1, 2, 9]], 0.07, False),         # parts where the top is clear
    ([[1, 2]], 0.0, False)])            # a shorter sequence
def test_tokens_agree_lets_sequences_part_only_at_a_near_tie(got, margin,
                                                             ok):
    want = [[1, 2, 3]]
    margins = {0: [(0.0, 1.0), (0.0, 1.0), (margin, 1.0)]}
    if ok:
        diffs = chip_smoke.tokens_agree("t", got, want, margins)
        assert [d["step"] for d in diffs] == ([2] if got != want else [])
    else:
        with pytest.raises(AssertionError):
            chip_smoke.tokens_agree("t", got, want, margins)


def test_set_env_sets_then_restores_each_setting(monkeypatch):
    monkeypatch.setenv("MXTPU_GEN_BLOCK_SIZE", "8")
    monkeypatch.delenv("MXTPU_GEN_PREFILL_CHUNK", raising=False)
    env = chip_smoke.os.environ
    with chip_smoke.set_env(chip_smoke.GEN_BF16_KNOBS):
        assert (env["MXTPU_GEN_BLOCK_SIZE"],
                env["MXTPU_GEN_PREFILL_CHUNK"]) == ("32", "16")
    assert env["MXTPU_GEN_BLOCK_SIZE"] == "8"
    assert "MXTPU_GEN_PREFILL_CHUNK" not in env


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_flash_decode_half_rows_bound_each_pair_at_its_products_rate(
        monkeypatch, dtype):
    """The bf16 and fp16 decode rows on the CPU (the plain version, fake
    clocks): named by the dtype, over pools of q's dtype the operations
    count at the 16-bit tensor-core rate; 16-bit q over fp32 pools is an
    fp32 product, at the fp32 rate with the fp32-accurate tensor-core rate
    as tc_bound_ms, as the fp32 rows; o is held to one step of q's dtype
    (2**-7, 2**-10) of each element's own value."""
    from incubator_mxnet_tpu_torch.telemetry.costs import flash_decode_cost
    monkeypatch.setattr(chip_smoke, "device_ms",
                        lambda torch_, fn, inputs, iters=20: (1.0,
                                                              "profiler"))
    monkeypatch.setattr(chip_smoke, "cold_copies",
                        lambda torch_, inputs, nbytes: [inputs])
    rows = chip_smoke.flash_decode_half_rows(torch, torch.device("cpu"),
                                             _randn_cpu(4), dtype)
    rules = chip_smoke.HALF_RULES[dtype]
    assert [(r["pool_dtype"], r["shape"]) for r in rows] == [
        (p, s) for p in ("float32", dtype)
        for s in ([1, 32, 12, 64], [8, 1, 12, 64])]
    for r in rows:
        assert r["name"] == "flash_decode_" + rules["suffix"]
        assert r["dtype"] == dtype and r["tolerance_share"] == 0.0
        assert rules["names"][0] in r["tolerance_rule"]
        kv = 2 if r["pool_dtype"] == dtype else 4
        S, C, H, D = r["shape"]
        nbytes, ops = flash_decode_cost(S, C, H, D, r["live_positions"], 64,
                                        2, kv)
        peak = rules["flops"] if kv == 2 else chip_smoke.FP32_FLOPS_PER_S
        assert r["bound_ms"] == pytest.approx(max(
            nbytes / chip_smoke.HBM_BYTES_PER_S, ops / peak) * 1e3)
        if kv == 2:
            assert "tc_bound_ms" not in r
        else:
            assert r["tc_bound_ms"] == pytest.approx(max(
                nbytes / chip_smoke.HBM_BYTES_PER_S,
                ops / chip_smoke.TF32X3_FLOPS_PER_S) * 1e3)
    prefill_half = rows[2]
    assert prefill_half["bound_by"] == "bytes"


def test_served_fp16_round_fails_on_a_model_that_is_not_fp16(
        tmp_path, one_torch_thread):
    """The served round on fp32 weights fails at once: the served model is
    not fp16 (the server is stopped on the way out)."""
    params = {n: t.float() for n, t in
              chip_smoke.gpt_half_params(torch, GEN_CFG, 3,
                                         "float16").items()}
    forced = chip_smoke.TeacherForced(torch, GEN_CFG, params,
                                      chip_smoke.GEN_FP16_ROW_TOL)
    prompts = [[3, 1, 4, 1, 5], [9, 2], [6]]
    with pytest.raises(AssertionError, match="the served model is not fp16"):
        chip_smoke.served_fp16_round(
            torch, torch.device("cpu"), GEN_CFG, params, prompts,
            str(tmp_path / "gpt"), forced, 4, 3, 64, None)
