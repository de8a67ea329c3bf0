"""The PyTorch port's hand-written CUDA kernels against their plain
PyTorch versions, on a CUDA card.

Every test here is marked ``needs_cuda`` and skips where
``torch.cuda.is_available()`` is false. The file imports neither JAX nor the
JAX package, so it runs on the card's machine, which has no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

Tolerances (TF32 off): LayerNorm and softmax atol 1e-5, flash attention
forward atol 2e-5, flash decode atol 2e-5 on o, 1e-5 on m and rtol 1e-5 on
l; the kernels sum in another order than the plain versions. The flash
backward kernels (fp32-accurate 3xTF32 products on the tensor cores) are
held at atol 2e-5 to the plain formulas evaluated in float64 on the same
inputs: the fp32 plain version's own error against float64 reaches 2e-5 at
these shapes, so a kernel that sums in another order cannot be held to it.
The learned bias's cotangent (the dK/dV kernel's dbias) is held at 2e-5 /
scale: it is dS before the scale, summed over the same rows as dK, so it
carries dK's tolerance in its own units; through autograd on the card
against the CPU, every gradient within 1e-4 of its tensor's max.
The fused Adam / AdamW and SGD-momentum kernels, of the trainer and of the
eager gluon seam (rescale / clip prologue), equal their plain versions
bitwise: both round every operation on its own, in the same order, from the
same f32 scalars; a NaN gradient comes out as NaN at the same places. So do
the seam's bf16 flavours, which round every operation and every scalar to
bf16. Kernels compiled at run time by mx.rtc equal plain torch exactly on
the axpy they compute.
The fused bottleneck is held within atol 1e-4 in fp32 (3xTF32 products on
the tensor cores, ~2^-21 of each product) and within 2 * 2**-8 of the
output's largest magnitude in bf16 (one bf16 step where the two round a
value from fp32 sums taken in other orders), on both of its bf16 routes
(16-byte and element-wise loads) and on the fp32 route's 16-byte and
4-byte copies.
LayerNorm is held at atol 1e-5 on each of its three routes (a warp a row in
16-byte and scalar forms, and the long-row block), each case asserting the
route the wrapper picks; its C entry refuses a route whose conditions
fail.
The 16-bit softmax is held on each of its three routes (vec: 16-byte
vectors, a lane group a row; scalar; long) within a step of its dtype of
each element's value plus a floor, each case asserting the route the
wrapper picks; its C entries refuse a route whose conditions fail.
The bf16 flavours of LayerNorm, softmax and the flash forward and backward
are held to their plain versions on the same bf16 inputs within 2 * 2**-8
of each output's largest magnitude (both round to bf16 from fp32 sums
taken in other orders, and P and dS round at the same points but may land
on neighbouring bf16 values), the lse within 1e-4, dead rows exactly 0.
The bf16 dK/dV kernel's dbias variant holds dk and dv to the same rule and
its fp32 dbias within 1e-4 of its largest of the float64 formulas on the
same bf16 inputs. The 16-bit backward's shared-memory layouts are held
on one wgmma tile to torch.matmul exactly (small integers, whose fp32 sums
are exact in any order), and the dQ kernel's delta within 1e-6 of each
row's sum of |dO * O| (the products are exact in fp32; the sums are taken
in another order). The bf16 decode kernel (bf16 q over bf16 or fp32 pools)
holds each element of o within a bf16 step (2**-7) of its own value plus
1e-5 of the plain version's (both round o once from fp32 sums taken in
other orders), m within 1e-5 and l within rtol 1e-5 (p stays fp32).
The forward's edge, dead-tile, masked, causal, learned-bias and bitwise
cases run in fp32, bf16 and fp16 (`_fwd_against_plain`: fp32 at 2e-5, the
16-bit kernels within a step of each element's value plus a step of the
same attention over |V|, their lse within 1e-4), and the decode kernel's
split, bitwise and long-table cases over fp32 pools and over 16-bit pools
of q's dtype (`_decode_against_plain`).
The GPT test holds whole generations on the card and the CPU token for
token. A served shape's CUDA graph (compilecache.aot.BlockProgram) replays
the eager forward's kernels in the same order on the same inputs, so a
replay is held to the eager forward on the card within 1e-6 of each row's
max (0 is expected), and its launches are counted at each replay; a live
weight swap keeps every graph and every weight's address, and the int8
head re-quantized in place equals a fresh one bit for bit. The int8 x int8 -> int32 matmul equals its plain version exactly
(integer sums are exact in any order), at every shape, aligned or not, on
each of its three routes (small, tma, bytes), each case asserting the
route the wrapper picks; the
lstm_lm family's served logits on the card are held to the CPU's replay of
the same grid (see its test for the int8 rule).
"""

import math

import pytest
import torch

from incubator_mxnet_tpu_torch.ops.kernels import fused_norm
from incubator_mxnet_tpu_torch.ops.kernels.flash_attention import (
    flash_attention, flash_attention_backward,
    flash_attention_backward_reference, flash_attention_bwd_dkv,
    flash_attention_bwd_dkv_bf16, flash_attention_bwd_dkv_dbias,
    flash_attention_bwd_dkv_f16, flash_attention_bwd_dq,
    flash_attention_bwd_dq_bf16, flash_attention_bwd_dq_f16,
    flash_attention_forward, flash_attention_fwd_bf16,
    flash_attention_fwd_f16, flash_attention_reference)
from incubator_mxnet_tpu_torch.ops.kernels.fused_optim import (
    fused_adam_flat, fused_adam_flat_bf16, fused_adam_flat_f16,
    fused_adam_flat_reference, fused_adamw_flat, fused_adamw_flat_bf16,
    fused_adamw_flat_f16, fused_adamw_flat_reference, fused_sgd_mom_flat,
    fused_sgd_mom_flat_bf16, fused_sgd_mom_flat_f16,
    fused_sgd_mom_flat_reference, multi_trainer_adam,
    multi_trainer_adam_reference, multi_trainer_sgd_mom,
    multi_trainer_sgd_mom_reference)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


#: the 16-bit dQ kernels, which also give delta = rowsum(dO * O)
_DQ16 = {"bfloat16": flash_attention_bwd_dq_bf16,
         "float16": flash_attention_bwd_dq_f16}


def _ln_inputs(rows, C, device):
    gen = torch.Generator(device=device).manual_seed(rows * C)
    x = torch.randn(rows, C, generator=gen, device=device) * 2 + 0.5
    g = torch.rand(C, generator=gen, device=device) + 0.5
    b = torch.randn(C, generator=gen, device=device)
    return x, g, b


@pytest.mark.needs_cuda
@pytest.mark.parametrize("rows,C", [(1, 768), (7, 768), (1024, 768),
                                    (4096, 768), (33, 100), (5, 3000)])
def test_layer_norm_kernel_matches_plain(cuda, rows, C):
    x, g, b = _ln_inputs(rows, C, cuda)
    n0 = fused_norm.layer_norm.launches
    got = fused_norm.layer_norm(x, g, b)
    torch.cuda.synchronize()
    assert fused_norm.layer_norm.launches == n0 + 1
    want = fused_norm.layer_norm_reference(x, g, b)
    assert (got - want).abs().max().item() <= 1e-5


def _ln_expected_route(C, vec=True):
    if C > 1024:
        return "long"
    return "warp" if vec else "warp_scalar"


def _ln_route_of(x, g, b, y):
    return fused_norm._route(x.shape[-1], x.data_ptr(), g.data_ptr(),
                             b.data_ptr(), y.data_ptr())


@pytest.mark.needs_cuda
@pytest.mark.parametrize("rows", [1, 7, 8, 31, 32, 63, 64, 65, 1024, 4097])
def test_layer_norm_routes_match_plain(cuda, rows):
    """Every C of 64, 100, 128, 768, 1000, 1024 and 1025 at this row count:
    the route the wrapper takes (a warp a row with 16-byte accesses up to
    1024 values, the long-row block above) and the kernel within 1e-5 of
    the plain version, one launch a call."""
    for C in (64, 100, 128, 768, 1000, 1024, 1025):
        x, g, b = _ln_inputs(rows, C, cuda)
        n0 = fused_norm.layer_norm.launches
        got = fused_norm.layer_norm(x, g, b)
        torch.cuda.synchronize()
        assert fused_norm.layer_norm.launches == n0 + 1
        assert _ln_route_of(x, g, b, got) == _ln_expected_route(C), (rows, C)
        want = fused_norm.layer_norm_reference(x, g, b)
        assert (got - want).abs().max().item() <= 1e-5, (rows, C)


@pytest.mark.needs_cuda
@pytest.mark.parametrize("rows", [8, 64, 1024])
def test_layer_norm_scalar_route_on_views_and_odd_c(cuda, rows):
    """A row 4 bytes past a 16-byte boundary, and C = 767 and 770 (not a
    multiple of 4), take the scalar form of the warp route and hold
    1e-5."""
    x, g, b = _ln_inputs(rows, 768, cuda)
    buf = torch.empty(rows * 768 + 1, device=cuda)
    view = buf[1:].view(rows, 768)
    view.copy_(x)
    assert view.data_ptr() % 16 == 4 and view.is_contiguous()
    got = fused_norm.layer_norm(view, g, b)
    assert _ln_route_of(view, g, b, got) == "warp_scalar"
    torch.cuda.synchronize()
    assert (got - fused_norm.layer_norm_reference(x, g, b)).abs().max() \
        .item() <= 1e-5
    for C in (767, 770):
        x, g, b = _ln_inputs(rows, C, cuda)
        got = fused_norm.layer_norm(x, g, b)
        assert _ln_route_of(x, g, b, got) == "warp_scalar"
        torch.cuda.synchronize()
        want = fused_norm.layer_norm_reference(x, g, b)
        assert (got - want).abs().max().item() <= 1e-5, (rows, C)


@pytest.mark.needs_cuda
def test_layer_norm_c_entry_refuses_a_route_whose_conditions_fail(cuda):
    """The C entry refuses, before any launch, the 16-byte warp route for a
    misaligned base or C % 4 != 0, the warp routes above 1024 values, the
    long route at or below it, and an unknown route code."""
    from incubator_mxnet_tpu_torch.ops.kernels import _build
    x, g, b = _ln_inputs(8, 768, cuda)
    view = torch.empty(8 * 768 + 1, device=cuda)[1:].view(8, 768)
    odd = _ln_inputs(8, 770, cuda)
    wide = _ln_inputs(8, 1028, cuda)
    lib = _build.library()
    stream = torch.cuda.current_stream(cuda).cuda_stream
    for (t, gg, bb), C, route in (((view, g, b), 768, 0), (odd, 770, 0),
                                  (wide, 1028, 0), (wide, 1028, 1),
                                  ((x, g, b), 768, 2), ((x, g, b), 768, 3)):
        y = torch.empty_like(t)
        rc = lib.mxtpu_layer_norm_f32(
            t.data_ptr(), gg.data_ptr(), bb.data_ptr(), y.data_ptr(), 8, C,
            1e-5, route, cuda.index, stream)
        assert rc != 0, (C, route)
    assert fused_norm.ROUTES == {"warp": 0, "warp_scalar": 1, "long": 2}


@pytest.mark.needs_cuda
@pytest.mark.parametrize("shape", [(8, 12, 128, 128), (3, 7), (2, 2000)])
def test_softmax_kernel_matches_plain(cuda, shape):
    x = torch.randn(*shape, device=cuda) * 3
    x[..., 0, :2] = -1e30
    got = fused_norm.softmax(x)
    torch.cuda.synchronize()
    assert (got - fused_norm.softmax_reference(x)).abs().max().item() <= 1e-5


@pytest.mark.needs_cuda
def test_softmax_kernel_minus_inf_rows(cuda):
    x = torch.randn(4, 64, device=cuda)
    x[1, 5:] = float("-inf")
    x[2] = float("-inf")
    got = fused_norm.softmax(x).cpu()
    assert (got[1, 5:] == 0).all() and torch.isnan(got[2]).all()


@pytest.mark.needs_cuda
def test_kernel_wrappers_refuse_what_the_kernel_does_not_take(cuda):
    x = torch.randn(4, 32, device=cuda)
    with pytest.raises(TypeError):
        fused_norm.softmax(x.double())
    with pytest.raises(ValueError, match="contiguous"):
        fused_norm.softmax(x.t())
    with pytest.raises(ValueError):
        fused_norm.layer_norm(x, torch.ones(16, device=cuda),
                              torch.zeros(16, device=cuda))


@pytest.mark.needs_cuda
@pytest.mark.parametrize("T", [1, 63, 64, 100, 512, 777])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_kernel_matches_plain(cuda, T, D, causal):
    BH = 6
    gen = torch.Generator(device=cuda).manual_seed(T * D)
    q, k, v = (torch.randn(BH, T, D, generator=gen, device=cuda)
               for _ in range(3))
    bias = torch.randn(BH, T, generator=gen, device=cuda)
    bias[0] = -1e30                        # every key of one row masked
    bias[1, T // 2:] = -1e30
    n0 = flash_attention_forward.launches
    out, lse = flash_attention_forward(q, k, v, bias, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention_forward.launches == n0 + 1
    ref, ref_lse = flash_attention_reference(q, k, v, bias,
                                             1.0 / math.sqrt(D), causal)
    assert (out - ref).abs().max().item() <= 2e-5
    assert (lse - ref_lse).abs().max().item() <= 2e-5
    assert (out[0] == 0).all() and (lse[0] == 0).all()


@pytest.mark.needs_cuda
def test_flash_kernel_without_bias(cuda):
    q = torch.randn(24, 256, 64, device=cuda)
    out, _ = flash_attention_forward(q, q, q)
    ref, _ = flash_attention_reference(q, q, q, None, 1 / 8.0)
    assert (out - ref).abs().max().item() <= 2e-5


@pytest.mark.needs_cuda
def test_flash_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    q = torch.randn(2, 16, 48, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_forward(q, q, q)
    q = torch.randn(2, 16, 64, device=cuda)
    with pytest.raises(TypeError):
        flash_attention_forward(q.double(), q.double(), q.double())
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_forward(q.transpose(0, 1), q, q)


@pytest.mark.needs_cuda
@pytest.mark.parametrize("T", [1, 63, 64, 100, 512, 777])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_backward_kernels_match_plain(cuda, T, D, causal):
    """dq, dk, dv against the plain formulas in float64 from the same
    forward, with a row of every key masked (exact zero gradients), a
    half-masked row and a non-contiguous cotangent."""
    BH = 6
    gen = torch.Generator(device=cuda).manual_seed(T * D + causal)
    q, k, v = (torch.randn(BH, T, D, generator=gen, device=cuda)
               for _ in range(3))
    bias = torch.randn(BH, T, generator=gen, device=cuda)
    bias[0] = -1e30
    bias[1, T // 2:] = -1e30
    scale = 1.0 / math.sqrt(D)
    out, lse = flash_attention_forward(q, k, v, bias, scale, causal)
    do = torch.randn(BH, D, T, generator=gen, device=cuda).transpose(1, 2)
    n0 = (flash_attention_bwd_dq.launches, flash_attention_bwd_dkv.launches)
    dq, dk, dv = flash_attention_backward(q, k, v, out, lse,
                                          do.contiguous(), bias, scale,
                                          causal)
    torch.cuda.synchronize()
    assert (flash_attention_bwd_dq.launches,
            flash_attention_bwd_dkv.launches) == (n0[0] + 1, n0[1] + 1)
    want = flash_attention_backward_reference(q, k, v, out, lse, do, bias,
                                              scale, causal,
                                              compute_dtype=torch.float64)
    for got, ref in zip((dq, dk, dv), want):
        assert torch.isfinite(got).all()
        assert (got - ref).abs().max().item() <= 2e-5
    assert (dq[0] == 0).all() and (dk[0] == 0).all() and (dv[0] == 0).all()


@pytest.mark.needs_cuda
def test_flash_autograd_on_the_card_matches_the_cpu(cuda):
    """The public (B, H, T, D) API's gradients through the kernels against
    the same inputs through the plain versions on the CPU, with a padding
    mask that kills one sample."""
    B, H, T, D = 2, 3, 200, 64
    gen = torch.Generator().manual_seed(11)
    q, k, v = (torch.randn(B, H, T, D, generator=gen) for _ in range(3))
    mask = (torch.arange(T)[None] < torch.tensor([[0], [150]])).float()
    g = torch.randn(B, H, T, D, generator=gen)
    grads = {}
    for dev in (cuda, torch.device("cpu")):
        leaves = [t.to(dev).requires_grad_() for t in (q, k, v)]
        out = flash_attention(*leaves, kv_mask=mask.to(dev))
        out.backward(g.to(dev))
        grads[dev.type] = [t.grad.cpu() for t in leaves]
    for got, want in zip(grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    assert all((t[0] == 0).all() for t in grads["cuda"])


@pytest.mark.needs_cuda
def test_flash_backward_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    q = torch.randn(2, 16, 64, device=cuda)
    lse = torch.zeros(2, 16, device=cuda)
    with pytest.raises(ValueError, match="do must be"):
        flash_attention_bwd_dq(q, q, q, q.transpose(1, 2).contiguous()
                               .transpose(1, 2), lse, lse, None, 0.125,
                               False)
    with pytest.raises(ValueError, match="lse"):
        flash_attention_bwd_dkv(q, q, q, q, lse[:, :8], lse, None, 0.125,
                                False)
    with pytest.raises(TypeError):
        flash_attention_bwd_dq(q.double(), q.double(), q.double(), q, lse,
                               lse, None, 0.125, False)
    with pytest.raises(ValueError, match="tensor on|q on"):
        flash_attention_bwd_dkv(q, q.cpu(), q, q, lse, lse, None, 0.125,
                                False)


def _adam_state(sizes, device, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    groups = []
    for scale in (1.0, 1e-3, 1e-3, 1e-6):     # w, g, m, v (v >= 0)
        groups.append([torch.randn(n, generator=gen, device=device) * scale
                       for n in sizes])
    groups[3] = [t.abs() for t in groups[3]]
    return groups


@pytest.mark.needs_cuda
@pytest.mark.parametrize("adamw", [False, True], ids=["adam", "adamw"])
@pytest.mark.parametrize("t", [1, 1000])
def test_trainer_adam_kernel_equals_plain_bitwise(cuda, adamw, t):
    """Many tensors of sizes 1, 3 and 4097 (unaligned tails), one of 1 M
    elements (31 chunks) and one misaligned view: w, m and v bitwise."""
    sizes = [1, 3, 4097] * 20 + [1 << 20, 5]
    ws, gs, ms, vs = _adam_state(sizes, cuda, seed=t + adamw)
    for group, scale in zip((ws, gs, ms, vs), (1.0, 1e-3, 1e-3, 1e-6)):
        buf = torch.rand(4098, device=cuda) * scale
        group.append(buf[1:])      # contiguous, not 16-byte aligned
    w0 = [x.clone() for x in ws]
    ref = [[x.clone() for x in group] for group in (ws, gs, ms, vs)]
    hp = dict(lr=1e-3, wd=0.01, b1=0.9, b2=0.999, eps=1e-8, t=t,
              adamw=adamw)
    n0 = multi_trainer_adam.launches
    multi_trainer_adam(ws, gs, ms, vs, **hp)
    torch.cuda.synchronize()
    assert multi_trainer_adam.launches == n0 + 1
    multi_trainer_adam_reference(*ref, **hp)
    for got, want in zip((ws, ms, vs), (ref[0], ref[2], ref[3])):
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert not torch.equal(ws[-3], w0[-3]) and not torch.equal(ws[-1], w0[-1])


@pytest.mark.needs_cuda
def test_trainer_adam_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    w = [torch.zeros(8, device=cuda)]
    hp = dict(lr=1e-3, wd=0.0, b1=0.9, b2=0.999, eps=1e-8, t=1)
    with pytest.raises(TypeError, match="float32"):
        multi_trainer_adam([w[0].double()], [w[0].double()],
                           [w[0].double()], [w[0].double()], **hp)
    with pytest.raises(ValueError, match="shape"):
        multi_trainer_adam(w, [torch.zeros(4, device=cuda)], w, w, **hp)
    with pytest.raises(ValueError, match="on"):
        multi_trainer_adam(w, [torch.zeros(8)], w, w, **hp)
    with pytest.raises(ValueError, match="contiguous"):
        strided = torch.zeros(16, device=cuda)[::2]
        multi_trainer_adam([strided], w, w, w, **hp)


def _paged_inputs(S, C, H, D, bs, mb, lengths, device, seed):
    """q and pools drawn on the card, each sequence's table a disjoint
    shuffled set of pool blocks."""
    gen = torch.Generator(device=device).manual_seed(seed)
    nb = S * mb
    q = torch.randn(S, C, H, D, generator=gen, device=device)
    kp = torch.randn(nb, bs, H, D, generator=gen, device=device)
    vp = torch.randn(nb, bs, H, D, generator=gen, device=device)
    perm = torch.randperm(nb, generator=torch.Generator().manual_seed(seed))
    tables = perm.reshape(S, mb).to(torch.int32).to(device)
    lens = torch.tensor(lengths, dtype=torch.int32, device=device)
    return q, kp, vp, tables, lens


@pytest.mark.needs_cuda
@pytest.mark.parametrize("C", [1, 3, 8, 32])
@pytest.mark.parametrize("D", [32, 64, 128])
def test_flash_decode_kernel_matches_plain(cuda, C, D):
    """Ragged lengths: a dead row, one position, block boundaries (16, 48)
    and a full table (64 blocks of 16 = 1024)."""
    from incubator_mxnet_tpu_torch.ops.kernels.flash_decode import (
        paged_flash_decode, paged_flash_decode_reference)
    lengths = [0, 1, 16, 1024, 350, 48, 1023, 17]
    q, kp, vp, tables, lens = _paged_inputs(8, C, 4, D, 16, 64, lengths,
                                            cuda, seed=C * D)
    n0 = paged_flash_decode.launches
    o, m, l = paged_flash_decode(q, kp, vp, tables, lens)
    torch.cuda.synchronize()
    assert paged_flash_decode.launches == n0 + 1
    ro, rm, rl = paged_flash_decode_reference(q, kp, vp, tables, lens)
    assert (o - ro).abs().max().item() <= 2e-5
    assert (m - rm).abs().max().item() <= 1e-5
    torch.testing.assert_close(l, rl, rtol=1e-5, atol=0)
    assert (o[0] == 0).all() and (l[0] == 0).all()
    assert (m[0] == -1e30).all()


@pytest.mark.needs_cuda
def test_flash_decode_kernel_at_the_prefill_shape(cuda):
    from incubator_mxnet_tpu_torch.ops.kernels.flash_decode import (
        paged_flash_decode, paged_flash_decode_reference)
    q, kp, vp, tables, lens = _paged_inputs(1, 32, 12, 64, 16, 64, [480],
                                            cuda, seed=5)
    o, m, l = paged_flash_decode(q, kp, vp, tables, lens)
    ro, rm, rl = paged_flash_decode_reference(q, kp, vp, tables, lens)
    assert (o - ro).abs().max().item() <= 2e-5
    assert (m - rm).abs().max().item() <= 1e-5
    torch.testing.assert_close(l, rl, rtol=1e-5, atol=0)


@pytest.mark.needs_cuda
def test_paged_causal_attention_on_the_card_matches_the_cpu(cuda):
    from incubator_mxnet_tpu_torch.ops.kernels.flash_decode import (
        paged_causal_attention)
    q, kp, vp, tables, lens = _paged_inputs(3, 5, 2, 64, 16, 4, [0, 7, 64],
                                            cuda, seed=9)
    kn, vn = torch.randn_like(q), torch.randn_like(q)
    got = paged_causal_attention(q, kn, vn, kp, vp, tables, lens)
    want = paged_causal_attention(*(t.cpu() for t in (q, kn, vn, kp, vp,
                                                      tables, lens)))
    torch.testing.assert_close(got.cpu(), want, rtol=2e-5, atol=2e-5)


@pytest.mark.needs_cuda
def test_flash_decode_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    from incubator_mxnet_tpu_torch.ops.kernels.flash_decode import (
        paged_flash_decode)
    q, kp, vp, tables, lens = _paged_inputs(2, 1, 2, 64, 16, 2, [3, 5],
                                            cuda, seed=1)
    with pytest.raises(TypeError):
        paged_flash_decode(q.double(), kp.double(), vp.double(), tables, lens)
    with pytest.raises(TypeError, match="int32"):
        paged_flash_decode(q, kp, vp, tables.long(), lens)
    with pytest.raises(ValueError, match="tensor on"):
        paged_flash_decode(q, kp, vp, tables.cpu(), lens)
    strided = torch.randn(2, 1, 2, 128, device=cuda)[..., :64]
    with pytest.raises(ValueError, match="contiguous"):
        paged_flash_decode(strided, kp, vp, tables, lens)
    q48 = torch.randn(2, 1, 2, 48, device=cuda)
    kp48 = torch.randn(4, 16, 2, 48, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        paged_flash_decode(q48, kp48, kp48, tables, lens)


@pytest.mark.needs_cuda
def test_gpt_paged_forward_on_the_card_matches_the_cpu(cuda):
    """A 2-layer GPT through the kernels (LayerNorm and flash decode) against
    the same weights through the plain versions on the CPU: a prefill chunk
    and a decode step over a device-resident paged cache."""
    from incubator_mxnet_tpu_torch.generate import GenerateEngine, GPTPagedLM
    from incubator_mxnet_tpu_torch.models.gpt import GPTDecoder
    from incubator_mxnet_tpu_torch.ops.kernels import launch_counts
    cfg = dict(vocab_size=97, units=128, num_layers=2, num_heads=2,
               max_len=128)
    params = dict(GPTDecoder(device="cpu", seed=4, **cfg).named_parameters())
    outs = {}
    for dev in (cuda, torch.device("cpu")):
        lm = GPTPagedLM(params, cfg, device=dev)
        eng = GenerateEngine(lm, lm.make_cache(2, max_len=128),
                             prefill_chunk=16)
        before = launch_counts()
        outs[dev.type] = eng.generate([list(range(1, 40)), [5, 6]],
                                      max_new_tokens=6)
        after = launch_counts()
        if dev.type == "cuda":
            # prefill: 3 chunks (38 tokens by 16) + 1 (1 token); 6 steps
            assert after["flash_decode"] - before["flash_decode"] == 2 * 10
            assert after["layer_norm"] - before["layer_norm"] == 5 * 10
    assert outs["cuda"] == outs["cpu"]


@pytest.mark.needs_cuda
@pytest.mark.parametrize("T", [16, 520])
def test_bert_on_the_card_matches_the_cpu(cuda, T):
    """A 2-layer BERT through the kernels (softmax below 512, flash from 512
    up) against the same weights through the plain versions on the CPU;
    rtol = atol = 1e-4 over two layers of fp32 in another order."""
    from incubator_mxnet_tpu_torch.models.bert import BERTModel
    from incubator_mxnet_tpu_torch.ops.kernels import launch_counts
    cfg = dict(vocab_size=100, units=64, hidden_size=128, num_layers=2,
               num_heads=2, max_length=600, dropout=0.0)
    cpu = BERTModel(device="cpu", seed=3, **cfg)
    card = BERTModel(device=cuda, **cfg).load_params(
        dict(cpu.named_parameters()))
    gen = torch.Generator().manual_seed(T)
    ids = torch.randint(0, 100, (3, T), generator=gen)
    mask = (torch.arange(T)[None] < torch.tensor([[T], [T // 2], [1]])).float()
    before = launch_counts()
    with torch.inference_mode():
        want = cpu(ids, None, mask)
        got = card(ids.to(cuda), None, mask.to(cuda))
    torch.cuda.synchronize()
    after = launch_counts()
    attn = "flash_attention_fwd" if T >= 512 else "softmax"
    assert after["layer_norm"] - before["layer_norm"] == 5
    assert after[attn] - before[attn] == 2
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-4, atol=1e-4)


@pytest.mark.needs_cuda
@pytest.mark.parametrize("wd", [0.0, 1e-4])
def test_trainer_sgd_mom_kernel_equals_plain_bitwise(cuda, wd):
    """Ragged sizes around the 32768-element chunk (0, 1, 3, 32767, 32768,
    32769), one of 1 M elements and one contiguous view that is not 16-byte
    aligned (the scalar path): w and mom bitwise after two steps."""
    sizes = [0, 1, 3, 32767, 32768, 32769] * 3 + [1 << 20, 5]
    ws, gs, ms, _ = _adam_state(sizes, cuda, seed=11 + int(wd > 0))
    for group, scale in zip((ws, gs, ms), (1.0, 1e-3, 1e-3)):
        buf = torch.rand(4098, device=cuda) * scale
        group.append(buf[1:])
    ref = [[x.clone() for x in group] for group in (ws, gs, ms)]
    w0 = [x.clone() for x in ws]
    hp = dict(lr=0.1, wd=wd, momentum=0.9)
    n0 = multi_trainer_sgd_mom.launches
    for _ in range(2):
        multi_trainer_sgd_mom(ws, gs, ms, **hp)
        multi_trainer_sgd_mom_reference(*ref, **hp)
    torch.cuda.synchronize()
    assert multi_trainer_sgd_mom.launches == n0 + 2
    for got, want in zip((ws, ms), (ref[0], ref[2])):
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert not torch.equal(ws[-1], w0[-1]) and not torch.equal(ws[-3],
                                                                w0[-3])


@pytest.mark.needs_cuda
def test_trainer_sgd_mom_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    w = [torch.zeros(8, device=cuda)]
    hp = dict(lr=0.1, wd=0.0, momentum=0.9)
    with pytest.raises(TypeError, match="float32"):
        multi_trainer_sgd_mom([w[0].double()], [w[0].double()],
                              [w[0].double()], **hp)
    with pytest.raises(ValueError, match="shape"):
        multi_trainer_sgd_mom(w, [torch.zeros(4, device=cuda)], w, **hp)
    with pytest.raises(ValueError, match="on"):
        multi_trainer_sgd_mom(w, w, [torch.zeros(8)], **hp)
    with pytest.raises(ValueError, match="contiguous"):
        strided = torch.zeros(16, device=cuda)[::2]
        multi_trainer_sgd_mom([strided], w, w, **hp)
    assert multi_trainer_sgd_mom([torch.zeros(0, device=cuda)],
                                 [torch.zeros(0, device=cuda)],
                                 [torch.zeros(0, device=cuda)], **hp)


def _bottleneck_inputs(B, H, W, C, M, dtype, device, seed):
    """bench_fused_block's draws: x * 0.5 and weights * 0.05 of x's dtype,
    s in [0.5, 1.5) and b ~ 0.1 N(0, 1) in fp32."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def mk(*shape, scale=0.05):
        return (torch.randn(*shape, generator=gen, device=device)
                * scale).to(dtype)

    def sb(n):
        return (torch.rand(n, generator=gen, device=device) + 0.5,
                torch.randn(n, generator=gen, device=device) * 0.1)
    x = mk(B, H, W, C, scale=0.5)
    w1, (s1, b1) = mk(C, M), sb(M)
    w2, (s2, b2) = mk(9, M, M), sb(M)
    w3, (s3, b3) = mk(M, C), sb(C)
    return x, w1, s1, b1, w2, s2, b2, w3, s3, b3


#: the 16-bit bottleneck's tolerance: 2 steps of the dtype's mantissa at
#: the output's largest magnitude (fp32: 1e-4)
_BLOCK_TOL = {torch.bfloat16: 2 * 2 ** -8, torch.float16: 2 * 2 ** -11}


def _block_err_ok(got, want):
    err = (got.float() - want.float()).abs().max().item()
    if got.dtype == torch.float32:
        return err <= 1e-4
    return err <= _BLOCK_TOL[got.dtype] * want.float().abs().max().item()


@pytest.mark.needs_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16],
                         ids=["fp32", "bf16", "fp16"])
@pytest.mark.parametrize("B,H,W,C,M", [(2, 56, 56, 256, 64),
                                       (3, 13, 11, 64, 16),
                                       (1, 8, 8, 32, 8),
                                       (2, 7, 9, 300, 64),
                                       (1, 1, 3, 5, 1)])
def test_fused_bottleneck_kernel_matches_plain(cuda, dtype, B, H, W, C, M):
    from incubator_mxnet_tpu_torch.ops.kernels.fused_bottleneck import (
        bottleneck_reference, fused_bottleneck)
    args = _bottleneck_inputs(B, H, W, C, M, dtype, cuda, seed=B * H + C)
    n0 = fused_bottleneck.launches
    got = fused_bottleneck(*args)
    torch.cuda.synchronize()
    assert fused_bottleneck.launches == n0 + 1
    want = bottleneck_reference(*args)
    assert got.dtype == dtype and got.shape == want.shape
    assert _block_err_ok(got, want)


@pytest.mark.needs_cuda
@pytest.mark.parametrize("H,W", [(57, 55), (13, 11), (1, 3)])
@pytest.mark.parametrize("C", [5, 64, 256, 300])
@pytest.mark.parametrize("M", [1, 8, 16, 63, 64])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.float16],
                         ids=["bf16", "fp32", "fp16"])
def test_fused_bottleneck_bf16_tensor_cores_match_plain(cuda, H, W, C, M,
                                                        dtype):
    """Both tensor-core kernels on image sizes that are not multiples of
    their 8 x 14 tile, C and M on both sides of each one's 16-byte copies
    (bf16 and fp16: C % 8 and M % 8, two routes each; fp32: C % 4 and
    M % 4 inside the one "fp32" route): bf16 within 2 * 2**-8 of the
    output's max of the plain version, fp16 within 2 * 2**-11, fp32
    (3xTF32) within 1e-4; two calls equal bitwise."""
    from incubator_mxnet_tpu_torch.ops.kernels.fused_bottleneck import (
        _route, bottleneck_reference, fused_bottleneck)
    B = 2 if H * W < 100 else 1
    args = _bottleneck_inputs(B, H, W, C, M, dtype, cuda,
                              seed=H * W + 7 * C + M)
    ptrs = [t.data_ptr() for t in (args[0], args[1], args[4], args[7])]
    if dtype == torch.float32:
        want_route = "fp32"
    else:
        want_route = "bf16" if dtype == torch.bfloat16 else "fp16"
        if C % 8 or M % 8:
            want_route += "_scalar"
    assert _route(dtype, C, M, ptrs + [ptrs[0]]) == want_route
    got = fused_bottleneck(*args)
    again = fused_bottleneck(*args)
    torch.cuda.synchronize()
    want = bottleneck_reference(*args)
    assert got.dtype == dtype and got.shape == want.shape
    assert _block_err_ok(got, want)
    assert torch.equal(got, again)


@pytest.mark.needs_cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "fp16"])
def test_fused_bottleneck_bf16_misaligned_views_take_the_scalar_route(
        cuda, dtype):
    from incubator_mxnet_tpu_torch.ops.kernels.fused_bottleneck import (
        _route, bottleneck_reference, fused_bottleneck)
    args = list(_bottleneck_inputs(2, 9, 15, 64, 16, dtype, cuda, seed=3))
    buf = torch.empty(args[0].numel() + 1, dtype=dtype, device=cuda)
    x = buf[1:].view(args[0].shape)
    x.copy_(args[0])
    args[0] = x
    scalar = ("bf16" if dtype == torch.bfloat16 else "fp16") + "_scalar"
    assert _route(dtype, 64, 16,
                  [x.data_ptr(), args[1].data_ptr(), args[4].data_ptr(),
                   args[7].data_ptr(), args[1].data_ptr()]) == scalar
    got = fused_bottleneck(*args)
    again = fused_bottleneck(*args)
    want = bottleneck_reference(*args)
    assert _block_err_ok(got, want)
    assert torch.equal(got, again)


@pytest.mark.needs_cuda
@pytest.mark.parametrize("C,M", [(256, 64), (300, 63)],
                         ids=["fp16", "fp16_scalar"])
def test_fused_bottleneck_fp16_overflow_is_inf_and_nan_as_plain(cuda, C, M):
    """fp16 on both routes with bn1's scale of channel 0 at 3e5: h1 passes
    65504 and rounds to inf (no saturation), w2 reads that channel with
    weights >= 0 and one zero (the centre tap into h2's channel 0), w3's
    first half of the output channels reads h2 with weights >= 0: the
    output is NaN and inf at the same places as the plain version's, and
    within 2 * 2**-11 of its largest finite magnitude elsewhere."""
    from incubator_mxnet_tpu_torch.ops.kernels.fused_bottleneck import (
        bottleneck_reference, fused_bottleneck)
    args = list(_bottleneck_inputs(2, 16, 16, C, M, torch.float32, cuda,
                                   seed=5))
    args[2][0] = 3e5
    args[4][:, 0, :] = args[4][:, 0, :].abs()
    args[4][4, 0, 0] = 0
    args[7][:, :C // 2] = args[7][:, :C // 2].abs()
    args = [a.half() if i in (0, 1, 4, 7) else a for i, a in enumerate(args)]
    got = fused_bottleneck(*args).float()
    want = bottleneck_reference(*args).float()
    torch.cuda.synchronize()
    assert want.isnan().any() and want.isinf().any()
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(torch.where(got.isinf(), got, 0),
                       torch.where(want.isinf(), want, 0))
    fin = want.isfinite()
    err = (got[fin] - want[fin]).abs().max().item()
    assert err <= 2 * 2 ** -11 * want[fin].abs().max().item()


@pytest.mark.needs_cuda
def test_fused_bottleneck_fp32_misaligned_view_takes_the_4_byte_copies(
        cuda):
    """An fp32 x that starts 4 bytes past a 16-byte boundary (C and M
    multiples of 4) takes the fp32 route's 4-byte copies: within 1e-4 of
    the plain version, two calls equal bitwise."""
    from incubator_mxnet_tpu_torch.ops.kernels.fused_bottleneck import (
        _route, bottleneck_reference, fused_bottleneck)
    args = list(_bottleneck_inputs(2, 9, 15, 64, 16, torch.float32, cuda,
                                   seed=4))
    buf = torch.empty(args[0].numel() + 1, device=cuda)
    x = buf[1:].view(args[0].shape)
    x.copy_(args[0])
    args[0] = x
    assert x.data_ptr() % 16 == 4
    assert _route(torch.float32, 64, 16,
                  [x.data_ptr(), args[1].data_ptr(), args[4].data_ptr(),
                   args[7].data_ptr(), args[1].data_ptr()]) == "fp32"
    got = fused_bottleneck(*args)
    again = fused_bottleneck(*args)
    want = bottleneck_reference(*args)
    assert (got - want).abs().max().item() <= 1e-4
    assert torch.equal(got, again)


@pytest.mark.needs_cuda
def test_fused_bottleneck_wrapper_refuses_what_the_kernel_does_not_take(
        cuda):
    from incubator_mxnet_tpu_torch.ops.kernels.fused_bottleneck import (
        fused_bottleneck)
    args = list(_bottleneck_inputs(1, 4, 4, 8, 4, torch.float32, cuda, 0))
    with pytest.raises(TypeError, match="float32, bfloat16 or float16"):
        fused_bottleneck(*[a.double() for a in args])
    bad = list(args)
    bad[1] = args[1].to(torch.bfloat16)
    with pytest.raises(TypeError, match="w1"):
        fused_bottleneck(*bad)
    bad = list(args)
    bad[4] = torch.zeros(9, 4, 5, device=cuda)
    with pytest.raises(ValueError, match="w2"):
        fused_bottleneck(*bad)
    bad = list(args)
    bad[0] = torch.zeros(1, 4, 8, 4, device=cuda).transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        fused_bottleneck(*bad)
    bad = list(args)
    bad[2] = args[2].cpu()
    with pytest.raises(ValueError, match="s1 on"):
        fused_bottleneck(*bad)
    wide = _bottleneck_inputs(1, 4, 4, 8, 65, torch.float32, cuda, 1)
    with pytest.raises(ValueError, match="M <= 64"):
        fused_bottleneck(*wide)


@pytest.mark.needs_cuda
def test_max_pool_ties_route_to_the_first_maximum(cuda):
    """After the stem's ReLU many 3x3/2 windows hold only zeros: CUDA's
    max-pool gradient, like the CPU's (and JAX's on the CPU), sends each
    window's gradient to its first maximum."""
    from incubator_mxnet_tpu_torch.ops.nn import pooling
    gen = torch.Generator().manual_seed(5)
    x = torch.relu(torch.randn(2, 3, 17, 17, generator=gen))
    x[:, :, 4:9, 4:9] = 0.0
    x[0, 1, 10:13, 10:13] = 0.5
    dy = torch.randn(2, 3, 9, 9, generator=gen)
    grads = []
    for dev in (cuda, torch.device("cpu")):
        xi = x.to(dev).requires_grad_()
        out = pooling(xi, kernel=(3, 3), pool_type="max", stride=(2, 2),
                      pad=(1, 1))
        out.backward(dy.to(dev))
        grads.append(xi.grad.cpu())
    assert torch.equal(grads[0], grads[1])


@pytest.mark.needs_cuda
def test_small_resnet_step_on_the_card_matches_the_cpu(cuda):
    """Two SGD-momentum steps of a small bottleneck ResNet (v1) through
    ShardedTrainer on the card and on the CPU from the same weights: one
    trainer_sgd_mom launch a step, losses within rtol 1e-4, and every
    parameter, momentum and running statistic within 1e-4 of its tensor's
    largest magnitude. A v1 conv bias feeds a BatchNorm, which takes the
    batch mean away: its exact gradient is 0 and both sides hold roundoff
    there, so it (and its momentum) is held to its conv weight's scale."""
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision.resnet import (
        _ResNet, params_from_jax)
    from incubator_mxnet_tpu_torch.ops.kernels import launch_counts
    from incubator_mxnet_tpu_torch.parallel import ShardedTrainer

    def loss(out, lab):
        logp = torch.log_softmax(out.float(), dim=-1)
        return -logp.gather(-1, lab.long()[:, None]).mean()

    def small(dev):
        return _ResNet("bottleneck", [1, 1], [8, 16, 32], preact=False,
                       classes=10, device=dev, seed=3)

    start = {k: v.clone() for k, v in small("cpu").state_dict().items()}
    gen = torch.Generator().manual_seed(0)
    data = torch.rand(4, 3, 32, 32, generator=gen)
    label = torch.randint(0, 10, (4,), generator=gen).float()
    states = {}
    for dev in (cuda, torch.device("cpu")):
        net = params_from_jax(start, small(dev))
        tr = ShardedTrainer(net, loss, optimizer="sgd",
                            optimizer_params={"learning_rate": 0.1,
                                              "momentum": 0.9},
                            device=dev)
        before = launch_counts()
        losses = [float(tr.step(data, label)) for _ in range(2)]
        after = launch_counts()
        if dev.type == "cuda":
            assert after["trainer_sgd_mom"] - before["trainer_sgd_mom"] == 2
            assert tr._fused_launches == 1
        states[dev.type] = (losses, {k: v.cpu() for k, v in
                                     tr.state_dict().items()})
    (lc, sc), (lh, sh) = states["cuda"], states["cpu"]
    torch.testing.assert_close(torch.tensor(lc), torch.tensor(lh),
                               rtol=1e-4, atol=0)
    assert set(sc) == set(sh)
    for k, ref in sh.items():
        if k == "step":
            continue
        if k.endswith(".bias") and not k.endswith("output.bias"):
            ref_scale = sh[k[:-len("bias")] + "weight"]
        else:
            ref_scale = ref
        scale = max(float(ref_scale.abs().max()), 1e-30)
        assert (sc[k] - ref).abs().max().item() <= 1e-4 * scale, k


# ------------------------------------------------ the eager seam's flavours
_FLAT = {
    "sgd_mom": (fused_sgd_mom_flat, fused_sgd_mom_flat_reference, 1,
                dict(lr=0.1, wd=1e-4, momentum=0.9)),
    "adam": (fused_adam_flat, fused_adam_flat_reference, 2,
             dict(lr=1e-3, wd=1e-4, b1=0.9, b2=0.999, eps=1e-8, t=3)),
    "adamw": (fused_adamw_flat, fused_adamw_flat_reference, 2,
              dict(lr=1e-3, wd=1e-2, eta=0.5, b1=0.9, b2=0.999, eps=1e-8,
                   t=3)),
}


def _same_bits(a, b):
    """Equal values, NaN at the same places."""
    na, nb = a.isnan(), b.isnan()
    return torch.equal(na, nb) and torch.equal(a.masked_fill(na, 0),
                                               b.masked_fill(nb, 0))


@pytest.mark.needs_cuda
@pytest.mark.parametrize("flavour", sorted(_FLAT))
@pytest.mark.parametrize("clip", [-1.0, 2e-3], ids=["noclip", "clip"])
def test_flat_kernels_equal_plain_bitwise(cuda, flavour, clip):
    """The eager seam's flavours over one table: sizes 0, 1, 3, 32767,
    32768, 32769, 2**20 and a contiguous view that is not 16-byte aligned,
    rescale 1/128, clip off and on, and a NaN in one gradient; w and its
    states bitwise (NaN at the same places) after two steps."""
    kernel, plain, n_states, hp = _FLAT[flavour]
    sizes = [0, 1, 3, 32767, 32768, 32769, 1 << 20]
    ws, gs, ms, vs = _adam_state(sizes, cuda, seed=21 + len(flavour))
    gs = [g * 1e3 for g in gs]      # O(1): after 1/128 the clip engages
    for group, scale in zip((ws, gs, ms, vs), (1.0, 1.0, 1e-3, 1e-6)):
        buf = torch.rand(4098, device=cuda) * scale
        group.append(buf[1:])
    gs[2][1] = float("nan")
    groups = [ws, gs, ms] + ([vs] if n_states == 2 else [])
    ref = [[x.clone() for x in g] for g in groups]
    w0 = [x.clone() for x in ws]
    n0 = kernel.launches
    for _ in range(2):
        kernel(*groups, rescale=1.0 / 128, clip=clip, **hp)
        plain(*ref, rescale=1.0 / 128, clip=clip, **hp)
    torch.cuda.synchronize()
    assert kernel.launches == n0 + 2
    for i in [0] + list(range(2, len(groups))):
        for a, b in zip(groups[i], ref[i]):
            assert _same_bits(a, b), (flavour, i, a.numel())
    assert ws[2].isnan().any() and not ws[3].isnan().any()
    assert not torch.equal(ws[-1], w0[-1])


@pytest.mark.needs_cuda
def test_flat_sgd_prologue_is_a_no_op_at_rescale_1(cuda):
    """rescale 1 with the clip off changes no bit: the eager flavour and
    the trainer's launch of the same kernel give the same update."""
    ws, gs, ms, _ = _adam_state([5, 40000], cuda, seed=31)
    ref = [[x.clone() for x in g] for g in (ws, gs, ms)]
    fused_sgd_mom_flat(ws, gs, ms, 0.1, 1e-4, 0.9, 1.0, -1.0)
    multi_trainer_sgd_mom(*ref, lr=0.1, wd=1e-4, momentum=0.9)
    torch.cuda.synchronize()
    for a, b in zip(ws + ms, ref[0] + ref[2]):
        assert torch.equal(a, b)


@pytest.mark.needs_cuda
def test_flat_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    w = [torch.zeros(8, device=cuda)]
    hp = dict(lr=0.1, wd=0.0, momentum=0.9, rescale=1.0, clip=-1.0)
    with pytest.raises(ValueError, match="mix"):
        fused_sgd_mom_flat([w[0].bfloat16()], w, [w[0].bfloat16()], **hp)
    with pytest.raises(TypeError, match="float32"):
        fused_sgd_mom_flat([w[0].double()], [w[0].double()],
                           [w[0].double()], **hp)
    with pytest.raises(ValueError, match="contiguous"):
        strided = torch.zeros(16, device=cuda)[::2]
        fused_adam_flat([strided], w, w, w, lr=1e-3, wd=0.0, b1=0.9,
                        b2=0.999, eps=1e-8, t=1, rescale=1.0, clip=-1.0)
    with pytest.raises(ValueError, match="2 g"):
        fused_sgd_mom_flat(w, w + w, w, **hp)


@pytest.mark.needs_cuda
@pytest.mark.parametrize("optimizer", ["sgd", "adam", "adamw"])
def test_eager_gluon_step_on_the_card_matches_the_cpu(cuda, optimizer):
    """Two steps of autograd.record -> backward -> gluon.Trainer.step on a
    small bottleneck ResNet v1 on the card and on the CPU from the same
    weights: one launch of the optimizer's flat kernel a step and none of
    the trainer flavours, and losses within rtol 1e-4. SGD: every parameter
    within 1e-4 of its tensor's largest magnitude (a v1 conv bias, whose
    exact gradient is 0, of its conv weight's). Adam / AdamW normalize each
    element's gradient, so an element whose gradient is roundoff on both
    sides (those conv biases) moves by up to lr a step either way: every
    parameter within 2 * lr * steps, as for BERT's AdamW."""
    import numpy as np
    from incubator_mxnet_tpu_torch import autograd, gluon, init, nd
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision.resnet import (
        _ResNet)
    from incubator_mxnet_tpu_torch.ops.kernels import launch_counts
    hp = {"sgd": {"learning_rate": 0.1, "momentum": 0.9},
          "adam": {"learning_rate": 1e-3},
          "adamw": {"learning_rate": 1e-3, "wd": 0.01}}[optimizer]
    rs = np.random.RandomState(0)
    x = rs.rand(4, 3, 32, 32).astype(np.float32)
    y = rs.randint(0, 10, (4,)).astype(np.float32)
    runs = {}
    for dev in (cuda, torch.device("cpu")):
        np.random.seed(3)
        net = _ResNet("bottleneck", [1, 1], [8, 16, 32], preact=False,
                      classes=10)
        net.initialize(init.Xavier(), ctx=dev)
        tr = gluon.Trainer(net.collect_params(), optimizer, dict(hp))
        loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
        losses = []
        for _ in range(2):
            with autograd.record():
                loss = loss_fn(net(nd.array(x, ctx=dev)),
                               nd.array(y, ctx=dev))
            loss.backward()
            before = launch_counts()
            tr.step(4)
            after = launch_counts()
            if dev.type == "cuda":
                flat = {"sgd": "sgd_mom_flat"}.get(optimizer,
                                                   optimizer + "_flat")
                moved = {k: after[k] - before[k] for k in after
                         if after[k] != before[k]}
                assert moved == {flat: 1}, moved
            losses.append(float(loss.mean().asscalar()))
        runs[dev.type] = (losses, {k: p.data().asnumpy() for k, p in
                                   net._collect_params_with_prefix().items()})
    (lc, pc), (lh, ph) = runs["cuda"], runs["cpu"]
    np.testing.assert_allclose(lc, lh, rtol=1e-4)
    for k, ref in ph.items():
        scale_key = k[:-len("bias")] + "weight" if k.endswith(".bias") \
            and not k.startswith("output") else k
        limit = 1e-4 * max(float(np.abs(ph[scale_key]).max()), 1e-30) \
            if optimizer == "sgd" else 2 * hp["learning_rate"] * 2
        assert np.abs(pc[k] - ref).max() <= limit, k


@pytest.mark.needs_cuda
@pytest.mark.parametrize("optimizer", ["sgd", "adamw"])
def test_two_groups_launch_twice_and_equal_the_per_parameter_rules(
        cuda, optimizer, monkeypatch):
    """gluon.Trainer with wd_mult 0 on the biases: two (lr, wd) groups, so
    two launches of the flat kernel a step; two steps on the card equal,
    bitwise, the same steps with MXTPU_FUSED_OPTIM=0 (the per-parameter
    rules, plain PyTorch on the card)."""
    import numpy as np
    from incubator_mxnet_tpu_torch import autograd, gluon, init, nd
    from incubator_mxnet_tpu_torch.ops.kernels import launch_counts
    hp = {"sgd": {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3,
                  "clip_gradient": 0.5},
          "adamw": {"learning_rate": 1e-3, "wd": 0.01}}[optimizer]
    flat = {"sgd": "sgd_mom_flat", "adamw": "adamw_flat"}[optimizer]
    rs = np.random.RandomState(1)
    x = rs.rand(16, 40).astype(np.float32)
    y = rs.randint(0, 5, (16,)).astype(np.float32)
    runs = []
    for fused in ("1", "0"):
        monkeypatch.setenv("MXTPU_FUSED_OPTIM", fused)
        np.random.seed(2)
        net = gluon.nn.HybridSequential()
        net.add(gluon.nn.Dense(64, activation="relu"), gluon.nn.Dense(5))
        net.initialize(init.Xavier(), ctx=cuda)
        net(nd.array(x, ctx=cuda))
        for p in net.collect_params().values():
            if p.name.endswith("bias"):
                p.wd_mult = 0.0
        tr = gluon.Trainer(net.collect_params(), optimizer, dict(hp))
        before = launch_counts()[flat]
        for _ in range(2):
            with autograd.record():
                loss = gluon.loss.SoftmaxCrossEntropyLoss()(
                    net(nd.array(x, ctx=cuda)), nd.array(y, ctx=cuda))
            loss.backward()
            tr.step(16)
        torch.cuda.synchronize()
        assert launch_counts()[flat] - before == (4 if fused == "1" else 0)
        runs.append([p.data()._t.clone() for p in
                     net.collect_params().values()])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


# ------------------------------------------------------------- int8 matmul
def _int8(shape, gen, device, extremes=False):
    t = torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8)
    if extremes:
        flat = t.view(-1)
        flat[::3] = 127
        flat[1::3] = -127
        flat[2::7] = -128
    return t.to(device)


@pytest.mark.needs_cuda
@pytest.mark.parametrize("M", [1, 3, 8, 16, 17, 128])
def test_int8_matmul_kernel_equals_plain_exactly(cuda, M):
    """Every (K, N) of K in {1, 31, 32, 650, 4096} and N in {1, 7, 128,
    10000} at this M, through both entries: integer sums are exact, so the
    kernel equals its plain version bit for bit; one launch a call."""
    from incubator_mxnet_tpu_torch.ops.kernels.int8_matmul import (
        int8_matmul, int8_matmul_nk, int8_matmul_nk_reference,
        int8_matmul_reference)
    gen = torch.Generator().manual_seed(M)
    for K in (1, 31, 32, 650, 4096):
        for N in (1, 7, 128, 10000):
            a, w = _int8((M, K), gen, cuda), _int8((N, K), gen, cuda)
            n0 = int8_matmul.launches
            got = int8_matmul_nk(a, w)
            got_kn = int8_matmul(a, w.t().contiguous())
            torch.cuda.synchronize()
            assert int8_matmul.launches == n0 + 2
            assert got.dtype == torch.int32 and got.shape == (M, N)
            want = int8_matmul_nk_reference(a, w)
            assert torch.equal(got, want), (M, K, N)
            assert torch.equal(got_kn, int8_matmul_reference(
                a, w.t().contiguous())), (M, K, N)


@pytest.mark.needs_cuda
@pytest.mark.parametrize("M,K,N", [(8, 656, 10000), (8, 650, 10000),
                                   (33, 64, 300), (130, 4096, 129)])
def test_int8_matmul_kernel_at_the_extremes_and_on_misaligned_views(
        cuda, M, K, N):
    """+-127 and -128 everywhere (sums near the int32 range's scale), and
    operands whose data start 1 byte past a 16-byte boundary, which take the
    kernel's byte-wide loads instead of its 16-byte copies."""
    from incubator_mxnet_tpu_torch.ops.kernels.int8_matmul import (
        int8_matmul_nk, int8_matmul_nk_reference)
    gen = torch.Generator().manual_seed(K)
    a, w = _int8((M, K), gen, cuda, True), _int8((N, K), gen, cuda, True)
    assert torch.equal(int8_matmul_nk(a, w), int8_matmul_nk_reference(a, w))
    buf_a = torch.empty(M * K + 1, dtype=torch.int8, device=cuda)
    buf_w = torch.empty(N * K + 1, dtype=torch.int8, device=cuda)
    ma = buf_a[1:].view(M, K)
    mw = buf_w[1:].view(N, K)
    ma.copy_(a)
    mw.copy_(w)
    assert ma.data_ptr() % 16 == 1 and ma.is_contiguous()
    got = int8_matmul_nk(ma, mw)
    torch.cuda.synchronize()
    assert torch.equal(got, int8_matmul_nk_reference(a, w))


@pytest.mark.needs_cuda
def test_int8_matmul_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    from incubator_mxnet_tpu_torch.ops.kernels.int8_matmul import (
        K_MAX, int8_matmul, int8_matmul_nk)
    a = torch.zeros(4, 32, dtype=torch.int8, device=cuda)
    w = torch.zeros(8, 32, dtype=torch.int8, device=cuda)
    n0 = int8_matmul.launches
    with pytest.raises(TypeError, match="int8"):
        int8_matmul_nk(a.float(), w)
    with pytest.raises(TypeError, match="int8"):
        int8_matmul_nk(a, w.int())
    with pytest.raises(ValueError, match="contraction"):
        int8_matmul_nk(a, w[:, :16].contiguous())
    with pytest.raises(ValueError, match="2-D"):
        int8_matmul_nk(a[None], w)
    with pytest.raises(ValueError, match="2-D"):
        int8_matmul(a, w[0])
    with pytest.raises(ValueError, match="contiguous"):
        int8_matmul_nk(a[:, ::2], w[:, :16].contiguous())
    with pytest.raises(ValueError, match="on cpu"):
        int8_matmul_nk(a, w.cpu())
    with pytest.raises(ValueError, match="unsupported device"):
        int8_matmul_nk(a.cpu(), w)
    big = torch.zeros(1, K_MAX + 1, dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="overflow"):
        int8_matmul_nk(big, big)
    assert int8_matmul.launches == n0


@pytest.mark.needs_cuda
@pytest.mark.parametrize("M", [17, 64, 65, 128, 129, 300])
def test_int8_matmul_tma_route_equals_plain_exactly(cuda, M):
    """M > 16 with aligned operands and K % 16 == 0 takes the wgmma + TMA
    route: every (K, N) of K in {16, 656, 4000, 4096} and N in {8, 129,
    256, 10000} (ragged edges of the 128 x 256 tile in M, N and K) equals
    the plain version bit for bit."""
    from incubator_mxnet_tpu_torch.ops.kernels.int8_matmul import (
        _route, int8_matmul, int8_matmul_nk, int8_matmul_nk_reference)
    gen = torch.Generator().manual_seed(1000 + M)
    for K in (16, 656, 4000, 4096):
        for N in (8, 129, 256, 10000):
            a, w = _int8((M, K), gen, cuda), _int8((N, K), gen, cuda)
            assert _route(M, K, a.data_ptr(), w.data_ptr()) == "tma"
            n0 = int8_matmul.launches
            got = int8_matmul_nk(a, w)
            torch.cuda.synchronize()
            assert int8_matmul.launches == n0 + 1
            assert torch.equal(got, int8_matmul_nk_reference(a, w)), (M, K, N)


@pytest.mark.needs_cuda
def test_int8_matmul_tma_route_at_4096_cubed(cuda):
    from incubator_mxnet_tpu_torch.ops.kernels.int8_matmul import (
        _route, int8_matmul_nk, int8_matmul_nk_reference)
    gen = torch.Generator().manual_seed(4096)
    a, w = _int8((4096, 4096), gen, cuda), _int8((4096, 4096), gen, cuda)
    assert _route(4096, 4096, a.data_ptr(), w.data_ptr()) == "tma"
    assert torch.equal(int8_matmul_nk(a, w), int8_matmul_nk_reference(a, w))


@pytest.mark.needs_cuda
def test_int8_matmul_tma_route_at_the_longest_contraction(cuda):
    """K = 131056, the largest multiple of 16 under K_MAX, at M = N = 128:
    +-127 and -128 codes, then every code -128, whose sums (128^2 K) come
    within 0.02 % of the int32 range."""
    from incubator_mxnet_tpu_torch.ops.kernels.int8_matmul import (
        K_MAX, _route, int8_matmul_nk, int8_matmul_nk_reference)
    K = K_MAX - K_MAX % 16
    assert K == 131056
    gen = torch.Generator().manual_seed(K)
    a, w = _int8((128, K), gen, cuda, True), _int8((128, K), gen, cuda, True)
    assert _route(128, K, a.data_ptr(), w.data_ptr()) == "tma"
    assert torch.equal(int8_matmul_nk(a, w), int8_matmul_nk_reference(a, w))
    low = torch.full((128, K), -128, dtype=torch.int8, device=cuda)
    got = int8_matmul_nk(low, low)
    assert torch.equal(got, int8_matmul_nk_reference(low, low))
    assert int(got[0, 0]) == 128 * 128 * K


@pytest.mark.needs_cuda
@pytest.mark.parametrize("M,K,N,offset,route", [
    (8, 656, 10000, 0, "small"), (16, 656, 10000, 0, "small"),
    (8, 656, 10000, 1, "small"), (17, 656, 10000, 0, "tma"),
    (17, 656, 10000, 1, "bytes"), (130, 650, 129, 0, "bytes"),
    (300, 4096, 256, 1, "bytes"), (64, 4096, 256, 16, "tma")])
def test_int8_matmul_routes_on_views(cuda, M, K, N, offset, route):
    """Operands whose data start `offset` bytes into a buffer: the wrapper's
    route follows the alignment and K, and every route equals the plain
    version exactly."""
    from incubator_mxnet_tpu_torch.ops.kernels.int8_matmul import (
        _route, int8_matmul_nk, int8_matmul_nk_reference)
    gen = torch.Generator().manual_seed(M * K + offset)
    a, w = _int8((M, K), gen, cuda, True), _int8((N, K), gen, cuda, True)
    va = torch.empty(M * K + offset, dtype=torch.int8,
                     device=cuda)[offset:].view(M, K)
    vw = torch.empty(N * K + offset, dtype=torch.int8,
                     device=cuda)[offset:].view(N, K)
    va.copy_(a)
    vw.copy_(w)
    assert _route(M, K, va.data_ptr(), vw.data_ptr()) == route
    got = int8_matmul_nk(va, vw)
    torch.cuda.synchronize()
    assert torch.equal(got, int8_matmul_nk_reference(a, w))


@pytest.mark.needs_cuda
@pytest.mark.parametrize("M", list(range(1, 17)))
def test_int8_matmul_small_route_equals_plain_at_the_extremes(cuda, M):
    """The small route (K split over a cluster of 1, 2, 4 or 8 blocks) bit
    for bit at every K of 16, 48, 100, 192, 200, 640, 656 and 2000 (100 on
    the byte-wide loads: K % 16 != 0) and N of 8, 65 and 10000, on the
    extreme codes (+-127 and -128), one launch a call."""
    from incubator_mxnet_tpu_torch.ops.kernels.int8_matmul import (
        _route, int8_matmul, int8_matmul_nk, int8_matmul_nk_reference)
    gen = torch.Generator().manual_seed(2000 + M)
    for K in (16, 48, 100, 192, 200, 640, 656, 2000):
        for N in (8, 65, 10000):
            a = _int8((M, K), gen, cuda, extremes=True)
            w = _int8((N, K), gen, cuda, extremes=True)
            assert _route(M, K, a.data_ptr(), w.data_ptr()) == "small"
            n0 = int8_matmul.launches
            got = int8_matmul_nk(a, w)
            torch.cuda.synchronize()
            assert int8_matmul.launches == n0 + 1
            assert torch.equal(got, int8_matmul_nk_reference(a, w)), (M, K, N)


@pytest.mark.needs_cuda
def test_int8_matmul_c_entry_refuses_a_route_whose_conditions_fail(cuda):
    """The small route above 16 rows, the tma route on a misaligned base or
    K % 16 != 0, and an unknown route code are refused before any launch."""
    from incubator_mxnet_tpu_torch.ops.kernels import _build
    from incubator_mxnet_tpu_torch.ops.kernels.int8_matmul import ROUTES
    a = torch.zeros(17, 656, dtype=torch.int8, device=cuda)
    w = torch.zeros(64, 656, dtype=torch.int8, device=cuda)
    c = torch.empty(17, 64, dtype=torch.int32, device=cuda)
    lib = _build.library()
    stream = torch.cuda.current_stream(cuda).cuda_stream
    for (M, K, ap, route) in ((17, 656, a.data_ptr(), ROUTES["small"]),
                              (17, 656, a.data_ptr() + 1, ROUTES["tma"]),
                              (17, 650, a.data_ptr(), ROUTES["tma"]),
                              (17, 656, a.data_ptr(), 3)):
        rc = lib.mxtpu_int8_matmul_nk(ap, w.data_ptr(), c.data_ptr(), M, 64,
                                      K, route, cuda.index, stream)
        assert rc != 0, (M, K, route)


def _lstm_served(tmp_path, quantize, device):
    """A small tied word LM (vocab 300, 50 x 2: K = 50 is padded to 64 in
    the int8 head), exported from uniform(-0.3, 0.3) weights of
    RandomState(0) and loaded by the lstm_lm family on ``device``."""
    import numpy as np
    from incubator_mxnet_tpu_torch import init
    from incubator_mxnet_tpu_torch.models import RNNModel
    from incubator_mxnet_tpu_torch.serving import (export_for_serving,
                                                   load_served_model)
    cfg = dict(mode="lstm", vocab_size=300, num_embed=50, num_hidden=50,
               num_layers=2, tie_weights=True)
    d = tmp_path / "lm"
    if not d.exists():
        m = RNNModel(dropout=0.0, **cfg)
        m.initialize(init.Zero(), ctx="cpu")
        rs = np.random.RandomState(0)
        for _, p in sorted(m._collect_params_with_prefix().items()):
            p.set_data(rs.uniform(-0.3, 0.3, p.shape).astype(np.float32))
        export_for_serving(str(d), "lstm_lm", cfg, m)
    return load_served_model(str(d), quantize=quantize, device=device)


@pytest.mark.needs_cuda
@pytest.mark.parametrize("quantize", [False, True], ids=["fp32", "int8"])
def test_lstm_lm_family_on_the_card_matches_the_cpu(cuda, tmp_path,
                                                    quantize):
    """The family's DecodeLoop on the card, then the same grid on the CPU
    with the card's tokens forced (requests queued before each loop starts,
    and no eos: both grids admit and retire alike). At every step, every
    active slot's card argmax has a CPU logit within 1e-3 of its row's max;
    in int8 widened by 2 * 127 output units (x_amax * w_amax / 127**2, with
    x_amax < 1 for an LSTM's h): an activation code that the two devices'
    roundoff puts on either side of a rounding boundary moves a logit by
    its weight code, at most 127 units. int8: one int8_matmul launch a step,
    and none in fp32."""
    import numpy as np
    from incubator_mxnet_tpu_torch.ops.kernels import (launch_counts,
                                                       reset_launch_counts)
    from incubator_mxnet_tpu_torch.serving import DecodeLoop, DecodeRequest
    card = _lstm_served(tmp_path, quantize, cuda)
    host = _lstm_served(tmp_path, quantize, "cpu")
    prompts = [[1], [5, 9, 2, 77], list(range(10, 30)), [299, 0, 3],
               [42] * 9, [7, 8]]
    card_log, host_log = [], []

    def record(tokens, cache, active):
        out = card.step_fn(tokens, cache, active)
        card_log.append((tokens.copy(), active.copy(), out))
        return out

    def forced(tokens, cache, active):
        t, a, _ = card_log[len(host_log)]
        assert (a == active).all()
        host_log.append(host.step_fn(t, cache, a))
        return host_log[-1]

    for fn, served in ((record, card), (forced, host)):
        loop = DecodeLoop("lm", fn, served.make_cache(3, 64))
        reqs = [loop.submit(DecodeRequest("lm", p, max_new_tokens=8))
                for p in prompts]
        if fn is record:
            reset_launch_counts()
        loop.start()
        try:
            for r in reqs:
                r.wait(120.0)
        finally:
            loop.stop()
        if fn is record:
            torch.cuda.synchronize()
            counts = launch_counts()
    steps = len(card_log)
    assert steps == len(host_log) > 0
    assert counts == dict.fromkeys(counts, 0) | {
        "int8_matmul": steps if quantize else 0}
    tol = 1e-3
    if quantize:
        tol += 2 * 127 * host.int8_head.w_amax / 127.0 ** 2
    for (_t, a, card_out), cpu_out in zip(card_log, host_log):
        for s in np.flatnonzero(a):
            tok = int(np.argmax(card_out[s]))
            assert cpu_out[s].max() - cpu_out[s][tok] <= tol


# ------------------------------------------- the learned kv_bias's cotangent
@pytest.mark.needs_cuda
@pytest.mark.parametrize("T", [1, 63, 64, 100, 512, 777])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_dkv_dbias_kernel_matches_plain(cuda, T, D, causal):
    """The dK/dV kernel's dbias variant against the plain backward's
    formulas in float64: dk and dv within 2e-5 and bitwise equal to the
    variant without dbias, dbias within 2e-5 / scale; a row of keys all
    masked and a half-masked row give dbias exactly 0 at their masked keys;
    one launch of the variant, none of the plain dK/dV kernel."""
    BH = 6
    gen = torch.Generator(device=cuda).manual_seed(T * D + causal + 7)
    q, k, v, do = (torch.randn(BH, T, D, generator=gen, device=cuda)
                   for _ in range(4))
    bias = torch.randn(BH, T, generator=gen, device=cuda)
    bias[0] = -1e30
    bias[1, T // 2:] = -1e30
    scale = 1.0 / math.sqrt(D)
    out, lse = flash_attention_forward(q, k, v, bias, scale, causal)
    delta = (do * out).sum(dim=-1)
    n0 = (flash_attention_bwd_dkv.launches,
          flash_attention_bwd_dkv_dbias.launches)
    dk, dv, db = flash_attention_bwd_dkv_dbias(q, k, v, do, lse, delta, bias,
                                               scale, causal)
    torch.cuda.synchronize()
    assert (flash_attention_bwd_dkv.launches,
            flash_attention_bwd_dkv_dbias.launches) == (n0[0], n0[1] + 1)
    dk0, dv0 = flash_attention_bwd_dkv(q, k, v, do, lse, delta, bias, scale,
                                       causal)
    assert torch.equal(dk, dk0) and torch.equal(dv, dv0)
    want = flash_attention_backward_reference(q, k, v, out, lse, do, bias,
                                              scale, causal,
                                              needs_dbias=True,
                                              compute_dtype=torch.float64)
    assert db.shape == (BH, T) and torch.isfinite(db).all()
    assert (dk - want[1]).abs().max().item() <= 2e-5
    assert (dv - want[2]).abs().max().item() <= 2e-5
    assert (db - want[3]).abs().max().item() <= 2e-5 / scale
    assert (db[0] == 0).all() and (db[1, T // 2:] == 0).all()


@pytest.mark.needs_cuda
@pytest.mark.parametrize("form", ["bht", "bt_causal"])
def test_flash_autograd_with_learned_kv_bias_matches_the_cpu(cuda, form):
    """flash_attention with a learned kv_bias ((B, H, T), or (B, T) with
    causal=True) and a padding mask, under autograd, on the card and on the
    CPU from the same inputs: q, k, v and kv_bias gradients within 1e-4 of
    each tensor's max, a padded key's bias gradient exactly 0, and one
    dbias launch per backward."""
    B, H, T, D = 2, 3, 200, 64
    causal = form == "bt_causal"
    gen = torch.Generator().manual_seed(12 + causal)
    q, k, v = (torch.randn(B, H, T, D, generator=gen) for _ in range(3))
    kb = torch.randn(*((B, T) if causal else (B, H, T)), generator=gen)
    mask = (torch.arange(T)[None] < torch.tensor([[T], [150]])).float()
    g = torch.randn(B, H, T, D, generator=gen)
    grads = {}
    for dev in (cuda, torch.device("cpu")):
        leaves = [t.to(dev).requires_grad_() for t in (q, k, v, kb)]
        n0 = flash_attention_bwd_dkv_dbias.launches
        out = flash_attention(*leaves[:3], causal=causal,
                              kv_mask=mask.to(dev), kv_bias=leaves[3])
        out.backward(g.to(dev))
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert flash_attention_bwd_dkv_dbias.launches == n0 + 1
        grads[dev.type] = [t.grad.cpu() for t in leaves]
    for got, want in zip(grads["cuda"], grads["cpu"]):
        scale = want.abs().max().item()
        assert (got - want).abs().max().item() <= 1e-4 * scale
    assert (grads["cuda"][3][1][..., 150:] == 0).all()



def _backward_against_fp64(cuda, q, k, v, do, bias, causal=False,
                           dbias=False):
    """The forward, then the dQ and the dK/dV kernel (with dbias when asked)
    on the card, held to the plain formulas in float64: dq, dk, dv within
    2e-5, dbias within 2e-5 / scale. Returns the kernels' outputs and the
    oracle's."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    out, lse = flash_attention_forward(q, k, v, bias, scale, causal)
    delta = (do * out).sum(dim=-1)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, bias, scale, causal)
    dkv = flash_attention_bwd_dkv_dbias if dbias else flash_attention_bwd_dkv
    got = (dq,) + tuple(dkv(q, k, v, do, lse, delta, bias, scale, causal))
    torch.cuda.synchronize()
    want = flash_attention_backward_reference(
        q, k, v, out, lse, do, bias, scale, causal, needs_dbias=dbias,
        compute_dtype=torch.float64)
    for i, (a, b) in enumerate(zip(got, want)):
        assert torch.isfinite(a).all()
        limit = 2e-5 / scale if i == 3 else 2e-5
        assert (a.double() - b).abs().max().item() <= limit, i
    return got, want


#: the 16-bit backward's rule: 2 * one step of the dtype, of each
#: gradient's largest magnitude (or 1/64 of the three's largest)
_HALF_REL = {torch.bfloat16: 2.0 ** -8, torch.float16: 2.0 ** -11}


def _half_backward(q, k, v, do, bias, causal=False, dbias=False):
    """The forward, then the 16-bit dQ and dK/dV kernels (with dbias when
    asked) through flash_attention_backward, held to the plain version on
    the same 16-bit inputs by the sweeps' rule (dq, dk, dv within 2 * a
    step of the dtype of their largest magnitude, or of 1/64 of the three's
    largest), dbias within 1e-4 of its largest or delta's of the float64
    formulas. Returns the kernels' outputs and the plain version's."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    out, lse = flash_attention_forward(q, k, v, bias, scale, causal)
    got = flash_attention_backward(q, k, v, out, lse, do, bias, scale,
                                   causal, needs_dbias=dbias)
    torch.cuda.synchronize()
    want = flash_attention_backward_reference(q, k, v, out, lse, do, bias,
                                              scale, causal,
                                              needs_dbias=dbias)
    top = max(w.float().abs().max().item() for w in want[:3])
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == q.dtype and torch.isfinite(g.float()).all(), name
        lim = 2 * _HALF_REL[q.dtype] * max(w.float().abs().max().item(),
                                           top / 64)
        assert (g.float() - w.float()).abs().max().item() <= lim, name
    if dbias:
        db64 = flash_attention_backward_reference(
            q, k, v, out, lse, do, bias, scale, causal, needs_dbias=True,
            compute_dtype=torch.float64)[3]
        delta = (do.float() * out.float()).sum(dim=-1)
        assert got[3].dtype == torch.float32
        assert (got[3] - db64).abs().max().item() <= 1e-4 * max(
            db64.abs().max().item(), delta.abs().max().item())
    return got, want


@pytest.mark.needs_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("T, D, causal", [(100, 32, False), (512, 64, True),
                                          (777, 128, False)])
def test_flash_backward_two_calls_are_bitwise_equal(cuda, T, D, causal,
                                                    dtype):
    """No atomics, one block per output element: the same inputs give the
    same bits, dq, dk, dv and dbias alike, and the dbias variant's dk and dv
    are the plain variant's; in fp32 (held to float64) and through the
    16-bit kernels (held to the plain version on the same inputs)."""
    BH = 4
    gen = torch.Generator(device=cuda).manual_seed(T + D)
    q, k, v, do = (torch.randn(BH, T, D, generator=gen, device=cuda)
                   for _ in range(4))
    bias = torch.randn(BH, T, generator=gen, device=cuda)
    bias[1, T // 3:] = -1e30
    if dtype != torch.float32:
        q, k, v, do = (t.to(dtype) for t in (q, k, v, do))
        first, _ = _half_backward(q, k, v, do, bias, causal, True)
        second, _ = _half_backward(q, k, v, do, bias, causal, True)
        assert all(torch.equal(a, b) for a, b in zip(first, second))
        plain, _ = _half_backward(q, k, v, do, bias, causal)
        assert torch.equal(plain[1], first[1])
        assert torch.equal(plain[2], first[2])
        return
    first, _ = _backward_against_fp64(cuda, q, k, v, do, bias, causal, True)
    second, _ = _backward_against_fp64(cuda, q, k, v, do, bias, causal, True)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    plain, _ = _backward_against_fp64(cuda, q, k, v, do, bias, causal)
    assert torch.equal(plain[1], first[1]) and torch.equal(plain[2], first[2])


_EDGE_LENGTHS = [(T, n) for T in (100, 512, 777)
                 for n in sorted({0, 1, 63, 64, 65, 127, 128, T - 1, T})
                 if n <= T]


@pytest.mark.needs_cuda
@pytest.mark.parametrize("T, n", _EDGE_LENGTHS)
def test_flash_backward_key_lengths_at_tile_edges(cuda, T, n):
    """Samples whose live keys end at, just before and just after a 64-key
    tile edge (the tiles past the last live key are skipped): gradients
    within 2e-5 of float64, a masked key's dk, dv and dbias exactly 0, and a
    sample with no live key gives zero gradients everywhere."""
    BH, D = 3, 64
    gen = torch.Generator(device=cuda).manual_seed(T * 1000 + n)
    q, k, v, do = (torch.randn(BH, T, D, generator=gen, device=cuda)
                   for _ in range(4))
    bias = torch.zeros(BH, T, device=cuda)
    bias[:, n:] = -1e30
    got, _ = _backward_against_fp64(cuda, q, k, v, do, bias, dbias=True)
    dq, dk, dv, db = got
    assert (dk[:, n:] == 0).all() and (dv[:, n:] == 0).all()
    assert (db[:, n:] == 0).all()
    if n == 0:
        assert (dq == 0).all()


@pytest.mark.needs_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_flash_backward_dead_tiles_beside_live_ones(cuda, dtype):
    """Per (b*h) row: a live key tile between dead ones; a single live key
    in the last tile; live keys only in the middle of a tile; and a tile
    whose biases are all -60, very negative but finite, which is not dead:
    it is computed, its dk is non-zero and within 2e-5 of float64 (fp32),
    or within the 16-bit rule of the plain version (bf16, fp16)."""
    BH, T, D = 4, 512, 64
    gen = torch.Generator(device=cuda).manual_seed(99)
    q, k, v, do = (torch.randn(BH, T, D, generator=gen, device=cuda)
                   for _ in range(4))
    bias = torch.full((BH, T), -1e30, device=cuda)
    bias[0, 64:128] = 0.0
    bias[1, T - 1] = 0.5
    bias[2, 200:230] = torch.randn(30, generator=gen, device=cuda)
    bias[3, 128:192] = -60.0
    bias[3, 300:400] = 0.0
    if dtype == torch.float32:
        got, want = _backward_against_fp64(cuda, q, k, v, do, bias,
                                           dbias=True)
    else:
        q, k, v, do = (t.to(dtype) for t in (q, k, v, do))
        got, want = _half_backward(q, k, v, do, bias, dbias=True)
    dq, dk, dv, db = got
    assert db[3, 128:192].abs().max().item() > 0
    if dtype != torch.float16:
        # in fp16 p ~ e^-60 rounds to 0 before the second products, in the
        # plain version as in the kernels: only the fp32 dbias shows it
        assert dk[3, 128:192].abs().max().item() > 0
        assert dv[3, 128:192].abs().max().item() > 0
    assert (dk[0, :64] == 0).all() and (dk[0, 128:] == 0).all()
    assert (db[1, :T - 1] == 0).all() and (dk[1, :T - 1] == 0).all()


@pytest.mark.needs_cuda
@pytest.mark.parametrize("causal", [False, True])
def test_flash_backward_learned_bias_plus_mask(cuda, causal):
    """A learned bias added to a padding mask, as flash_attention builds it
    for kv_bias and kv_mask together: masked keys stay dead (below
    -0.5e30), live keys carry the learned value; dbias within 2e-5 / scale
    of float64 and exactly 0 at masked keys."""
    B, H, T, D = 2, 3, 300, 64
    gen = torch.Generator(device=cuda).manual_seed(7 + causal)
    q, k, v, do = (torch.randn(B * H, T, D, generator=gen, device=cuda)
                   for _ in range(4))
    learned = 2 * torch.randn(B, H, T, generator=gen, device=cuda)
    live = torch.arange(T, device=cuda)[None] < torch.tensor(
        [[T], [130]], device=cuda)
    mask = torch.zeros(B, T, device=cuda).masked_fill(~live, -1e30)
    bias = (learned + mask[:, None, :]).reshape(B * H, T).contiguous()
    got, _ = _backward_against_fp64(cuda, q, k, v, do, bias, causal, True)
    assert (got[3].view(B, H, T)[1][:, 130:] == 0).all()


@pytest.mark.needs_cuda
def test_flash_backward_at_the_ragged_training_shape(cuda):
    """chip_smoke.py's ragged case at (8 * 12, 512, 64): key lengths 512,
    300, 0, 511, 64, 1, 450 and 129, a sample with one live key (whose dk
    comes from rounding noise in dP - delta alone) and one with none."""
    B, H, T, D = 8, 12, 512, 64
    gen = torch.Generator(device=cuda).manual_seed(1234)
    q, k, v, do = (torch.randn(B * H, T, D, generator=gen, device=cuda)
                   for _ in range(4))
    live = torch.arange(T, device=cuda)[None] < torch.tensor(
        [512, 300, 0, 511, 64, 1, 450, 129], device=cuda)[:, None]
    bias = torch.zeros(B, T, device=cuda).masked_fill(~live, -1e30)
    bias = bias[:, None].expand(B, H, T).reshape(B * H, T).contiguous()
    got, _ = _backward_against_fp64(cuda, q, k, v, do, bias, dbias=True)
    assert all((g.view(B, H, T, -1)[2] == 0).all() for g in got[:3])

# ------------------------------------------ the seam's bf16 and fp16 flavours
_FLAT_HALF = {
    torch.bfloat16: {"sgd_mom": fused_sgd_mom_flat_bf16,
                     "adam": fused_adam_flat_bf16,
                     "adamw": fused_adamw_flat_bf16},
    torch.float16: {"sgd_mom": fused_sgd_mom_flat_f16,
                    "adam": fused_adam_flat_f16,
                    "adamw": fused_adamw_flat_f16},
}


def _flat_half_case(cuda, flavour, clip, dtype, plant=None):
    """The 16-bit flavour of one flat kernel over one table: sizes 0, 1, 3,
    7, 8, 9, 32767, 32768, 32769 and 2**20 (tails of every length short of
    a 16-byte access), a view one element (2 bytes) off 16-byte alignment
    (scalar loads) and one 8 elements (16 bytes) in (vector loads), a NaN
    in one gradient, rescale 1/128, the clip off and on, and what ``plant``
    writes into the lists: w and its states bitwise against the 16-bit
    rules tensor by tensor after two steps; the launches are counted on the
    dtype's wrapper, none on the fp32 one. Returns the lists."""
    kernel, plain, n_states, hp = _FLAT[flavour]
    sizes = [0, 1, 3, 7, 8, 9, 32767, 32768, 32769, 1 << 20, 4096, 4096]
    groups32 = _adam_state(sizes, cuda, seed=41 + len(flavour))
    groups32[1] = [x * 1e3 for x in groups32[1]]
    ws, gs, ms, vs = ([x.to(dtype) for x in g] for g in groups32)
    if plant is not None:
        plant(ws, gs, ms, vs)
    for g in (ws, gs, ms, vs):      # the last two become offset views
        for j, off in ((-2, 1), (-1, 8)):
            base = torch.empty(g[j].numel() + off, dtype=dtype, device=cuda)
            base[off:].copy_(g[j])
            g[j] = base[off:]
    assert ws[-2].data_ptr() % 16 == 2 and ws[-1].data_ptr() % 16 == 0
    gs[2][1] = float("nan")
    groups = [ws, gs, ms] + ([vs] if n_states == 2 else [])
    ref = [[x.clone() for x in g] for g in groups]
    half = _FLAT_HALF[dtype][flavour]
    n0 = (kernel.launches, half.launches)
    for step in range(2):
        (kernel if step == 0 else half)(*groups, rescale=1.0 / 128,
                                        clip=clip, **hp)
        plain(*ref, rescale=1.0 / 128, clip=clip, **hp)
    torch.cuda.synchronize()
    assert (kernel.launches, half.launches) == (n0[0], n0[1] + 2)
    for i in [0] + list(range(2, len(groups))):
        for a, b in zip(groups[i], ref[i]):
            assert a.dtype == dtype
            assert _same_bits(a.float(), b.float()), (flavour, i, a.numel())
    assert ws[2].isnan().any()
    if dtype == torch.bfloat16:
        # in fp16, eps = 1e-8 is 0 and a small v can round to 0: Adam's
        # division then gives inf, and NaN a step later, without a NaN
        # gradient (the plain version too; bitwise above)
        assert not ws[3].isnan().any()
    return ws, gs, ms, vs


@pytest.mark.needs_cuda
@pytest.mark.parametrize("flavour", sorted(_FLAT))
@pytest.mark.parametrize("clip", [-1.0, 2e-3], ids=["noclip", "clip"])
def test_flat_bf16_kernels_equal_plain_bitwise(cuda, flavour, clip):
    """The bf16 flavour of each flat kernel (``_flat_half_case``)."""
    _flat_half_case(cuda, flavour, clip, torch.bfloat16)


def _plant_fp16(ws, gs, ms, vs):
    """fp16's edges, in tensors 5 to 7 of ``_flat_half_case``'s lists:
    (5) g, v and the first four w and m 0, the other m +-0.5: eps = 1e-8
    is 0 in fp16, so Adam and AdamW divide 0 by 0 (NaN) and m by 0 (inf);
    (6) the first eight w, m and v fp16 subnormals and g 0 there, so that
    the step's arithmetic stays among the subnormals; (7) |g| 60000 (468
    after 1/128, past 256) on v = 65504 and w, m at 65000 and 60000, so
    that v and SGD's w + mom round past 65504 to inf."""
    f16 = dict(dtype=torch.float16, device=ws[0].device)
    gs[5].zero_()
    vs[5].zero_()
    ws[5][:4] = 0
    ms[5][:4] = 0
    ms[5][4:] = torch.tensor([0.5, -0.5, 0.5, -0.5, 0.5], **f16)
    sub = torch.tensor([2 ** -15, -2 ** -18, 2 ** -24, 3 * 2 ** -20,
                        -2 ** -24, 2 ** -16, -5 * 2 ** -22, 2 ** -14.5],
                       **f16)
    ws[6][:8], ms[6][:8], vs[6][:8] = sub, sub.flip(0), sub.abs()
    gs[6][:8] = 0
    gs[7][:4] = torch.tensor([6e4, -6e4, 6e4, -6e4], **f16)
    vs[7][:4] = 65504
    ws[7][:4] = torch.tensor([65000, -65000, 1, -1], **f16)
    ms[7][:4] = torch.tensor([60000, -60000, 0, 0], **f16)


@pytest.mark.needs_cuda
@pytest.mark.parametrize("flavour", sorted(_FLAT))
@pytest.mark.parametrize("clip", [-1.0, 2e-3], ids=["noclip", "clip"])
def test_flat_f16_kernels_equal_plain_bitwise(cuda, flavour, clip):
    """The fp16 flavour of each flat kernel (``_flat_half_case``) with
    fp16's edges planted (``_plant_fp16``): NaN and inf where eps rounds to
    0 over v = 0 in Adam and AdamW, subnormal w, m and v kept, inf where v
    or SGD's w passes 65504, all bitwise with the plain version."""
    ws, _gs, ms, vs = _flat_half_case(cuda, flavour, clip, torch.float16,
                                      _plant_fp16)
    # after two steps the first step's inf has met a 0 or an inf: NaN
    if flavour != "sgd_mom":
        assert ws[5][:4].isnan().all() and not ws[5].isfinite().any()
        if clip < 0:
            assert vs[7][:2].isinf().all()
    else:
        assert not ws[7][:2].isfinite().any()
    sub = ms[6][:8].float().abs()
    assert ((sub > 0) & (sub < 2 ** -14)).any()


# ---------------------------------------------------------------- mx.rtc
_AXPY = r"""
extern "C" __global__ void axpy(const float *x, float *y, float alpha) {
    int i = threadIdx.x + blockIdx.x * blockDim.x;
    y[i] += alpha * x[i];
}

extern "C" __global__ void saxpy(const float *x, float *y, float alpha) {
    extern __shared__ float smem[];
    int i = threadIdx.x + blockIdx.x * blockDim.x;
    smem[threadIdx.x] = x[i];
    y[i] += alpha * smem[threadIdx.x];
}
"""

_SCALE = r"""
template <typename T>
__global__ void scale(const T *x, T *y, T a, int n) {
    int i = threadIdx.x + blockIdx.x * blockDim.x;
    if (i < n) y[i] = a * x[i];
}

extern "C" __global__ void big_smem(const float *x, float *y, int n) {
    extern __shared__ float buf[];
    for (int i = threadIdx.x; i < n; i += blockDim.x) buf[i] = x[i];
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += blockDim.x) y[i] = buf[n - 1 - i];
}
"""


@pytest.mark.needs_cuda
def test_rtc_reference_axpy_compiles_and_launches(cuda):
    """The reference's own test_cuda_rtc: axpy, then saxpy through dynamic
    shared memory, on nd arrays on mx.gpu(0)."""
    import incubator_mxnet_tpu_torch as mx
    module = mx.rtc.CudaModule(_AXPY)
    axpy = module.get_kernel("axpy", "const float *x, float *y, float alpha")
    x = mx.nd.ones((10,), ctx=mx.gpu(0))
    y = mx.nd.zeros((10,), ctx=mx.gpu(0))
    axpy.launch([x, y, 3.0], mx.gpu(0), (1, 1, 1), (10, 1, 1))
    assert (y.asnumpy() == 3).all() and axpy.launches == 1
    saxpy = module.get_kernel("saxpy", "const float *x, float *y, float alpha")
    saxpy.launch([x, y, 4.0], mx.gpu(0), (1, 1, 1), (10, 1, 1), 10 * 4)
    assert (y.asnumpy() == 7).all()
    saxpy.launch([x, y, 5.0], mx.gpu(0), (2, 1, 1), (5, 1, 1), 5 * 4)
    assert (y.asnumpy() == 12).all() and saxpy.launches == 2


@pytest.mark.needs_cuda
def test_rtc_exports_templates_cache_and_large_shared_memory(cuda):
    """A template instantiation reached through exports, at two types; a
    second module of the same source loads the cached cubin; a kernel with
    64 KB of dynamic shared memory; plain torch tensors as arguments."""
    from incubator_mxnet_tpu_torch import rtc
    exports = ["scale<float>", "scale<double>"]
    first = rtc.CudaModule(_SCALE, exports=exports)
    second = rtc.CudaModule(_SCALE, exports=exports)
    assert second.from_cache and second.cubin == first.cubin
    assert first.cache_path.parent == rtc.CACHE_DIR
    n = 1000
    for name, ctype, dtype in (("scale<float>", "float", torch.float32),
                               ("scale<double>", "double", torch.float64)):
        k = second.get_kernel(name, "const %s *x, %s *y, %s a, int n"
                              % (ctype, ctype, ctype))
        assert k.symbol != name          # the lowered (mangled) name
        x = torch.randn(n, device=cuda, dtype=dtype)
        y = torch.empty_like(x)
        k.launch([x, y, 2.5, n], cuda, ((n + 127) // 128, 1, 1),
                 (128, 1, 1))
        torch.cuda.synchronize()
        assert torch.equal(y, 2.5 * x)
    big = first.get_kernel("big_smem", "const float *x, float *y, int n")
    m = 16384                                     # 64 KB of floats
    x = torch.randn(m, device=cuda)
    y = torch.empty_like(x)
    big.launch([x, y, m], cuda, (1, 1, 1), (256, 1, 1), 4 * m)
    torch.cuda.synchronize()
    assert torch.equal(y, x.flip(0))


@pytest.mark.needs_cuda
def test_rtc_refuses_cpu_arrays_wrong_types_and_bad_source(cuda):
    from incubator_mxnet_tpu_torch import rtc
    k = rtc.CudaModule(_AXPY).get_kernel(
        "axpy", "const float *x, float *y, float alpha")
    x = torch.ones(4, device=cuda)
    with pytest.raises(ValueError, match="is on cpu"):
        k.launch([x.cpu(), x, 1.0], cuda, (1, 1, 1), (4, 1, 1))
    with pytest.raises(TypeError, match="float64"):
        k.launch([x.double(), x, 1.0], cuda, (1, 1, 1), (4, 1, 1))
    with pytest.raises(ValueError, match="GPU context"):
        k.launch([x, x, 1.0], torch.device("cpu"), (1, 1, 1), (4, 1, 1))
    assert k.launches == 0
    with pytest.raises(rtc.RtcError, match="error"):
        rtc.CudaModule('extern "C" __global__ void k( { }')


# ------------------------------- the flash forward on the tensor cores
#: the forward kernel of each input dtype, and one step of each 16-bit one
_FWD = {torch.float32: flash_attention_forward,
        torch.bfloat16: flash_attention_fwd_bf16,
        torch.float16: flash_attention_fwd_f16}
_STEP16 = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10}


def _fwd_against_plain(q, k, v, bias, causal=False):
    """The forward kernel of q's dtype once (one launch of its wrapper),
    held to its plain version: in fp32 out and lse at atol 2e-5; in bf16 or
    fp16 by the 16-bit rule, each element of out within one step of the
    dtype of its own value plus one step of the same attention over |V|
    (p rounds to a neighbouring 16-bit value, against the running max),
    and the fp32 lse within 1e-4. Returns both."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    wrapper = _FWD[q.dtype]
    n0 = wrapper.launches
    got = flash_attention_forward(q, k, v, bias, scale, causal)
    torch.cuda.synchronize()
    assert wrapper.launches == n0 + 1
    want = flash_attention_reference(q, k, v, bias, scale, causal)
    if q.dtype == torch.float32:
        for a, b in zip(got, want):
            assert torch.isfinite(a).all()
            assert (a - b).abs().max().item() <= 2e-5
        return got
    out, lse = got
    assert out.dtype == q.dtype and lse.dtype == torch.float32
    assert torch.isfinite(out.float()).all() and torch.isfinite(lse).all()
    step = _STEP16[q.dtype]
    mass = flash_attention_reference(q, k, v.abs(), bias, scale, causal)[0]
    gap = (out.float() - want[0].float()).abs()
    bad = gap > step * (want[0].float().abs() + mass.float())
    assert not bool(bad.any()), (int(bad.sum()), gap.max().item())
    assert (lse - want[1]).abs().max().item() <= 1e-4
    return got


def _randn(gen, *shape, device):
    return torch.randn(*shape, generator=gen, device=device)


_FWD_DTYPES = pytest.mark.parametrize(
    "dtype", [torch.float32, torch.bfloat16, torch.float16],
    ids=["float32", "bfloat16", "float16"])


@pytest.mark.needs_cuda
@_FWD_DTYPES
@pytest.mark.parametrize("T, n", [(T, n) for T in (512, 777)
                                  for n in (1, 63, 64, 65, 127, 128, 129,
                                            511, 777)
                                  if n <= T])
def test_flash_fwd_key_lengths_at_tile_edges(cuda, T, n, dtype):
    """Live keys ending at, before and after the 32-, 64- and 128-key edges
    of the kernels' stages (the tiles past the last live key are skipped):
    out and lse held to the plain version by _fwd_against_plain's rule of
    the dtype, one row with no live key exact zeros and lse 0."""
    BH, D = 3, 64
    gen = torch.Generator(device=cuda).manual_seed(T * 1000 + n)
    q, k, v = (_randn(gen, BH, T, D, device=cuda).to(dtype)
               for _ in range(3))
    bias = torch.zeros(BH, T, device=cuda)
    bias[:2, n:] = -1e30
    bias[2] = -1e30
    out, lse = _fwd_against_plain(q, k, v, bias)
    assert (out[2] == 0).all() and (lse[2] == 0).all()


@pytest.mark.needs_cuda
@_FWD_DTYPES
@pytest.mark.parametrize("D", [32, 64, 128])
def test_flash_fwd_dead_tiles_beside_live_ones(cuda, D, dtype):
    """Per (b*h) row: a live tile between dead ones; a single live key in
    the last tile; live keys only in the middle of a tile; a tile of -60
    biases beside live keys; and a row whose only keys above -0.5e30 are
    -60 biases: very negative but finite, so not dead. That tile must be
    computed, not skipped: the row's output is a softmax over those keys,
    not zeros."""
    BH, T = 5, 512
    gen = torch.Generator(device=cuda).manual_seed(99 + D)
    q, k, v = (_randn(gen, BH, T, D, device=cuda).to(dtype)
               for _ in range(3))
    bias = torch.full((BH, T), -1e30, device=cuda)
    bias[0, 64:128] = 0.0
    bias[1, T - 1] = 0.5
    bias[2, 200:230] = _randn(gen, 30, device=cuda)
    bias[3, 128:192] = -60.0
    bias[3, 300:400] = 0.0
    bias[4, 128:192] = -60.0
    out, lse = _fwd_against_plain(q, k, v, bias)
    assert out[4].float().abs().max().item() > 0
    assert lse[4].max().item() < -50.0


@pytest.mark.needs_cuda
@_FWD_DTYPES
@pytest.mark.parametrize("causal", [False, True])
def test_flash_fwd_fully_masked_sample_gives_exact_zeros(cuda, causal,
                                                         dtype):
    """chip_smoke.py's ragged serving shape, (8 * 12, 512, 64) with key
    lengths 512, 300, 0, 511, 64, 1, 450 and 129: the sample with no live
    key skips every tile and writes exact zeros and lse 0."""
    B, H, T, D = 8, 12, 512, 64
    gen = torch.Generator(device=cuda).manual_seed(1234 + causal)
    q, k, v = (_randn(gen, B * H, T, D, device=cuda).to(dtype)
               for _ in range(3))
    live = torch.arange(T, device=cuda)[None] < torch.tensor(
        [512, 300, 0, 511, 64, 1, 450, 129], device=cuda)[:, None]
    bias = torch.zeros(B, T, device=cuda).masked_fill(~live, -1e30)
    bias = bias[:, None].expand(B, H, T).reshape(B * H, T).contiguous()
    out, lse = _fwd_against_plain(q, k, v, bias, causal)
    assert (out.view(B, H, T, D)[2] == 0).all()
    assert (lse.view(B, H, T)[2] == 0).all()


@pytest.mark.needs_cuda
@_FWD_DTYPES
@pytest.mark.parametrize("T", [1, 33, 100, 300, 777])
@pytest.mark.parametrize("D", [32, 64, 128])
def test_flash_fwd_causal_with_t_not_a_multiple_of_64(cuda, T, D, dtype):
    """Causal, with a padding mask that kills the first keys of one row (so
    its first query rows see no live key and come out zero) and the last
    keys of another; and causal without a bias."""
    BH = 4
    gen = torch.Generator(device=cuda).manual_seed(T * D + 7)
    q, k, v = (_randn(gen, BH, T, D, device=cuda).to(dtype)
               for _ in range(3))
    bias = _randn(gen, BH, T, device=cuda)
    bias[1, :T // 3] = -1e30
    bias[2, T // 2:] = -1e30
    out, lse = _fwd_against_plain(q, k, v, bias, causal=True)
    assert (out[1, :T // 3] == 0).all() and (lse[1, :T // 3] == 0).all()
    _fwd_against_plain(q, k, v, None, causal=True)


@pytest.mark.needs_cuda
@_FWD_DTYPES
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("D", [32, 64, 128])
def test_flash_fwd_learned_bias_plus_mask(cuda, causal, D, dtype):
    """A learned bias added to a padding mask, as flash_attention builds it
    for kv_bias and kv_mask together; and the public (B, H, T, D) API with
    both against the plain version."""
    B, H, T = 2, 3, 300
    gen = torch.Generator(device=cuda).manual_seed(7 + causal + D)
    q, k, v = (_randn(gen, B, H, T, D, device=cuda).to(dtype)
               for _ in range(3))
    learned = 2 * _randn(gen, B, H, T, device=cuda)
    mask = (torch.arange(T, device=cuda)[None] < torch.tensor(
        [[T], [130]], device=cuda)).float()
    bias = (learned + (1 - mask)[:, None, :] * -1e30).reshape(B * H, T) \
        .contiguous()
    q3, k3, v3 = (t.reshape(B * H, T, D) for t in (q, k, v))
    out, _ = _fwd_against_plain(q3, k3, v3, bias, causal)
    pub = flash_attention(q, k, v, kv_mask=mask, kv_bias=learned,
                          causal=causal)
    assert (pub.float() - out.view(B, H, T, D).float()).abs().max().item() \
        <= 2e-5


@pytest.mark.needs_cuda
@_FWD_DTYPES
@pytest.mark.parametrize("T, D, causal", [(100, 32, False), (512, 64, True),
                                          (777, 128, False)])
def test_flash_fwd_two_calls_are_bitwise_equal(cuda, T, D, causal, dtype):
    """One block per output row and a fixed walk, with a bias and without
    one (in 16 bits: a block a tile, and the persistent grid's walk of
    tiles b, b + grid, ...): the same inputs give the same bits."""
    BH = 4
    gen = torch.Generator(device=cuda).manual_seed(T + D)
    q, k, v = (_randn(gen, BH, T, D, device=cuda).to(dtype)
               for _ in range(3))
    bias = _randn(gen, BH, T, device=cuda)
    bias[1, T // 3:] = -1e30
    for b in (bias, None):
        first = _fwd_against_plain(q, k, v, b, causal)
        second = _fwd_against_plain(q, k, v, b, causal)
        assert all(torch.equal(x, y) for x, y in zip(first, second))


@pytest.mark.needs_cuda
@pytest.mark.parametrize("T, D", [(100, 64), (777, 128), (63, 32),
                                  (512, 64)])
@pytest.mark.parametrize("where", ["past_last_full_tile", "first_rows"])
def test_flash_f16_inf_in_v_stays_in_its_head(cuda, T, D, where):
    """fp16: an inf in one head's V, in a row past its last full key stage
    or in one of its first rows (those a neighbour's stage past T would
    reach if the stages were cut from (B*H*T, D) rows), makes that head's O
    non-finite and leaves every other head's O bit for bit as it was, with
    the persistent grid (no bias) and a block a tile (a bias): the 3-D
    tensor maps fill rows past T with zeros."""
    BH = 4
    gen = torch.Generator(device=cuda).manual_seed(T + D + 1)
    q, k, v = (torch.randn(BH, T, D, generator=gen, device=cuda).half()
               for _ in range(3))
    scale = 1.0 / math.sqrt(D)
    row = T - 1 if where == "past_last_full_tile" else min(3, T - 1)
    bad = v.clone()
    bad[1, row] = float("inf")
    for bias in (None, torch.zeros(BH, T, device=cuda)):
        clean = flash_attention_forward(q, k, v, bias, scale)[0]
        out = flash_attention_forward(q, k, bad, bias, scale)[0]
        torch.cuda.synchronize()
        assert not bool(torch.isfinite(out[1]).all())
        others = [0, 2, 3]
        assert bool(torch.isfinite(out[others]).all())
        assert torch.equal(out[others], clean[others])


# ------------------------------------------------- split-KV flash decode
_DECODE_DTYPES = pytest.mark.parametrize(
    "dtype", [torch.float32, torch.bfloat16, torch.float16],
    ids=["float32", "bfloat16", "float16"])


def _decode_against_plain(q, kp, vp, tables, lens):
    """The decode kernel of q's dtype once (one launch of its wrapper),
    held to its plain version: o within 2e-5 in fp32, and over 16-bit
    pools of q's dtype (read in place, no widening pass) each element of o
    within one step of the dtype of its own value plus 1e-5 (both round o
    once from fp32 sums taken in other orders); m within 1e-5, l within
    rtol 1e-5 (p and its sums stay fp32); a sequence with no past gives o =
    0, m = -1e30 and l = 0 exactly. Returns (o, m, l)."""
    from incubator_mxnet_tpu_torch.ops.kernels.flash_decode import (
        paged_flash_decode, paged_flash_decode_bf16, paged_flash_decode_f16,
        paged_flash_decode_reference)
    wrapper = {torch.float32: paged_flash_decode,
               torch.bfloat16: paged_flash_decode_bf16,
               torch.float16: paged_flash_decode_f16}[q.dtype]
    n0 = wrapper.launches
    o, m, l = paged_flash_decode(q, kp, vp, tables, lens)
    torch.cuda.synchronize()
    assert wrapper.launches == n0 + 1
    ro, rm, rl = paged_flash_decode_reference(q, kp, vp, tables, lens)
    assert o.dtype == q.dtype and torch.isfinite(o.float()).all()
    if q.dtype == torch.float32:
        assert (o - ro).abs().max().item() <= 2e-5
    else:
        gap = (o.float() - ro.float()).abs()
        step = _STEP16[q.dtype]
        assert not bool((gap > step * ro.float().abs() + 1e-5).any()), \
            gap.max().item()
    assert (m - rm).abs().max().item() <= 1e-5
    torch.testing.assert_close(l, rl, rtol=1e-5, atol=0)
    dead = (lens == 0).nonzero().flatten().tolist()
    for s in dead:
        assert (o[s] == 0).all() and (l[s] == 0).all()
        assert (m[s] == -1e30).all()
    return o, m, l


@pytest.mark.needs_cuda
@_DECODE_DTYPES
@pytest.mark.parametrize("bs", [16, 8])
@pytest.mark.parametrize("C", [1, 8, 32, 33])
@pytest.mark.parametrize("D", [32, 64, 128])
def test_flash_decode_split_kv_pasts_and_chunks(cuda, bs, C, D, dtype):
    """A table of 1024 positions (a cluster of four blocks of eight tiles
    for one query row, of eight blocks of four tiles for a chunk) and seven
    sequences, an odd count: pasts of 0, 1, 16, 1023, 1024 (the full
    table), 500 and 33; chunks of 1, 8, 32 and 33 query rows (33 takes two
    query tiles); blocks of 16 and of 8 positions; fp32 q over fp32 pools,
    and 16-bit q over pools of its own dtype, read as they landed (the
    CUDA-core route up to 8 rows, the tensor-core route from 16)."""
    lengths = [0, 1, 16, 1023, 1024, 500, 33]
    q, kp, vp, tables, lens = _paged_inputs(7, C, 2, D, bs, 1024 // bs,
                                            lengths, cuda,
                                            seed=C * D + bs)
    q, kp, vp = q.to(dtype), kp.to(dtype), vp.to(dtype)
    _decode_against_plain(q, kp, vp, tables, lens)


@pytest.mark.needs_cuda
@pytest.mark.parametrize("bs, mb", [(16, 1), (8, 13), (16, 40), (16, 200)])
@pytest.mark.parametrize("C", [1, 32])
def test_flash_decode_splits_of_other_capacities(cuda, bs, mb, C):
    """Capacities that give one block and one stage (16), one block of
    four tiles (104), three or five blocks (640) and eight blocks of
    thirteen tiles each, walked through a three-stage ring (3200); pasts
    from 0 to the full table, five sequences."""
    cap = bs * mb
    lengths = sorted({0, 1, cap // 3, cap - 1, cap})[:5]
    lengths += [cap] * (5 - len(lengths))
    q, kp, vp, tables, lens = _paged_inputs(5, C, 3, 64, bs, mb, lengths,
                                            cuda, seed=cap + C)
    _decode_against_plain(q, kp, vp, tables, lens)


@pytest.mark.needs_cuda
@_DECODE_DTYPES
@pytest.mark.parametrize("S, C", [(8, 1), (1, 32), (3, 33)])
def test_flash_decode_two_calls_are_bitwise_equal(cuda, S, C, dtype):
    """The split depends on the shapes alone and every merge adds in a
    fixed order: two calls on the same inputs give the same bits, over fp32
    pools and over 16-bit pools of q's dtype."""
    lengths = [1024, 700, 0, 1, 350, 511, 200, 777][:S]
    q, kp, vp, tables, lens = _paged_inputs(S, C, 12, 64, 16, 64, lengths,
                                            cuda, seed=S * C)
    q, kp, vp = q.to(dtype), kp.to(dtype), vp.to(dtype)
    first = _decode_against_plain(q, kp, vp, tables, lens)
    second = _decode_against_plain(q, kp, vp, tables, lens)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.needs_cuda
@_DECODE_DTYPES
@pytest.mark.parametrize("C", [1, 32])
def test_flash_decode_long_table_at_d128(cuda, C, dtype):
    """A table of 4096 positions: eight blocks of sixteen tiles, so the
    host asks for the deepest ring; at D = 128 with a chunk's 16-row tiles
    that ring would not fit beside the cluster's partials (fp32 pools), and
    the launch takes a shallower one; 16-bit pools' stages are half the
    size."""
    lengths = [4096, 0, 2500]
    q, kp, vp, tables, lens = _paged_inputs(3, C, 2, 128, 16, 256, lengths,
                                            cuda, seed=4096 + C)
    q, kp, vp = q.to(dtype), kp.to(dtype), vp.to(dtype)
    _decode_against_plain(q, kp, vp, tables, lens)


# ------------------------------------- one CUDA graph per served shape
def _graph_counts(served):
    return {k: served.graph_counts[k] for k in ("captured", "replayed")}


def _within_row_max(got, want, rel=1e-6):
    import numpy as np
    got, want = np.asarray(got), np.asarray(want)
    scale = np.abs(want).reshape(-1, want.shape[-1]).max(axis=1)
    err = np.abs(got - want).reshape(-1, want.shape[-1]).max(axis=1)
    assert (err <= rel * np.maximum(scale, 1e-30)).all(), err.max()
    return float(err.max())


def _bert_served(tmp_path, device, T_max=600, seed=3, generation=None):
    from incubator_mxnet_tpu_torch.models.bert import BERTModel
    from incubator_mxnet_tpu_torch.serving import (export_for_serving,
                                                   load_served_model)
    cfg = dict(vocab_size=100, units=64, hidden_size=128, num_layers=2,
               num_heads=2, max_length=T_max)
    d = tmp_path / "bert"
    if not d.exists():
        for g in range(2):
            m = BERTModel(device="cpu", dropout=0.0, seed=seed + g, **cfg)
            export_for_serving(str(d), "bert_encoder",
                               dict(cfg, emit_seq=True), m)
    return str(d), load_served_model(str(d), device=device,
                                     generation=generation)


@pytest.mark.needs_cuda
@pytest.mark.parametrize("T", [16, 512])
@pytest.mark.parametrize("names", [("token_ids",),
                                   ("token_ids", "token_types",
                                    "valid_mask")])
def test_bert_encode_graph_replays_the_eager_forward(cuda, tmp_path, T,
                                                     names):
    """bert_encoder on the card: the first call of a (rows, bucket, names)
    signature runs eagerly and captures its program, later calls replay it.
    Replays equal the eager forward on the same inputs (within 1e-6 of each
    row's max), and each replay adds one forward's launches to the counts
    (softmax below 512, flash from 512 up)."""
    import numpy as np
    from incubator_mxnet_tpu_torch.ops.kernels import launch_counts
    _d, served = _bert_served(tmp_path, cuda)
    rs = np.random.RandomState(T)
    arrays = {"token_ids": rs.randint(0, 100, (4, T)).astype(np.int32),
              "token_types": rs.randint(0, 2, (4, T)).astype(np.int32),
              "valid_mask": (np.arange(T)[None] < np.array(
                  [[T], [T // 2], [1], [T - 3]])).astype(np.float32)}
    arrays = {k: v for k, v in arrays.items() if k in names}
    first = served.encode_fn(arrays, T)
    assert _graph_counts(served) == {"captured": 1, "replayed": 0}
    before = launch_counts()
    replayed = [served.encode_fn(arrays, T) for _ in range(3)]
    torch.cuda.synchronize()
    after = launch_counts()
    assert _graph_counts(served) == {"captured": 1, "replayed": 3}
    attn = "flash_attention_fwd" if T >= 512 else "softmax"
    delta = {k: after[k] - before[k] for k in after}
    assert delta == dict.fromkeys(delta, 0) | {"layer_norm": 3 * 5,
                                               attn: 3 * 2}
    served.graphs = False
    eager = served.encode_fn(arrays, T)
    served.graphs = True
    for out in [first] + replayed:
        for key in ("pooled", "seq"):
            _within_row_max(out[key], eager[key])


@pytest.mark.needs_cuda
def test_gpt_graphs_replay_eager_and_survive_a_swap(cuda, tmp_path):
    """gpt_decoder on the card: the grid step (gptdecode/s3) and a padded
    prefill chunk (gptprefill/s3xc32) replay the eager forward within 1e-6
    of each row's max, with 2 flash_decode and 5 layer_norm launches a
    replay; a swap to generation 1 (target and draft) recaptures nothing,
    moves no weight, keeps the session's committed prefix, and the next
    step equals a freshly loaded generation 1 on the same cache."""
    import numpy as np
    from incubator_mxnet_tpu_torch.generate import export_gpt_for_serving
    from incubator_mxnet_tpu_torch.models.gpt import GPTDecoder
    from incubator_mxnet_tpu_torch.ops.kernels import launch_counts
    from incubator_mxnet_tpu_torch.serving import (load_generation_params,
                                                   load_served_model)
    cfg = dict(vocab_size=97, units=128, num_layers=2, num_heads=2,
               max_len=128)
    dcfg = dict(cfg, units=64, num_layers=1)
    d = str(tmp_path / "gpt")
    for g in range(2):
        export_gpt_for_serving(d, cfg, GPTDecoder(device="cpu", seed=g, **cfg),
                               draft=GPTDecoder(device="cpu", seed=10 + g,
                                                **dcfg))
    served = load_served_model(d, device=cuda, generation=0)
    cache = served.make_cache(3, 128)
    slot = cache.alloc()
    served.prefill_fn(slot, np.arange(1, 60) % 97, cache)   # 2 chunks
    assert _graph_counts(served) == {"captured": 1, "replayed": 1}
    toks = np.zeros(3, np.int32)
    active = np.zeros(3, bool)
    active[slot] = True

    def step_pair(tok):
        """One step replayed, rolled back, and run eagerly."""
        toks[slot] = tok
        n = int(cache.lengths[slot])
        before = launch_counts()
        got = served.step_fn(toks, cache, active)
        torch.cuda.synchronize()
        after = launch_counts()
        cache.truncate(slot, n)
        served.graphs = False
        want = served.step_fn(toks, cache, active)
        served.graphs = True
        return got, want, {k: after[k] - before[k] for k in after}

    served.step_fn(toks, cache, active)                  # capture
    cache.truncate(slot, int(cache.lengths[slot]) - 1)
    got, want, delta = step_pair(5)
    assert delta == dict.fromkeys(delta, 0) | {"flash_decode": 2,
                                               "layer_norm": 5}
    _within_row_max(got, want)
    captured = _graph_counts(served)["captured"]
    ptrs = [p.data_ptr() for m in (served.model, served.draft)
            for p in m.parameters()]
    params1, _ = load_generation_params(d, 1)
    served.swap_params(params1, 1)
    assert _graph_counts(served)["captured"] == captured
    assert ptrs == [p.data_ptr() for m in (served.model, served.draft)
                    for p in m.parameters()]
    got1, want1, _ = step_pair(7)
    _within_row_max(got1, want1)
    fresh = load_served_model(d, device=cuda, generation=1)
    fresh.graphs = False
    cache.truncate(slot, int(cache.lengths[slot]) - 1)
    toks[slot] = 7
    _within_row_max(got1, fresh.step_fn(toks, cache, active))
    assert not np.allclose(got1, got)


@pytest.mark.needs_cuda
@pytest.mark.parametrize("quantize", [False, True], ids=["fp32", "int8"])
def test_lstm_graph_replays_eager_and_requantizes_in_place(cuda, tmp_path,
                                                           quantize):
    """lstm_lm on the card: the decode/s4 program (with the int8 head in
    it) replays the eager step within 1e-6 of each row's max, logits and
    states; after a swap the graph is not recaptured, no weight or int8
    buffer moves, the head's codes, scale and bias equal a fresh Int8Dense
    of the new decoder weight bit for bit, and the replayed step equals
    the eager one of the new weights."""
    import numpy as np
    from incubator_mxnet_tpu_torch.serving import Int8Dense
    card = _lstm_served(tmp_path, quantize, cuda)
    cache = card.make_cache(4, 16)
    for _ in range(4):
        cache.alloc()
    tokens = np.array([3, 77, 299, 0], np.int32)
    active = np.ones(4, bool)
    card.step_fn(tokens, cache, active)                  # capture

    def pair():
        start = {n: t.clone() for n, t in cache.data.items()}
        got = card.step_fn(tokens, cache, active)
        got_states = {n: t.cpu().numpy() for n, t in cache.data.items()}
        for n, t in cache.data.items():
            t.copy_(start[n])
        card.graphs = False
        want = card.step_fn(tokens, cache, active)
        card.graphs = True
        for n, t in cache.data.items():
            _within_row_max(got_states[n], t.cpu().numpy())
        _within_row_max(got, want)
        return got

    before = pair()
    head = card.int8_head
    captured = _graph_counts(card)["captured"]
    ptrs = [p.data()._t.data_ptr()
            for p in card.model.collect_params().values()]
    if quantize:
        ptrs += [head._qw.data_ptr(), head._w_amax.data_ptr(),
                 head._bias.data_ptr()]
    rs = np.random.RandomState(5)
    new = {n: rs.uniform(-0.3, 0.3, tuple(p.shape)).astype(np.float32)
           for n, p in card.model._collect_params_with_prefix().items()}
    new["decoder.weight"] = new["encoder.weight"]       # tied
    card.swap_params(new, 1)
    assert _graph_counts(card)["captured"] == captured
    after_ptrs = [p.data()._t.data_ptr()
                  for p in card.model.collect_params().values()]
    if quantize:
        after_ptrs += [head._qw.data_ptr(), head._w_amax.data_ptr(),
                       head._bias.data_ptr()]
        dec = card.model.decoder
        fresh = Int8Dense(dec.weight.data()._t, dec.bias.data()._t)
        assert torch.equal(head._qw, fresh._qw)
        assert torch.equal(head._w_amax, fresh._w_amax)
        assert torch.equal(head._bias, fresh._bias)
    assert after_ptrs == ptrs
    assert not np.allclose(pair(), before)


@pytest.mark.needs_cuda
@pytest.mark.parametrize("shape", [(300, 50), (10000, 650), (64, 64)])
def test_int8_dense_requantize_equals_a_fresh_head(cuda, shape):
    """Int8Dense.requantize_ writes the codes (K padding kept zero), the
    amax and the bias of a new weight into the head's own buffers: bit for
    bit a fresh Int8Dense of that weight, and its calls equal the fresh
    head's."""
    from incubator_mxnet_tpu_torch.serving import Int8Dense
    gen = torch.Generator(device=cuda).manual_seed(shape[0])
    w0, w1 = (torch.randn(*shape, generator=gen, device=cuda) * s
              for s in (0.1, 0.7))
    b0, b1 = (torch.randn(shape[0], generator=gen, device=cuda)
              for _ in range(2))
    head = Int8Dense(w0, b0)
    ptrs = (head._qw.data_ptr(), head._w_amax.data_ptr(),
            head._bias.data_ptr())
    head.requantize_(w1, b1)
    fresh = Int8Dense(w1, b1)
    assert ptrs == (head._qw.data_ptr(), head._w_amax.data_ptr(),
                    head._bias.data_ptr())
    assert torch.equal(head._qw, fresh._qw)
    assert torch.equal(head._w_amax, fresh._w_amax)
    assert torch.equal(head._bias, fresh._bias)
    x = torch.rand(8, shape[1], generator=gen, device=cuda) * 2 - 1
    assert torch.equal(head(x), fresh(x))
    with pytest.raises(ValueError, match="requantize_"):
        head.requantize_(w1[:, :-1], b1)


@pytest.mark.needs_cuda
def test_model_server_deploy_on_the_card_keeps_every_graph(cuda, tmp_path):
    """serve.deploy through a ServingClient against a ModelServer on the
    card: the bert replies follow generation 0, then 1, as the CPU port's
    at each generation (rtol = atol = 1e-4); the deploy recaptures nothing
    and reports its drain, swap and admit milliseconds."""
    import numpy as np
    from incubator_mxnet_tpu_torch.serving import (ModelServer,
                                                   ServingClient,
                                                   load_served_model)
    d, _ = _bert_served(tmp_path, "cpu")
    ids = np.random.RandomState(1).randint(0, 100, (1, 20)).astype(np.int32)
    srv = ModelServer(device=cuda).load("bert", directory=d, generation=0,
                                        buckets=(32,), max_wait_ms=0).start()
    try:
        with ServingClient(srv.addr) as c:
            outs = [c.infer("bert", {"token_ids": ids})["pooled"]
                    for _ in range(2)]
            graphs = c.stats()["bert"]["graphs"]
            rep = c.deploy("bert")
            outs.append(c.infer("bert", {"token_ids": ids})["pooled"])
            after = c.stats()["bert"]["graphs"]
    finally:
        srv.stop()
    assert rep["generation"] == 1 and rep["previous"] == 0
    assert all(rep[k] >= 0 for k in ("drain_ms", "swap_ms", "admit_ms"))
    assert after["captured"] == graphs["captured"] == 1
    assert after["replayed"] == graphs["replayed"] + 1
    padded = {"token_ids": np.pad(ids, ((0, 0), (0, 12)))}
    for gen, out in ((0, outs[0]), (0, outs[1]), (1, outs[2])):
        want = load_served_model(d, device="cpu", generation=gen) \
            .encode_fn(padded, 32)["pooled"]
        np.testing.assert_allclose(out, want, rtol=1e-4, atol=1e-4)


def _bert_flops(B, T, units, hidden_size, num_layers):
    """The products of one BERT forward: the projections and feed-forward
    matmuls, attention's QK^T and PV over every key, and the pooler."""
    return num_layers * (2 * B * T * units * (4 * units + 2 * hidden_size)
                         + 4 * B * T * T * units) + 2 * B * units * units


@pytest.mark.needs_cuda
@pytest.mark.parametrize("T", [16, 512])
def test_program_flop_record_includes_the_hand_kernels(cuda, tmp_path,
                                                       monkeypatch, T):
    """Under MXTPU_COSTS=1 a served program's warm-up is counted: the aten
    products through FlopCounterMode and the hand kernels (which launch
    through ctypes) by their formulas, beside their launches. The sum is
    the analytic count of the BERT forward's products; at T = 512 the
    attention products are the flash kernel's, below it aten's."""
    import numpy as np
    from incubator_mxnet_tpu_torch.telemetry import costs
    monkeypatch.setenv("MXTPU_COSTS", "1")
    _d, served = _bert_served(tmp_path, cuda)
    arrays = {"token_ids": np.ones((4, T), np.int32)}
    served.encode_fn(arrays, T)
    (prog,) = served.programs.values()
    cost = prog.cost
    assert cost["flops"] == _bert_flops(4, T, 64, 128, 2)
    assert costs.captured(prog.name)["flops"] == cost["flops"]
    assert costs.captured(prog.name)["samples"] == 4 * T
    kernels = cost["kernels"]
    assert kernels["layer_norm"][:2] == [5, 0.0]
    if T >= 512:
        # two layers of 4 rows x 2 heads, head dim 32: QK^T and PV
        assert kernels["flash_attention_forward"][:2] == [
            2, 2 * 4 * (4 * 2) * T * T * 32]
        assert kernels.keys() == {"layer_norm", "flash_attention_forward"}
    else:
        assert kernels.keys() == {"layer_norm", "softmax"}
        assert cost["kernel_flops"] == 0
    assert cost["bytes"] > sum(k[2] for k in kernels.values()) > 0
    # a replay is not counted again, and counts its launches as before
    served.encode_fn(arrays, T)
    assert prog.cost is cost and _graph_counts(served)["replayed"] == 1
    costs.reset()


@pytest.mark.needs_cuda
def test_replayed_decode_counts_steps_and_spans_once_per_replay(
        cuda, tmp_path, monkeypatch):
    """Telemetry sits around the captured step, never inside it: over
    served decode requests whose steps replay a CUDA graph,
    serving_decode_steps and the decode.step spans move once per grid step
    and token, the capture counts once as a serving compile, and the flash
    decode program's FLOP record carries its kernel."""
    import numpy as np
    from incubator_mxnet_tpu_torch.generate import export_gpt_for_serving
    from incubator_mxnet_tpu_torch.models.gpt import GPTDecoder
    from incubator_mxnet_tpu_torch.serving import ModelServer, ServingClient
    from incubator_mxnet_tpu_torch.telemetry import catalog, costs, tracing
    cfg = dict(vocab_size=97, units=128, num_layers=2, num_heads=2,
               max_len=128)
    d = str(tmp_path / "gpt")
    export_gpt_for_serving(d, cfg, GPTDecoder(device="cpu", seed=1, **cfg))
    srv = ModelServer(device=cuda).load("gpt", directory=d, slots=2,
                                        cache_len=128).start()
    prev = tracing.sample_rate()
    compiles = catalog.compile_events("serving")
    monkeypatch.setenv("MXTPU_COSTS", "1")
    try:
        with ServingClient(srv.addr) as c:
            c.decode("gpt", np.arange(1, 40) % 97, max_new_tokens=3)
            before = c.stats()["gpt"]
            steps0 = catalog.serving_decode_steps.value(model="gpt")
            tracing.set_sample_rate(1.0)
            tids = []
            for n in (1, 9, 33):
                out = c.decode("gpt", np.arange(n) % 97, max_new_tokens=5)
                assert out.shape == (5,)
                tids.append(c.last_trace_id)
            after = c.stats()["gpt"]
    finally:
        tracing.set_sample_rate(prev)
        srv.stop()
    grid = after["decode"]["steps"] - before["decode"]["steps"]
    assert grid == 15
    assert catalog.serving_decode_steps.value(model="gpt") - steps0 == grid
    assert after["graphs"]["replayed"] - before["graphs"]["replayed"] >= grid
    for tid in tids:
        names = [s["name"] for s in tracing.spans_for_trace(tid)]
        assert names.count("decode.step") == 5
        assert names.count("client.decode") == 1
    assert catalog.compile_events("serving") - compiles == \
        after["graphs"]["captured"]
    step = costs.captured("gptdecode/s2")
    assert step is not None and step["flops"] > 0
    costs.reset()


# ------------------------------------------------------------ bf16 flavours
# The bf16 LayerNorm, softmax and flash kernels against their plain versions
# on the same bf16 inputs, element by element where both sides round once:
# LayerNorm and softmax compute in fp32 and round to bf16, so each element
# within one bf16 step (2**-7) of its own value, plus 2**-16 of its row's
# largest for LayerNorm's cancellation and 1e-6 for softmax; the flash
# forward's O also within 2**-7 of the same attention over |V| (each p may
# round to a neighbouring bf16 value). The gradients, whose sums mix dS
# rounded on both sides, within 2 * 2**-8 of their largest magnitude. The
# lse within 1e-4, dead rows exactly 0; float16 raises TypeError, and each
# call counts one launch of its bf16 kernel and none of the fp32 one.

BF16 = torch.bfloat16


def _bf16_close(got, want, what, ref_max=None):
    """Within 2 * 2**-8 of ``ref_max``, by default want's largest
    magnitude (a gradient that is exactly 0, as dq and dk are at T = 1, is
    held to its siblings' scale)."""
    assert got.dtype == BF16, what
    if ref_max is None:
        ref_max = want.float().abs().max().item()
    lim = 2 * 2.0 ** -8 * max(ref_max, 1e-30)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= lim, (what, err, lim)


def _bf16_each(got, want, limit, what):
    """Each element within ``limit`` (broadcast to want's shape)."""
    assert got.dtype == BF16, what
    gap = (got.float() - want.float()).abs()
    out = gap > limit.float().expand_as(gap)
    assert not bool(out.any()), (what, int(out.sum()), gap.max().item())


def _one_step(want, floor):
    """One bf16 step of each element of ``want``, plus ``floor``."""
    return 2.0 ** -7 * want.float().abs() + floor


@pytest.mark.needs_cuda
@pytest.mark.parametrize("rows", [1, 8, 33, 256, 8192])
@pytest.mark.parametrize("C", [768, 96, 770, 33, 1000, 2000])
def test_layer_norm_bf16_kernel_matches_plain(cuda, rows, C):
    """Each route: the 16-byte warp route (C % 8 == 0, at most 1024), its
    scalar form (770, 33, 1000 hold C % 8 != 0) and the long-row block."""
    x, g, b = (t.to(BF16) for t in _ln_inputs(rows, C, cuda))
    n0 = (fused_norm.layer_norm.launches, fused_norm.layer_norm_bf16.launches)
    got = fused_norm.layer_norm(x, g, b)
    torch.cuda.synchronize()
    assert (fused_norm.layer_norm.launches,
            fused_norm.layer_norm_bf16.launches) == (n0[0], n0[1] + 1)
    route = fused_norm._route(C, x.data_ptr(), g.data_ptr(), b.data_ptr(),
                              got.data_ptr(), 2)
    assert route == ("long" if C > 1024 else
                     "warp" if C % 8 == 0 else "warp_scalar"), (C, route)
    want = fused_norm.layer_norm_reference(x, g, b)
    _bf16_each(got, want, _one_step(want, 2.0 ** -16 * want.float().abs()
                                    .amax(dim=-1, keepdim=True)), (rows, C))


@pytest.mark.needs_cuda
def test_layer_norm_bf16_misaligned_view_takes_the_scalar_route(cuda):
    x, g, b = (t.to(BF16) for t in _ln_inputs(64, 768, cuda))
    view = torch.empty(64 * 768 + 1, dtype=BF16, device=cuda)[1:] \
        .view(64, 768)
    view.copy_(x)
    assert view.data_ptr() % 16 == 2
    got = fused_norm.layer_norm(view, g, b)
    assert fused_norm._route(768, view.data_ptr(), g.data_ptr(),
                             b.data_ptr(), got.data_ptr(), 2) == "warp_scalar"
    want = fused_norm.layer_norm_reference(x, g, b)
    _bf16_each(got, want, _one_step(want, 2.0 ** -16 * want.float().abs()
                                    .amax(dim=-1, keepdim=True)), "view")


@pytest.mark.needs_cuda
@pytest.mark.parametrize("shape", [(64, 12, 128, 128), (3, 7), (33, 257),
                                   (2, 2000)])
def test_softmax_bf16_kernel_matches_plain(cuda, shape):
    gen = torch.Generator(device=cuda).manual_seed(sum(shape))
    x = 3 * torch.randn(*shape, generator=gen, device=cuda)
    if len(shape) == 4:             # the padding bias of the T = 128 path
        x[:, :, :, 100:] = -1e30
    x = x.to(BF16)
    n0 = (fused_norm.softmax.launches, fused_norm.softmax_bf16.launches)
    got = fused_norm.softmax(x)
    torch.cuda.synchronize()
    assert (fused_norm.softmax.launches,
            fused_norm.softmax_bf16.launches) == (n0[0], n0[1] + 1)
    want = fused_norm.softmax_reference(x)
    _bf16_each(got, want, _one_step(want, 1e-6), shape)


def _flash_bf16_inputs(BH, T, D, device, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    q, k, v, do = (torch.randn(BH, T, D, generator=gen, device=device)
                   .to(BF16) for _ in range(4))
    bias = torch.zeros(BH, T, device=device)
    bias[0] = -1e30                        # every key of one row masked
    bias[1, T // 2:] = -1e30
    return q, k, v, do, bias


@pytest.mark.needs_cuda
@pytest.mark.parametrize("T", [1, 63, 100, 128, 512, 777])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_bf16_forward_matches_plain(cuda, T, D, causal):
    q, k, v, _do, bias = _flash_bf16_inputs(6, T, D, cuda, T * D + causal)
    scale = 1.0 / math.sqrt(D)
    n0 = (flash_attention_forward.launches, flash_attention_fwd_bf16.launches)
    out, lse = flash_attention_forward(q, k, v, bias, scale, causal)
    again = flash_attention_forward(q, k, v, bias, scale, causal)
    torch.cuda.synchronize()
    assert (flash_attention_forward.launches,
            flash_attention_fwd_bf16.launches) == (n0[0], n0[1] + 2)
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
    ref, ref_lse = flash_attention_reference(q, k, v, bias, scale, causal)
    mass = flash_attention_reference(q, k, v.abs(), bias, scale, causal)[0]
    _bf16_each(out, ref, _one_step(ref, 2.0 ** -7 * mass.float()),
               (T, D, causal))
    assert lse.dtype == torch.float32
    assert (lse - ref_lse).abs().max().item() <= 1e-4
    assert (out[0] == 0).all() and (lse[0] == 0).all()


@pytest.mark.needs_cuda
@pytest.mark.parametrize("T", [1, 63, 100, 128, 512, 777])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_bf16_backward_matches_plain(cuda, T, D, causal):
    q, k, v, do, bias = _flash_bf16_inputs(6, T, D, cuda, T * D + 7)
    scale = 1.0 / math.sqrt(D)
    out, lse = flash_attention_forward(q, k, v, bias, scale, causal)
    n0 = (flash_attention_bwd_dq_bf16.launches,
          flash_attention_bwd_dkv_bf16.launches,
          flash_attention_bwd_dq.launches, flash_attention_bwd_dkv.launches)
    got = flash_attention_backward(q, k, v, out, lse, do, bias, scale,
                                   causal)
    again = flash_attention_backward(q, k, v, out, lse, do, bias, scale,
                                     causal)
    torch.cuda.synchronize()
    assert (flash_attention_bwd_dq_bf16.launches,
            flash_attention_bwd_dkv_bf16.launches,
            flash_attention_bwd_dq.launches,
            flash_attention_bwd_dkv.launches) == (n0[0] + 2, n0[1] + 2,
                                                  n0[2], n0[3])
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = flash_attention_backward_reference(q, k, v, out, lse, do, bias,
                                              scale, causal)
    top = max(w.float().abs().max().item() for w in want)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert torch.isfinite(g.float()).all(), name
        _bf16_close(g, w, (name, T, D, causal),
                    max(w.float().abs().max().item(), top / 64))
        assert (g[0] == 0).all(), name


@pytest.mark.needs_cuda
def test_flash_bf16_autograd_on_the_card_matches_the_cpu(cuda):
    """The public (B, H, T, D) API on bf16 leaves: bf16 gradients through
    the bf16 kernels against the plain versions on the CPU, one sample's
    keys all masked."""
    B, H, T, D = 2, 3, 200, 64
    gen = torch.Generator().manual_seed(12)
    q, k, v, g = (torch.randn(B, H, T, D, generator=gen).to(BF16)
                  for _ in range(4))
    mask = (torch.arange(T)[None] < torch.tensor([[0], [150]])).float()
    grads = {}
    for dev in (cuda, torch.device("cpu")):
        leaves = [t.to(dev).requires_grad_() for t in (q, k, v)]
        out = flash_attention(*leaves, kv_mask=mask.to(dev))
        assert out.dtype == BF16
        out.backward(g.to(dev))
        grads[dev.type] = [t.grad.cpu() for t in leaves]
    for got, want in zip(grads["cuda"], grads["cpu"]):
        _bf16_close(got, want, "autograd")
        assert (got[0] == 0).all()


@pytest.mark.needs_cuda
def test_bf16_wrappers_refuse_what_their_kernels_do_not_take(cuda):
    """Each 16-bit wrapper takes its own dtype only, and the public
    wrappers one dtype across their tensors; fp16 now has kernels of its
    own (the fp16 tests below), a learned bias's gradient on fp16 included:
    it launches the fp16 has_dbias kernel, and the fp16 dbias wrapper
    refuses a bf16 tensor."""
    x = torch.randn(4, 64, device=cuda)
    h, b16 = x.half(), x.to(BF16)
    with pytest.raises(TypeError, match="float16"):
        fused_norm.layer_norm_bf16(h, h[0], h[0])
    with pytest.raises(TypeError, match="float16"):
        fused_norm.softmax_bf16(h)
    with pytest.raises(TypeError, match="one dtype"):
        fused_norm.layer_norm(b16, x[0], x[0])
    with pytest.raises(TypeError, match="one dtype"):
        fused_norm.layer_norm(h, b16[0], b16[0])
    with pytest.raises(ValueError, match="contiguous"):
        fused_norm.layer_norm_bf16(b16.t(), b16[:, 0], b16[:, 0])
    with pytest.raises(TypeError, match="bfloat16"):
        fused_norm.softmax_bf16(x)
    with pytest.raises(TypeError, match="float16"):
        fused_norm.softmax_f16(b16)
    q = torch.randn(2, 16, 64, device=cuda)
    qh, qb = q.half(), q.to(BF16)
    lse = torch.zeros(2, 16, device=cuda)
    with pytest.raises(TypeError, match="float16"):
        flash_attention_fwd_bf16(qh, qh, qh)
    with pytest.raises(TypeError):
        flash_attention_forward(qh, qb, qh)
    with pytest.raises(TypeError):
        flash_attention_forward(qb, q, qb)
    with pytest.raises(TypeError):
        flash_attention_fwd_bf16(q, q, q)
    with pytest.raises(TypeError):
        flash_attention_fwd_f16(qb, qb, qb)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_forward(qb.transpose(0, 1), qb, qb)
    unaligned = torch.empty(2 * 16 * 64 + 1, dtype=BF16,
                            device=cuda)[1:].view(2, 16, 64)
    with pytest.raises(ValueError, match="aligned"):
        flash_attention_forward(unaligned, qb, qb)
    with pytest.raises(ValueError, match="do must be"):
        flash_attention_bwd_dq_bf16(qb, qb, qb, q, qb, lse, None, 0.125,
                                    False)
    with pytest.raises(TypeError):
        flash_attention_bwd_dkv_bf16(qh, qh, qh, qh, lse, lse, None, 0.125,
                                     False)
    with pytest.raises(TypeError):
        flash_attention_bwd_dq_f16(qb, qb, qb, qb, qb, lse, None, 0.125,
                                   False)
    with pytest.raises(TypeError):
        flash_attention_bwd_dq(qb, qb, qb, qb, lse, lse, None, 0.125, False)
    from incubator_mxnet_tpu_torch.ops.kernels.flash_attention import (
        flash_attention_bwd_dkv_dbias_f16)
    n0 = (flash_attention_bwd_dkv_f16.launches,
          flash_attention_bwd_dkv_dbias_f16.launches)
    grads = flash_attention_backward(qh, qh, qh, qh, lse, qh, lse, 0.125,
                                     needs_dbias=True)
    torch.cuda.synchronize()
    assert len(grads) == 4 and grads[3].dtype == torch.float32
    assert (flash_attention_bwd_dkv_f16.launches,
            flash_attention_bwd_dkv_dbias_f16.launches) == (n0[0],
                                                             n0[1] + 1)
    with pytest.raises(TypeError):
        flash_attention_bwd_dkv_dbias_f16(qb, qb, qb, qb, lse, lse, lse,
                                          0.125, False)


# ------------------------------------------------------------ fp16 flavours
# The fp16 LayerNorm, softmax and flash kernels against their plain versions
# on the same fp16 inputs, by the bf16 rules with fp16's step: each element
# of LN, softmax and the forward's O within 2**-10 of its own value plus a
# floor (bf16's divided by 8: 2**-19 of the row's largest for LN, 1.25e-7
# for softmax, 2**-10 of the same attention over |V| for O); dq, dk and dv
# within 2 * 2**-11 of their largest magnitude; the lse within 1e-4; dead
# rows exactly 0; bitwise on two calls; an inf in dO non-finite in every
# gradient (the kernels never saturate); each call one launch of its fp16
# kernel and none of the fp32 or bf16 ones.

F16 = torch.float16


def _f16_each(got, want, limit, what):
    assert got.dtype == F16, what
    gap = (got.float() - want.float()).abs()
    out = gap > limit.float().expand_as(gap)
    assert not bool(out.any()), (what, int(out.sum()), gap.max().item())


def _f16_step(want, floor):
    """One fp16 step of each element of ``want``, plus ``floor``."""
    return 2.0 ** -10 * want.float().abs() + floor


@pytest.mark.needs_cuda
@pytest.mark.parametrize("rows", [1, 7, 33, 8192])
@pytest.mark.parametrize("C", [768, 770, 33, 2000])
def test_layer_norm_f16_kernel_matches_plain(cuda, rows, C):
    x, g, b = (t.half() for t in _ln_inputs(rows, C, cuda))
    n0 = (fused_norm.layer_norm.launches, fused_norm.layer_norm_bf16.launches,
          fused_norm.layer_norm_f16.launches)
    got = fused_norm.layer_norm(x, g, b)
    again = fused_norm.layer_norm(x, g, b)
    torch.cuda.synchronize()
    assert (fused_norm.layer_norm.launches,
            fused_norm.layer_norm_bf16.launches,
            fused_norm.layer_norm_f16.launches) == (n0[0], n0[1], n0[2] + 2)
    assert torch.equal(got, again)
    want = fused_norm.layer_norm_reference(x, g, b)
    _f16_each(got, want, _f16_step(want, 2.0 ** -19 * want.float().abs()
                                   .amax(dim=-1, keepdim=True)), (rows, C))


@pytest.mark.needs_cuda
def test_layer_norm_f16_rounds_past_the_range_to_inf(cuda):
    """An output past 65504 is inf in the kernel as in the plain version's
    ``.to(torch.float16)``: no saturation."""
    x, g, b = (t.half() for t in _ln_inputs(8, 768, cuda))
    g = torch.full_like(g, 60000.0)
    got = fused_norm.layer_norm(x, g, b)
    # the fp32 values before the rounding: fp16 rounds to inf from 65520
    # on; elements within 2**-10 of that edge may land on either side
    # (the sums differ in order), the rest must land where the plain
    # version's do
    v = fused_norm.layer_norm_reference(x.float(), g.float(), b.float())
    over = v.abs() > 65520.0 * (1 + 2.0 ** -10)
    under = v.abs() < 65520.0 * (1 - 2.0 ** -10)
    assert bool(over.any()) and bool(under.any())
    assert bool(torch.isinf(got[over]).all())
    assert bool(torch.isfinite(got[under]).all())
    want = fused_norm.layer_norm_reference(x, g, b)
    assert bool(torch.isinf(want[over]).all())


@pytest.mark.needs_cuda
@pytest.mark.parametrize("shape", [(64, 12, 128, 128), (3, 7), (33, 257),
                                   (2, 2000)])
def test_softmax_f16_kernel_matches_plain(cuda, shape):
    gen = torch.Generator(device=cuda).manual_seed(sum(shape) + 1)
    x = 3 * torch.randn(*shape, generator=gen, device=cuda)
    if len(shape) == 4:             # the padding bias (-inf in fp16)
        x[:, :, :, 100:] = -1e30
    x = x.half()
    n0 = (fused_norm.softmax.launches, fused_norm.softmax_f16.launches)
    got = fused_norm.softmax(x)
    torch.cuda.synchronize()
    assert (fused_norm.softmax.launches,
            fused_norm.softmax_f16.launches) == (n0[0], n0[1] + 1)
    want = fused_norm.softmax_reference(x)
    _f16_each(got, want, _f16_step(want, 1e-6 / 8), shape)


# The 16-bit softmax on each of its routes (fused_norm._softmax_route):
# vec (C <= 1024, C % 8 == 0, x and the output 16-byte aligned), scalar
# (the other rows up to 1024: odd C, or a view one element off a 16-byte
# boundary) and long (C > 1024). Each element within one step of its dtype
# (2**-7 bf16, 2**-10 fp16) of the plain version's value plus the floor
# (1e-6 bf16, 1.25e-7 fp16); a partly -inf row 0 there, an all -inf row
# NaN; bitwise on two calls; each call one launch of the dtype's kernel.
#: dtype -> (one step as a share of the value, the floor)
HALF_SOFTMAX = {BF16: (2.0 ** -7, 1e-6), F16: (2.0 ** -10, 1e-6 / 8)}
HALF_WRAPPER = {BF16: fused_norm.softmax_bf16, F16: fused_norm.softmax_f16}


def _half_softmax_check(x, route, what):
    wrapper = HALF_WRAPPER[x.dtype]
    n0 = (fused_norm.softmax.launches, wrapper.launches)
    got = fused_norm.softmax(x)
    again = fused_norm.softmax(x)
    torch.cuda.synchronize()
    assert (fused_norm.softmax.launches, wrapper.launches) == (n0[0],
                                                              n0[1] + 2)
    C = x.shape[-1]
    assert fused_norm._softmax_route(C, x.data_ptr(), got.data_ptr(),
                                     2) == route, what
    nan = got.isnan()
    assert torch.equal(nan, again.isnan()), what
    assert torch.equal(got.masked_fill(nan, 0), again.masked_fill(nan, 0))
    want = fused_norm.softmax_reference(x)
    assert torch.equal(nan, want.isnan()), what
    step, floor = HALF_SOFTMAX[x.dtype]
    gap = (got.float() - want.float()).abs()[~nan]
    limit = step * want.float().abs()[~nan] + floor
    assert bool((gap <= limit).all()), (what, gap.max().item())
    return got


@pytest.mark.needs_cuda
@pytest.mark.parametrize("dtype", [BF16, F16], ids=["bf16", "f16"])
@pytest.mark.parametrize("C,route", [(1, "scalar"), (7, "scalar"),
                                     (100, "scalar"), (8, "vec"),
                                     (16, "vec"), (24, "vec"), (56, "vec"),
                                     (128, "vec"), (136, "vec"),
                                     (264, "vec"), (520, "vec"),
                                     (1024, "vec"), (1500, "long")])
@pytest.mark.parametrize("rows", [1, 33, 4096])
def test_half_softmax_routes_match_plain(cuda, dtype, C, route, rows):
    """Each route against the plain version. The vec cases reach each of
    its nine instantiations a dtype (csrc/fused_norm.cu
    launch_softmax_vec_bucket), most with lanes of the row's group past its
    end: C = 8 one lane a row, 16 a group of 2, 24 a group of 4 (3 vectors),
    56 a group of 8 (7), 128 a full group of 16, and groups of 32 at 1
    vector a lane (136: 17 vectors), 2 (264: 33), 3 (520: 65) and a full
    4 (1024)."""
    gen = torch.Generator(device=cuda).manual_seed(rows * C)
    x = 3 * torch.randn(rows, C, generator=gen, device=cuda)
    x[0, (C + 1) // 2:] = float("-inf")    # partly -inf: 0 there
    if rows > 1:
        x[rows // 2] = float("-inf")        # all -inf: NaN
    got = _half_softmax_check(x.to(dtype), route, (rows, C))
    if (C + 1) // 2 < C:
        assert bool((got[0, (C + 1) // 2:] == 0).all())
    if rows > 1:
        assert bool(got[rows // 2].isnan().all())


@pytest.mark.needs_cuda
@pytest.mark.parametrize("dtype", [BF16, F16], ids=["bf16", "f16"])
def test_half_softmax_misaligned_view_takes_the_scalar_route(cuda, dtype):
    x = (3 * torch.randn(64, 128, device=cuda)).to(dtype)
    view = torch.empty(64 * 128 + 1, dtype=dtype, device=cuda)[1:] \
        .view(64, 128)
    view.copy_(x)
    assert view.data_ptr() % 16 == 2 and view.is_contiguous()
    _half_softmax_check(view, "scalar", "view")


@pytest.mark.needs_cuda
@pytest.mark.parametrize("C,route", [(128, "vec"), (100, "scalar"),
                                     (1500, "long")])
def test_f16_softmax_keeps_subnormal_probabilities(cuda, C, route):
    """Probabilities of ~6e-6, below fp16's smallest normal 2**-14, are
    fp16 subnormals on every route, as in the plain version: no flush to
    zero on the output."""
    x = torch.zeros(8, C, device=cuda)
    x[:, 0] = 12.0
    got = _half_softmax_check(x.half(), route, C)
    sub = got[:, 1:].float()
    assert bool(((sub > 0) & (sub < 2.0 ** -14)).all())


@pytest.mark.needs_cuda
@pytest.mark.parametrize("dtype", [BF16, F16], ids=["bf16", "f16"])
def test_softmax_c_entry_refuses_a_route_whose_conditions_fail(cuda, dtype):
    """The 16-bit C entries refuse, before any launch, vec for a misaligned
    input or output, C % 8 != 0 or C > 1024; scalar above 1024; long at or
    below it; an unknown route code; and take each route whose conditions
    hold."""
    from incubator_mxnet_tpu_torch.ops.kernels import _build
    entry = getattr(_build.library(), "mxtpu_softmax_" + (
        "bf16" if dtype == BF16 else "f16"))
    stream = torch.cuda.current_stream(cuda).cuda_stream

    def rc(x, y, route):
        return entry(x.data_ptr(), y.data_ptr(), x.shape[0], x.shape[1],
                     route, cuda.index, stream)

    x = torch.randn(8, 128, device=cuda).to(dtype)
    y = torch.empty_like(x)
    off = torch.empty(8 * 128 + 1, dtype=dtype, device=cuda)[1:].view(8, 128)
    odd, wide = (torch.randn(8, c, device=cuda).to(dtype) for c in (100, 1032))
    vec, scalar, long_ = (fused_norm.SOFTMAX_ROUTES[r]
                          for r in ("vec", "scalar", "long"))
    for a, b, route in ((off, y, vec), (x, off, vec),
                        (odd, torch.empty_like(odd), vec),
                        (wide, torch.empty_like(wide), vec),
                        (wide, torch.empty_like(wide), scalar),
                        (x, y, long_), (x, y, 3)):
        assert rc(a, b, route) != 0, (tuple(a.shape), route)
    for a, route in ((x, vec), (x, scalar), (odd, scalar), (wide, long_)):
        assert rc(a, torch.empty_like(a), route) == 0, (tuple(a.shape),
                                                        route)
    torch.cuda.synchronize()
    assert fused_norm.SOFTMAX_ROUTES == {"vec": 0, "scalar": 1, "long": 2}


def _flash_f16_inputs(BH, T, D, device, seed):
    q, k, v, do, bias = _flash_bf16_inputs(BH, T, D, device, seed)
    return tuple(t.half() for t in (q, k, v, do)) + (bias,)


@pytest.mark.needs_cuda
@pytest.mark.parametrize("T", [1, 63, 128, 512, 777])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_f16_forward_matches_plain(cuda, T, D, causal):
    q, k, v, _do, bias = _flash_f16_inputs(6, T, D, cuda, T * D + causal)
    scale = 1.0 / math.sqrt(D)
    n0 = (flash_attention_forward.launches, flash_attention_fwd_bf16.launches,
          flash_attention_fwd_f16.launches)
    out, lse = flash_attention_forward(q, k, v, bias, scale, causal)
    again = flash_attention_forward(q, k, v, bias, scale, causal)
    torch.cuda.synchronize()
    assert (flash_attention_forward.launches,
            flash_attention_fwd_bf16.launches,
            flash_attention_fwd_f16.launches) == (n0[0], n0[1], n0[2] + 2)
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
    ref, ref_lse = flash_attention_reference(q, k, v, bias, scale, causal)
    mass = flash_attention_reference(q, k, v.abs(), bias, scale, causal)[0]
    _f16_each(out, ref, _f16_step(ref, 2.0 ** -10 * mass.float()),
              (T, D, causal))
    assert lse.dtype == torch.float32
    assert (lse - ref_lse).abs().max().item() <= 1e-4
    assert (out[0] == 0).all() and (lse[0] == 0).all()


@pytest.mark.needs_cuda
@pytest.mark.parametrize("T", [1, 63, 128, 512, 777])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_f16_backward_matches_plain(cuda, T, D, causal):
    q, k, v, do, bias = _flash_f16_inputs(6, T, D, cuda, T * D + 7)
    scale = 1.0 / math.sqrt(D)
    out, lse = flash_attention_forward(q, k, v, bias, scale, causal)
    n0 = (flash_attention_bwd_dq_f16.launches,
          flash_attention_bwd_dkv_f16.launches,
          flash_attention_bwd_dq_bf16.launches,
          flash_attention_bwd_dq.launches)
    got = flash_attention_backward(q, k, v, out, lse, do, bias, scale,
                                   causal)
    again = flash_attention_backward(q, k, v, out, lse, do, bias, scale,
                                     causal)
    torch.cuda.synchronize()
    assert (flash_attention_bwd_dq_f16.launches,
            flash_attention_bwd_dkv_f16.launches,
            flash_attention_bwd_dq_bf16.launches,
            flash_attention_bwd_dq.launches) == (n0[0] + 2, n0[1] + 2,
                                                 n0[2], n0[3])
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = flash_attention_backward_reference(q, k, v, out, lse, do, bias,
                                              scale, causal)
    top = max(w.float().abs().max().item() for w in want)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == F16 and torch.isfinite(g.float()).all(), name
        lim = 2 * 2.0 ** -11 * max(w.float().abs().max().item(), top / 64)
        err = (g.float() - w.float()).abs().max().item()
        assert err <= lim, (name, T, D, causal, err, lim)
        assert (g[0] == 0).all(), name
    # an overflowed cotangent (a loss scale past fp16's range) reaches every
    # gradient as inf or NaN, in the kernels as in the plain version
    do_inf = do.clone()
    do_inf[2, T // 2] = float("inf")
    bad = flash_attention_backward(q, k, v, out, lse, do_inf, bias, scale,
                                   causal)
    plain = flash_attention_backward_reference(q, k, v, out, lse, do_inf,
                                               bias, scale, causal)
    for name, g, w in zip(("dq", "dk", "dv"), bad, plain):
        assert not bool(torch.isfinite(g).all()), name
        assert not bool(torch.isfinite(w).all()), name
        assert not bool((g.float().abs() == 65504.0).any()), name


@pytest.mark.needs_cuda
def test_flash_f16_autograd_on_the_card_matches_the_cpu(cuda):
    """The public (B, H, T, D) API on fp16 leaves with an fp16 mask (the
    key bias stays fp32): fp16 gradients through the fp16 kernels against
    the plain versions on the CPU, one sample's keys all masked."""
    B, H, T, D = 2, 3, 200, 64
    gen = torch.Generator().manual_seed(13)
    q, k, v, g = (torch.randn(B, H, T, D, generator=gen).half()
                  for _ in range(4))
    mask = (torch.arange(T)[None] < torch.tensor([[0], [150]])).half()
    grads = {}
    for dev in (cuda, torch.device("cpu")):
        leaves = [t.to(dev).requires_grad_() for t in (q, k, v)]
        out = flash_attention(*leaves, kv_mask=mask.to(dev))
        assert out.dtype == F16
        out.backward(g.to(dev))
        grads[dev.type] = [t.grad.cpu() for t in leaves]
    for got, want in zip(grads["cuda"], grads["cpu"]):
        lim = 2 * 2.0 ** -11 * want.float().abs().max().item()
        assert (got.float() - want.float()).abs().max().item() <= lim
        assert (got[0] == 0).all()


@pytest.mark.needs_cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("T", [1, 63, 128, 512, 777])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_half_dkv_dbias_kernel_matches_plain(cuda, T, D, causal,
                                                   dtype):
    """The bf16 or fp16 dK/dV kernel's dbias variant (the TPU kernel's
    has_dbias on 16-bit inputs), through
    flash_attention_backward(needs_dbias=True): one launch of it and none
    of the dK/dV kernel without dbias; dk and dv bitwise those of the
    variant without dbias and within 2 * 2**-8 (bf16) or 2 * 2**-11 (fp16)
    of the plain version's largest; dbias fp32 within 1e-4 (of its largest
    or of delta's) of the float64 formulas' on the same 16-bit inputs; a
    row of keys all masked and a half-masked (ragged) row give dbias
    exactly 0 at their masked keys; the same bits on two calls. In fp16 an
    inf planted in dO gives non-finite dk, dv and dbias, never 65504 (dS
    rounds by cvt.rn, which does not saturate)."""
    from incubator_mxnet_tpu_torch.ops.kernels.flash_attention import (
        flash_attention_bwd_dkv_dbias_bf16, flash_attention_bwd_dkv_dbias_f16)
    dbias_fn, plain_fn, rel = {
        "bfloat16": (flash_attention_bwd_dkv_dbias_bf16,
                     flash_attention_bwd_dkv_bf16, 2.0 ** -8),
        "float16": (flash_attention_bwd_dkv_dbias_f16,
                    flash_attention_bwd_dkv_f16, 2.0 ** -11)}[dtype]
    q, k, v, do, bias = _flash_bf16_inputs(6, T, D, cuda, T * D + 11)
    if dtype == "float16":
        q, k, v, do = (t.half() for t in (q, k, v, do))
    bias[2:] = torch.randn(4, T, device=cuda)       # a learned bias
    scale = 1.0 / math.sqrt(D)
    out, lse = flash_attention_forward(q, k, v, bias, scale, causal)
    n0 = (plain_fn.launches, dbias_fn.launches,
          flash_attention_bwd_dkv_dbias.launches)
    got = flash_attention_backward(q, k, v, out, lse, do, bias, scale,
                                   causal, needs_dbias=True)
    again = flash_attention_backward(q, k, v, out, lse, do, bias, scale,
                                     causal, needs_dbias=True)
    torch.cuda.synchronize()
    assert (plain_fn.launches, dbias_fn.launches,
            flash_attention_bwd_dkv_dbias.launches) == (n0[0], n0[1] + 2,
                                                        n0[2])
    assert len(got) == 4 and all(torch.equal(a, b)
                                 for a, b in zip(got, again))
    # the delta the pair fed dK/dV: the dQ kernel's
    delta = _DQ16[dtype](q, k, v, do, out, lse, bias, scale, causal)[1]
    dk0, dv0 = plain_fn(q, k, v, do, lse, delta, bias, scale, causal)
    assert torch.equal(got[1], dk0) and torch.equal(got[2], dv0)
    want = flash_attention_backward_reference(q, k, v, out, lse, do, bias,
                                              scale, causal,
                                              needs_dbias=True)
    top = max(w.float().abs().max().item() for w in want[:3])
    for name, g, w in zip(("dk", "dv"), got[1:3], want[1:3]):
        assert g.dtype == q.dtype, name
        lim = 2 * rel * max(w.float().abs().max().item(), top / 64, 1e-30)
        err = (g.float() - w.float()).abs().max().item()
        assert err <= lim, (name, T, D, causal, err, lim)
    db64 = flash_attention_backward_reference(
        q, k, v, out, lse, do, bias, scale, causal, needs_dbias=True,
        compute_dtype=torch.float64)[3]
    db = got[3]
    assert db.dtype == torch.float32 and db.shape == (6, T)
    # a key's dbias sums p * (dP - delta) terms, which may cancel (to 0 at
    # T = 1): the scale is the larger of its largest value and delta's
    assert (db - db64).abs().max().item() <= 1e-4 * max(
        db64.abs().max().item(), delta.abs().max().item())
    assert (db[0] == 0).all() and (db[1, T // 2:] == 0).all()
    if dtype == "float16":
        do_inf = do.clone()
        do_inf[3, T // 2] = float("inf")
        bad = flash_attention_backward(q, k, v, out, lse, do_inf, bias,
                                       scale, causal, needs_dbias=True)
        for name, g in zip(("dk", "dv", "dbias"), bad[1:]):
            assert not bool(torch.isfinite(g).all()), name
            assert not bool((g.float().abs() == 65504.0).any()), name


# --------------------------------------- the 16-bit backward on wgmma + TMA
@pytest.mark.needs_cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("D", [32, 64, 128])
def test_wgmma_descriptors_match_matmul_on_one_tile(cuda, D, dtype):
    """The 16-bit backward's shared-memory layouts on one 64-row tile
    (csrc flash_bwd_dq_probe_kernel): q and k loaded by TMA as the
    kernels load them, s = q k^T with both operands K-major (S = Q K^T)
    and o = p k with k read MN-major through the transposed-B descriptor
    (dQ += dS K), against torch.matmul in fp32 on the same values. The
    inputs are small integers, exact in both 16-bit types, whose sums are
    exact in fp32 in any order: the two must be equal, so a wrong stride
    or swizzle shows here rather than as a wrong gradient."""
    from incubator_mxnet_tpu_torch.ops.kernels import _build
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(D)
    q, k = (torch.randint(-8, 9, (64, D), generator=gen, device=cuda).to(dt)
            for _ in range(2))
    p = torch.randint(-4, 5, (64, 64), generator=gen, device=cuda).float()
    s = torch.full((64, 64), float("nan"), device=cuda)
    o = torch.full((64, D), float("nan"), device=cuda)
    rc = _build.library().mxtpu_flash_bwd_wgmma_probe(
        q.data_ptr(), k.data_ptr(), p.data_ptr(), s.data_ptr(), o.data_ptr(),
        D, 0 if dtype == "bfloat16" else 1, cuda.index,
        torch.cuda.current_stream(cuda).cuda_stream)
    _build.check(rc, "mxtpu_flash_bwd_wgmma_probe")
    torch.cuda.synchronize()
    want_s = torch.matmul(q.float(), k.float().t())
    want_o = torch.matmul(p, k.float())
    assert want_s.abs().max().item() > 0 and want_o.abs().max().item() > 0
    assert torch.equal(s, want_s)
    assert torch.equal(o, want_o)


@pytest.mark.needs_cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("T, D", [(1, 32), (100, 64), (512, 64),
                                  (777, 128)])
def test_flash_half_dq_kernel_takes_delta(cuda, T, D, dtype):
    """The 16-bit dQ kernel's second output: delta = rowsum(dO * O) in
    fp32, each row within 1e-6 of its sum of |dO * O| of the plain
    (do.float() * out.float()).sum(-1) (the products are exact in fp32; the
    sums are taken in another order), exactly 0 on a row whose keys are all
    masked; and its dq is the pair's."""
    q, k, v, do, bias = _flash_bf16_inputs(5, T, D, cuda, T * D + 3)
    dt = getattr(torch, dtype)
    q, k, v, do = (t.to(dt) for t in (q, k, v, do))
    scale = 1.0 / math.sqrt(D)
    out, lse = flash_attention_forward(q, k, v, bias, scale)
    fn = _DQ16[dtype]
    n0 = fn.launches
    dq, delta = fn(q, k, v, do, out, lse, bias, scale, False)
    torch.cuda.synchronize()
    assert fn.launches == n0 + 1
    assert delta.dtype == torch.float32 and delta.shape == (5, T)
    prod = do.float() * out.float()
    want, mass = prod.sum(dim=-1), prod.abs().sum(dim=-1)
    assert ((delta - want).abs() <= 1e-6 * mass).all()
    assert (delta[0] == 0).all()
    pair = flash_attention_backward(q, k, v, out, lse, do, bias, scale)
    assert torch.equal(dq, pair[0])


@pytest.mark.needs_cuda
@pytest.mark.parametrize("T, D", [(100, 64), (777, 128), (63, 32)])
@pytest.mark.parametrize("where", ["past_last_full_tile", "first_rows"])
def test_flash_f16_inf_in_do_stays_in_its_head(cuda, T, D, where):
    """fp16 at a ragged T (not a multiple of the 64-row tiles): an inf in
    one head's dO, in a row past its last full tile or in one of its first
    rows (those a neighbour's tile past T would reach if the tiles were cut
    from (B*H*T, D) rows), makes that head's dq, dk and dv non-finite and
    leaves every other head's finite: the 3-D tensor maps fill rows past T
    with zeros."""
    BH = 4
    gen = torch.Generator(device=cuda).manual_seed(T + D)
    q, k, v, do = (torch.randn(BH, T, D, generator=gen, device=cuda).half()
                   for _ in range(4))
    scale = 1.0 / math.sqrt(D)
    out, lse = flash_attention_forward(q, k, v, None, scale)
    row = T - 1 if where == "past_last_full_tile" else min(3, T - 1)
    do[1, row] = float("inf")
    grads = flash_attention_backward(q, k, v, out, lse, do, None, scale)
    torch.cuda.synchronize()
    for name, g in zip(("dq", "dk", "dv"), grads):
        assert not bool(torch.isfinite(g[1]).all()), name
        others = torch.cat([g[:1], g[2:]])
        assert bool(torch.isfinite(others).all()), name


@pytest.mark.needs_cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("pools", ["half", "float32"])
@pytest.mark.parametrize("bs", [16, 8, 32, 12])
@pytest.mark.parametrize("C", [1, 3, 8, 32, 33])
@pytest.mark.parametrize("D", [32, 64, 128])
def test_flash_decode_half_kernel_matches_plain(cuda, pools, bs, C, D,
                                                dtype):
    """The bf16 or fp16 decode kernel on 16-bit q over pools of q's dtype
    or fp32, read in place: one launch of it and none of the fp32 kernel or
    the other 16-bit one; o in q's dtype, each element within one step of
    it (2**-7 for bf16, 2**-10 for fp16) of its own value plus 1e-5 of the
    plain version's, m within 1e-5 and l within rtol 1e-5 (p and its sums
    stay fp32); a sequence with no past exact; the same bits on two calls.
    Blocks of 16, 8, 32 and 12 positions (12: a block that is no multiple
    of 8 positions, 16-byte rows all the same), a table of about 1024
    positions with odd pasts, chunks from decode to two query tiles."""
    from incubator_mxnet_tpu_torch.ops.kernels.flash_decode import (
        paged_flash_decode, paged_flash_decode_bf16, paged_flash_decode_f16,
        paged_flash_decode_reference)
    tq = getattr(torch, dtype)
    mine, other, step = {
        "bfloat16": (paged_flash_decode_bf16, paged_flash_decode_f16,
                     2.0 ** -7),
        "float16": (paged_flash_decode_f16, paged_flash_decode_bf16,
                    2.0 ** -10)}[dtype]
    mb = -(-1024 // bs)
    cap = mb * bs
    lengths = [0, 1, bs, cap, 350, 2 * bs - 1, cap - 1, 17]
    q, kp, vp, tables, lens = _paged_inputs(8, C, 4, D, bs, mb, lengths,
                                            cuda, seed=C * D + bs)
    pdt = tq if pools == "half" else torch.float32
    q, kp, vp = q.to(tq), kp.to(pdt), vp.to(pdt)
    n0 = (paged_flash_decode.launches, mine.launches, other.launches)
    o, m, l = paged_flash_decode(q, kp, vp, tables, lens)
    again = paged_flash_decode(q, kp, vp, tables, lens)
    torch.cuda.synchronize()
    assert (paged_flash_decode.launches, mine.launches,
            other.launches) == (n0[0], n0[1] + 2, n0[2])
    assert all(torch.equal(a, b) for a, b in zip((o, m, l), again))
    ro, rm, rl = paged_flash_decode_reference(q, kp, vp, tables, lens)
    assert o.dtype == tq and m.dtype == l.dtype == torch.float32
    gap = (o.float() - ro.float()).abs()
    out = gap > step * ro.float().abs() + 1e-5
    assert not bool(out.any()), (pools, bs, C, D, int(out.sum()),
                                 gap.max().item())
    assert (m - rm).abs().max().item() <= 1e-5
    torch.testing.assert_close(l, rl, rtol=1e-5, atol=0)
    assert (o[0] == 0).all() and (l[0] == 0).all()
    assert (m[0] == -1e30).all()


@pytest.mark.needs_cuda
def test_flash_decode_refuses_pairs_without_a_kernel(cuda):
    """No kernel takes a 16-bit q over pools of the other 16-bit type,
    fp32 q over 16-bit pools, or K and V of two dtypes: each raises
    TypeError naming the pair, and nothing launches; each 16-bit wrapper
    refuses a q of another dtype. fp16 q over fp16 or fp32 pools launches
    the fp16 kernel once."""
    from incubator_mxnet_tpu_torch.ops.kernels.flash_decode import (
        paged_flash_decode, paged_flash_decode_bf16, paged_flash_decode_f16)
    q, kp, vp, tables, lens = _paged_inputs(2, 1, 2, 64, 16, 2, [3, 5],
                                            cuda, seed=2)
    wrappers = (paged_flash_decode, paged_flash_decode_bf16,
                paged_flash_decode_f16)
    n0 = tuple(w.launches for w in wrappers)
    for qq, kk, vv in ((q.to(BF16), kp.half(), vp.half()),
                       (q.half(), kp.to(BF16), vp.to(BF16)),
                       (q, kp.to(BF16), vp.to(BF16)),
                       (q, kp.half(), vp.half()),
                       (q.to(BF16), kp.to(BF16), vp),
                       (q.half(), kp.half(), vp)):
        with pytest.raises(TypeError, match="no CUDA kernel takes q %s"
                           % qq.dtype):
            paged_flash_decode(qq, kk, vv, tables, lens)
    with pytest.raises(TypeError, match="bfloat16 CUDA q"):
        paged_flash_decode_bf16(q, kp, vp, tables, lens)
    with pytest.raises(TypeError, match="float16 CUDA q"):
        paged_flash_decode_f16(q.to(BF16), kp, vp, tables, lens)
    assert tuple(w.launches for w in wrappers) == n0
    for pools in (kp.half(), kp):
        o, m, l = paged_flash_decode(q.half(), pools, pools, tables, lens)
        assert o.dtype == torch.float16 and m.dtype == torch.float32
    torch.cuda.synchronize()
    assert tuple(w.launches for w in wrappers) == (n0[0], n0[1], n0[2] + 2)


@pytest.mark.needs_cuda
def test_fp16_seam_and_bottleneck_launch_and_a_dtype_mix_raises(cuda):
    """The last fp16 flavours launch: the flat seam kernel (counted on its
    fp16 wrapper, not the fp32 one) and the fused bottleneck on its fp16
    route; a call that mixes fp16 with fp32 still raises ValueError and
    launches nothing."""
    from incubator_mxnet_tpu_torch.ops.kernels.fused_bottleneck import (
        fused_bottleneck)
    w = torch.zeros(64, device=cuda, dtype=torch.float16)
    n0 = (fused_sgd_mom_flat.launches, fused_sgd_mom_flat_f16.launches)
    fused_sgd_mom_flat([w], [w.clone()], [w.clone()], 0.1, 0.0, 0.9, 1.0,
                       -1.0)
    with pytest.raises(ValueError, match="mix"):
        fused_sgd_mom_flat([w], [w.float()], [w.clone()], 0.1, 0.0, 0.9,
                           1.0, -1.0)
    assert (fused_sgd_mom_flat.launches,
            fused_sgd_mom_flat_f16.launches) == (n0[0], n0[1] + 1)
    args = list(_bottleneck_inputs(1, 4, 4, 8, 4, torch.float16, cuda, 0))
    n0 = fused_bottleneck.launches
    out = fused_bottleneck(*args)
    torch.cuda.synchronize()
    assert out.dtype == torch.float16 and out.isfinite().all()
    assert fused_bottleneck.launches == n0 + 1


@pytest.mark.needs_cuda
def test_a_capture_failure_raises_instead_of_running_eagerly(cuda):
    """A forward that reads a device value back to the host runs as the
    warm-up and then cannot be captured: the program raises CaptureError
    naming itself. (Last in the file: it ends in a failed capture.)"""
    from incubator_mxnet_tpu_torch.compilecache import (BlockProgram,
                                                        CaptureError)

    def reads_back(x):
        return x * float(x.sum())

    prog = BlockProgram("probe/host_read", reads_back,
                        [torch.ones(4, device=cuda)])
    with pytest.raises(CaptureError, match="probe/host_read"):
        prog(torch.ones(4, device=cuda))
    assert prog.graph is None
