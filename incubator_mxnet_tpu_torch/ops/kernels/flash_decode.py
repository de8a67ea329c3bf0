"""Paged flash decode: the CUDA kernel's wrapper, its plain PyTorch version,
and the full decode-step attention around it.

Counterpart of ``incubator_mxnet_tpu/ops/pallas/flash_decode.py``. The kernel
is in ``csrc/flash_decode.cu``; unlike the TPU kernel, which covers one query
row per sequence and leaves C > 1 to lax, it takes any C >= 1, so chunked
prefill and speculative verification go through it too.

``paged_flash_decode`` is attention of ``q`` over each sequence's paged past
and returns ``(o, m, l)``. For a CPU tensor it takes the plain version; for a
CUDA tensor it launches a kernel or raises, and adds one to that kernel's
``launches`` count: fp32 q over fp32 pools launches the fp32 kernel (counted
on ``paged_flash_decode``), bf16 q over bf16 or fp32 pools the bf16 one
(counted on ``paged_flash_decode_bf16``) and fp16 q over fp16 or fp32 pools
the fp16 one (counted on ``paged_flash_decode_f16``): the pairs a 16-bit GPT
feeds over a spec of its dtype or the default one. Any other pair (fp32 q
over 16-bit pools, a 16-bit q over pools of the other 16-bit type, K and V
of two dtypes) raises TypeError naming it; no pool is ever converted. o
comes back in q's dtype, m and l in fp32. ``paged_causal_attention`` is the
whole decode-step attention: the past term through ``paged_flash_decode``,
the in-chunk causal term and the two-way softmax merge in plain PyTorch, as
the JAX package computes them in lax outside its Pallas call.
"""

import math

import torch

from ...telemetry import costs as _costs
from . import _build

__all__ = ["paged_flash_decode", "paged_flash_decode_bf16",
           "paged_flash_decode_f16", "paged_flash_decode_reference",
           "paged_causal_attention"]

_NEG_INF = -1e30
_HEAD_DIMS = (32, 64, 128)


def paged_flash_decode_reference(q, k_pool, v_pool, block_tables, lengths,
                                 scale=None):
    """Plain past-attention with the lax oracle's arithmetic
    (``_lax_paged_mhl``): gather each sequence's table, score in fp32, mask
    positions at or past ``lengths`` with -1e30, softmax through max / exp /
    sum. A sequence with no past gives o = 0, m = -1e30 and l = 0 exactly.

    q (S, C, H, D); pools (num_blocks, block_size, H, D); block_tables
    (S, MB) int; lengths (S,) int. Returns o (S, C, H, D) in q's dtype and
    m, l (S, C, H) in float32."""
    S, C, H, D = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    bs = k_pool.shape[1]
    tables = torch.as_tensor(block_tables, device=q.device).long()
    lens = torch.as_tensor(lengths, device=q.device).long()
    mb = tables.shape[1]
    k = k_pool[tables].reshape(S, mb * bs, H, D).float()
    v = v_pool[tables].reshape(S, mb * bs, H, D).float()
    s = torch.einsum("schd,sphd->shcp", q.float(), k) * scale   # (S, H, C, P)
    live = (torch.arange(mb * bs, device=q.device)[None, :]
            < lens[:, None])[:, None, None, :]
    s = s.masked_fill(~live, _NEG_INF)
    m = s.amax(dim=-1)                                          # (S, H, C)
    # all-masked rows have s - m = 0 everywhere: re-mask so p sums to 0
    p = torch.exp(s - m[..., None]).masked_fill(~live, 0.0)
    l = p.sum(dim=-1)
    o = torch.einsum("shcp,sphd->schd", p, v)
    o = o / l.clamp_min(1e-30).transpose(1, 2)[..., None]
    dead = m <= _NEG_INF * 0.5
    o = o.masked_fill(dead.transpose(1, 2)[..., None], 0.0)
    l = l.masked_fill(dead, 0.0)
    return (o.to(q.dtype), m.transpose(1, 2).contiguous(),
            l.transpose(1, 2).contiguous())


#: (q dtype, pool dtype) -> the C entry's pool code, for each pair a CUDA
#: kernel takes: the fp32 kernel's one pair, the bf16 and fp16 kernels' two
#: each (0: pools of q's dtype, 1: fp32 pools)
_PAIRS = {(torch.float32, torch.float32): None,
          (torch.bfloat16, torch.bfloat16): 0,
          (torch.bfloat16, torch.float32): 1,
          (torch.float16, torch.float16): 0,
          (torch.float16, torch.float32): 1}


def _check_cuda(q, k_pool, v_pool, block_tables, lengths):
    pair = (q.dtype, k_pool.dtype)
    if pair not in _PAIRS or v_pool.dtype != k_pool.dtype:
        raise TypeError(
            "paged_flash_decode: no CUDA kernel takes q %s over k_pool %s "
            "and v_pool %s; the kernels take float32 q over float32 pools, "
            "bfloat16 q over bfloat16 or float32 pools and float16 q over "
            "float16 or float32 pools" % (q.dtype, k_pool.dtype,
                                          v_pool.dtype))
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool)):
        if t.device != q.device:
            raise ValueError("paged_flash_decode: %s on %s, q on %s"
                             % (name, t.device, q.device))
        if t.dim() != 4:
            raise ValueError("paged_flash_decode: %s must be 4-D, got %s"
                             % (name, tuple(t.shape)))
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("paged_flash_decode: %s must be contiguous and "
                             "16-byte aligned" % name)
    S, C, H, D = q.shape
    if D not in _HEAD_DIMS:
        raise ValueError("paged_flash_decode: head dim %d not in %s"
                         % (D, _HEAD_DIMS))
    if k_pool.shape != v_pool.shape or tuple(k_pool.shape[2:]) != (H, D):
        raise ValueError("paged_flash_decode: pools %s and %s must both be "
                         "(num_blocks, block_size, %d, %d)"
                         % (tuple(k_pool.shape), tuple(v_pool.shape), H, D))
    for name, t, shape in (("block_tables", block_tables, None),
                           ("lengths", lengths, (S,))):
        if not isinstance(t, torch.Tensor) or t.device != q.device:
            raise ValueError("paged_flash_decode: %s must be a tensor on %s"
                             % (name, q.device))
        if t.dtype != torch.int32:
            raise TypeError("paged_flash_decode: %s must be int32, got %s"
                            % (name, t.dtype))
        if not t.is_contiguous():
            raise ValueError("paged_flash_decode: %s must be contiguous"
                             % name)
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError("paged_flash_decode: %s must be %s, got %s"
                             % (name, shape, tuple(t.shape)))
    if block_tables.dim() != 2 or block_tables.shape[0] != S \
            or block_tables.shape[1] < 1:
        raise ValueError("paged_flash_decode: block_tables must be (%d, MB) "
                         "with MB >= 1, got %s"
                         % (S, tuple(block_tables.shape)))
    if S > 65535 or H > 65535 or (C + 7) // 8 > 65535:
        raise ValueError("paged_flash_decode: S = %d, H = %d or C = %d "
                         "exceeds the kernel's grid" % (S, H, C))
    if k_pool.shape[0] > 2 ** 31 - 1 \
            or block_tables.shape[1] * k_pool.shape[1] > 2 ** 31 - 1:
        raise ValueError("paged_flash_decode: pool %s and table %s exceed "
                         "the kernel's int range" % (
                             tuple(k_pool.shape), tuple(block_tables.shape)))


def _decode_cost(S, C, H, D, lengths, mb, q_bytes, kv_bytes):
    """(flops, bytes) of one decode launch over this call's live past (a
    host read of ``lengths``: called only while costs are counted, on an
    eager call)."""
    nbytes, flops = _costs.flash_decode_cost(
        S, C, H, D, int(lengths.sum()), mb, q_bytes, kv_bytes)
    return flops, nbytes


def _launch(entry, wrapper, q, k_pool, v_pool, block_tables, lengths,
            scale, *codes):
    """One launch of a decode kernel (C entry ``entry``, given ``codes``
    before the device), counted on ``wrapper``. Returns ``(o, m, l)``."""
    _check_cuda(q, k_pool, v_pool, block_tables, lengths)
    S, C, H, D = q.shape
    out = torch.empty_like(q)
    m = torch.empty((S, C, H), dtype=torch.float32, device=q.device)
    l = torch.empty((S, C, H), dtype=torch.float32, device=q.device)
    if S == 0 or C == 0 or H == 0:
        return out, m, l
    num_blocks, block_size = k_pool.shape[0], k_pool.shape[1]
    rc = getattr(_build.library(), entry)(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        m.data_ptr(), l.data_ptr(), S, C, H, D, num_blocks, block_size,
        block_tables.shape[1], float(scale), *codes, q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, wrapper.__name__)
    qb, kvb = q.element_size(), k_pool.element_size()
    _build.count_launch(wrapper, lambda: _decode_cost(
        S, C, H, D, lengths, block_tables.shape[1], qb, kvb))
    return out, m, l


def paged_flash_decode(q, k_pool, v_pool, block_tables, lengths, scale=None):
    """Attention of ``q`` over the paged PAST of each sequence.

    q (S, C, H, D); k_pool / v_pool (num_blocks, block_size, H, D);
    block_tables (S, MB) int32 (padded with any valid block id); lengths
    (S,) int32, the committed past positions of each sequence. Returns
    ``(o, m, l)``: the normalised output (S, C, H, D) and the online-softmax
    row max and denominator, both (S, C, H), for merging with in-chunk
    terms. A sequence with no past gives o = 0, m = -1e30 and l = 0. A
    bf16 ``q`` on CUDA goes to ``paged_flash_decode_bf16``, an fp16 one to
    ``paged_flash_decode_f16``."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return paged_flash_decode_reference(q, k_pool, v_pool, block_tables,
                                            lengths, scale)
    if q.device.type != "cuda":
        raise ValueError("paged_flash_decode: unsupported device %s"
                         % q.device)
    if q.dtype in _HALF:
        return _HALF[q.dtype](q, k_pool, v_pool, block_tables, lengths,
                              scale)
    return _launch("mxtpu_flash_decode_f32", paged_flash_decode, q, k_pool,
                   v_pool, block_tables, lengths, scale)


paged_flash_decode.launches = 0


def paged_flash_decode_bf16(q, k_pool, v_pool, block_tables, lengths,
                            scale=None):
    """The bf16 decode kernel on CUDA tensors: bfloat16 q (S, C, H, D) over
    bfloat16 or float32 pools (both of one dtype), read in place. Returns
    ``(o, m, l)``, o bf16 (rounded once), m and l fp32."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type != "cuda" or q.dtype != torch.bfloat16:
        raise TypeError("paged_flash_decode_bf16: takes a bfloat16 CUDA q, "
                        "got %s on %s" % (q.dtype, q.device))
    return _launch("mxtpu_flash_decode_bf16", paged_flash_decode_bf16, q,
                   k_pool, v_pool, block_tables, lengths, scale,
                   _PAIRS.get((q.dtype, k_pool.dtype)))


paged_flash_decode_bf16.launches = 0


def paged_flash_decode_f16(q, k_pool, v_pool, block_tables, lengths,
                           scale=None):
    """The fp16 decode kernel on CUDA tensors: float16 q (S, C, H, D) over
    float16 or float32 pools (both of one dtype), read in place. Returns
    ``(o, m, l)``, o fp16 (rounded once), m and l fp32."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type != "cuda" or q.dtype != torch.float16:
        raise TypeError("paged_flash_decode_f16: takes a float16 CUDA q, "
                        "got %s on %s" % (q.dtype, q.device))
    return _launch("mxtpu_flash_decode_f16", paged_flash_decode_f16, q,
                   k_pool, v_pool, block_tables, lengths, scale,
                   _PAIRS.get((q.dtype, k_pool.dtype)))


paged_flash_decode_f16.launches = 0
#: the 16-bit decode kernels by q's dtype
_HALF = {torch.bfloat16: paged_flash_decode_bf16,
         torch.float16: paged_flash_decode_f16}


def paged_causal_attention(q, k_new, v_new, k_pool, v_pool, block_tables,
                           lengths, scale=None):
    """Full decode-step attention: paged past plus causal in-chunk self.

    q / k_new / v_new (S, C, H, D) are the chunk fed this step, whose K and V
    are NOT yet in the pool; position c attends every past position and the
    in-chunk positions <= c. Returns (S, C, H, D) in q's dtype. The diagonal
    gives every row at least one live score, so the merge never divides by
    zero, even with no past."""
    S, C, H, D = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    o_p, m_p, l_p = paged_flash_decode(q.contiguous(), k_pool, v_pool,
                                       block_tables, lengths, scale=scale)
    s_new = torch.einsum("schd,sthd->shct", q.float(),
                         k_new.float()) * scale                 # (S, H, C, T)
    pos = torch.arange(C, device=q.device)
    future = pos[:, None] < pos[None, :]                        # (C, T)
    s_new = s_new.masked_fill(future, _NEG_INF)
    m_s = s_new.amax(dim=-1)                                    # (S, H, C)
    p = torch.exp(s_new - m_s[..., None]).masked_fill(future, 0.0)
    l_s = p.sum(dim=-1)
    o_s = torch.einsum("shct,sthd->schd", p, v_new.float())    # unnormalised
    m_s = m_s.transpose(1, 2)                                   # (S, C, H)
    l_s = l_s.transpose(1, 2)
    m = torch.maximum(m_p, m_s)
    w_p = l_p * torch.exp(m_p - m)          # the past's weight
    w_s = torch.exp(m_s - m)                # the self term's rescale
    num = o_p.float() * w_p[..., None] + o_s * w_s[..., None]
    den = w_p + l_s * w_s                   # >= exp(0) through the diagonal
    return (num / den[..., None]).to(q.dtype)
