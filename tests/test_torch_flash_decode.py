"""The PyTorch port's paged flash decode against the JAX package.

On the CPU the port takes its plain version (the gathered table, the lengths
mask, dead-row zeroing); the JAX side runs its lax oracle and, at C = 1, the
Pallas decode kernel in interpret mode, as tests/test_generate.py does. Same
numpy inputs from a seed. Tolerances: fp32 atol 1e-5 on o and m and rtol
1e-5 on l (another summation order); bf16 on the plain path atol 3e-2 on o,
as the JAX package holds its own bf16 kernel; bf16 and fp16 q over pools of
their dtype or fp32 with o one step of its dtype from the JAX package's
(2**-8, 2**-11 of its own value, plus 1e-6). The CUDA kernel is held
against the plain version on a card in tests/test_torch_kernels_cuda.py.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from incubator_mxnet_tpu.ops.pallas import flash_decode as jfd
from incubator_mxnet_tpu_torch.ops.kernels import flash_decode as tfd

ATOL = 1e-5
RTOL_L = 1e-5

# jitted once per shape: the lax oracle op by op compiles every primitive
_jax_lax = jax.jit(functools.partial(jfd.paged_flash_decode,
                                     use_kernel=False))
_jax_kernel = jax.jit(functools.partial(jfd.paged_flash_decode,
                                        use_kernel=True, interpret=True))
_jax_causal = jax.jit(functools.partial(jfd.paged_causal_attention,
                                        use_kernel=False))


def _inputs(seed, S, C, H, D, bs, mb, lengths=None):
    """q, pools and a shuffled disjoint table per sequence; one dead row."""
    rs = np.random.RandomState(seed)
    if lengths is None:
        lengths = rs.randint(0, bs * mb + 1, S)
        lengths[0] = 0
    q = rs.randn(S, C, H, D).astype(np.float32)
    kp = rs.randn(S * mb, bs, H, D).astype(np.float32)
    vp = rs.randn(S * mb, bs, H, D).astype(np.float32)
    tables = rs.permutation(S * mb).reshape(S, mb).astype(np.int32)
    return q, kp, vp, tables, np.asarray(lengths, np.int32)


def _port(q, kp, vp, tables, lengths, dtype=torch.float32):
    return tfd.paged_flash_decode(
        torch.from_numpy(q).to(dtype), torch.from_numpy(kp).to(dtype),
        torch.from_numpy(vp).to(dtype), torch.from_numpy(tables),
        torch.from_numpy(lengths))


def _close(port, jax_out, atol=ATOL, rtol_l=RTOL_L):
    o, m, l = (t.float().numpy() for t in port)
    jo, jm, jl = (np.asarray(a, np.float32) for a in jax_out)
    np.testing.assert_allclose(o, jo, atol=atol, rtol=0)
    np.testing.assert_allclose(m, jm, atol=atol, rtol=0)
    np.testing.assert_allclose(l, jl, rtol=rtol_l, atol=1e-6)


@pytest.mark.parametrize("seed,S,C,H,D,bs,mb", [
    (0, 3, 1, 2, 8, 4, 4), (1, 1, 1, 1, 16, 8, 2), (2, 4, 3, 3, 8, 16, 3),
    (3, 2, 8, 2, 64, 16, 4), (4, 5, 32, 2, 32, 16, 3)])
def test_flash_decode_matches_jax_lax(seed, S, C, H, D, bs, mb):
    q, kp, vp, tables, lengths = _inputs(seed, S, C, H, D, bs, mb)
    got = _port(q, kp, vp, tables, lengths)
    want = _jax_lax(q, kp, vp, tables, lengths)
    _close(got, want)
    o, m, l = got
    assert (o[0] == 0).all() and (l[0] == 0).all()      # dead row, exact
    assert (m[0] == np.float32(-1e30)).all()


@pytest.mark.parametrize("seed,S,H,D,bs,mb", [
    (5, 2, 2, 8, 8, 2), (6, 3, 1, 16, 4, 4), (7, 4, 2, 64, 16, 3)])
def test_flash_decode_matches_jax_pallas_interpret(seed, S, H, D, bs, mb):
    """At C = 1 against the TPU kernel itself, in interpret mode; lengths
    cover a dead row, a block boundary and a full table."""
    lengths = [0, bs, bs * mb, 1][:S]
    q, kp, vp, tables, lengths = _inputs(seed, S, 1, H, D, bs, mb, lengths)
    got = _port(q, kp, vp, tables, lengths)
    want = _jax_kernel(q, kp, vp, tables, lengths)
    _close(got, want)


def test_flash_decode_bf16_on_the_plain_path():
    q, kp, vp, tables, lengths = _inputs(8, 2, 1, 2, 8, 8, 2)
    got = _port(q, kp, vp, tables, lengths, dtype=torch.bfloat16)
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == torch.float32
    bf = [jnp.asarray(a, jnp.bfloat16) for a in (q, kp, vp)]
    want = _jax_lax(*bf, tables, lengths)
    _close(got, want, atol=3e-2, rtol_l=2e-2)


#: bf16 or fp16 q over pools of its dtype or fp32 (the two pairs a 16-bit
#: GPT feeds): both sides score and sum in fp32 from the same stored values
#: and round only o to q's dtype, so o is held to one step of that dtype of
#: its own value (the fp32 sums differ in order and may round to a
#: neighbouring value) plus 1e-6; m and l at ATOL and RTOL_L as in fp32
HALF_STEP = {"bfloat16": 2.0 ** -8, "float16": 2.0 ** -10}


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("pools", ["half", "float32"])
@pytest.mark.parametrize("C,bs", [(1, 8), (1, 32), (3, 8), (5, 32)])
def test_flash_decode_half_pairs_match_jax(pools, C, bs, dtype):
    """paged_flash_decode on bf16 or fp16 q over pools of q's dtype and
    fp32 pools against the JAX package on the same values: at C = 1 its
    Pallas decode kernel in interpret mode, at C > 1 its lax oracle; block
    sizes 8 and 32, a dead row, a block boundary and a full table; o in q's
    dtype, m and l fp32 on both sides."""
    S, H, D, mb = 4, 2, 16, 3
    q, kp, vp, tables, lengths = _inputs(40 + C + bs, S, C, H, D, bs, mb,
                                         [0, bs, bs * mb, 2 * bs - 3])
    jdt, tq = getattr(jnp, dtype), getattr(torch, dtype)
    q = q.astype(jdt)
    pdt = jdt if pools == "half" else jnp.float32
    kp, vp = kp.astype(pdt), vp.astype(pdt)
    oracle = _jax_kernel if C == 1 else _jax_lax
    want = oracle(q, kp, vp, tables, lengths)
    tdt = tq if pools == "half" else torch.float32
    got = tfd.paged_flash_decode(
        torch.from_numpy(np.asarray(q, np.float32)).to(tq),
        torch.from_numpy(np.asarray(kp, np.float32)).to(tdt),
        torch.from_numpy(np.asarray(vp, np.float32)).to(tdt),
        torch.from_numpy(tables), torch.from_numpy(lengths))
    assert got[0].dtype == tq and want[0].dtype == jdt
    assert got[1].dtype == got[2].dtype == torch.float32
    assert want[1].dtype == want[2].dtype == jnp.float32
    o, jo = got[0].float().numpy(), np.asarray(want[0], np.float32)
    assert (np.abs(o - jo) <= HALF_STEP[dtype] * np.abs(jo) + 1e-6).all()
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               rtol=RTOL_L, atol=1e-6)
    assert (got[0][0] == 0).all() and (got[2][0] == 0).all()


@pytest.mark.parametrize("C", [1, 4, 8])
@pytest.mark.parametrize("past", [0, 5, 11])
def test_paged_causal_attention_matches_jax(C, past):
    S, H, D, bs, mb = 2, 2, 8, 4, 4
    q, kp, vp, tables, lengths = _inputs(10 * C + past, S, C, H, D, bs, mb,
                                         [past] * S)
    rs = np.random.RandomState(C + past)
    k_new = rs.randn(S, C, H, D).astype(np.float32)
    v_new = rs.randn(S, C, H, D).astype(np.float32)
    got = tfd.paged_causal_attention(
        *(torch.from_numpy(a) for a in (q, k_new, v_new, kp, vp, tables,
                                        lengths)))
    want = _jax_causal(q, k_new, v_new, kp, vp, tables, lengths)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=ATOL)


def test_flash_decode_wrapper_counts_only_kernel_launches():
    """On the CPU the wrapper takes the plain version and counts nothing."""
    q, kp, vp, tables, lengths = _inputs(9, 2, 1, 2, 8, 4, 2)
    n0 = tfd.paged_flash_decode.launches
    _port(q, kp, vp, tables, lengths)
    assert tfd.paged_flash_decode.launches == n0
    with pytest.raises(ValueError, match="unsupported device"):
        tfd.paged_flash_decode(torch.zeros(1, 1, 1, 32, device="meta"),
                               None, None, None, None)


def _split_kv_as_the_kernel_merges_it(q, kp, vp, tables, lengths, nsplit,
                                      tile=32):
    """The CUDA kernel's split-KV, emulated in float32 numpy: each
    sequence's live positions cut into nact contiguous runs of whole 32-key
    tiles, nact the number of tiles up to nsplit (at least one run), as
    many tiles a run as ceil(ceil(len / nact) / 32); each run's partial (m, l, acc) with acc unnormalised, a run past
    the length giving (-1e30, 0, 0); then the (m, l, acc) combine: M the
    max of the runs' m, L and O their l and acc weighted by exp(m - M); a
    sequence whose M stays at or below -0.5e30 gives o = 0 and l = 0."""
    S, C, H, D = q.shape
    bs = kp.shape[1]
    scale = np.float32(1.0 / np.sqrt(D))
    o = np.zeros((S, C, H, D), np.float32)
    m_out = np.zeros((S, C, H), np.float32)
    l_out = np.zeros((S, C, H), np.float32)
    for s in range(S):
        n = int(min(lengths[s], tables.shape[1] * bs))
        pos = np.arange(n)
        rows = tables[s][pos // bs], pos % bs
        k, v = kp[rows], vp[rows]                           # (n, H, D)
        nact = max(1, min(nsplit, -(-n // tile)))
        per = -(-(-(-n // nact)) // tile) * tile
        parts = []
        for r in range(nact):
            lo, hi = min(n, r * per), min(n, r * per + per)
            if hi == lo:
                parts.append((np.full((C, H), -1e30, np.float32),
                              np.zeros((C, H), np.float32),
                              np.zeros((C, H, D), np.float32)))
                continue
            sc = np.einsum("chd,phd->chp", q[s], k[lo:hi]) * scale
            m = sc.max(axis=-1)
            p = np.exp(sc - m[..., None])
            parts.append((m, p.sum(axis=-1),
                          np.einsum("chp,phd->chd", p, v[lo:hi])))
        M = np.max([p[0] for p in parts], axis=0)
        L = np.zeros((C, H), np.float32)
        O = np.zeros((C, H, D), np.float32)
        for m, l, acc in parts:
            e = np.exp(m - M)
            L = L + l * e
            O = O + acc * e[..., None]
        dead = M <= np.float32(-0.5e30)
        o[s] = np.where(dead[..., None], 0.0, O / np.maximum(L, 1e-30)[
            ..., None])
        m_out[s] = M
        l_out[s] = np.where(dead, 0.0, L)
    return o, m_out, l_out


@pytest.mark.parametrize("nsplit", [1, 3, 8])
@pytest.mark.parametrize("seed,S,H,D,bs,mb", [
    (11, 4, 2, 64, 16, 8), (12, 5, 3, 32, 8, 16)])
def test_split_kv_merge_matches_jax_lax_and_pallas(nsplit, seed, S, H, D,
                                                   bs, mb):
    """The decode kernel's split-KV method at C = 1 (the kernel itself runs
    only on a card): partials over contiguous runs, merged by (m, l, acc),
    against the JAX package's lax oracle and its Pallas kernel in interpret
    mode. Pasts cover none, one position, a block edge, a tile edge and a
    full table, so that some runs are short or empty; the empty past comes
    out as o = 0, m = -1e30 and l = 0 exactly."""
    cap = bs * mb
    lengths = [0, 1, bs, 33, cap, cap - 1][:S]
    q, kp, vp, tables, lengths = _inputs(seed, S, 1, H, D, bs, mb, lengths)
    got = tuple(torch.from_numpy(a) for a in
                _split_kv_as_the_kernel_merges_it(q, kp, vp, tables,
                                                  lengths, nsplit))
    _close(got, _jax_lax(q, kp, vp, tables, lengths))
    _close(got, _jax_kernel(q, kp, vp, tables, lengths))
    o, m, l = got
    assert (o[0] == 0).all() and (l[0] == 0).all()
    assert (m[0] == np.float32(-1e30)).all()
