"""The ``gpt_decoder`` family's live weight swap against the JAX package's,
on the CPU (the reference's ``test_gpt_swap_keeps_sessions_and_programs``).

Both packages load generation 0 of one checkpoint written by the JAX
package (a 2-layer target and a 1-layer draft), prefill the same prompt
into a slot in chunks padded to 32, swap to generation 1 and take the next
step on the same cache: the session keeps its committed prefix (lengths,
block tables and pools untouched by the swap), and the step's logits equal
the JAX family's at rtol = atol = 1e-5. A drifted draft raises
``GenerationMismatchError`` before either set moves.
"""

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as mx
from incubator_mxnet_tpu import generate as jgen
from incubator_mxnet_tpu import nd
from incubator_mxnet_tpu import serving as jserving
from incubator_mxnet_tpu.models import gpt as jgpt
from incubator_mxnet_tpu_torch import serving

RTOL = ATOL = 1e-5
CFG = dict(vocab_size=37, units=16, num_layers=2, num_heads=2, max_len=96)
DRAFT = dict(vocab_size=37, units=8, num_layers=1, num_heads=2, max_len=96)
PROMPT = np.array([(7 * i + 3) % 37 for i in range(45)], np.int32)


def _jax_gpt(prefix, cfg, scale=1.0):
    m = jgpt.GPTDecoder(prefix=prefix, **cfg)
    m.initialize(mx.init.Normal(0.05))
    m(nd.array(np.zeros((1, 4), np.int32)))
    if scale != 1.0:
        for _n, p in m._collect_params_with_prefix().items():
            p.set_data(nd.array(np.asarray(p.data()._data) * scale))
    return m


@pytest.fixture(scope="module")
def gpt_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("gpt_gens"))
    np.random.seed(5)
    target, draft = _jax_gpt("dg_", CFG), _jax_gpt("dgd_", DRAFT)
    jgen.export_gpt_for_serving(d, CFG, target, draft=draft)
    for m in (target, draft):
        for _n, p in m._collect_params_with_prefix().items():
            p.set_data(nd.array(np.asarray(p.data()._data) * 1.2))
    jgen.export_gpt_for_serving(d, CFG, target, draft=draft)
    return d


def _prefilled(served, make_cache, slots=2):
    cache = make_cache(slots, 96)
    slot = cache.alloc()
    served.prefill_fn(slot, PROMPT[:-1], cache)
    return cache, slot


def _step(served, cache, slot, token, slots=2):
    toks = np.zeros(slots, np.int32)
    toks[slot] = token
    active = np.arange(slots) == slot
    return np.asarray(served.step_fn(toks, cache, active))


def test_gpt_swap_keeps_sessions_and_matches_jax(gpt_dir):
    served = serving.load_served_model(gpt_dir, device="cpu", generation=0)
    jserved = jserving.load_served_model(gpt_dir, quantize=False,
                                         generation=0)
    cache, slot = _prefilled(served, served.make_cache)
    jcache, jslot = _prefilled(jserved, jserved.make_cache)
    assert slot == jslot
    assert int(cache.lengths[slot]) == int(jcache.lengths[slot]) \
        == len(PROMPT) - 1
    got0 = _step(served, cache, slot, PROMPT[-1])
    want0 = _step(jserved, jcache, jslot, PROMPT[-1])
    np.testing.assert_allclose(got0, want0, rtol=RTOL, atol=ATOL)
    table = cache.table(slot)
    pools = {n: t.clone() for n, t in cache.data.items()}
    ptrs = [p.data_ptr() for m in (served.model, served.draft)
            for p in m.parameters()]
    params1, _ = serving.load_generation_params(gpt_dir, 1)
    served.swap_params(params1, 1)
    jserved.swap_params(jserving.load_generation_params(gpt_dir, 1)[0], 1)
    assert served.generation == 1
    # the in-flight session keeps its committed prefix...
    assert cache.table(slot) == table
    assert int(cache.lengths[slot]) == len(PROMPT)
    assert all(torch.equal(cache.data[n], pools[n]) for n in pools)
    assert ptrs == [p.data_ptr() for m in (served.model, served.draft)
                    for p in m.parameters()]
    # ...and its next step reads the new weights, as the JAX family's does
    got1 = _step(served, cache, slot, int(np.argmax(got0[slot])))
    want1 = _step(jserved, jcache, jslot, int(np.argmax(want0[jslot])))
    np.testing.assert_allclose(got1, want1, rtol=RTOL, atol=ATOL)
    fresh = serving.load_served_model(gpt_dir, device="cpu", generation=1)
    for a, b in zip(fresh.model.parameters(), served.model.parameters()):
        assert torch.equal(a, b)
    for a, b in zip(fresh.draft.parameters(), served.draft.parameters()):
        assert torch.equal(a, b)


def test_gpt_draft_drift_leaves_the_target_untouched(gpt_dir):
    served = serving.load_served_model(gpt_dir, device="cpu", generation=0)
    before = {n: p.clone() for n, p in served.model.named_parameters()}
    params1, _ = serving.load_generation_params(gpt_dir, 1)
    bad = dict(params1)
    bad["draft/wte"] = torch.zeros(3, 3)
    with pytest.raises(serving.GenerationMismatchError,
                       match=r"drifted \(draft\)"):
        served.swap_params(bad, 1)
    missing = {k: v for k, v in params1.items() if k != "draft/lnf_g"}
    with pytest.raises(serving.GenerationMismatchError,
                       match=r"missing gpt params \(draft\)"):
        served.swap_params(missing, 1)
    assert served.generation == 0
    for n, p in served.model.named_parameters():
        assert torch.equal(p, before[n])
    # the JAX family refuses the same drift
    jserved = jserving.load_served_model(gpt_dir, quantize=False,
                                         generation=0)
    with pytest.raises(jserving.GenerationMismatchError):
        jserved.swap_params({k: (v.numpy() if hasattr(v, "numpy") else v)
                             for k, v in bad.items()}, 1)


def test_gpt_prefill_pads_each_chunk_and_commits_the_valid_positions(
        gpt_dir):
    """A prompt prefix of 44 tokens is two forwards of 32 positions (the
    JAX family's padded chunks): the cache holds 44 positions, each equal
    to the K/V the JAX family committed."""
    served = serving.load_served_model(gpt_dir, device="cpu", generation=0)
    jserved = jserving.load_served_model(gpt_dir, quantize=False,
                                         generation=0)
    cache, slot = _prefilled(served, served.make_cache)
    jcache, _ = _prefilled(jserved, jserved.make_cache)
    assert served.prefill_chunk == 32
    for i in range(CFG["num_layers"]):
        for n in ("k%d" % i, "v%d" % i):
            np.testing.assert_allclose(cache.prefix(n, slot).numpy(),
                                       np.asarray(jcache.prefix(n, slot)),
                                       rtol=RTOL, atol=ATOL)
    assert served.extra_warmup(2) == {
        "built": [], "failed": ["gptdecode/s2", "gptprefill/s2xc32"]}
    assert served.decode_program_for(2) is None       # no graphs on the CPU
