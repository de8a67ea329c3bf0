"""``gpt_decoder`` serving family: the GPT decoder on the slot grid.

Counterpart of ``incubator_mxnet_tpu/generate/family.py``. Wires
``models/gpt.py`` and ``paged_kv`` into the DecodeLoop's contract
(``step_fn(tokens, cache, active)`` over a fixed slot grid) plus the chunked
prompt ingestion ``prefill_fn(slot, tokens, cache)``, so a joining prompt is
committed in ``ceil(P / chunk)`` forwards instead of P one-token steps.

The KV pools live on the device (``PagedKVCache``). A forward uploads the
step's tokens, lengths and block tables as one int32 buffer, runs
``gpt_forward_paged`` under ``torch.inference_mode()``, then commits the new
K and V of the live rows with one indexed write per pool, outside the
forward, as the JAX package commits outside its program, and returns the
logits to the host. A prefill chunk is padded to the family's chunk,
``MXTPU_GEN_PREFILL_CHUNK`` positions (default 32) read when the family is
built, as in the JAX package, so that one program serves every chunk:
pad tokens sit after the valid ones, causal masking keeps them out of every
committed position's window, and their K and V are not committed.

On a CUDA device the forward of each shape is a CUDA graph
(``compilecache.aot.BlockProgram``), the port's counterpart of the JAX
package's AOT programs: ``gptdecode/s%d`` for the grid step and
``gptprefill/s%dxc%d`` for a prefill chunk. A program reads its cache's
pools in place, so it belongs to that cache (one per cache the family
made). ``swap`` copies a new generation's weights into the served tensors
in place, the target's and the draft's, after checking both sets: the
graphs and the sessions that survive the server's drain go on with their
committed prefix against the new weights.

A checkpoint may carry a draft model (params under ``draft/``, config under
``config["draft"]``) for the engine's speculative decoding; it is loaded,
checked and swapped, and the step path ignores it, as in the JAX package.
"""

import logging

import numpy as np
import torch

from ..models.gpt import GPTDecoder, gpt_config, params_from_jax
from ..serving.decode import check_token_ids
from ..serving.loader import GenerationMismatchError, ServedModel, \
    _aval, _serve_mgr, generation_steps, publish_generation, serving_family
from .paged_kv import PagedKVCache, _env_int

__all__ = ["export_gpt_for_serving", "gpt_cache_spec", "commit_chunk",
           "PREFILL_CHUNK"]

log = logging.getLogger(__name__)

_DRAFT_PREFIX = "draft/"

#: prompt positions per prefill forward unless MXTPU_GEN_PREFILL_CHUNK says
#: otherwise; the served model carries it to the DecodeLoop, whose admission
#: estimate counts chunks of this size
PREFILL_CHUNK = 32


def gpt_cache_spec(cfg):
    """PagedKVCache spec for a gpt config: per-layer k/v (H, D) entries."""
    cfg = gpt_config(cfg)
    H = cfg["num_heads"]
    D = cfg["units"] // H
    spec = {}
    for i in range(cfg["num_layers"]):
        spec["k%d" % i] = ("kv", (H, D))
        spec["v%d" % i] = ("kv", (H, D))
    return spec


_CONFIG_KEYS = ("vocab_size", "units", "num_layers", "num_heads", "max_len",
                "ffn_hidden", "moe_experts", "moe_top_k",
                "moe_capacity_factor")


def _decoder(config, params, device, what):
    """A served GPTDecoder with a checkpoint's weights in their dtype, as the
    JAX family's ``jnp.asarray`` keeps them: an fp16 checkpoint is served in
    fp16 (over the default fp32 pools), and a swap must then bring fp16
    weights. A bfloat16 checkpoint is the exception: the JAX family cannot
    load one (``jnp.asarray`` of the restored bf16 NDArrays raises), so it
    is served as the port always served it, widened to fp32 (ROADMAP Queue
    3); ``GPTPagedLM`` is the path that computes in bf16."""
    model = GPTDecoder(device=device,
                       **{k: config[k] for k in _CONFIG_KEYS if k in config})
    try:
        model.load_params(params)
    except (KeyError, ValueError) as e:
        raise IOError("gpt serving checkpoint does not match the %s config: "
                      "%s" % (what, e)) from e
    if any(p.dtype == torch.bfloat16 for p in model.parameters()):
        model.float()
    return model


def commit_chunk(cache, num_layers, new_k, new_v, counts):
    """Commit chunk positions into the cache: ``counts`` is ``[(slot, row,
    n)]``, the first n positions of row ``row`` of new_k / new_v (per-layer
    (S, C, H, D) tensors) go to ``slot``. Every slot is extended first, then
    each pool takes one indexed write of all its new rows, cast to the
    pool's dtype."""
    dst, src = [], []
    C = new_k[0].shape[1]
    for slot, row, n in counts:
        dst += cache.extend(slot, n)
        src += range(row * C, row * C + n)
    if not dst:
        return
    dev = cache.device
    dst = torch.tensor(dst, dtype=torch.long, device=dev)
    if src == list(range(len(src))):        # a leading run: no gather
        pick = slice(0, len(src))
    else:
        pick = torch.tensor(src, dtype=torch.long, device=dev)
    for i in range(num_layers):
        for name, new in (("k%d" % i, new_k[i]), ("v%d" % i, new_v[i])):
            H, D = new.shape[2:]
            cache.write_rows(name, dst, new.reshape(-1, H, D)[pick])


def stage_swap(model, params, tag):
    """Check an incoming param dict against ``model``'s (GPTDecoder) and
    return its values as tensors: nothing is mutated here, so a mismatch on
    the draft cannot leave the target half-swapped. Raises
    GenerationMismatchError on missing params or shape/dtype drift."""
    current = dict(model.named_parameters())
    missing = [n for n in sorted(current) if n not in params]
    if missing:
        raise GenerationMismatchError(
            "incoming generation is missing gpt params (%s): %s"
            % (tag, ", ".join(missing[:8])))
    drift = []
    for n in sorted(current):
        (cs, cd), (ns, nd_) = _aval(current[n]), _aval(params[n])
        if cs != ns or cd != nd_:
            drift.append("%s: %s%s -> %s%s" % (n, cd, cs, nd_, ns))
    if drift:
        raise GenerationMismatchError(
            "incoming generation's gpt avals drifted (%s): %s"
            % (tag, "; ".join(drift[:8])))
    return params_from_jax({n: params[n] for n in current}, model.config,
                           "cpu")


def apply_swap(model, vals):
    """Copy staged values into ``model``'s parameters in place: the eager
    path and every captured graph read those tensors."""
    with torch.no_grad():
        for n, p in model.named_parameters():
            ptr = p.data_ptr()
            p.copy_(vals[n])
            if p.data_ptr() != ptr:
                raise RuntimeError("gpt swap moved %s" % n)


@serving_family("gpt_decoder")
def _build_gpt_decoder(config, params, quantize, device):
    """Autoregressive GPT decode over a paged KV cache on ``device``. The
    DecodeLoop steps the target one token at a time and prefills through
    ``prefill_fn``. ``quantize`` is ignored: the family has no int8 path,
    as in the JAX package."""
    cfg = gpt_config({k: v for k, v in config.items() if k != "draft"})
    if quantize:
        log.info("serving: gpt_decoder has no int8 path; serving full "
                 "precision")
    model = _decoder(cfg, {k: v for k, v in params.items()
                           if not k.startswith(_DRAFT_PREFIX)}, device,
                     "target")
    draft = None
    if isinstance(config.get("draft"), dict):
        draft = _decoder(gpt_config(config["draft"]),
                         {k[len(_DRAFT_PREFIX):]: v for k, v in params.items()
                          if k.startswith(_DRAFT_PREFIX)}, device, "draft")
    L = cfg["num_layers"]
    chunk = _env_int("MXTPU_GEN_PREFILL_CHUNK", PREFILL_CHUNK)
    caches = {}                 # slots -> the last cache made of that size
    decode_programs = {}        # (name, id(cache)) -> BlockProgram

    def make_cache(slots, max_len):
        cache = PagedKVCache(slots, gpt_cache_spec(cfg), max_len=max_len,
                             name="gpt", device=device)
        caches[int(slots)] = cache
        return cache

    def pack(cache, slots, tokens):
        """tokens (S, C), the slots' lengths and block tables as one flat
        int32 array: a single upload."""
        tokens = check_token_ids(tokens, cfg["vocab_size"])
        lengths = cache.lengths[list(slots)].astype(np.int32)
        return np.concatenate([np.asarray(tokens, np.int32).ravel(), lengths,
                               cache.tables_array(slots).ravel()])

    def forward(cache, rows, C):
        """The paged forward over a packed buffer, reading ``cache``'s
        pools in place: -> (logits (S, C, V), new_k x L, new_v x L)."""
        kps = [cache.pool("k%d" % i) for i in range(L)]
        vps = [cache.pool("v%d" % i) for i in range(L)]
        mb = cache.max_blocks_per_slot

        def fn(packed):
            tokens = packed[:rows * C].view(rows, C)
            lengths = packed[rows * C:rows * (C + 1)]
            tables = packed[rows * (C + 1):].view(rows, mb)
            logits, nk, nv = model.forward_paged(tokens, lengths, tables,
                                                 kps, vps)
            return (logits,) + tuple(nk) + tuple(nv)
        return fn

    def program(cache, name, rows, C):
        key = (name, id(cache))     # the program keeps its cache alive
        if key not in decode_programs:
            size = rows * (C + 1 + cache.max_blocks_per_slot)
            decode_programs[key] = served.new_program(
                name, forward(cache, rows, C),
                [torch.zeros(size, dtype=torch.int32, device=device)],
                bound=(cache,), samples=rows * C)
        return decode_programs[key]

    def run(cache, name, rows, C, packed):
        packed = torch.from_numpy(packed)
        if not served.graphs:
            return served.run_eager(name, forward(cache, rows, C),
                                    [packed.to(device)], samples=rows * C)
        return program(cache, name, rows, C)(packed)

    def step(tokens, cache, active):
        """DecodeLoop contract: tokens (slots,) int32 over the FULL grid;
        commit K/V for active slots only; return (slots, V) logits."""
        s = int(tokens.shape[0])
        packed = pack(cache, range(s), np.asarray(tokens).reshape(s, 1))
        with torch.inference_mode():
            outs = run(cache, "gptdecode/s%d" % s, s, 1, packed)
            commit_chunk(cache, L, outs[1:1 + L], outs[1 + L:],
                         [(int(slot), int(slot), 1)
                          for slot in np.flatnonzero(np.asarray(active))])
            return outs[0][:, 0].cpu().numpy()

    def prefill(slot, tokens, cache):
        """Commit a prompt prefix into one slot in chunks padded to the
        family's chunk; only the valid positions are committed."""
        name = "gptprefill/s%dxc%d" % (cache.slots, chunk)
        tokens = np.asarray(tokens, np.int32).ravel()
        with torch.inference_mode():
            for start in range(0, len(tokens), chunk):
                piece = tokens[start:start + chunk]
                padded = np.zeros((1, chunk), np.int32)
                padded[0, :len(piece)] = piece
                outs = run(cache, name, 1, chunk, pack(cache, [slot], padded))
                commit_chunk(cache, L, outs[1:1 + L], outs[1 + L:],
                             [(slot, 0, len(piece))])

    def decode_program_for(slots):
        """The grid step's program over the last cache made with ``slots``
        slots, or None when there is none."""
        cache = caches.get(int(slots))
        if cache is None:
            return None
        return program(cache, "gptdecode/s%d" % slots, slots, 1)

    def extra_warmup(slots):
        """Capture the generative program grid for a slot count (the grid
        step and the prefill chunk over the last cache made with that many
        slots) by running each once on zero inputs, which writes nothing.
        Returns {"built": [...], "failed": [...]}; on the CPU, with graphs
        off or before a cache of that size exists, every name is in
        "failed"."""
        built, failed = [], []
        cache = caches.get(int(slots))
        for name, rows, C in (("gptdecode/s%d" % slots, slots, 1),
                              ("gptprefill/s%dxc%d" % (slots, chunk), 1,
                               chunk)):
            if cache is None or not served.graphs:
                failed.append(name)
                continue
            prog = program(cache, name, rows, C)
            if prog.graph is None:
                with torch.inference_mode():
                    prog(*prog.inputs)
            built.append(name)
        return {"built": built, "failed": failed}

    def swap(params):
        """Live weight push: params only, the cache untouched (its pools
        are read in place, not captured state), so sessions that survive
        the server's drain keep their committed prefix. Both sets are
        checked before either is touched."""
        staged = [(model, stage_swap(model, params, "target"))]
        if draft is not None:
            staged.append((draft, stage_swap(
                draft, {k[len(_DRAFT_PREFIX):]: v for k, v in params.items()
                        if k.startswith(_DRAFT_PREFIX)}, "draft")))
        for module, vals in staged:
            apply_swap(module, vals)

    served = ServedModel("gpt_decoder", config, step_fn=step,
                         make_cache=make_cache, pad_token=0, quantized=False,
                         device=device, prefill_fn=prefill,
                         prefill_chunk=chunk, params_swapper=swap,
                         decode_program_factory=decode_program_for,
                         decode_programs=decode_programs)
    served.model = model
    served.draft = draft
    served.extra_warmup = extra_warmup
    return served


def export_gpt_for_serving(directory, config, model, draft=None,
                           generation=None):
    """Write a gpt_decoder serving checkpoint: the target decoder's params
    (flat names), optionally a draft model's params under ``draft/`` with
    its config under ``config["draft"]``, plus the family stanza, under a
    new generation whose pointer is then published. Either package loads
    it."""
    params = {k: v.detach().cpu() for k, v in model.named_parameters()}
    config = dict(config)
    if draft is not None:
        params.update({_DRAFT_PREFIX + k: v.detach().cpu()
                       for k, v in draft.named_parameters()})
        config.setdefault("draft", getattr(draft, "config", None)
                          or config.get("draft"))
        if not isinstance(config.get("draft"), dict):
            raise ValueError("draft model carries no config dict; pass "
                             "config['draft'] explicitly")
    mgr = _serve_mgr(directory)
    gens = generation_steps(directory)
    if generation is None:
        generation = max(gens, default=-1) + 1
    elif gens and int(generation) <= max(gens):
        raise ValueError("generation numbers are monotonic: %d is not newer "
                         "than the retained max %d"
                         % (int(generation), max(gens)))
    step = mgr.latest_step()
    step = 0 if step is None else step + 1
    mgr.save(step, params, extra={"serving": {"family": "gpt_decoder",
                                              "config": config},
                                  "generation": int(generation)})
    publish_generation(directory, generation, step)
    return directory
