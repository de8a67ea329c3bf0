"""``gpt_decoder`` serving family: the GPT decoder on the slot grid.

Counterpart of ``incubator_mxnet_tpu/generate/family.py``. Wires
``models/gpt.py`` and ``paged_kv`` into the DecodeLoop's contract
(``step_fn(tokens, cache, active)`` over a fixed slot grid) plus the chunked
prompt ingestion ``prefill_fn(slot, tokens, cache)``, so a joining prompt is
committed in ``ceil(P / chunk)`` forwards instead of P one-token steps.

The port runs the model eagerly under ``torch.inference_mode()`` on the
served device: there are no AOT programs, no warm-up grid and no live weight
swap. The KV pools live on the device (``PagedKVCache``); a step uploads the
lengths, block tables and tokens, runs ``gpt_forward_paged``, commits the new
K and V of the active rows with one indexed write per pool, and returns the
(slots, V) logits to the host. A prefill chunk is fed at its own width, not
padded to the chunk size: pad positions would change nothing a committed
position sees, only the work done.

A checkpoint may carry a draft model (params under ``draft/``, config under
``config["draft"]``) for the engine's speculative decoding; it is loaded and
checked, and the step path ignores it, as in the JAX package.
"""

import logging

import numpy as np
import torch

from ..models.gpt import GPTDecoder, gpt_config
from ..serving.decode import check_token_ids
from ..serving.loader import ServedModel, _serve_mgr, generation_steps, \
    publish_generation, serving_family
from .paged_kv import PagedKVCache

__all__ = ["export_gpt_for_serving", "gpt_cache_spec", "commit_chunk",
           "PREFILL_CHUNK"]

log = logging.getLogger(__name__)

_DRAFT_PREFIX = "draft/"

#: prompt positions per prefill forward; the served model carries it to the
#: DecodeLoop, whose admission estimate counts chunks of this size
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
    model = GPTDecoder(device=device,
                       **{k: config[k] for k in _CONFIG_KEYS if k in config})
    try:
        return model.load_params(params)
    except (KeyError, ValueError) as e:
        raise IOError("gpt serving checkpoint does not match the %s config: "
                      "%s" % (what, e)) from e


def commit_chunk(cache, num_layers, new_k, new_v, counts):
    """Commit chunk positions into the cache: ``counts`` is ``[(slot, row,
    n)]``, the first n positions of row ``row`` of new_k / new_v (per-layer
    (S, C, H, D) tensors) go to ``slot``. Every slot is extended first, then
    each pool takes one indexed write of all its new rows."""
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

    def make_cache(slots, max_len):
        return PagedKVCache(slots, gpt_cache_spec(cfg), max_len=max_len,
                            name="gpt", device=device)

    def _forward(cache, slots, tokens):
        tokens = check_token_ids(tokens, cfg["vocab_size"])
        lengths = torch.from_numpy(
            cache.lengths[list(slots)].astype(np.int32)).to(device)
        tables = torch.from_numpy(cache.tables_array(slots)).to(device)
        kps = [cache.pool("k%d" % i) for i in range(L)]
        vps = [cache.pool("v%d" % i) for i in range(L)]
        return model.forward_paged(torch.tensor(tokens, device=device),
                                   lengths, tables, kps, vps)

    def step(tokens, cache, active):
        """DecodeLoop contract: tokens (slots,) int32 over the FULL grid;
        commit K/V for active slots only; return (slots, V) logits."""
        s = int(tokens.shape[0])
        with torch.inference_mode():
            logits, nk, nv = _forward(
                cache, range(s), np.asarray(tokens, np.int32).reshape(s, 1))
            commit_chunk(cache, L, nk, nv,
                         [(int(slot), int(slot), 1)
                          for slot in np.flatnonzero(np.asarray(active))])
            return logits[:, 0].cpu().numpy()

    def prefill(slot, tokens, cache):
        """Commit a prompt prefix into one slot, ``PREFILL_CHUNK`` positions
        per forward."""
        tokens = np.asarray(tokens, np.int32).ravel()
        with torch.inference_mode():
            for start in range(0, len(tokens), PREFILL_CHUNK):
                piece = tokens[start:start + PREFILL_CHUNK][None]
                _logits, nk, nv = _forward(cache, [slot], piece)
                commit_chunk(cache, L, nk, nv, [(slot, 0, piece.shape[1])])

    served = ServedModel("gpt_decoder", config, step_fn=step,
                         make_cache=make_cache, pad_token=0, quantized=False,
                         device=device, prefill_fn=prefill,
                         prefill_chunk=PREFILL_CHUNK)
    served.model = model
    served.draft = draft
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
