"""Serving checkpoints and the serveable-model family registry.

Counterpart of ``incubator_mxnet_tpu/serving/loader.py``. A serving
checkpoint is a ``utils/checkpoint.py`` directory (prefix ``serve``) whose
``meta.json`` carries a ``serving`` stanza naming the model family and its
construction config, plus a ``generation`` number that the directory's
``GENERATION.json`` pointer publishes. The layout is the JAX package's, so
either package loads what the other exported.

The port runs eager PyTorch: no AOT program is built, bound or exported.
A family's forwards run under ``torch.inference_mode()`` on the model's
device. Built-in families:

- ``bert_encoder``: models.bert.BERTModel, the pooled embedding (and the
  sequence output with ``emit_seq``);
- ``lstm_lm``: models.lstm_lm.RNNModel step decode, its recurrent state in
  the device-resident KVCache's state grid (one row per slot); with
  ``quantize`` its vocab projection runs int8 (serving.quant.Int8Dense).

``gpt_decoder`` (``generate/family.py``) registers when ``generate`` is
imported, which ``load_served_model`` does for a checkpoint of that family.
Live weight swaps (with the int8 head's re-quantization) wait for ROADMAP
Queue 1 item 3.
"""

import json
import os
import time

import numpy as np
import torch

from ..context import resolve_device
from ..utils.checkpoint import CheckpointManager
from .decode import check_token_ids
from .kv_cache import KVCache
from .quant import Int8Dense, int8_serving_enabled

__all__ = ["ServedModel", "serving_family", "export_for_serving",
           "load_served_model", "SERVING_FAMILIES", "GENERATION_POINTER",
           "publish_generation", "read_generation", "generation_steps"]

SERVING_FAMILIES = {}

GENERATION_POINTER = "GENERATION.json"


def serving_family(name):
    """Register ``builder(config, params, quantize, device) -> ServedModel``."""
    def wrap(builder):
        if name in SERVING_FAMILIES:
            raise ValueError("serving family %r already registered" % name)
        SERVING_FAMILIES[name] = builder
        return builder
    return wrap


class ServedModel:
    """What a family builder hands the server: the forward surfaces plus the
    facts the schedulers need. ``encode_fn(arrays, bucket) -> {name:
    np.ndarray}`` serves one-shot requests through the ContinuousBatcher;
    ``step_fn(tokens, cache, active) -> (slots, V) logits`` with
    ``make_cache(slots, max_len)`` serves generation through the
    DecodeLoop, which commits a prompt prefix through ``prefill_fn(slot,
    tokens, cache)`` in chunks of ``prefill_chunk`` when the family has
    one. ``params_swapper``, where a family has one, is the live weight
    swap, which no family of the port implements yet (ROADMAP Queue 1 item
    3)."""

    def __init__(self, family, config, encode_fn=None, step_fn=None,
                 make_cache=None, pad_token=0, quantized=False, device=None,
                 prefill_fn=None, prefill_chunk=None, params_swapper=None):
        if encode_fn is None and step_fn is None:
            raise ValueError("a ServedModel needs encode_fn, step_fn, "
                             "or both")
        if (step_fn is None) != (make_cache is None):
            raise ValueError("step_fn and make_cache come together")
        if prefill_fn is not None and step_fn is None:
            raise ValueError("prefill_fn requires step_fn")
        self.family = family
        self.config = dict(config)
        self.encode_fn = encode_fn
        self.step_fn = step_fn
        self.make_cache = make_cache
        self.prefill_fn = prefill_fn
        self.prefill_chunk = (int(prefill_chunk)
                              if prefill_chunk is not None else None)
        self.pad_token = int(pad_token)
        self.quantized = bool(quantized)
        self.device = device
        self.params_swapper = params_swapper
        self.generation = 0

    @property
    def has_encode(self):
        return self.encode_fn is not None

    @property
    def has_decode(self):
        return self.step_fn is not None


# ----------------------------------------------------------- generations
def _serve_mgr(directory, keep=None):
    return CheckpointManager(directory, keep=keep, async_save=False,
                             prefix="serve")


def read_generation(directory):
    """The published generation pointer ({"generation", "step", "time"})
    or None."""
    return _serve_mgr(directory).read_pointer(GENERATION_POINTER)


def publish_generation(directory, generation, step):
    """Atomically (re)point the directory's generation pointer."""
    return _serve_mgr(directory).publish_pointer(
        GENERATION_POINTER, {"generation": int(generation),
                             "step": int(step), "time": time.time()})


def generation_steps(directory):
    """{generation: step} for every retained serving checkpoint that
    carries a generation number (the newest step wins)."""
    mgr = _serve_mgr(directory)
    out = {}
    for s in mgr.steps():
        try:
            with open(os.path.join(directory, "serve-%08d" % s,
                                   "meta.json")) as f:
                meta = json.load(f)
        except (OSError, ValueError):
            continue
        if meta.get("generation") is not None:
            out[int(meta["generation"])] = int(s)
    return out


# ------------------------------------------------------------ export/load
def export_for_serving(directory, family, config, model, generation=None):
    """Write a serving checkpoint of ``model`` (an ``nn.Module`` whose
    parameter names are the JAX package's) under a new generation, and
    publish the generation pointer to it. A tensor shared by two names (a
    tied decoder) is written under both, as the JAX package writes it."""
    if family not in SERVING_FAMILIES:
        raise ValueError("unknown serving family %r (registered: %s)"
                         % (family, sorted(SERVING_FAMILIES)))
    params = {k: v.detach().cpu()
              for k, v in model.named_parameters(remove_duplicate=False)}
    mgr = _serve_mgr(directory)
    gens = generation_steps(directory)
    if generation is None:
        generation = max(gens, default=-1) + 1
    else:
        generation = int(generation)
        if gens and generation <= max(gens):
            raise ValueError(
                "generation numbers are monotonic: %d is not newer than "
                "the retained max %d" % (generation, max(gens)))
    step = mgr.latest_step()
    step = 0 if step is None else step + 1
    mgr.save(step, params, extra={"serving": {"family": family,
                                              "config": dict(config)},
                                  "generation": generation})
    publish_generation(directory, generation, step)
    return directory


def load_served_model(directory, quantize=None, generation=None, device=None):
    """Restore a serving checkpoint and build its family on ``device``
    (None: ``cuda:0``, raising without CUDA; ``"cpu"`` for the plain
    path). The generation pointer picks the checkpoint unless
    ``generation`` names a retained one. ``quantize=None`` reads
    ``MXTPU_SERVE_INT8`` (``int8_serving_enabled``)."""
    device = resolve_device(device)
    mgr = _serve_mgr(directory)
    step = None
    if generation is not None:
        gens = generation_steps(directory)
        if int(generation) not in gens:
            raise FileNotFoundError(
                "generation %d is not retained under %r (have: %s)"
                % (int(generation), directory, sorted(gens)))
        step = gens[int(generation)]
    else:
        ptr = read_generation(directory)
        if ptr is not None:
            step = generation_steps(directory).get(
                int(ptr.get("generation", -1)))
    _step, params, _trainer, meta = mgr.restore(step)
    info = meta.get("serving")
    if not isinstance(info, dict) or "family" not in info:
        raise ValueError("checkpoint under %r has no serving stanza - "
                         "export it with export_for_serving()" % directory)
    family = info["family"]
    builder = SERVING_FAMILIES.get(family)
    if builder is None and family == "gpt_decoder":
        # the generative family registers when generate/ is imported; a
        # server that never touched it can still load its checkpoints
        from .. import generate  # noqa: F401
        builder = SERVING_FAMILIES.get(family)
    if builder is None:
        raise ValueError("serving family %r is not part of this port"
                         % info["family"])
    if quantize is None:
        quantize = int8_serving_enabled()
    served = builder(dict(info.get("config") or {}), params,
                     bool(quantize), device)
    served.generation = int(meta.get("generation") or 0)
    return served


# ------------------------------------------------------- builtin families
def _ids_tensor(arrays, name, limit, device):
    a = np.asarray(arrays[name])
    if a.size and (a.min() < 0 or a.max() >= limit):
        raise ValueError("%s must lie in [0, %d), got [%d, %d]"
                         % (name, limit, a.min(), a.max()))
    return torch.from_numpy(a.astype(np.int64)).to(device)


@serving_family("bert_encoder")
def _build_bert_encoder(config, params, quantize, device):
    """One-shot BERT forward. Inputs: token_ids (B, T) int; optional
    token_types (B, T) int and valid_mask (B, T) float (zero-padded to the
    bucket, so padding is masked). Output: pooled (B, units), plus seq
    (B, T, units) when the config sets emit_seq. ``quantize`` is ignored,
    as in the JAX package's family."""
    from ..models.bert import BERTModel
    cfg = dict(vocab_size=int(config.get("vocab_size", 30522)),
               units=int(config.get("units", 768)),
               hidden_size=int(config.get("hidden_size", 3072)),
               num_layers=int(config.get("num_layers", 12)),
               num_heads=int(config.get("num_heads", 12)),
               max_length=int(config.get("max_length", 512)),
               dropout=0.0)
    model = BERTModel(device=device, **cfg)
    try:
        model.load_params(params)
    except KeyError as e:
        raise IOError("serving checkpoint does not match the bert_encoder "
                      "config: %s" % e) from e
    emit_seq = bool(config.get("emit_seq", False))
    vocab = cfg["vocab_size"]
    type_vocab = model.token_type_embed.weight.shape[0]

    def encode(arrays, _bucket):
        ids = _ids_tensor(arrays, "token_ids", vocab, device)
        types = (_ids_tensor(arrays, "token_types", type_vocab, device)
                 if "token_types" in arrays else None)
        mask = (torch.from_numpy(np.asarray(arrays["valid_mask"],
                                            np.float32)).to(device)
                if "valid_mask" in arrays else None)
        with torch.inference_mode():
            seq, pooled = model(ids, types, mask)
            out = {"pooled": pooled.cpu().numpy()}
            if emit_seq:
                out["seq"] = seq.cpu().numpy()
        return out

    return ServedModel("bert_encoder", config, encode, quantized=False,
                       device=device)


def _set_params(model, params):
    """Copy a restored param dict into a built gluon model by its
    ``_collect_params_with_prefix`` names (a tied weight under each of its
    names); every model param must be present in the checkpoint."""
    targets = model._collect_params_with_prefix()
    missing = sorted(set(targets) - set(params))
    if missing:
        raise IOError("serving checkpoint is missing params: %s"
                      % ", ".join(missing[:8]))
    for name, p in targets.items():
        p.set_data(params[name])


@serving_family("lstm_lm")
def _build_lstm_lm(config, params, quantize, device):
    """Autoregressive word-LM step decode. The recurrent state ((h, c) of
    every layer, or h) lives in the KVCache's state grid on ``device``, one
    (layers, hidden) row per slot, so sequences join and leave the fixed
    decode batch between steps. A step runs embed -> RNN (T = 1) -> the
    vocab head for all slots at once, writes the new states back into the
    cache on the device and returns only the (slots, V) logits to the host.
    With ``quantize`` the head is an ``Int8Dense`` built once from the
    decoder's weight and bias. There is no prefill_fn: the DecodeLoop feeds
    a prompt one token a step, as in the JAX package."""
    from .. import initializer as _init
    from ..models.lstm_lm import RNNModel
    mode = str(config.get("mode", "lstm"))
    layers = int(config.get("num_layers", 2))
    hidden = int(config.get("num_hidden", 650))
    vocab = int(config.get("vocab_size", 10000))
    cfg = dict(mode=mode, vocab_size=vocab,
               num_embed=int(config.get("num_embed", hidden)),
               num_hidden=hidden, num_layers=layers, dropout=0.0,
               tie_weights=bool(config.get("tie_weights", False)))
    model = RNNModel(prefix="serve_lm_", **cfg)
    model.initialize(_init.Zero(), ctx=device)
    _set_params(model, params)

    state_names = ("h", "c")[:2 if mode == "lstm" else 1]
    int8_head = None
    if quantize:
        dec = model.decoder
        int8_head = Int8Dense(dec.weight.data()._t,
                              dec.bias.data()._t if dec.bias is not None
                              else None, device=device)

    def make_cache(slots, max_len):
        return KVCache(slots, {s: ("state", (layers, hidden))
                               for s in state_names}, max_len=max_len,
                       device=device)

    def step(tokens, cache, _active):
        """DecodeLoop contract: tokens (slots,) over the FULL grid; every
        slot's state is read and replaced; returns (slots, V) logits."""
        s = int(tokens.shape[0])
        ids = check_token_ids(np.asarray(tokens), vocab)
        with torch.inference_mode():
            inp = torch.from_numpy(ids.astype(np.int64).reshape(1, s)) \
                .to(device)
            states = [cache.data[n].transpose(0, 1) for n in state_names]
            emb = model.encoder(inp)
            out, new_states = model.rnn(emb, states)
            if int8_head is None:
                logits = model.decoder(out)
            else:
                logits = int8_head(out.reshape(s, hidden))
            for n, st in zip(state_names, new_states):
                cache.data[n].copy_(st.transpose(0, 1))
            return logits.reshape(s, -1).cpu().numpy()

    def swap(*_args, **_kwargs):
        raise NotImplementedError("lstm_lm: live weight swap, and the int8 "
                                  "head's re-quantization on swap, are not "
                                  "ported yet (ROADMAP Queue 1 item 3)")

    served = ServedModel("lstm_lm", config, step_fn=step,
                         make_cache=make_cache, pad_token=0,
                         quantized=bool(quantize), device=device,
                         params_swapper=swap)
    served.model = model
    served.int8_head = int8_head
    return served
