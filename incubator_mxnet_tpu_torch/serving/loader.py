"""Serving checkpoints and the serveable-model family registry.

Counterpart of ``incubator_mxnet_tpu/serving/loader.py``. A serving
checkpoint is a ``utils/checkpoint.py`` directory (prefix ``serve``) whose
``meta.json`` carries a ``serving`` stanza naming the model family and its
construction config, plus a ``generation`` number that the directory's
``GENERATION.json`` pointer publishes. The layout is the JAX package's, so
either package loads what the other exported.

A family's forwards run under ``torch.inference_mode()`` on the model's
device. On a CUDA device each served shape runs as a CUDA graph, the
port's counterpart of the JAX package's AOT programs
(``compilecache/aot.py`` ``BlockProgram``): captured on the shape's first
call and replayed after, reading the weights in place. On the CPU there are
no programs. A graph has no serialized form, so no executable is exported
or bound. Built-in families:

- ``bert_encoder``: models.bert.BERTModel, the pooled embedding (and the
  sequence output with ``emit_seq``);
- ``lstm_lm``: models.lstm_lm.RNNModel step decode, its recurrent state in
  the device-resident KVCache's state grid (one row per slot); with
  ``quantize`` its vocab projection runs int8 (serving.quant.Int8Dense).

``gpt_decoder`` (``generate/family.py``) registers when ``generate`` is
imported, which ``load_served_model`` does for a checkpoint of that family.

Every export is a generation. ``ServedModel.swap_params`` swaps a retained
generation's weights in live (``ModelServer.deploy`` drains the model
first): the family checks the incoming shapes and dtypes against the served
ones (``GenerationMismatchError`` on any drift, before a weight moves) and
copies them into the served tensors in place, so every captured graph reads
the new weights: zero recaptures. The int8 head is re-quantized in place.
"""

import json
import logging
import os
import time

import numpy as np
import torch

from ..compilecache.aot import BlockProgram, capture_lock
from ..telemetry import costs as _costs
from ..context import resolve_device
from ..utils.checkpoint import CheckpointManager
from .decode import check_token_ids
from .kv_cache import KVCache
from .quant import Int8Dense, int8_serving_enabled

__all__ = ["ServedModel", "serving_family", "export_for_serving",
           "load_served_model", "SERVING_FAMILIES",
           "GenerationMismatchError", "GENERATION_POINTER",
           "publish_generation", "read_generation", "generation_steps",
           "load_generation_params"]

log = logging.getLogger(__name__)

SERVING_FAMILIES = {}

GENERATION_POINTER = "GENERATION.json"


class GenerationMismatchError(ValueError):
    """A live weight swap was refused: the incoming generation's params do
    not match the served ones that the captured graphs read (missing
    params, or shape/dtype drift). The served weights are untouched; the
    deploy must re-export instead."""


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
    one.

    The program surfaces are family-owned: ``program_factory`` (``(rows,
    bucket, names) -> BlockProgram``, caching into ``programs``) and
    ``decode_program_factory`` (``(slots) -> BlockProgram``, caching into
    ``decode_programs``). A program is a CUDA graph captured on its first
    call (``new_program``); the family's programs share one graph memory
    pool, since one scheduler thread replays them. ``graphs`` is True on a
    CUDA device; set it False and every forward runs eagerly on the card
    (``chip_smoke.py`` compares the two). ``params_swapper`` is the live
    weight swap."""

    def __init__(self, family, config, encode_fn=None, step_fn=None,
                 make_cache=None, pad_token=0, quantized=False, device=None,
                 prefill_fn=None, prefill_chunk=None, params_swapper=None,
                 program_factory=None, decode_program_factory=None,
                 programs=None, decode_programs=None):
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
        self.program_factory = program_factory
        self.decode_program_factory = decode_program_factory
        self.programs = programs if programs is not None else {}
        self.decode_programs = (decode_programs
                                if decode_programs is not None else {})
        self.graphs = device is not None and \
            torch.device(device).type == "cuda"
        self.graph_counts = {"captured": 0, "replayed": 0}
        self._graph_pool = None
        self._eager_counted = set()     # program names counted eagerly
        self.generation = 0

    @property
    def has_encode(self):
        return self.encode_fn is not None

    @property
    def has_decode(self):
        return self.step_fn is not None

    # ------------------------------------------------------- programs
    def new_program(self, name, fn, example_inputs, bound=(), samples=None):
        """A BlockProgram of this family (see ``compilecache.aot``): its
        graph goes into the family's memory pool, its captures and replays
        into ``graph_counts``, and each capture counts as a "serving"
        compile. ``samples``: the tokens one call consumes."""
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        return BlockProgram(name, fn, example_inputs, pool=self._graph_pool,
                            bound=bound, counts=self.graph_counts,
                            where="serving", samples=samples)

    def run_eager(self, name, fn, inputs, samples=None):
        """``fn(*inputs)`` without a graph (the CPU, or ``graphs`` off). Its
        first call under each program ``name`` is counted under
        ``MXTPU_COSTS=1``, as a BlockProgram's warm-up is; a failed count
        still runs the call and is counted as a failure."""
        if name in self._eager_counted:
            return fn(*inputs)
        result, cost = _costs.run_counted(name, fn, inputs, samples)
        if cost is not None:
            self._eager_counted.add(name)
        return result

    def program_for(self, rows, bucket, names):
        """The encode program of this (rows, bucket, input-name)
        signature, captured on its first call. None on the CPU, with
        ``graphs`` off, or for a family without a program factory: the
        forward runs eagerly."""
        if self.program_factory is None or not self.graphs:
            return None
        return self.program_factory(int(rows), int(bucket), tuple(names))

    def decode_program_for(self, slots):
        """The decode-step program of this slot count, or None (see
        ``program_for``)."""
        if self.decode_program_factory is None or not self.graphs:
            return None
        return self.decode_program_factory(int(slots))

    def graph_stats(self):
        """{"captured", "replayed": CUDA graphs since load, "programs":
        programs held}."""
        out = dict(self.graph_counts)
        out["programs"] = sum(1 for progs in (self.programs,
                                              self.decode_programs)
                              for p in progs.values() if p is not None)
        return out

    def export_executables(self):
        """{executable name: blob} for a checkpoint ``executables``
        section: always empty here. A CUDA graph has no serialized form
        (``BlockProgram.dump`` raises), which the JAX package's contract
        covers as a backend without executable serialization: the program
        is captured again on demand."""
        out = {}
        for progs in (self.programs, self.decode_programs):
            for prog in progs.values():
                if prog is None:
                    continue
                try:
                    out[prog.name] = prog.dump()
                except NotImplementedError as e:
                    log.info("serving: %r not serializable (%s)",
                             prog.name, e)
        return out

    def bind_executable(self, name, blob):
        """Rebind a serialized executable from a checkpoint: always False
        here (no CUDA graph is serialized); the program is captured on
        demand, as the JAX package does with a foreign blob."""
        log.info("serving: executable %r (%d bytes) is not bound; its "
                 "program is captured on demand", name, len(blob or b""))
        return False

    # ---------------------------------------------------------- swaps
    def swap_params(self, params, generation):
        """Replace the served weights IN PLACE with ``params``, the live
        weight push. The family swapper checks the incoming avals first
        (GenerationMismatchError on any drift: the current weights keep
        serving) and then copies every weight into the tensor that the
        eager path and every captured graph read: zero recaptures. On a
        CUDA device the copies are complete when this returns. The caller
        (ModelServer.deploy) owns the scheduling contract: the model must
        be drained, never mid-batch."""
        if self.params_swapper is None:
            raise RuntimeError("serving family %r does not support live "
                               "param swap" % self.family)
        self.params_swapper(params)
        if self.device is not None and torch.device(self.device).type \
                == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        self.generation = int(generation)
        return self


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


def load_generation_params(directory, generation=None, pin=False):
    """Params + meta of one retained generation (default: the pointer's)
    without building the family: the swap payload for
    ``ServedModel.swap_params``. Params are CPU tensors, in pinned memory
    with ``pin`` (a faster copy to the card). Raises FileNotFoundError when
    the generation is not retained on disk."""
    mgr = _serve_mgr(directory)
    if generation is None:
        ptr = read_generation(directory)
        if not ptr:
            raise FileNotFoundError("no generation pointer under %r"
                                    % directory)
        generation = ptr["generation"]
    generation = int(generation)
    gens = generation_steps(directory)
    if generation not in gens:
        raise FileNotFoundError(
            "generation %d is not retained under %r (have: %s)"
            % (generation, directory, sorted(gens)))
    _step, params, _trainer, meta = mgr.restore(gens[generation])
    if pin:
        # Pinning allocates page-locked host memory (cudaHostAlloc through
        # PyTorch's caching host allocator) while a served model keeps
        # running; a CUDA graph capture on the batcher's thread was once
        # invalidated (cudaErrorStreamCaptureInvalidated) during a deploy's
        # pinning. The copies therefore hold the capture lock: no capture
        # runs while they do, and none waits longer than they take, since
        # the read from disk above runs without it.
        with capture_lock():
            params = {k: v.pin_memory() for k, v in params.items()}
    return params, meta


def _aval(value):
    """(shape, dtype name) of a tensor, either package's NDArray or an
    array; a bfloat16 tensor and an ml_dtypes bfloat16 array are both
    ``"bfloat16"``."""
    if hasattr(value, "_t") and isinstance(value._t, torch.Tensor):
        value = value._t                        # the port's NDArray
    if isinstance(value, torch.Tensor):
        return tuple(value.shape), str(value.dtype).replace("torch.", "")
    if hasattr(value, "asnumpy"):               # the JAX package's NDArray
        value = value.asnumpy()
    value = np.asarray(value)
    return tuple(value.shape), value.dtype.name


def check_generation_avals(current, new, context=""):
    """Check an incoming param dict against the served one: every current
    param must be in ``new`` with the same shape and dtype. Raises
    GenerationMismatchError naming the drift; extras in ``new`` are ignored
    (forward-compatible checkpoints)."""
    where = " (%s)" % context if context else ""
    missing = sorted(set(current) - set(new))
    if missing:
        raise GenerationMismatchError(
            "incoming generation is missing params%s: %s"
            % (where, ", ".join(missing[:8])))
    drift = []
    for name in sorted(current):
        (cs, cd), (ns, nd_) = _aval(current[name]), _aval(new[name])
        if cs != ns or cd != nd_:
            drift.append("%s: %s%s -> %s%s" % (name, cd, cs, nd_, ns))
    if drift:
        raise GenerationMismatchError(
            "incoming generation's avals drifted%s - the captured graphs "
            "read the served shapes: %s" % (where, "; ".join(drift[:8])))


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
def _host_ids(arrays, name, limit):
    """Token ids checked on the host, as an int64 CPU tensor (on the card
    an out-of-range embedding index is a device fault)."""
    a = np.asarray(arrays[name])
    if a.size and (a.min() < 0 or a.max() >= limit):
        raise ValueError("%s must lie in [0, %d), got [%d, %d]"
                         % (name, limit, a.min(), a.max()))
    return torch.from_numpy(a.astype(np.int64))


def _src_tensor(value):
    """A checkpoint value (tensor, either package's NDArray, array) as a
    tensor."""
    if hasattr(value, "_t") and isinstance(value._t, torch.Tensor):
        return value._t
    if isinstance(value, torch.Tensor):
        return value
    if hasattr(value, "asnumpy"):
        value = value.asnumpy()
    return torch.from_numpy(np.array(value))


def _swap_in_place(current, copy, program_dicts):
    """Run ``copy()`` under no_grad and refuse a copy that moved a served
    tensor (``current() -> {name: tensor}``) while programs exist: their
    graphs would go on reading the old one."""
    before = {n: t.data_ptr() for n, t in current().items()}
    with torch.no_grad():
        copy()
    moved = sorted(n for n, t in current().items()
                   if t.data_ptr() != before[n])
    if moved and any(program_dicts):
        raise RuntimeError("a weight swap moved %s instead of copying in "
                           "place; the captured graphs read the old "
                           "tensors" % ", ".join(moved[:8]))


def _module_swapper(module, program_dicts):
    """``params_swapper`` of an ``nn.Module`` whose parameter names are the
    checkpoint's (BERT): check the incoming avals against every parameter
    (all or nothing), then copy each into its tensor in place."""
    def current():
        return dict(module.named_parameters())

    def swap(params):
        check_generation_avals(current(), params)
        _swap_in_place(current, lambda: [
            p.copy_(_src_tensor(params[n])) for n, p in current().items()],
            program_dicts)
    return swap


def _gluon_swapper(model, program_dicts, after=None):
    """``params_swapper`` of a gluon-backed family: check the incoming
    avals against the served params (all or nothing: any drift raises
    before a weight moves), then copy the new weights into the served
    tensors in place (``Parameter.set_data`` does, the shapes being
    equal), so that the eager path and every program of ``program_dicts``
    read them. ``after`` runs last, for family-private derived state (the
    lstm int8 head's re-quantization)."""
    def current():
        return {n: p.data()._t
                for n, p in model._collect_params_with_prefix().items()}

    def swap(params):
        targets = model._collect_params_with_prefix()
        check_generation_avals(current(), params)
        _swap_in_place(current, lambda: [p.set_data(params[n])
                                         for n, p in targets.items()],
                       program_dicts)
        if after is not None:
            after()
    return swap


@serving_family("bert_encoder")
def _build_bert_encoder(config, params, quantize, device):
    """One-shot BERT forward. Inputs: token_ids (B, T) int; optional
    token_types (B, T) int and valid_mask (B, T) float (zero-padded to the
    bucket, so padding is masked). Output: pooled (B, units), plus seq
    (B, T, units) when the config sets emit_seq. ``quantize`` is ignored,
    as in the JAX package's family. On CUDA each (rows, bucket, input
    names) signature is one program (``encode/r%dxb%d/names``): the rows
    are the batcher's powers of two, and the names count because a mask or
    token types change the forward."""
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
    programs = {}

    def forward(names):
        """The encoder over inputs in sorted-name order."""
        def fn(ids, *rest):
            extra = dict(zip(names[1:], rest))
            return model(ids, extra.get("token_types"),
                         extra.get("valid_mask"))
        return fn

    def input_names(arrays):
        return tuple(n for n in sorted(arrays) if n in (
            "token_ids", "token_types", "valid_mask"))

    def program_name(rows, bucket, names):
        return "encode/r%dxb%d/%s" % (rows, bucket, "+".join(names))

    def program_for(rows, bucket, names):
        key = (rows, bucket, names)
        if key not in programs:
            ex = [torch.zeros((rows, bucket), dtype=torch.float32
                              if n == "valid_mask" else torch.int64,
                              device=device) for n in names]
            programs[key] = served.new_program(
                program_name(rows, bucket, names), forward(names), ex,
                samples=rows * bucket)
        return programs[key]

    def encode(arrays, _bucket):
        names = input_names(arrays)
        ins = []
        for n in names:
            if n == "valid_mask":
                ins.append(torch.from_numpy(np.asarray(arrays[n],
                                                       np.float32)))
            else:
                ins.append(_host_ids(arrays, n, vocab if n == "token_ids"
                                     else type_vocab))
        with torch.inference_mode():
            prog = served.program_for(ins[0].shape[0], ins[0].shape[1],
                                      names)
            if prog is None:
                rows, bucket = ins[0].shape
                seq, pooled = served.run_eager(
                    program_name(rows, bucket, names), forward(names),
                    [t.to(device) for t in ins], samples=rows * bucket)
            else:
                seq, pooled = prog(*ins)
            out = {"pooled": pooled.cpu().numpy()}
            if emit_seq:
                out["seq"] = seq.cpu().numpy()
        return out

    def cost_name(arrays, _bucket):
        """The program a batch of these padded arrays runs: the name its
        cost is counted under (telemetry.costs)."""
        names = input_names(arrays)
        rows, bucket = np.shape(arrays[names[0]])[:2]
        return program_name(rows, bucket, names)

    encode.cost_name = cost_name
    served = ServedModel("bert_encoder", config, encode, quantized=False,
                         device=device, program_factory=program_for,
                         programs=programs,
                         params_swapper=_module_swapper(model, [programs]))
    served.model = model
    return served


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
    With ``quantize`` the head is an ``Int8Dense`` quantized from the
    decoder's weight and bias, and re-quantized in place by a swap. On CUDA
    each slot count is one program (``decode/s%d``), the int8 head inside
    it. There is no prefill_fn: the DecodeLoop feeds a prompt one token a
    step, as in the JAX package."""
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
    dec = model.decoder
    int8_head = None
    if quantize:
        int8_head = Int8Dense(dec.weight.data()._t,
                              dec.bias.data()._t if dec.bias is not None
                              else None, device=device)
    embed = model.encoder.weight.data()._t
    decode_programs = {}

    def make_cache(slots, max_len):
        return KVCache(slots, {s: ("state", (layers, hidden))
                               for s in state_names}, max_len=max_len,
                       device=device, name="lstm_lm")

    def forward(ids, *states):
        """ids (1, S) int64 (checked on the host), states in the cache's
        (S, layers, hidden) layout -> (logits (S, V), new states in that
        layout)."""
        s = ids.shape[1]
        emb = torch.nn.functional.embedding(ids, embed)
        out, new_states = model.rnn(emb, [st.transpose(0, 1)
                                          for st in states])
        if int8_head is None:
            logits = model.decoder(out)
        else:
            logits = int8_head(out.reshape(s, hidden))
        return (logits.reshape(s, -1),) + tuple(st.transpose(0, 1)
                                                for st in new_states)

    def decode_program_for(slots):
        if slots not in decode_programs:
            ex = [torch.zeros((1, slots), dtype=torch.int64, device=device)]
            ex += [torch.zeros((slots, layers, hidden), device=device)
                   for _ in state_names]
            decode_programs[slots] = served.new_program(
                "decode/s%d" % slots, forward, ex, samples=slots)
        return decode_programs[slots]

    def step(tokens, cache, _active):
        """DecodeLoop contract: tokens (slots,) over the FULL grid; every
        slot's state is read and replaced; returns (slots, V) logits."""
        s = int(tokens.shape[0])
        ids = check_token_ids(np.asarray(tokens), vocab)
        ids = torch.from_numpy(ids.astype(np.int64).reshape(1, s))
        states = [cache.data[n] for n in state_names]
        with torch.inference_mode():
            prog = served.decode_program_for(s)
            if prog is None:
                outs = served.run_eager("decode/s%d" % s, forward,
                                        [ids.to(device)] + states,
                                        samples=s)
            else:
                outs = prog(ids, *states)
            for n, st in zip(state_names, outs[1:]):
                cache.data[n].copy_(st)
            return outs[0].cpu().numpy()

    def requantize_head():
        # the int8 head is quantized FROM the decoder weight: a swap
        # re-quantizes it in place, where the graphs read it
        if int8_head is not None:
            int8_head.requantize_(dec.weight.data()._t,
                                  dec.bias.data()._t if dec.bias is not None
                                  else None)

    served = ServedModel("lstm_lm", config, step_fn=step,
                         make_cache=make_cache, pad_token=0,
                         quantized=bool(quantize), device=device,
                         decode_program_factory=decode_program_for,
                         decode_programs=decode_programs,
                         params_swapper=_gluon_swapper(
                             model, [decode_programs],
                             after=requantize_head))
    served.model = model
    served.int8_head = int8_head
    return served
