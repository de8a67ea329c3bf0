"""GPT: the causal decoder LLM of the generation path, in PyTorch.

Counterpart of ``incubator_mxnet_tpu/models/gpt.py``: a pre-LN transformer
decoder in the GPT-2 layout (learned token and position embeddings, per layer
``x += proj(attn(ln1(x)))`` then ``x += mlp(ln2(x))``, a final LayerNorm, and
logits through the tied token embedding), over the same flat parameter names
(``wte``, ``wpe``, ``h0_qkv_w``, ..., ``lnf_b``) and the same ``x @ W``
layouts (``qkv_w`` is (d, 3d), ``fc_w`` is (d, f)), so weights cross between
the packages by name (``params_from_jax``).

Two forwards over a flat parameter dict:

- :func:`gpt_logits`, the full-sequence forward (B, T) -> (B, T, V), the
  oracle of the paged path;
- :func:`gpt_forward_paged`, the incremental forward: a chunk of C new tokens
  per sequence attends its paged KV history through
  ``ops/kernels/flash_decode.paged_causal_attention`` and returns the
  chunk's K and V for the caller to commit. C > 1 is chunked prefill, C = 1
  decode.

LayerNorm goes through the LayerNorm kernel (``ops/nn.layer_norm``, with the
JAX package's ``_ln`` arithmetic), the full-sequence softmax through the
softmax kernel, and the MLP's GELU is the tanh approximation that
``jax.nn.gelu`` defaults to. The MoE feed-forward (``moe_experts > 0``,
``parallel/moe.py`` in the JAX package) is not part of the port yet.

The forwards compute in the weights' dtype, float32, bfloat16 or float16, as
the JAX package's do: 16-bit weights give 16-bit activations, logits and new
K/V, the LayerNorm and attention kernels' flavours of that dtype, and 16-bit
products through ``torch.matmul`` (fp32 sums, rounded once to the dtype). On
the CPU an fp16 product runs as the fp32 product of the fp16 values rounded
once to fp16: the same function as PyTorch's CPU fp16 GEMM (fp32 sums, one
rounding), which has no fast kernel on a CPU without fp16 arithmetic and
there runs tens of times slower than the bf16 one. A 16-bit model may read
fp32 pools or pools of its own dtype. The full-sequence forward masks future
keys with -1e30 in the scores' dtype, as ``jnp.where`` does: -inf in fp16,
which the softmax turns into exact zeros.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..context import resolve_device
from ..ops.kernels.flash_decode import paged_causal_attention
from ..ops.nn import layer_norm, softmax
from .bert import _to_tensor

__all__ = ["GPTDecoder", "gpt_config", "gpt_param_shapes", "gpt_logits",
           "gpt_forward_paged", "params_from_jax"]

_LN_EPS = 1e-5


def gpt_config(config):
    """Normalize a config dict, filling derived defaults."""
    cfg = dict(config)
    cfg.setdefault("max_len", 512)
    cfg.setdefault("ffn_hidden", 4 * cfg["units"])
    cfg.setdefault("moe_experts", 0)
    cfg.setdefault("moe_top_k", 2)
    cfg.setdefault("moe_capacity_factor", 1.25)
    for key in ("vocab_size", "units", "num_layers", "num_heads"):
        if key not in cfg:
            raise ValueError("gpt config missing %r" % key)
    if cfg["units"] % cfg["num_heads"]:
        raise ValueError("units (%d) must divide by num_heads (%d)"
                         % (cfg["units"], cfg["num_heads"]))
    if cfg["moe_experts"]:
        raise NotImplementedError(
            "gpt with moe_experts > 0 needs the MoE feed-forward "
            "(parallel/moe.py), which comes with a later slice of the port")
    return cfg


def gpt_param_shapes(cfg):
    """Flat ``name -> shape`` map of every decoder parameter."""
    d, f = cfg["units"], cfg["ffn_hidden"]
    shapes = {"wte": (cfg["vocab_size"], d), "wpe": (cfg["max_len"], d)}
    for i in range(cfg["num_layers"]):
        p = "h%d_" % i
        shapes[p + "ln1_g"] = (d,)
        shapes[p + "ln1_b"] = (d,)
        shapes[p + "qkv_w"] = (d, 3 * d)
        shapes[p + "qkv_b"] = (3 * d,)
        shapes[p + "proj_w"] = (d, d)
        shapes[p + "proj_b"] = (d,)
        shapes[p + "ln2_g"] = (d,)
        shapes[p + "ln2_b"] = (d,)
        shapes[p + "fc_w"] = (d, f)
        shapes[p + "fc_b"] = (f,)
        shapes[p + "out_w"] = (f, d)
        shapes[p + "out_b"] = (d,)
    shapes["lnf_g"] = (d,)
    shapes["lnf_b"] = (d,)
    return shapes


def _ln(x, params, name):
    return layer_norm(x, params[name + "_g"], params[name + "_b"],
                      eps=_LN_EPS)


def _product(fn, *args):
    """``fn(*args)``, a product of tensors of one dtype; an fp16 one on the
    CPU as the fp32 product rounded once to fp16 (see the module
    docstring)."""
    ts = [a for a in args if isinstance(a, torch.Tensor)]
    if ts[0].dtype != torch.float16 or ts[0].device.type != "cpu":
        return fn(*args)
    return fn(*(a.float() if isinstance(a, torch.Tensor) else a
                for a in args)).half()


def _dense(x, w, b):
    """x @ w + b over the last axis, w in the JAX (in, out) layout."""
    lead = x.shape[:-1]
    return _product(torch.addmm, b, x.reshape(-1, x.shape[-1]), w).reshape(
        *lead, w.shape[1])


def _mlp(x, params, p):
    h = F.gelu(_dense(x, params[p + "fc_w"], params[p + "fc_b"]),
               approximate="tanh")
    return _dense(h, params[p + "out_w"], params[p + "out_b"])


def _mask_value(dtype):
    """-1e30 rounded to ``dtype`` as jnp rounds a Python float against an
    array of that dtype: -inf in float16."""
    return float(torch.tensor(-1e30).to(dtype))


def gpt_logits(params, cfg, tokens):
    """Full-sequence causal forward: (B, T) int tokens -> (B, T, V)."""
    cfg = gpt_config(cfg)
    B, T = tokens.shape
    H = cfg["num_heads"]
    d = cfg["units"]
    D = d // H
    scale = 1.0 / math.sqrt(D)
    dev = params["wte"].device
    tokens = torch.as_tensor(tokens, device=dev).long()
    pos = torch.arange(T, device=dev)
    x = params["wte"][tokens] + params["wpe"][pos][None]
    future = pos[:, None] < pos[None, :]
    for i in range(cfg["num_layers"]):
        p = "h%d_" % i
        qkv = _dense(_ln(x, params, p + "ln1"), params[p + "qkv_w"],
                     params[p + "qkv_b"])
        q, k, v = (a.reshape(B, T, H, D) for a in qkv.split(d, dim=-1))
        s = _product(torch.einsum, "bqhd,bkhd->bhqk", q, k) * scale
        a = softmax(s.masked_fill(future, _mask_value(s.dtype)), axis=-1)
        o = _product(torch.einsum, "bhqk,bkhd->bqhd", a, v)
        x = x + _dense(o.reshape(B, T, d), params[p + "proj_w"],
                       params[p + "proj_b"])
        x = x + _mlp(_ln(x, params, p + "ln2"), params, p)
    x = _ln(x, params, "lnf")
    return _product(torch.matmul, x, params["wte"].t())


def gpt_forward_paged(params, cfg, tokens, lengths, block_tables, k_pools,
                      v_pools):
    """Incremental decode forward over the paged KV cache.

    tokens (S, C) int, C new tokens per sequence (C = 1 decode, C > 1
    chunked prefill); lengths (S,) int32, the committed past positions;
    block_tables (S, MB) int32; k_pools / v_pools, per-layer lists of
    (num_blocks, block_size, H, D) pool tensors. lengths and block_tables
    are tensors on the pools' device.

    Returns ``(logits (S, C, V), new_k, new_v)``, where new_k / new_v are
    per-layer (S, C, H, D) chunk projections for the caller to commit into
    the cache. Positions are clipped at ``max_len - 1``, as in the JAX
    package."""
    cfg = gpt_config(cfg)
    S, C = tokens.shape
    H = cfg["num_heads"]
    d = cfg["units"]
    D = d // H
    dev = params["wte"].device
    tokens = torch.as_tensor(tokens, device=dev).long()
    positions = (lengths.long()[:, None]
                 + torch.arange(C, device=dev)[None]).clamp(
                     0, cfg["max_len"] - 1)
    x = params["wte"][tokens] + params["wpe"][positions]
    new_k, new_v = [], []
    for i in range(cfg["num_layers"]):
        p = "h%d_" % i
        qkv = _dense(_ln(x, params, p + "ln1"), params[p + "qkv_w"],
                     params[p + "qkv_b"])
        q, k, v = (a.reshape(S, C, H, D) for a in qkv.split(d, dim=-1))
        new_k.append(k)
        new_v.append(v)
        att = paged_causal_attention(q, k, v, k_pools[i], v_pools[i],
                                     block_tables, lengths)
        x = x + _dense(att.reshape(S, C, d), params[p + "proj_w"],
                       params[p + "proj_b"])
        x = x + _mlp(_ln(x, params, p + "ln2"), params, p)
    x = _ln(x, params, "lnf")
    return _product(torch.matmul, x, params["wte"].t()), new_k, new_v


#: the dtypes a weight keeps; any other float dtype is carried as float32
_WEIGHT_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def params_from_jax(params, cfg, device):
    """Carry a GPT parameter dict named as the JAX package names it onto
    ``device``. A float32, bfloat16 or float16 weight keeps its dtype, as
    the JAX package's ``jnp.asarray`` keeps it, so 16-bit weights compute
    in their dtype; any other dtype is carried as float32. The key set must
    be exactly ``cfg``'s and every shape must match, else KeyError /
    ValueError."""
    expected = gpt_param_shapes(gpt_config(cfg))
    tensors = {str(k): _to_tensor(v) for k, v in params.items()}
    missing = sorted(set(expected) - set(tensors))
    extra = sorted(set(tensors) - set(expected))
    if missing or extra:
        raise KeyError("GPT parameter names do not match: missing %s, extra "
                       "%s" % (missing[:8], extra[:8]))
    for name, shape in expected.items():
        if tuple(tensors[name].shape) != shape:
            raise ValueError("%s: shape %s, expected %s"
                             % (name, tuple(tensors[name].shape), shape))
    return {name: t.to(device=device, dtype=t.dtype if t.dtype in
                       _WEIGHT_DTYPES else torch.float32)
            for name, t in tensors.items()}


class GPTDecoder(nn.Module):
    """The decoder as an ``nn.Module`` whose parameter names are the JAX
    package's flat names, so a serving checkpoint of either package loads
    into it.

    ``device=None`` is ``cuda:0`` and raises without CUDA; pass
    ``device="cpu"`` for the plain path. Weights are drawn from N(0, 0.02)
    (biases 0, LayerNorm gains 1) with a ``torch.Generator`` seeded from
    ``seed`` on that device; ``load_params`` replaces them. ``forward`` is
    :func:`gpt_logits`, ``forward_paged`` :func:`gpt_forward_paged`."""

    def __init__(self, vocab_size, units, num_layers, num_heads, max_len=512,
                 ffn_hidden=None, moe_experts=0, moe_top_k=2,
                 moe_capacity_factor=1.25, device=None, seed=0):
        super().__init__()
        device = resolve_device(device)
        self._cfg = gpt_config(dict(
            vocab_size=vocab_size, units=units, num_layers=num_layers,
            num_heads=num_heads, max_len=max_len,
            ffn_hidden=ffn_hidden or 4 * units, moe_experts=moe_experts,
            moe_top_k=moe_top_k, moe_capacity_factor=moe_capacity_factor))
        for name, shape in gpt_param_shapes(self._cfg).items():
            self.register_parameter(name, nn.Parameter(
                torch.empty(shape, device=device), requires_grad=False))
        self.reset_parameters(seed)
        self.eval()

    @property
    def config(self):
        return dict(self._cfg)

    @property
    def device(self):
        return self.wte.device

    def params(self):
        """The flat ``name -> tensor`` dict the forwards take."""
        return dict(self.named_parameters())

    def reset_parameters(self, seed=0):
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name.endswith("_b"):
                    p.zero_()
                elif name.endswith("_g"):
                    p.fill_(1.0)
                else:
                    p.normal_(0.0, 0.02, generator=gen)

    def load_params(self, params):
        """Copy a JAX-named parameter dict (numpy arrays, tensors or the JAX
        package's NDArrays) into this model; every key and shape must
        match. Each parameter takes the incoming weight's dtype (float32,
        bfloat16 or float16, see ``params_from_jax``), so the model computes
        in the dtype it was given."""
        state = params_from_jax(params, self._cfg, self.device)
        with torch.no_grad():
            for name, p in self.named_parameters():
                if p.dtype != state[name].dtype:
                    p.data = torch.empty_like(state[name])
                p.copy_(state[name])
        return self

    def forward(self, tokens):
        return gpt_logits(self.params(), self._cfg, tokens)

    def forward_paged(self, tokens, lengths, block_tables, k_pools, v_pools):
        return gpt_forward_paged(self.params(), self._cfg, tokens, lengths,
                                 block_tables, k_pools, v_pools)
