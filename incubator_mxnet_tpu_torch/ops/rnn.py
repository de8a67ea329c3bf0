"""Fused multi-layer RNN (vanilla / LSTM / GRU) of the PyTorch port.

Counterpart of ``incubator_mxnet_tpu/ops/rnn.py``: modes ``rnn_relu``,
``rnn_tanh``, ``lstm`` and ``gru``, several layers, bidirectional, the
(T, N, C) layout and the reference's packed flat parameter vector (all
weights of every layer and direction first, then all biases). Gate order is
i, f, g, o (LSTM) and r, z, n (GRU), as in the reference and cuDNN.

Each layer and direction hoists its input projection out of the time loop
into one (T * N, C) matmul and then steps through time in a Python loop
(the JAX package's ``lax.scan``), with the recurrent matmul and the gates in
plain PyTorch; the JAX package has no Pallas kernel here. Inter-layer
dropout while training is random and waits for the Dropout op (ROADMAP
Queue 1 item 5); serving runs with p = 0.
"""

import torch

from .registry import register

__all__ = ["rnn_forward", "rnn_param_slices", "unpack_rnn_params",
           "rnn_param_size", "rnn"]

_GATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}


def _cell_step(mode):
    if mode == "lstm":
        def step(carry, xw, wh, bh):
            h, c = carry
            gates = xw + torch.matmul(h, wh.t()) + bh
            i, f, g, o = gates.chunk(4, dim=-1)
            i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
            g = torch.tanh(g)
            c_new = f * c + i * g
            h_new = o * torch.tanh(c_new)
            return (h_new, c_new), h_new
        return step
    if mode == "gru":
        def step(carry, xw, wh, bh):
            (h,) = carry
            hw = torch.matmul(h, wh.t()) + bh
            xr, xz, xn = xw.chunk(3, dim=-1)
            hr, hz, hn = hw.chunk(3, dim=-1)
            r = torch.sigmoid(xr + hr)
            z = torch.sigmoid(xz + hz)
            n = torch.tanh(xn + r * hn)
            h_new = (1 - z) * n + z * h
            return (h_new,), h_new
        return step
    if mode not in _GATES:
        raise ValueError("unknown RNN mode %r (one of %s)"
                         % (mode, sorted(_GATES)))
    act = torch.relu if mode == "rnn_relu" else torch.tanh

    def step(carry, xw, wh, bh):
        (h,) = carry
        h_new = act(xw + torch.matmul(h, wh.t()) + bh)
        return (h_new,), h_new
    return step


def _run_layer(x, wx, wh, bx, bh, h0, c0, mode, reverse=False):
    """x: (T, N, C). Returns (out (T, N, H), h_T, c_T or None)."""
    step = _cell_step(mode)
    # the input projection of every step in one (T * N, C) matmul
    xw = torch.matmul(x, wx.t()) + bx
    carry = (h0, c0) if mode == "lstm" else (h0,)
    order = range(x.shape[0] - 1, -1, -1) if reverse else range(x.shape[0])
    ys = [None] * x.shape[0]
    for t in order:
        carry, ys[t] = step(carry, xw[t], wh, bh)
    out = torch.stack(ys, dim=0)
    if mode == "lstm":
        return out, carry[0], carry[1]
    return out, carry[0], None


def rnn_forward(data, layer_params, init_h, init_c=None, mode="lstm",
                bidirectional=False, p=0.0, training=False):
    """Structured-weight fused RNN.

    data: (T, N, C). layer_params: a list over layers of lists over
    directions of dicts {wx, wh, bx, bh}. init_h / init_c: (num_layers *
    dirs, N, H). Returns (out (T, N, H * dirs), h_n, c_n or None)."""
    dirs = 2 if bidirectional else 1
    if p > 0 and training and len(layer_params) > 1:
        raise NotImplementedError(
            "inter-layer RNN dropout in training draws random masks: the "
            "Dropout op is not ported yet (ROADMAP Queue 1 item 5)")
    x = data
    hs, cs = [], []
    for li, dir_params in enumerate(layer_params):
        outs = []
        for d in range(dirs):
            pr = dir_params[d]
            idx = li * dirs + d
            c0 = init_c[idx] if init_c is not None else None
            out, hT, cT = _run_layer(x, pr["wx"], pr["wh"], pr["bx"],
                                     pr["bh"], init_h[idx], c0, mode,
                                     reverse=(d == 1))
            outs.append(out)
            hs.append(hT)
            if cT is not None:
                cs.append(cT)
        x = outs[0] if dirs == 1 else torch.cat(outs, dim=-1)
    h_n = torch.stack(hs, dim=0)
    c_n = torch.stack(cs, dim=0) if cs else None
    return x, h_n, c_n


def rnn_param_slices(input_size, state_size, num_layers, mode,
                     bidirectional=False):
    """The packed-vector layout (reference rnn-inl.h: all weights for every
    layer and direction first, then all biases) as (role, layer, direction,
    shape, offset) tuples."""
    g = _GATES[mode]
    dirs = 2 if bidirectional else 1
    H = state_size
    out = []
    off = 0
    for li in range(num_layers):
        in_sz = input_size if li == 0 else H * dirs
        for d in range(dirs):
            for role, shp in (("wx", (g * H, in_sz)), ("wh", (g * H, H))):
                out.append((role, li, d, shp, off))
                off += shp[0] * shp[1]
    for li in range(num_layers):
        for d in range(dirs):
            for role in ("bx", "bh"):
                out.append((role, li, d, (g * H,), off))
                off += g * H
    return out


def unpack_rnn_params(parameters, input_size, state_size, num_layers, mode,
                      bidirectional=False, projection_size=None):
    """The reference's flat parameter vector as per-layer / direction dicts
    (layout: ``rnn_param_slices``); the dicts hold views."""
    dirs = 2 if bidirectional else 1
    layers = [[{} for _ in range(dirs)] for _ in range(num_layers)]
    for role, li, d, shp, off in rnn_param_slices(
            input_size, state_size, num_layers, mode, bidirectional):
        n = 1
        for s in shp:
            n *= s
        layers[li][d][role] = parameters[off:off + n].reshape(shp)
    return layers


def rnn_param_size(input_size, state_size, num_layers, mode,
                   bidirectional=False):
    g = _GATES[mode]
    dirs = 2 if bidirectional else 1
    H = state_size
    total = 0
    for li in range(num_layers):
        in_sz = input_size if li == 0 else H * dirs
        total += dirs * (g * H * in_sz + g * H * H + 2 * g * H)
    return total


def _rnn_num_outputs(attrs):
    """Output arity of the RNN op (the reference's FNumOutputs): out [, h_n
    [, c_n]]."""
    so = attrs.get("state_outputs", True)
    if isinstance(so, str):
        so = so.lower() in ("true", "1")
    if not so:
        return 1
    return 3 if str(attrs.get("mode", "lstm")) == "lstm" else 2


@register("RNN", num_outputs=_rnn_num_outputs)
def rnn(data, parameters, state, state_cell=None, state_size=None,
        num_layers=1, mode="lstm", bidirectional=False, p=0.0,
        state_outputs=True, training=False, **_ignored):
    """Packed-parameter fused RNN op, the reference's ``RNN`` symbol.

    data: (T, N, C); state: (L * dirs, N, H); lstm also takes state_cell.
    Returns out, or (out, h_n[, c_n]) with ``state_outputs``."""
    layer_params = unpack_rnn_params(parameters, data.shape[2], state_size,
                                     num_layers, mode, bidirectional)
    out, h_n, c_n = rnn_forward(data, layer_params, state, state_cell, mode,
                                bidirectional, p, training)
    if not state_outputs:
        return out
    if mode == "lstm":
        return out, h_n, c_n
    return out, h_n
