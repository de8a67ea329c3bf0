"""Recording scopes and gradients for the eager (NDArray) frontend.

Counterpart of ``incubator_mxnet_tpu/autograd.py``: scoped
``record()/pause()/train_mode()/predict_mode()``, ``is_recording`` /
``is_training`` and their setters, ``mark_variables``,
``backward(heads, head_grads, retain_graph, create_graph)`` and the
functional ``grad()``.

The tape is torch autograd. An NDArray operation builds a graph only while
``record()`` is on (``ndarray.py`` runs every operation under
``torch.set_grad_enabled(is_recording())``), so nothing is recorded outside
it and ``pause()`` inside it stops recording. ``backward`` takes
``torch.autograd.grad`` of the heads with respect to every live marked
variable (``attach_grad`` / ``mark_variables`` / a Parameter's data) and
writes the result by its ``grad_req``: ``"write"`` overwrites the gradient
buffer, ``"add"`` accumulates into it, ``"null"`` has none; a variable the
heads do not reach keeps its buffer as it was. A head without a head
gradient gets ones. The port's autograd Functions (LayerNorm, softmax, flash
attention, BatchNorm's one-pass VJP) are engaged as under any torch graph.

``is_training()`` is the training flag the layers read (BatchNorm's batch
statistics), as in the JAX package; ``record()`` sets it unless
``train_mode=False``. A user-defined ``Function`` is not ported yet
(ROADMAP Queue 1 item 4) and raises.
"""

import threading
import weakref

import torch

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "mark_variables", "backward", "grad", "Function",
           "set_recording", "set_training"]

_state = threading.local()

# NDArrays marked as variables (autograd leaves), by identity; dead ones
# drop out
_LEAVES = weakref.WeakValueDictionary()


def _st():
    if not hasattr(_state, "recording"):
        _state.recording = False
        _state.training = False
    return _state


def is_recording():
    return _st().recording


def is_training():
    return _st().training


def set_recording(flag):
    st = _st()
    old, st.recording = st.recording, bool(flag)
    return old


def set_training(flag):
    st = _st()
    old, st.training = st.training, bool(flag)
    return old


class _RecordingScope:
    def __init__(self, recording, training):
        self._rec, self._train = recording, training

    def __enter__(self):
        st = _st()
        self._old = (st.recording, st.training)
        if self._rec is not None:
            st.recording = self._rec
        if self._train is not None:
            st.training = self._train
        return self

    def __exit__(self, *a):
        st = _st()
        st.recording, st.training = self._old
        return False


def record(train_mode=True):  # noqa: D401
    """Scope that records NDArray operations for ``backward``."""
    return _RecordingScope(True, train_mode)


def pause(train_mode=False):
    """Scope that suspends recording."""
    return _RecordingScope(False, train_mode)


def train_mode():
    return _RecordingScope(None, True)


def predict_mode():
    return _RecordingScope(None, False)


def _register_leaf(array):
    _LEAVES[id(array)] = array


def mark_variables(variables, gradients=None, grad_reqs="write"):
    """Attach gradient buffers to arrays, making them autograd leaves."""
    if not isinstance(variables, (list, tuple)):
        variables = [variables]
        gradients = [gradients] if gradients is not None else None
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for i, v in enumerate(variables):
        g = gradients[i] if gradients is not None else None
        v._mark_variable(g, grad_reqs[i])


def _heads(heads, head_grads):
    """(head tensors, head-gradient tensors), ones where none is given."""
    from .ndarray.ndarray import NDArray
    if isinstance(heads, NDArray):
        heads = [heads]
        if head_grads is not None and not isinstance(head_grads,
                                                     (list, tuple)):
            head_grads = [head_grads]
    outs, cts = [], []
    for i, h in enumerate(heads):
        t = h._t
        hg = head_grads[i] if head_grads is not None else None
        if hg is None:
            ct = torch.ones_like(t)
        elif isinstance(hg, NDArray):
            ct = hg._t
        else:
            ct = torch.as_tensor(hg, dtype=t.dtype, device=t.device)
        outs.append(t)
        cts.append(ct.to(t.dtype).expand(t.shape) if ct.shape != t.shape
                   else ct)
    return outs, cts


def _gradients(heads, head_grads, variables, retain_graph, create_graph):
    """torch.autograd.grad of the recorded heads with respect to the
    tensors of ``variables``; None where a variable is not reached."""
    outs, cts = _heads(heads, head_grads)
    live = [(o, c) for o, c in zip(outs, cts) if o.requires_grad]
    reach = [i for i, v in enumerate(variables) if v._t.requires_grad]
    out = [None] * len(variables)
    if not live or not reach:
        return out
    with torch.enable_grad():
        got = torch.autograd.grad(
            [o for o, _ in live], [variables[i]._t for i in reach],
            [c for _, c in live], retain_graph=retain_graph,
            create_graph=create_graph, allow_unused=True)
    for i, g in zip(reach, got):
        out[i] = g
    return out


def backward(heads, head_grads=None, retain_graph=False, train_mode=True,
             create_graph=False):
    """Gradients of ``heads`` into the ``grad`` buffers of the variables
    they reach, by each variable's ``grad_req``; ``create_graph`` keeps the
    graph and makes the buffers differentiable."""
    leaves = [v for v in list(_LEAVES.values())
              if v._grad_req not in (None, "null") and v._t.requires_grad]
    grads = _gradients(heads, head_grads, leaves,
                       retain_graph or create_graph, create_graph)
    for v, g in zip(leaves, grads):
        if g is not None:
            v._accumulate_grad(g, create_graph)


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """Functional gradient: the gradients of ``heads`` with respect to
    ``variables`` (recorded arrays), without touching any ``grad`` buffer;
    zeros where a variable is not reached."""
    from .ndarray.ndarray import NDArray
    single = isinstance(variables, NDArray)
    if single:
        variables = [variables]
    if retain_graph is None:
        retain_graph = create_graph
    raw = _gradients(heads, head_grads, variables, retain_graph,
                     create_graph)
    outs = [NDArray(g if g is not None else torch.zeros_like(v._t))
            for v, g in zip(variables, raw)]
    return outs[0] if single else outs


class Function:
    """A user-defined differentiable function (forward and backward over
    NDArrays). Not ported yet: it raises (ROADMAP Queue 1 item 4)."""

    def __init__(self):
        self._saved = None

    def save_for_backward(self, *args):
        self._saved = args

    @property
    def saved_tensors(self):
        return self._saved

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *output_grads):
        raise NotImplementedError

    def __call__(self, *inputs):
        raise NotImplementedError(
            "autograd.Function is not ported yet (ROADMAP Queue 1 item 4); "
            "a torch.autograd.Function over the NDArrays' tensors is the "
            "way to a custom gradient meanwhile")
