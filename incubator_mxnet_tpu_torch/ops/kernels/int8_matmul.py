"""Exact int8 x int8 -> int32 matrix product: the CUDA kernel's wrappers and
their plain PyTorch versions.

Counterpart of ``incubator_mxnet_tpu/ops/pallas/int8_matmul.py``
(``int8_matmul``). Two entries, one kernel (``csrc/int8_matmul.cu``):

- ``int8_matmul(a, b)``: a (M, K) int8, b (K, N) int8 -> (M, N) int32, the
  JAX package's signature. The kernel reads its second operand as (N, K),
  K-contiguous, so b is passed as ``b.t().contiguous()``: no copy when b is
  the transposed view of an (N, K) tensor, one plain-PyTorch copy otherwise.
- ``int8_matmul_nk(a, w)``: a (M, K) int8, w (N, K) int8 -> a @ w.T, the
  (out, in) layout in which ``Int8Dense`` and ``quantized_fully_connected``
  keep their weight, with no copy.

Both add one to ``int8_matmul.launches`` where they launch the kernel. The
kernel takes any M, N and K up to ``K_MAX``: the TPU wrapper's tiling assert
(``M % min(512, M) == 0``) does not carry over. For CPU tensors both take
the plain version; for CUDA tensors they launch the kernel or raise.

``_route`` picks the kernel's route from the shape and the operands'
addresses: ``"small"`` for M <= 16 (the decode tile: each block requests
all of its K share at once and its warps split the k-steps, ``mma.sync``),
``"tma"`` for larger M with both bases 16-byte aligned and K % 16 == 0
(``wgmma`` fed by TMA), ``"bytes"`` for anything else (byte-wide loads).
The C entry refuses a route whose condition fails.
"""

import torch

from ...telemetry import costs as _costs
from . import _build

__all__ = ["int8_matmul", "int8_matmul_nk", "int8_matmul_reference",
           "int8_matmul_nk_reference", "K_MAX"]

#: the longest contraction whose int32 sum of int8 products cannot overflow:
#: K * 128 * 128 < 2**31
K_MAX = (2 ** 31 - 1) // (128 * 128)

#: the C entry's route codes
ROUTES = {"small": 0, "tma": 1, "bytes": 2}
#: rows of C a block of the bytes route owns (the grid's y extent)
_BYTES_BLOCK_M = 128


def _route(M, K, a_ptr, w_ptr):
    """The kernel's route for an (M, K) x (N, K) product whose operands
    start at byte addresses a_ptr and w_ptr."""
    if M <= 16:
        return "small"
    if a_ptr % 16 == 0 and w_ptr % 16 == 0 and K % 16 == 0:
        return "tma"
    return "bytes"


def int8_matmul_nk_reference(a, w):
    """a (M, K) @ w (N, K).T as int32, widened before the product. The
    product runs in float64, where every partial sum of int8 products with
    K <= K_MAX is an integer below 2**53 and so exact in any order (int8 @
    int8 in torch wraps in int8, and CUDA has no int32 matmul)."""
    return torch.matmul(a.to(torch.float64),
                        w.to(torch.float64).t()).to(torch.int32)


def int8_matmul_reference(a, b):
    """a (M, K) @ b (K, N) as int32 (see ``int8_matmul_nk_reference``)."""
    return int8_matmul_nk_reference(a, b.t())


def _check_cuda(a, w, what):
    for name, t in (("a", a), (what, w)):
        if t.device != a.device:
            raise ValueError("int8_matmul: %s on %s, a on %s"
                             % (name, t.device, a.device))
        if t.dtype != torch.int8:
            raise TypeError("int8_matmul: %s must be int8, got %s"
                            % (name, t.dtype))
        if t.dim() != 2:
            raise ValueError("int8_matmul: %s must be 2-D, got %s"
                             % (name, tuple(t.shape)))
        if not t.is_contiguous():
            raise ValueError("int8_matmul: %s is not contiguous" % name)
    M, K = a.shape
    N, K2 = w.shape
    if K != K2:
        raise ValueError("int8_matmul: a is (%d, %d) but the weight's "
                         "contraction is %d" % (M, K, K2))
    if K > K_MAX:
        raise ValueError("int8_matmul: K = %d can overflow an int32 sum "
                         "(the kernel takes K <= %d)" % (K, K_MAX))
    if max(M, N) >= 2 ** 31:
        raise ValueError("int8_matmul: (%d, %d) is outside the kernel's "
                         "grid" % (M, N))
    return M, N, K


def _launch(a, w, what):
    M, N, K = _check_cuda(a, w, what)
    if M == 0 or N == 0 or K == 0:
        return torch.zeros((M, N), dtype=torch.int32, device=a.device)
    route = _route(M, K, a.data_ptr(), w.data_ptr())
    if route == "bytes" and -(-M // _BYTES_BLOCK_M) > 65535:
        raise ValueError("int8_matmul: M = %d is outside the byte-load "
                         "route's grid" % M)
    out = torch.empty((M, N), dtype=torch.int32, device=a.device)
    dev = a.device
    rc = _build.library().mxtpu_int8_matmul_nk(
        a.data_ptr(), w.data_ptr(), out.data_ptr(), M, N, K, ROUTES[route],
        dev.index, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "int8_matmul")
    _build.count_launch(int8_matmul,
                        lambda: _costs.int8_matmul_cost(M, N, K)[::-1])
    return out


def _on_cpu(a, w):
    """True for CPU operands (the plain version); False for CUDA ones."""
    if a.device.type == "cpu" and w.device.type == "cpu":
        return True
    if a.device.type != "cuda":
        raise ValueError("int8_matmul: unsupported device %s" % a.device)
    return False


def int8_matmul(a, b):
    """(M, K) int8 x (K, N) int8 -> (M, N) int32, exact."""
    if _on_cpu(a, b):
        return int8_matmul_reference(a, b)
    if b.dim() != 2:
        raise ValueError("int8_matmul: b must be 2-D, got %s"
                         % (tuple(b.shape),))
    return _launch(a, b.t().contiguous(), "b")


def int8_matmul_nk(a, w):
    """(M, K) int8 x (N, K) int8 -> (M, N) int32 = a @ w.T, exact."""
    if _on_cpu(a, w):
        return int8_matmul_nk_reference(a, w)
    return _launch(a, w, "w")


int8_matmul.launches = 0
