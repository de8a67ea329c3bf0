"""incubator_mxnet_tpu_torch - the PyTorch and CUDA port of incubator_mxnet_tpu.

The JAX package (``incubator_mxnet_tpu``) is the reference; this package
does what it does in PyTorch on an NVIDIA H100, with the JAX package's Pallas
kernels written again by hand for Hopper (``csrc/``, built at first use into
``build/torch_kernels/``). It imports neither JAX nor the JAX package.

Ported so far: serving a BERT encoder and GPT generation (``serving``,
``models``, ``generate``), ShardedTrainer training (``parallel``: fp32,
bf16 compute over fp32 masters, bf16-stored parameters with stochastic
rounding, the numeric guard's step) with ``resilience`` (the guardian,
rollback ring and watchdog around it), and the
eager gluon surface: ``nd`` (NDArray), ``autograd``, ``gluon`` (Block,
Parameter, layers, losses, Trainer, the ResNet zoo), ``init``,
``optimizer``, ``kvstore`` and ``lr_scheduler``, with the hand-written
kernels of ``ops.kernels``; ``rtc``, CUDA source compiled at run time
(NVRTC) and launched on the card; and the serving plane's observability:
``telemetry`` (metrics, request traces, flight records, costs, memz,
lockdep), ``profiler`` and ``utils.failpoints``.
"""

from . import telemetry  # noqa: I001 - first: MXTPU_LOCKDEP=1 patches locks
from . import (autograd, context, gluon, initializer, kvstore, lr_scheduler,
               ndarray, optimizer, profiler, resilience, rtc)
from .base import MXNetError
from .context import cpu, default_device, gpu, num_gpus, tpu

nd = ndarray
init = initializer

__all__ = ["autograd", "context", "gluon", "init", "initializer", "kvstore",
           "lr_scheduler", "nd", "ndarray", "optimizer", "profiler",
           "resilience", "rtc",
           "telemetry", "MXNetError",
           "cpu",
           "gpu", "tpu", "num_gpus", "default_device"]
