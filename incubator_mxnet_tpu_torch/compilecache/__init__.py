"""compilecache/ - the served shapes' compiled programs.

Counterpart of ``incubator_mxnet_tpu/compilecache/``, of the part that
``serving/`` and ``generate/family.py`` call: ``aot.BlockProgram``, here one
CUDA graph per served shape (the JAX package's AOT executable per shape),
with its telemetry: a capture counts as a compile
(``mxtpu_jit_compiles_total``), its footprint goes to memz and, under
``MXTPU_COSTS=1``, its counted FLOPs to ``telemetry.costs``. The JAX
package's on-disk store, its warm-up module and executable blobs wait for
ROADMAP Queue 1 item 13: a CUDA graph has no serialized form.
"""

from . import aot
from .aot import BlockProgram, CaptureError

__all__ = ["aot", "BlockProgram", "CaptureError"]
