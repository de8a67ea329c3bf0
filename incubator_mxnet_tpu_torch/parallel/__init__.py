"""Training on a device mesh: ``make_mesh`` and ``ShardedTrainer``, for one
device in this slice. Counterpart of ``incubator_mxnet_tpu/parallel/``."""

from .mesh import Mesh, make_mesh
from .trainer import ShardedTrainer

__all__ = ["Mesh", "make_mesh", "ShardedTrainer"]
