"""Device meshes for the PyTorch port.

Counterpart of ``incubator_mxnet_tpu/parallel/mesh.py``. This slice trains
on one device, so a mesh names its axes and holds that device; an axis
larger than 1 raises NotImplementedError until scale-out over NCCL is ported
(ROADMAP Queue 1 item 12).
"""

from ..context import resolve_device

__all__ = ["Mesh", "make_mesh"]


class Mesh:
    """Named axes over devices: ``shape`` {axis: size}, ``axis_names``,
    ``devices`` and, for the one-device meshes of this slice, ``device``."""

    def __init__(self, shape, devices):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)
        self.devices = list(devices)

    @property
    def device(self):
        return self.devices[0]

    def __repr__(self):
        return "Mesh(%s, devices=%s)" % (self.shape, self.devices)


def make_mesh(axes, devices=None):
    """A Mesh from {'dp': 1, ...}; a size of -1 is the device count over the
    other sizes. ``devices=None`` is ``[cuda:0]`` and raises without CUDA;
    pass ``devices=["cpu"]`` for the host."""
    devices = [resolve_device(d) for d in (devices or [None])]
    names, sizes = list(axes), list(axes.values())
    if -1 in sizes:
        known = 1
        for s in sizes:
            if s != -1:
                known *= s
        sizes[sizes.index(-1)] = len(devices) // known
    total = 1
    for s in sizes:
        total *= s
    if total > len(devices) or any(s <= 0 for s in sizes):
        raise ValueError("mesh %s needs %d devices, have %d"
                         % (dict(zip(names, sizes)), total, len(devices)))
    big = {n: s for n, s in zip(names, sizes) if s > 1}
    if big:
        raise NotImplementedError(
            "make_mesh: axes %s span more than one device; scale-out over "
            "NCCL is ROADMAP Queue 1 item 12" % big)
    return Mesh(dict(zip(names, sizes)), devices[:1])
