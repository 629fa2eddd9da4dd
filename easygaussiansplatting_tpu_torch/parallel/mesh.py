"""The (data, gs) device mesh over the ranks of a process group.

Port of easygaussiansplatting_tpu/parallel/mesh.py (``make_mesh``,
``mesh_axis_size``). The two axes keep their meaning:

* ``data`` — cameras per step: each data row renders its own cameras;
* ``gs``   — the gaussian pool: each rank of a data row holds a contiguous
  block of the pool's rows (parameters, Adam moments, density stats).

A device of the JAX mesh is a rank here: one process, one card. Ranks lie
data-major, ``rank = d * gs + g``, the flattened index JAX's bands use.
Where JAX's GSPMD inserted collectives, the port calls them through
``parallel/collectives.py`` on the mesh's process groups: one per data row
(its gs ranks, the "gs" group), one per gs column (its data ranks, the
"data" group) and the whole mesh ("all"). A mesh of one rank needs no
process group; its collectives are identities.
"""

import dataclasses
import math

import torch.distributed as dist

def mesh_shape(n_devices, data=None):
    """(data, gs) of a mesh of ``n_devices``: ``data`` defaults to the
    largest power of two <= sqrt(n) that divides n, so 8 -> (2, 4), 4 ->
    (2, 2), 2 -> (1, 2), 1 -> (1, 1); JAX's rule and its error."""
    if data is None:
        data = 1
        limit = int(math.isqrt(n_devices))
        d = 2
        while d <= limit and n_devices % d == 0:
            data = d
            d *= 2
    if n_devices % data != 0:
        raise ValueError(f"data axis {data} does not divide {n_devices} devices")
    return data, n_devices // data


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A (data, gs) mesh seen from one rank. ``groups`` maps "data", "gs"
    and "all" to this rank's process groups (empty for a one-rank mesh
    without a process group); ``hosts`` counts the hosts its ranks span
    (parallel/distributed.py ``make_multihost_mesh`` finds it)."""

    data: int
    gs: int
    rank: int
    groups: dict
    hosts: int = 1

    @property
    def shape(self):
        return {"data": self.data, "gs": self.gs}

    @property
    def size(self):
        return self.data * self.gs

    def index(self, axis):
        """This rank's index along ``axis`` ("data", "gs" or "all")."""
        d, g = divmod(self.rank, self.gs)
        return {"data": d, "gs": g, "all": self.rank}[axis]

    def axis_size(self, axis):
        return {"data": self.data, "gs": self.gs, "all": self.size}[axis]


def _axis_groups(data, gs, rank):
    """Every rank creates every group, in one order (``new_group`` is
    collective over the default group); each keeps its own."""
    groups = {"all": dist.group.WORLD}
    for d in range(data):
        ranks = list(range(d * gs, (d + 1) * gs))
        pg = dist.new_group(ranks)
        if rank in ranks:
            groups["gs"] = pg
    for g in range(gs):
        ranks = list(range(g, data * gs, gs))
        pg = dist.new_group(ranks)
        if rank in ranks:
            groups["data"] = pg
    return groups


def make_mesh(n_devices=None, data=None):
    """The (data, gs) mesh over the ranks of the default process group
    (one rank, and no group, when none is initialised). ``n_devices``, when
    given, must equal the group's size: a rank cannot sit out of the mesh.
    ``data`` as in :func:`mesh_shape`. Every rank must call this, in the
    same order as its other group creations."""
    initialised = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialised else 1
    n = world if n_devices is None else n_devices
    if n != world:
        raise ValueError(f"a mesh of {n} devices needs {n} ranks; the process group has "
                         f"{world}")
    data, gs = mesh_shape(n, data)
    rank = dist.get_rank() if initialised else 0
    groups = _axis_groups(data, gs, rank) if initialised else {}
    return Mesh(data=data, gs=gs, rank=rank, groups=groups)


def mesh_axis_size(mesh, name):
    return mesh.shape[name]
