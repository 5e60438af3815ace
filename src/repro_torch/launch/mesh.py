"""Meshes of the port: named axes over the ranks of ``torch.distributed``.

Port of ``repro.launch.mesh``.  A ``Mesh`` holds the axis names and shape
(``mesh.shape["model"]`` as in JAX), this rank's coordinates (row-major over
the axes: rank ``r`` of a ``(2, 2)`` ``("data", "model")`` mesh is at
``data = r // 2``, ``model = r % 2``), and, once a process group is up, the
process group of every axis and of every tuple of axes, its ranks in mesh
order (data-major).  A mesh built without a process group is abstract: it
carries the shape only, which is all the rule tables of
``repro_torch.distributed.sharding`` and ``launch.shapes.input_specs`` read.

The shapes are JAX's, so the rule tables compare one to one: the production
mesh is ``(16, 16)`` ``("data", "model")``, or ``(2, 16, 16)`` with a
leading ``"pod"`` axis.  On H100 hosts a model axis of 16 spans two 8-GPU
NVLink domains, so its collectives would cross the hosts' network; which
mesh to run in production on H100s is an open question of ``ROADMAP.md``.

``init_mesh`` needs ``torch.distributed`` initialised with the mesh's size;
nothing here reads a cluster's environment: the caller gives
``init_process_group`` its address, world size and rank.
"""
from __future__ import annotations

import datetime
import itertools
import math
from typing import Dict, Optional, Sequence, Tuple

Axes = Tuple[str, ...]


class Mesh:
    """Named axes over ``prod(shape)`` ranks; ``groups`` maps each tuple of
    axes (in mesh order) to this rank's process group along them (None for
    an axis tuple of size 1), or is None for an abstract mesh."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 rank: int = 0, groups: Optional[Dict[Axes, object]] = None):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {tuple(shape)} against axes "
                             f"{tuple(axis_names)}")
        self.axis_names: Axes = tuple(axis_names)
        self.devices_shape = tuple(int(s) for s in shape)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              self.devices_shape))
        self.size = math.prod(self.devices_shape)
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} outside a mesh of {self.size}")
        self.rank = rank
        idx, coords = rank, {}
        for name, n in reversed(list(self.shape.items())):
            coords[name] = idx % n
            idx //= n
        self.coords: Dict[str, int] = {a: coords[a] for a in self.axis_names}
        self.groups = groups

    @property
    def abstract(self) -> bool:
        return self.groups is None

    def axes(self, names) -> Axes:
        """``names`` (one axis or a tuple) as a tuple in mesh order."""
        names = (names,) if isinstance(names, str) else tuple(names)
        for a in names:
            if a not in self.shape:
                raise ValueError(f"no axis {a!r} in mesh {self.axis_names}")
        return tuple(a for a in self.axis_names if a in names)

    def index(self, names) -> int:
        """This rank's index along ``names``, row-major in mesh order."""
        i = 0
        for a in self.axes(names):
            i = i * self.shape[a] + self.coords[a]
        return i

    def ranks(self, names) -> Tuple[int, ...]:
        """The global ranks of this rank's group along ``names``, in mesh
        order."""
        along = self.axes(names)
        out = []
        for vals in itertools.product(*(range(self.shape[a])
                                        for a in along)):
            c = dict(self.coords)
            c.update(zip(along, vals))
            r = 0
            for a in self.axis_names:
                r = r * self.shape[a] + c[a]
            out.append(r)
        return tuple(out)

    def group(self, names):
        """The process group along ``names`` (None when its size is 1)."""
        if self.groups is None:
            raise ValueError(f"mesh {self.devices_shape} is abstract: it has "
                             "no process group")
        return self.groups[self.axes(names)]

    def __repr__(self) -> str:
        kind = "abstract " if self.abstract else ""
        return (f"Mesh({kind}{dict(self.shape)}, rank={self.rank}, "
                f"coords={self.coords})")


def axis_tuples(axis_names: Axes):
    """Every non-empty tuple of axes, in mesh order."""
    for n in range(1, len(axis_names) + 1):
        yield from itertools.combinations(axis_names, n)


def init_mesh(shape: Sequence[int], axis_names: Sequence[str], *,
              timeout_s: float = 120.0) -> Mesh:
    """This rank's ``Mesh`` over the initialised default process group
    (its world size must be ``prod(shape)``), with one group per tuple of
    axes and per value of the other axes' coordinates.  Every rank creates
    every group in the same order, as ``torch.distributed.new_group``
    requires; groups of one rank are not created.  ``timeout_s`` bounds
    each group's collectives, so a mismatched collective raises."""
    import torch.distributed as dist
    if not dist.is_initialized():
        raise ValueError("init_mesh needs torch.distributed initialised")
    world, rank = dist.get_world_size(), dist.get_rank()
    n = math.prod(shape)
    if world != n:
        raise ValueError(f"a {tuple(shape)} mesh needs {n} ranks, the "
                         f"process group has {world}")
    probe = Mesh(shape, axis_names, rank)
    timeout = datetime.timedelta(seconds=timeout_s)
    groups: Dict[Axes, object] = {}
    for along in axis_tuples(probe.axis_names):
        size = math.prod(probe.shape[a] for a in along)
        if size == 1:
            groups[along] = None
            continue
        others = [a for a in probe.axis_names if a not in along]
        mine = probe.ranks(along)
        for vals in itertools.product(*(range(probe.shape[a])
                                        for a in others)):
            peer = Mesh(shape, axis_names, _rank_at(probe, dict(
                zip(others, vals)), along))
            ranks = list(peer.ranks(along))
            g = dist.new_group(ranks, timeout=timeout)
            if tuple(ranks) == mine:
                groups[along] = g
    return Mesh(shape, axis_names, rank, groups)


def _rank_at(mesh: Mesh, fixed: Dict[str, int], free: Axes) -> int:
    """The rank whose coordinates are ``fixed`` and 0 along ``free``."""
    r = 0
    for a in mesh.axis_names:
        r = r * mesh.shape[a] + (0 if a in free else fixed[a])
    return r


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """JAX's production shape, abstract: ``(16, 16)`` ``("data",
    "model")``, or ``(2, 16, 16)`` with a leading ``"pod"`` axis."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes)


def make_local_mesh() -> Mesh:
    """The single-rank mesh: every rule degenerates to replicate."""
    return Mesh((1, 1), ("data", "model"))


def batch_axes(mesh: Mesh) -> Axes:
    """Mesh axes the batch dimension shards over."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def axis_size(mesh: Mesh, names) -> int:
    if isinstance(names, str):
        names = (names,)
    n = 1
    for a in names:
        n *= mesh.shape[a]
    return n
