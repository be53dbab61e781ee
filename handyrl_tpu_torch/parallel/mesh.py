"""The device mesh of a run of several processes, and the dispatch locks.

Counterpart of ``handyrl_tpu/parallel/mesh.py``.  A JAX mesh names every
device of every process; the port's learner runs one process per rank and
one device per rank, so its mesh is the list of the ranks' devices laid out
by axis, row-major in the spec's order as JAX's ``make_mesh`` reshapes its
devices: under ``{'dp': 2, 'sp': 2}`` rank r sits at ``(r // 2, r % 2)``.
Two axes are acted on: ``dp`` (data parallel: the batch splits over the
ranks, the params are replicated) and ``sp`` (sequence parallel: each rank
of an ``sp`` group holds one T/sp shard of every window, ops/ring_attention.py).
``Mesh.group(axis)`` gives this rank's ``AxisGroup`` along an axis, once
``build_groups`` has made one ``torch.distributed`` group per group of
ranks of every axis.  ``split_mesh``'s partition is here with the JAX
package's checks and words, and nothing wires it yet (ROADMAP A8).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, TypeVar

from ..utils.trace import trace_span
from . import dispatch

T = TypeVar("T")


class RankDevice(NamedTuple):
    """One member of the mesh: a rank and the device it placed itself on."""
    rank: int
    device: str


class Mesh:
    """Devices laid out by named axes, row-major: ``shape`` maps each axis
    name to its size, and ``devices`` holds ``prod(sizes)`` members."""

    def __init__(self, devices: Sequence, shape: Dict[str, int]):
        self.devices = list(devices)
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)
        if math.prod(self.shape.values()) != len(self.devices):
            raise ValueError(f"mesh {self.shape} does not hold {len(self.devices)} devices")
        self._groups: Optional[Dict[str, object]] = None

    @property
    def size(self) -> int:
        return len(self.devices)

    def coords(self, index: int) -> Dict[str, int]:
        """The position of ``devices[index]`` on each axis, row-major in the
        spec's order (the last axis varies fastest)."""
        out = {}
        for axis in reversed(self.axis_names):
            index, out[axis] = divmod(index, self.shape[axis])
        return {axis: out[axis] for axis in self.axis_names}

    def axis_groups(self, axis: str) -> List[List[int]]:
        """The groups of device indices along ``axis``: one per position on
        the other axes, in row-major order, each ordered by its position on
        ``axis``."""
        groups: Dict[tuple, List[int]] = {}
        for index in range(self.size):
            c = self.coords(index)
            groups.setdefault(tuple(v for a, v in c.items() if a != axis), []).append(index)
        return [groups[key] for key in sorted(groups)]

    def build_groups(self) -> None:
        """One ``torch.distributed`` group per group of every axis of size
        > 1.  ``new_group`` is a collective of every rank of the world, so
        every rank calls this, at the same point of its run, and the groups
        are made in one order on all of them."""
        import torch.distributed as dist

        from .distributed import AxisGroup, process_index

        if self._groups is not None:
            return
        me = process_index()
        ranks = [d.rank if isinstance(d, RankDevice) else i for i, d in enumerate(self.devices)]
        mine = self.devices[ranks.index(me)] if me in ranks else "cpu"
        device = mine.device if isinstance(mine, RankDevice) else str(mine)
        found: Dict[str, object] = {}
        for axis in self.axis_names:
            if self.shape[axis] < 2:
                continue
            for members in self.axis_groups(axis):
                group_ranks = [ranks[i] for i in members]
                pg = dist.new_group(group_ranks)
                if me in group_ranks:
                    found[axis] = AxisGroup(pg, group_ranks, axis, device)
        self._groups = found

    def group(self, axis: str):
        """This rank's ``AxisGroup`` along ``axis``; raises when the mesh
        has no such axis of size >= 2.  The first call builds the groups
        (``build_groups``: a collective, so every rank must reach it)."""
        if self._groups is None:
            self.build_groups()
        if axis not in self._groups:
            raise ValueError(f"mesh {self.shape} has no {axis!r} axis of size >= 2 holding "
                             "this rank")
        return self._groups[axis]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {self.devices})"


def rank_devices() -> List[RankDevice]:
    """Every rank's device, in rank order (one rank of the CPU when no
    process group is up)."""
    from .distributed import placements, process_count

    found = placements()
    if found is None:
        from .distributed import collective_device

        return [RankDevice(0, str(collective_device()))]
    return [RankDevice(r, dev) for r, (_host, dev) in enumerate(found[:process_count()])]


def make_mesh(spec: Optional[Dict[str, int]] = None, devices: Optional[Sequence] = None) -> Mesh:
    """A mesh from an axis-name -> size dict; -1 fills the remaining
    devices (default: every rank's device, ``rank_devices()``).

    make_mesh({'dp': -1})            # all ranks data-parallel
    make_mesh({'dp': 2})             # exactly 2 ranks

    The JAX package lets all-positive sizes cover a prefix of its devices
    (a sub-mesh that pins its learner to some chips); a rank outside the
    mesh would sit out of the collective step, so here the sizes must
    cover every device."""
    devices = list(devices if devices is not None else rank_devices())
    spec = dict(spec or {"dp": -1})
    n = len(devices)
    fixed = math.prod(s for s in spec.values() if s > 0)
    if any(s <= 0 for s in spec.values()):
        if n % max(fixed, 1) != 0:
            raise ValueError(f"{n} devices not divisible by fixed mesh axes {spec}")
        fill = n // fixed
        sizes = tuple(s if s > 0 else fill for s in spec.values())
    else:
        sizes = tuple(spec.values())
    if math.prod(sizes) > n:
        raise ValueError(f"mesh {dict(zip(spec, sizes))} needs more than {n} devices")
    if math.prod(sizes) < n:
        raise ValueError(
            f"mesh {dict(zip(spec, sizes))} covers {math.prod(sizes)} of {n} devices: a "
            "sub-mesh would leave ranks out of the collective train step"
        )
    return Mesh(devices, dict(zip(spec, sizes)))


def split_mesh(spec: Optional[Dict[str, int]] = None, actor_chips: int = 1,
               devices: Optional[Sequence] = None):
    """Partition a device list into disjoint (learner_mesh, actor_mesh):
    the learner keeps the prefix (device 0, the coordinator's, stays a
    learner device) laid out by ``spec``, the actors take the trailing
    ``actor_chips`` devices as a flat ``{'dp': actor_chips}`` mesh.  The
    JAX package's checks and words; ``plane: split`` that would use it is
    still refused (ROADMAP A8)."""
    actor_chips = int(actor_chips)
    if actor_chips < 1:
        raise ValueError(f"actor_chips must be >= 1, got {actor_chips}")
    devices = list(devices if devices is not None else rank_devices())
    if actor_chips >= len(devices):
        raise ValueError(
            f"plane: split needs at least one learner device: actor_chips "
            f"{actor_chips} of {len(devices)} devices leaves none"
        )
    learner_devs = devices[: len(devices) - actor_chips]
    # the learner's spec over its own devices: -1 fills them; all-positive
    # sizes take a prefix, as the JAX package lays out its learner plane
    spec = dict(spec or {"dp": -1})
    learner = (make_mesh(spec, learner_devs) if any(s <= 0 for s in spec.values())
               else _prefix_mesh(spec, learner_devs))
    actor = Mesh(devices[len(devices) - actor_chips:], {"dp": actor_chips})
    return learner, actor


def _prefix_mesh(spec: Dict[str, int], devices: List) -> Mesh:
    """All-positive sizes over a prefix of ``devices``, as JAX lays out a
    sub-mesh (the learner plane of a split)."""
    sizes = tuple(spec.values())
    if math.prod(sizes) > len(devices):
        raise ValueError(f"mesh {spec} needs more than {len(devices)} devices")
    return Mesh(devices[: math.prod(sizes)], spec)


def _local(devices) -> List[str]:
    """The devices of ``devices`` this process dispatches to."""
    from .distributed import process_index

    if isinstance(devices, Mesh):
        devices = devices.devices
    me = process_index()
    out = []
    for d in devices:
        if isinstance(d, RankDevice):
            if d.rank == me:
                out.append(d.device)
        else:
            out.append(d)
    return out


def dispatch_serialized(call: Callable[[], T], devices=None) -> T:
    """Run ``call`` holding the dispatch lock of each of this process's
    devices among ``devices`` (a ``Mesh``, a list of devices or mesh
    members, or None for this rank's collective device): the per-device
    locks of ``parallel/dispatch.py``, no second registry.  Two threads of
    one rank that enqueue collectives on one device take turns, so every
    rank issues its collectives in one order."""
    if devices is None:
        from .distributed import collective_device

        devices = [collective_device()]
    local = _local(devices)
    locks = dispatch.locks_for(local)
    held = []
    try:
        # inside the try: an exception landing mid-loop releases what is held
        with trace_span("dispatch.wait", devices=len(local)):
            for lock in locks:
                lock.acquire()
                held.append(lock)
        with trace_span("dispatch.run", devices=len(local)):
            return call()
    finally:
        for lock in reversed(held):
            lock.release()
