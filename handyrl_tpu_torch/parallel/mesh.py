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
ranks of every axis.

``split_mesh`` carves the planes of ``plane: split``.  Over a device list
it is the JAX package's carve (the learner keeps the prefix, the actors
take the trailing ``actor_chips``).  A learner (``plane_members``) carves
per rank, as the JAX package carves per host: the rank keeps its own
device as its learner member and adds ``actor_chips`` actor members local
to its process, on the trailing cards of ``distributed.local_device_ids``
when that names more cards than the learner's one, else on the rank's own
card.  Each actor member on a card makes a CUDA stream of its own (the
learner member keeps the card's default stream), and each member has a
dispatch lock of its own, so members sharing a card run concurrently.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple, TypeVar

import torch

from ..utils import resolve_device
from ..utils.trace import trace_span
from . import dispatch

T = TypeVar("T")


class RankDevice(NamedTuple):
    """One member of the mesh: a rank and the device it placed itself on."""
    rank: int
    device: str


class PlaneMember:
    """One member of a device plane of this process: a device, its role
    (``learner`` or ``actor``) and index, and the CUDA stream its work is
    enqueued on.  The learner member's stream is its card's default stream
    (the trainer, the rings and the boundary run there); an actor member
    makes a stream of its own on its card, and raises when it cannot.  On
    the CPU a member has no stream.  ``lock_key`` names its dispatch lock:
    the learner member's is its device's, an actor member's its own."""

    def __init__(self, device, role: str = "learner", index: int = 0, rank: int = 0):
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self.role = role
        self.index = int(index)
        self.rank = int(rank)
        self.stream = None
        if device.type == "cuda":
            self.stream = (torch.cuda.default_stream(device) if role == "learner"
                           else torch.cuda.Stream(device))

    @property
    def lock_key(self) -> str:
        return str(self.device) if self.role == "learner" else f"{self.device}/{self.role}{self.index}"

    @property
    def stream_handle(self) -> Optional[int]:
        """The stream's ``cudaStream_t`` as an int (0: the default stream)."""
        return None if self.stream is None else int(self.stream.cuda_stream)

    def stream_context(self):
        """Make this member's stream the calling thread's current one."""
        return contextlib.nullcontext() if self.stream is None else torch.cuda.stream(self.stream)

    def describe(self) -> str:
        if self.stream is None:
            return str(self.device)
        own = "the card's default" if self.role == "learner" else "its own"
        return f"{self.device} (stream {self.stream_handle:#x}, {own})"

    def __repr__(self) -> str:
        return f"PlaneMember({self.role}{self.index}, rank {self.rank}, {self.describe()})"


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

    def local_members(self) -> List[PlaneMember]:
        """The plane members of this mesh (``split_mesh``'s per-rank carve)
        that this process dispatches to."""
        from .distributed import process_index

        me = process_index()
        return [d for d in self.devices if isinstance(d, PlaneMember) and d.rank == me]

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


def plane_members(device, actor_chips: int = 1, local_device_ids: Optional[Sequence] = None,
                  rank: int = 0) -> Tuple[PlaneMember, List[PlaneMember]]:
    """This rank's members under ``plane: split``: (learner, actors).  The
    learner member is ``device``; the ``actor_chips`` actor members take the
    trailing ids of ``local_device_ids`` when it names more cards than one
    (the JAX package's per-host carve: ``actor_chips`` is per host), else
    they share ``device``, each on a stream of its own."""
    actor_chips = int(actor_chips)
    if actor_chips < 1:
        raise ValueError(f"actor_chips must be >= 1, got {actor_chips}")
    learner = PlaneMember(device, "learner", 0, rank)
    ids = [int(i) for i in (local_device_ids or ())]
    if len(ids) > 1:
        if actor_chips >= len(ids):
            raise ValueError(
                f"plane: split needs at least one learner device PER HOST: "
                f"actor_chips {actor_chips} of {len(ids)} local devices "
                "leaves none (actor_chips is per host in a multi-process run)"
            )
        cards = [torch.device("cuda", i) for i in ids[len(ids) - actor_chips:]]
    else:
        cards = [learner.device] * actor_chips
    return learner, [PlaneMember(d, "actor", i, rank) for i, d in enumerate(cards)]


def split_mesh(spec: Optional[Dict[str, int]] = None, actor_chips: int = 1,
               devices: Optional[Sequence] = None, device=None,
               local_device_ids: Optional[Sequence] = None):
    """Partition devices into disjoint (learner_mesh, actor_mesh).  A
    member of this rank's planes is a ``PlaneMember`` (``local_members``).

    Over a device list (``devices``): the learner keeps the prefix (device
    0, the coordinator's, stays a learner device) laid out by ``spec``, the
    actors take the trailing ``actor_chips`` devices as a flat ``{'dp':
    actor_chips}`` mesh; the JAX package's checks and words.  With
    ``devices`` None the carve is per rank (``plane_members``): the
    learner mesh is every rank's device laid out by ``spec``
    (``make_mesh``), and the actor mesh is this rank's ``actor_chips``
    actor members of ``device`` (the card unless it names another device),
    local to its process."""
    actor_chips = int(actor_chips)
    if actor_chips < 1:
        raise ValueError(f"actor_chips must be >= 1, got {actor_chips}")
    if devices is None:
        from .distributed import is_initialized, process_index

        rank = process_index()
        member, actors = plane_members(resolve_device(device), actor_chips, local_device_ids,
                                       rank)
        if is_initialized():
            # this rank's entry is its learner member: its stream, its lock
            base = make_mesh(spec)
            learner = Mesh([member if isinstance(d, RankDevice) and d.rank == rank else d
                            for d in base.devices], base.shape)
        else:
            learner = Mesh([member], {"dp": 1})
        return learner, Mesh(actors, {"dp": actor_chips})
    devices = list(devices)
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
        if isinstance(d, PlaneMember):
            if d.rank == me:
                out.append(d)     # its own lock, not its device's
        elif isinstance(d, RankDevice):
            if d.rank == me:
                out.append(d.device)
        else:
            out.append(d)
    return out


def dispatch_serialized(call: Callable[[], T], devices=None) -> T:
    """Run ``call`` holding the dispatch lock of each of this process's
    devices among ``devices`` (a ``Mesh``, a list of devices, mesh members
    or plane members, or None for this rank's collective device): the per-device
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
