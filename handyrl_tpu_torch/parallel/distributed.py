"""A learner of several processes: the process group, its backend, the
coordinator's cadence.

Counterpart of ``handyrl_tpu/parallel/distributed.py``.  Each rank is one
``python -m handyrl_tpu_torch.main --train`` process with one device; the
ranks join one ``torch.distributed`` process group over a ``TCPStore`` that
rank 0 (the coordinator) serves at ``distributed.coordinator_address``.
Config (``train_args.distributed``)::

    distributed:
      coordinator_address: "10.0.0.1:1234"   # host:port of rank 0
      num_processes: 2
      process_id: 0                          # or the PROCESS_ID environment variable
      initialization_timeout: 300.0          # a loud failure, never a hang
      heartbeat_interval: 5.0                # the health plane (parallel/health.py)
      heartbeat_timeout: 30.0
      collective_timeout: 300.0

**Placement and backend.**  Rank r takes ``cuda:{local_device_ids[0]}``
where that key is given, else ``cuda:{LOCAL_RANK % device_count}``
(``LOCAL_RANK`` defaults to the rank).  The backend follows from where
the ranks placed themselves, exchanged through the store before the group
is built: ``nccl`` when every rank of a host has a card of its own,
``gloo`` when ranks share a card (NCCL refuses two ranks on one card:
"Duplicate GPU detected") and on the CPU.  An NCCL failure raises; it is
never retried as gloo.

**Division of labour.**  Every rank takes the same train steps on its
shard of the global batch (``local_batch_size``), the gradients summed
over the ranks (parallel/train_step.py); only rank 0 writes checkpoints
and metrics.  Whether an epoch ends, whether the run stops and whether it
drains are the coordinator's decisions, broadcast as one small collective
per step and per boundary (``DistributedCadence``): a rank deciding on its
own would leave the others waiting in a collective forever.
"""

from __future__ import annotations

import datetime
import json
import math
import os
import socket
import sys
import time
import zlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# this process's group: its rank and world size, the backend, its device,
# every rank's (host, device) placement, and the store the group was built on
_STATE: Dict[str, Any] = {"backend": None, "device": None, "placements": None, "store": None}


class CollectiveError(RuntimeError):
    """A collective of the group failed: under gloo a lost peer closes its
    connections, and the survivors' collectives raise this (a wedged peer
    raises nothing; the collective watchdog bounds that)."""


def _collective(call, name: Optional[str] = None):
    """Run one collective call; its failure becomes ``CollectiveError``,
    named after ``name`` when given."""
    try:
        return call()
    except CollectiveError:
        raise
    except Exception as exc:   # gloo and NCCL raise several concrete types
        where = f"{name}: " if name else ""
        raise CollectiveError(f"{where}{type(exc).__name__}: {exc}") from exc


def _split_address(address: str) -> Tuple[str, int]:
    host, _, port = address.rpartition(":")
    return host or "127.0.0.1", int(port)


def _timeout_error(process_id: int, num_processes: int, address: str,
                   timeout: float, last_exc: Optional[BaseException]) -> RuntimeError:
    return RuntimeError(
        f"torch.distributed could not connect process {process_id}/{num_processes} to the "
        f"coordinator at {address} within initialization_timeout={timeout:.0f}s "
        f"(last error: {type(last_exc).__name__}: {last_exc}). Check that "
        "distributed.coordinator_address names a reachable host:port, that process 0 is up, "
        "and that every process agrees on num_processes."
    )


def _await_coordinator(address: str, deadline: float, process_id: int,
                       num_processes: int, timeout: float) -> None:
    """A follower's pre-flight: wait, with backoff and under the same
    deadline, until the coordinator's port accepts a connection.  A dead
    coordinator is then a loud error within ``initialization_timeout``;
    a coordinator that comes up a beat after its followers is waited for."""
    host, port = _split_address(address)
    backoff = 0.25
    last_exc: Optional[BaseException] = None
    while True:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            raise _timeout_error(process_id, num_processes, address, timeout,
                                 last_exc) from last_exc
        try:
            socket.create_connection((host, port), timeout=min(remaining, 5.0)).close()
            return
        except OSError as exc:
            last_exc = exc
            time.sleep(min(backoff, max(0.0, deadline - time.monotonic())))
            backoff = min(backoff * 2.0, 5.0)


def _reset_half_initialized_state() -> None:
    """Make a retry of the rendezvous real: a group or a store left by a
    failed attempt is torn down first, so the next attempt builds anew."""
    if dist.is_available() and dist.is_initialized():
        try:
            dist.destroy_process_group()
        except Exception:
            pass
    _STATE.update(backend=None, placements=None, store=None)


def rank_placement(dist_args: Dict[str, Any], process_id: int, device=None) -> torch.device:
    """The device rank ``process_id`` runs on: ``device`` when the caller
    names one (``cpu`` in the tests), else the card of
    ``local_device_ids[0]``, else card ``LOCAL_RANK % device_count``.  No
    card means an error, never the CPU."""
    if device is not None:
        device = torch.device(device)
        if device.type != "cuda" or device.index is not None:
            return device
    ids = dist_args.get("local_device_ids")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    if ids:
        return torch.device("cuda", int(ids[0]))
    local_rank = int(os.environ.get("LOCAL_RANK", process_id))
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def choose_backend(placements: Sequence[Tuple[str, str]]) -> str:
    """The group's backend from every rank's (host, device) placement:
    ``nccl`` when each rank has a card of its own, ``gloo`` when two ranks
    share one (NCCL cannot build that communicator) or any rank is on the
    CPU.  Every rank computes it from the same list, so all agree."""
    devices = [str(dev) for _host, dev in placements]
    if not devices or any(not d.startswith("cuda") for d in devices):
        return "gloo"
    if len(set((str(h), str(d)) for h, d in placements)) < len(placements):
        return "gloo"
    return "nccl"


def _exchange_placements(store, process_id: int, num_processes: int,
                         device: torch.device) -> List[Tuple[str, str]]:
    """Publish this rank's placement on the store and read every rank's."""
    store.set(f"placement/{process_id}", json.dumps([socket.gethostname(), str(device)]))
    out = []
    for r in range(num_processes):
        host, dev = json.loads(store.get(f"placement/{r}").decode())
        out.append((host, dev))
    return out


def init_distributed(dist_args: Optional[Dict[str, Any]], device=None) -> Tuple[int, torch.device]:
    """Join the process group from config; returns (rank, this rank's
    device).  A missing ``coordinator_address`` means one process: (0,
    ``device`` or the card).  ``process_id`` comes from the config or the
    ``PROCESS_ID`` environment variable.

    ``initialization_timeout`` bounds the whole rendezvous: a follower
    first waits for the coordinator's port (``_await_coordinator``), then
    the store's connect and the placement exchange are retried with
    backoff inside the deadline, a half-built group torn down before each
    retry.  The group's backend is chosen from the placements before it is
    built (``choose_backend``), and one small all-reduce proves it: an
    NCCL failure there raises."""
    if not dist_args or not dist_args.get("coordinator_address"):
        from ..utils import resolve_device

        return 0, resolve_device(device)
    address = str(dist_args["coordinator_address"])
    host, port = _split_address(address)
    num_processes = int(dist_args["num_processes"])
    process_id = dist_args.get("process_id")
    if process_id is None:
        process_id = int(os.environ.get("PROCESS_ID", "0"))
    process_id = int(process_id)
    if not 0 <= process_id < num_processes:
        raise ValueError(f"distributed.process_id {process_id} is not a rank of "
                         f"num_processes={num_processes}")
    placed = rank_placement(dist_args, process_id, device)
    timeout = float(dist_args.get("initialization_timeout") or 300.0)
    deadline = time.monotonic() + timeout
    if process_id != 0:
        _await_coordinator(address, deadline, process_id, num_processes, timeout)
    backoff = 1.0
    last_exc: Optional[BaseException] = None
    while True:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            raise _timeout_error(process_id, num_processes, address, timeout,
                                 last_exc) from last_exc
        try:
            store = dist.TCPStore(host, port, num_processes, process_id == 0,
                                  timeout=datetime.timedelta(seconds=max(1.0, remaining)),
                                  wait_for_workers=False)
            found = _exchange_placements(store, process_id, num_processes, placed)
            break
        except (RuntimeError, OSError) as exc:   # the store surfaces its faults as these
            last_exc = exc
            _reset_half_initialized_state()
            if time.monotonic() + backoff >= deadline:
                raise _timeout_error(process_id, num_processes, address, timeout,
                                     exc) from exc
            time.sleep(backoff)
            backoff = min(backoff * 2.0, 15.0)
    backend = choose_backend(found)
    if backend == "nccl":
        torch.cuda.set_device(placed)
    collective_timeout = float(dist_args.get("collective_timeout") or 0.0)
    dist.init_process_group(
        backend, store=store, rank=process_id, world_size=num_processes,
        timeout=datetime.timedelta(seconds=max(collective_timeout, timeout, 60.0)))
    _STATE.update(backend=backend, device=placed, placements=found, store=store)
    # the group is proven here, before anything trains: an NCCL that cannot
    # build its communicator raises now (and is not retried as gloo)
    probe = torch.ones(1, device=collective_device())
    dist.all_reduce(probe)
    if int(probe.item()) != num_processes:
        raise RuntimeError(f"the {backend} group's first all-reduce gave {probe.item()}, "
                           f"not {num_processes}")
    return process_id, placed


def shutdown_distributed() -> None:
    """Leave the group after a clean run: a barrier, so no rank tears down
    while another is still in its last collective, then
    ``destroy_process_group``.  Best effort: a failed teardown does not
    turn a finished run into a nonzero exit."""
    if not (dist.is_available() and dist.is_initialized()):
        return
    try:
        dist.barrier()
        dist.destroy_process_group()
    except Exception as exc:
        print(f"[handyrl_tpu_torch] torch.distributed shutdown failed "
              f"({type(exc).__name__}: {exc}); continuing exit", file=sys.stderr)
    _STATE.update(backend=None, device=None, placements=None, store=None)


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def is_coordinator() -> bool:
    """True on the process that owns checkpoints and metrics."""
    return process_index() == 0


def process_count() -> int:
    return dist.get_world_size() if is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if is_initialized() else 0


def backend() -> Optional[str]:
    """The group's backend ('nccl' or 'gloo'), None with no group."""
    return _STATE["backend"] if is_initialized() else None


def placements() -> Optional[List[Tuple[str, str]]]:
    """Every rank's (host, device) as exchanged at init, None with no group."""
    return _STATE["placements"] if is_initialized() else None


def collective_device() -> torch.device:
    """Where this rank's small collectives run: the card under NCCL, the
    host under gloo (or with no group)."""
    if backend() == "nccl":
        return _STATE["device"]
    return torch.device("cpu")


def local_batch_size(global_batch_size: int, data_shards: Optional[int] = None) -> int:
    """This process's share of a global batch: one of ``data_shards``
    (default: every process; under a sequence axis the ranks of one ``sp``
    group share one shard, so global / dp)."""
    n = process_count() if data_shards is None else int(data_shards)
    if global_batch_size % n:
        what = "processes" if data_shards is None else "data shards (dp)"
        raise ValueError(f"batch_size {global_batch_size} not divisible by {n} {what}")
    return global_batch_size // n


def broadcast_from_coordinator(value: int) -> int:
    """Broadcast one int from rank 0 to every rank (all must call): the
    primitive under the resume agreement and the cadence."""
    t = torch.tensor([int(value)], dtype=torch.int64, device=collective_device())
    _collective(lambda: dist.broadcast(t, src=0))
    return int(t.item())


def broadcast_resume_epoch(local_epoch: int) -> int:
    """The epoch every rank resumes: the coordinator's manifest verdict
    (it owns the checkpoint files); the others pass anything."""
    if process_count() <= 1:
        return int(local_epoch)
    return broadcast_from_coordinator(int(local_epoch))


def broadcast_params(tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A state dict of host tensors from rank 0 to every rank (all must
    call; followers pass a like-shaped dict whose values are discarded).
    The cross-process sentinel rollback rides it: every rank installs the
    coordinator's bytes without the snapshot on its own disk."""
    dev = collective_device()
    out = {}
    for key in sorted(tree):
        t = tree[key].detach().to(dev, copy=True).contiguous()
        _collective(lambda t=t: dist.broadcast(t, src=0))
        out[key] = t.cpu()
    return {key: out[key] for key in tree}


def params_crc32(state_dict: Dict[str, torch.Tensor]) -> int:
    """CRC32 of a state dict's bytes, tensors in name order: equal on two
    ranks exactly when their params are bit for bit the same."""
    crc = 0
    for key in sorted(state_dict):
        t = state_dict[key].detach().cpu().contiguous()
        crc = zlib.crc32(key.encode(), crc)
        crc = zlib.crc32(t.view(torch.uint8).numpy().tobytes() if t.numel() else b"", crc)
    return crc & 0xFFFFFFFF


# -- the gradient bucket --------------------------------------------------------


class BucketAllReduce:
    """Sums a list of fp32 tensors over the ranks, in place, as one flat
    bucket: one collective per call.

    The JAX loss is a sum over the global batch, never divided by the data
    count, so the gradient of the global batch is the SUM of the ranks'
    gradients (not their mean, as ``DistributedDataParallel`` takes).

    Under NCCL the bucket is reduced where it lies, on the card.  Under
    gloo with the tensors on a card (ranks that share one), the bucket is
    staged explicitly through a pinned host buffer: the host must wait for
    the card's gradients anyway, since gloo reduces on the host, and the
    staging makes that one wait, per step, visible and timed apart from the
    collective.  On the CPU gloo reduces the bucket itself.

    ``stats()`` gives the calls, the bytes of one bucket and the seconds
    spent in the collective itself (host clock; CUDA events under NCCL),
    which hold the wait for the slower rank."""

    def __init__(self):
        self.calls = 0
        self.bucket_bytes = 0
        self._seconds = 0.0
        self._events: List[Tuple[Any, Any]] = []
        self._host: Optional[torch.Tensor] = None

    def __call__(self, tensors: List[torch.Tensor]) -> None:
        if process_count() <= 1:
            return
        from ..utils.trace import trace_span

        flat = torch.cat([t.reshape(-1) for t in tensors])
        self.calls += 1
        self.bucket_bytes = flat.numel() * flat.element_size()
        with trace_span("collective.all_reduce", plane="learner", nbytes=self.bucket_bytes):
            if flat.device.type == "cuda" and backend() == "gloo":
                if self._host is None or self._host.numel() != flat.numel():
                    self._host = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
                self._host.copy_(flat, non_blocking=True)
                torch.cuda.current_stream(flat.device).synchronize()
                t0 = time.perf_counter()
                _collective(lambda: dist.all_reduce(self._host))
                self._seconds += time.perf_counter() - t0
                # the next call's device-to-host copy is queued behind this one
                # on the same stream, so the buffer is never overwritten early
                flat.copy_(self._host, non_blocking=True)
            elif flat.device.type == "cuda":
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                _collective(lambda: dist.all_reduce(flat))
                end.record()
                self._events.append((start, end))
            else:
                t0 = time.perf_counter()
                _collective(lambda: dist.all_reduce(flat))
                self._seconds += time.perf_counter() - t0
        offset = 0
        for t in tensors:
            n = t.numel()
            t.copy_(flat[offset:offset + n].view_as(t))
            offset += n

    def stats(self) -> Dict[str, float]:
        """Cumulative (calls, bytes per bucket, collective seconds); reading
        NCCL's events waits for them."""
        for start, end in self._events:
            end.synchronize()
            self._seconds += start.elapsed_time(end) / 1e3
        self._events = []
        return {"calls": self.calls, "bucket_bytes": self.bucket_bytes, "seconds": self._seconds}


# -- the coordinator-driven epoch cadence --------------------------------------

# agree_step() command bits, broadcast from the coordinator: CONTINUE (0)
# keeps stepping; END closes the epoch on every process after the same
# step count; DRAIN (always with END) also ends the RUN at this boundary,
# a preemption drain, skipping the stop agreement.
CMD_CONTINUE = 0
CMD_END = 1
CMD_DRAIN = 2


class DistributedCadence:
    """The lockstep epoch cadence of a learner of several processes.

    Every train step is a collective (the gradient bucket), so every rank
    must take the same number of steps per epoch and stop together.  The
    coordinator's decisions therefore reach the others as one tiny
    broadcast per step (``agree_step``) and one per epoch boundary
    (``agree_stop``); followers pass 0 and obey.  All calls happen on the
    trainer thread, in one order on every rank: per epoch ``[agree_step
    (train_step agree_step)*, agree_stop?]``, ``agree_stop`` skipped by
    every rank alike when the epoch ended with the DRAIN bit.
    """

    def __init__(self, mesh=None):
        self.mesh = mesh
        self.is_coordinator = is_coordinator()
        self.num_processes = process_count()

    def _agree(self, value: int, tag: str) -> int:
        from ..utils.trace import trace_span
        from .mesh import dispatch_serialized

        # the span times the whole rendezvous: under rank skew it IS the
        # wait for the slowest rank
        with trace_span("cadence." + tag, plane="cadence"):
            return dispatch_serialized(lambda: broadcast_from_coordinator(value), self.mesh)

    def agree_step(self, end: bool, drain: bool) -> int:
        """One per trainer-loop iteration: the coordinator passes its local
        epoch-end and drain verdicts, everyone receives the agreed command."""
        cmd = CMD_CONTINUE
        if self.is_coordinator and (end or drain):
            cmd = CMD_END | (CMD_DRAIN if drain else 0)
        return self._agree(cmd, "agree_step")

    def agree_stop(self, stop: bool) -> bool:
        """One per epoch boundary (unless the epoch drained): the
        coordinator passes its learner's continue/shutdown decision."""
        return bool(self._agree(1 if (self.is_coordinator and stop) else 0, "agree_stop"))

    def agree_rollback_epoch(self, epoch: int) -> int:
        """The sentinel rollback's target: the coordinator passes its
        manifest verdict (the newest verified epoch, 0 = none), followers
        anything.  Every rank reaches this call together: the streak that
        triggers it is computed from the reduced step metrics, the same on
        every rank."""
        return self._agree(int(epoch) if self.is_coordinator else 0, "agree_rollback")


# -- a group along one mesh axis: the sequence ring's transport -------------------

_ALIGN = 16   # each tensor of a packed buffer starts on a 16-byte boundary


def _layout(specs):
    """The (offset, dtype, shape) of each (dtype, shape) in a packed buffer,
    and the buffer's size in bytes."""
    layout, offset = [], 0
    for dtype, shape in specs:
        layout.append((offset, dtype, tuple(shape)))
        offset += -(-math.prod(shape) * dtype.itemsize // _ALIGN) * _ALIGN
    return layout, offset


def _pack(tensors: Sequence[torch.Tensor]):
    """The tensors as one flat uint8 buffer on their device, and the layout
    of each, for ``_unpack``."""
    layout, size = _layout([(t.dtype, t.shape) for t in tensors])
    buf = torch.empty(size, dtype=torch.uint8, device=tensors[0].device)
    for t, (off, _dtype, _shape) in zip(tensors, layout):
        flat = t.detach().contiguous().reshape(-1).view(torch.uint8)
        buf[off:off + flat.numel()].copy_(flat)
    return buf, layout


def _unpack(buf: torch.Tensor, layout) -> List[torch.Tensor]:
    """Views of ``buf`` as the tensors ``_pack`` laid out."""
    return [buf[off:off + math.prod(shape) * dtype.itemsize].view(dtype).view(shape)
            for off, dtype, shape in layout]


def _pinned(staging: Dict[Any, torch.Tensor], key, like: torch.Tensor) -> torch.Tensor:
    buf = staging.get(key)
    if buf is None or buf.numel() != like.numel():
        buf = staging[key] = torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
    return buf


def ring_shift(tensors: Sequence[torch.Tensor], group,
               staging: Optional[Dict[Any, torch.Tensor]] = None) -> List[torch.Tensor]:
    """Send ``tensors`` to the next rank of ``group`` and return the previous
    rank's (the same shapes and dtypes): JAX's ``ppermute`` by one step
    around an axis.  Every rank of the group calls it at once.  The tensors
    travel as one flat buffer each way.

    Under NCCL (a card per rank) the buffers go card to card through
    ``batch_isend_irecv``.  Under gloo, host tensors go as they are, and
    card tensors (ranks that share a card) are staged explicitly through
    pinned host buffers (``staging``, reused by size): one wait for the
    card per shift, as ``BucketAllReduce`` stages its bucket.  A lost peer
    raises ``CollectiveError``."""
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    nxt = dist.get_global_rank(group, (me + 1) % n)
    prv = dist.get_global_rank(group, (me - 1) % n)
    buf, layout = _pack(tensors)
    recv = torch.empty_like(buf)
    if buf.device.type == "cuda" and backend() == "nccl":
        ops = [dist.P2POp(dist.isend, buf, nxt, group), dist.P2POp(dist.irecv, recv, prv, group)]
        _collective(lambda: [w.wait() for w in dist.batch_isend_irecv(ops)], "ring_shift")
        return _unpack(recv, layout)
    if buf.device.type == "cuda":
        staging = {} if staging is None else staging
        send_h, recv_h = _pinned(staging, "send", buf), _pinned(staging, "recv", buf)
        send_h.copy_(buf, non_blocking=True)
        # the card's copy must land before gloo reads it; the previous
        # shift's copy out of recv_h is on this stream too, so it is done
        # before gloo writes into recv_h again
        torch.cuda.current_stream(buf.device).synchronize()
        _exchange(send_h, recv_h, nxt, prv, group)
        recv.copy_(recv_h, non_blocking=True)
        return _unpack(recv, layout)
    _exchange(buf, recv, nxt, prv, group)
    return _unpack(recv, layout)


def _exchange(send: torch.Tensor, recv: torch.Tensor, nxt: int, prv: int, group) -> None:
    """gloo: ``send`` to global rank ``nxt`` while ``recv`` fills from
    ``prv``; both posted before either is waited on."""
    def call():
        works = [dist.isend(send, nxt, group=group), dist.irecv(recv, prv, group=group)]
        for work in works:
            work.wait()
    _collective(call, "ring_shift")


def _tree_items(tree, prefix=()):
    """(path, leaf) pairs of a nested dict, keys in sorted order."""
    if isinstance(tree, dict):
        for key in sorted(tree, key=repr):
            yield from _tree_items(tree[key], prefix + (key,))
    else:
        yield prefix, tree


def _tree_build(items):
    out: Dict[Any, Any] = {}
    for path, leaf in items:
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return out


class AxisGroup:
    """This rank's group along one mesh axis (``Mesh.group``): the
    ``torch.distributed`` group, its global ranks in axis order, this rank's
    ``index`` on the axis, the axis ``size`` and this rank's device.  Along
    ``sp`` it is the sequence ring: ``shift`` (timed, its bytes counted),
    ``all_gather`` and the differentiable ``gather`` of a sharded output,
    and the leader's batch (``broadcast_batch``)."""

    def __init__(self, group, ranks: Sequence[int], axis: str = "sp", device="cpu"):
        self.group = group
        self.device = torch.device(device)   # where a member's broadcast batch lands
        self.ranks = [int(r) for r in ranks]
        self.axis = axis
        self.size = len(self.ranks)
        self.index = self.ranks.index(process_index())
        self.leader = self.ranks[0]          # the group's index 0
        self.is_leader = self.index == 0
        self.shifts = 0
        self.shift_bytes = 0
        self._seconds = 0.0
        self._events: List[Tuple[Any, Any]] = []
        self._staging: Dict[Any, torch.Tensor] = {}

    def __repr__(self) -> str:
        return f"AxisGroup({self.axis!r}, ranks={self.ranks}, index={self.index})"

    def shift(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """``ring_shift`` over this group, timed (host clock; CUDA events
        under NCCL) and its bytes counted for ``stats``."""
        from ..utils.trace import trace_span

        nbytes = sum(t.numel() * t.element_size() for t in tensors)
        self.shifts += 1
        self.shift_bytes += nbytes
        with trace_span("collective.ring_shift", plane="learner", nbytes=nbytes):
            if tensors[0].device.type == "cuda" and backend() == "nccl":
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = ring_shift(tensors, self.group, self._staging)
                end.record()
                self._events.append((start, end))
                return out
            t0 = time.perf_counter()
            out = ring_shift(tensors, self.group, self._staging)
            self._seconds += time.perf_counter() - t0
            return out

    def stats(self) -> Dict[str, float]:
        """Cumulative (shifts, bytes sent, seconds) of ``shift``."""
        for start, end in self._events:
            end.synchronize()
            self._seconds += start.elapsed_time(end) / 1e3
        self._events = []
        return {"shifts": self.shifts, "bytes": self.shift_bytes, "seconds": self._seconds}

    def all_gather(self, x: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's ``x`` (one shape on all), in axis order, on ``x``'s
        device; under gloo a card tensor goes through the host."""
        dev = x.device
        host = x.detach().contiguous()
        if dev.type == "cuda" and backend() != "nccl":
            host = host.cpu()
        parts = [torch.empty_like(host) for _ in range(self.size)]
        _collective(lambda: dist.all_gather(parts, host, group=self.group), "all_gather")
        return [p.to(dev) for p in parts]

    def gather(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """The group's shards of ``x`` concatenated along ``dim`` (axis
        order), differentiable: the backward returns this rank's own slice
        of the incoming gradient and sums nothing, since every rank of the
        group computes the same loss on the gathered tensor (a summing
        backward would scale each gradient by the group's size)."""
        return _GatherShards.apply(x, self, dim)

    def broadcast_batch(self, batch):
        """The leader's batch (a nested dict of tensors or arrays, or None
        when it is stopping) on every rank of the group, a member's on its
        ``device``; members pass None.  The layout goes first (a small
        pickled object), then one flat buffer."""
        spec: List[Any] = [None]
        leaves: List[torch.Tensor] = []
        if self.is_leader and batch is not None:
            items = [(path, torch.as_tensor(leaf)) for path, leaf in _tree_items(batch)]
            leaves = [leaf for _, leaf in items]
            spec = [[(path, leaf.dtype, tuple(leaf.shape)) for path, leaf in items]]
        _collective(lambda: dist.broadcast_object_list(spec, src=self.leader, group=self.group),
                    "broadcast_batch")
        if spec[0] is None:
            return None
        if self.is_leader:
            buf, layout = _pack(leaves)
            dev = buf.device
        else:
            layout, size = _layout([(dtype, shape) for _path, dtype, shape in spec[0]])
            dev = self.device
            buf = torch.empty(size, dtype=torch.uint8, device=dev)
        wire = buf.cpu() if dev.type == "cuda" and backend() != "nccl" else buf
        _collective(lambda: dist.broadcast(wire, src=self.leader, group=self.group),
                    "broadcast_batch")
        if self.is_leader:
            return batch
        buf = wire.to(dev)
        return _tree_build(zip((path for path, _, _ in spec[0]), _unpack(buf, layout)))


class _GatherShards(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group: AxisGroup, dim: int):
        ctx.group, ctx.dim = group, dim
        return torch.cat(group.all_gather(x), dim=dim)

    @staticmethod
    def backward(ctx, g):
        group, dim = ctx.group, ctx.dim
        n = g.shape[dim] // group.size
        return g.narrow(dim, group.index * n, n), None, None
