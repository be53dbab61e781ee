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


def _collective(call):
    """Run one collective call; its failure becomes ``CollectiveError``."""
    try:
        return call()
    except CollectiveError:
        raise
    except Exception as exc:   # gloo and NCCL raise several concrete types
        raise CollectiveError(f"{type(exc).__name__}: {exc}") from exc


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


def local_batch_size(global_batch_size: int) -> int:
    """This process's share of a global batch."""
    n = process_count()
    if global_batch_size % n:
        raise ValueError(f"batch_size {global_batch_size} not divisible by {n} processes")
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
