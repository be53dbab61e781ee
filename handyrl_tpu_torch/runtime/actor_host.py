"""A dedicated actor host: on-device self-play feeding a learner elsewhere.

Counterpart of ``handyrl_tpu/runtime/actor_host.py``.  A process started
with ``distributed.role: actor`` (``python -m handyrl_tpu_torch.main
--train``) runs only the data plane: the streaming device rollout on its
own card, each (K, B, ...) record block shipped to the learner's plane
gateway over TCP (runtime/plane.py) and versioned params polled back.

It stays outside the learner's process group by design: losing it never
leaves a collective waiting; the gateway counts the loss
(``dist_actor_host_losses``) and the run goes on.  The reverse is loud: a
dead gateway means the learner is gone, and this process announces the
fault and exits 75 (EX_TEMPFAIL), to be relaunched once a learner is back.

One block is on the wire at a time (the ship is a blocking request and
reply), so a slow learner holds the rollout back without a budget
protocol; the next block is launched before the previous one is read, so
the card works while the host ships.
"""

from __future__ import annotations

import os
import signal
import sys
import threading
import time
from typing import Any, Dict

import torch

from ..envs import make_env, prepare_env
from ..models import init_variables
from ..utils import resolve_device, trace
from ..utils.retry import retry_call

# the learner's drain convention (runtime/learner.py)
EXIT_RESUMABLE = 75


def actor_host_main(args: Dict[str, Any], device=None) -> int:
    """``--train`` with ``distributed.role: actor``; returns the exit code
    (0 when the gateway said stop, 75 when it was lost).  Runs on the card
    unless ``device`` names another device."""
    from ..parallel.health import announce_fault
    from .device_rollout import HostRecord, StreamingDeviceRollout
    from .plane import PlaneClient

    train_args = dict(args["train_args"])
    train_args["env"] = args["env_args"]
    dist = dict(train_args.get("distributed") or {})
    seed = int(train_args["seed"])
    rank = int(dist.get("process_id") if dist.get("process_id") is not None
               else os.environ.get("PROCESS_ID", "0"))
    device = resolve_device(device)
    if trace.configure(train_args.get("trace"), rank=1000 + rank):
        print(f"trace: spans -> {trace.current_path()} (actor host {rank})")

    prepare_env(args["env_args"])
    env = make_env(args["env_args"])
    module = env.net()
    vector_env = getattr(env, "vector_env", None)
    if vector_env is None:
        raise ValueError(f"distributed.role: actor needs a vector env; "
                         f"{args['env_args'].get('env')} exposes no vector_env()")
    venv = vector_env()
    if not hasattr(venv, "record"):
        raise ValueError(
            "distributed.role: actor needs a STREAMING vector env "
            "(record/reset_done/step hooks); "
            f"{getattr(venv, '__name__', type(venv).__name__)} lacks them")
    # the learner's rings are built for device_rollout_games / num_processes
    # lanes per rank: a record block of another width fails at the gateway
    games = int(train_args["device_rollout_games"]) // max(1, int(dist.get("num_processes") or 1))
    # the base seed, as every learner rank: its rollouts play the learner's
    # initial params until the first poll lands
    init_variables(module, seed)
    roll = StreamingDeviceRollout(venv, module, train_args, n_lanes=games,
                                  k_steps=int(train_args["device_replay_k_steps"]), device=device)

    client = PlaneClient(dist)
    version = client.connect(retry_for=float(dist.get("initialization_timeout") or 300.0))
    print(f"actor host {rank}: connected to plane gateway (param version {version}); "
          f"{games} lanes on {device}", flush=True)

    stop = threading.Event()

    def _reconnect(i, exc):
        # one flaky syscall must not cost an exit 75: drop the connection,
        # dial a fresh one, and let retry_call re-issue the same request; a
        # reconnect that fails itself propagates (the gateway IS gone)
        nonlocal client
        print(f"[handyrl_tpu_torch] actor host {rank}: transient plane fault ({exc}); "
              f"reconnect attempt {i + 1}", file=sys.stderr)
        try:
            client.close()
        except Exception:
            pass
        client = PlaneClient(dist)
        # a learner that stays away past heartbeat_timeout (30 s by default,
        # JAX's reconnect window) is lost
        client.connect(retry_for=float(dist.get("heartbeat_timeout") or 30.0))

    def _stop_signal(signum, frame):
        print(f"[handyrl_tpu_torch] actor host {rank}: signal {signum} — draining",
              file=sys.stderr)
        stop.set()

    if threading.current_thread() is threading.main_thread():
        signal.signal(signal.SIGTERM, _stop_signal)
        signal.signal(signal.SIGINT, _stop_signal)

    # a stream of its own, past the learner ranks' seed + 1009 * rank family
    gen = torch.Generator(device=device).manual_seed(seed + 0x5EED + 0xAC706 + 1009 * rank)
    fresh = None            # params polled and not loaded yet
    pending = None          # the block launched before this one, on its way to the host
    dispatches = 0
    code = 0
    try:
        while not stop.is_set():
            with torch.inference_mode():
                block = HostRecord(roll.launch(fresh, gen))
            fresh = None
            prev, pending = pending, block
            if prev is None:
                continue
            records = prev.numpy()
            gateway_version = retry_call(lambda: client.ship_records(records),
                                         attempts=3, base_delay=0.1, on_retry=_reconnect)
            if gateway_version is None:
                break   # a clean stop from the gateway
            dispatches += 1
            if gateway_version > client.param_version:
                held, bytes0, t0 = client.param_version, client.bytes_in, time.perf_counter()
                got = retry_call(lambda: client.poll_params(),
                                 attempts=3, base_delay=0.1, on_retry=_reconnect)
                if got is None:
                    break
                new_version, params = got
                if params is not None:
                    fresh = {k: torch.from_numpy(v) for k, v in params.items()}
                    # the lag: learner updates these params are ahead of the
                    # ones the host played until now
                    print(f"actor host {rank}: params -> version {new_version} "
                          f"({client.bytes_in - bytes0} bytes in "
                          f"{time.perf_counter() - t0:.3f} s, lag {new_version - held} updates)",
                          flush=True)
    except (ConnectionError, OSError) as e:
        announce_fault(f"plane gateway lost after {dispatches} dispatches: {e}",
                       "learner_loss", EXIT_RESUMABLE)
        code = EXIT_RESUMABLE
    finally:
        # the block in flight finishes before the process leaves
        if pending is not None:
            pending.wait()
        client.close()
        trace.shutdown()
    if code == 0:
        print(f"actor host {rank}: finished ({dispatches} dispatches)", flush=True)
    return code
