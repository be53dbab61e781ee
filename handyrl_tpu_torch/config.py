"""Training configuration: defaults and validation for the keys the port reads.

The subset of ``handyrl_tpu/config.py`` that the ported modules use, with
the same names, defaults and checks, so one config.yaml (``env_args``,
``train_args``, ``worker_args``) configures both packages.  Every other key
of the JAX package's defaults is listed in ``NOT_PORTED_KEYS`` with its JAX
default and the ROADMAP item that ports it: the default passes, any other
value is refused by name rather than quietly run on the plain loop.  Keys
that neither package knows pass through untouched.  Every default is the
JAX package's, ``batch_pipeline: shm`` included.  Ported and acted on:
on-device self-play and evaluation, the device data plane, the
``serving`` block of ``--serve`` (int8 weights included), ``obs_int8``,
the ``fleet`` block of ``--fleet`` and ``--edge``, the ``flywheel`` block,
the divergence sentinel with its rollback, the preemption drain,
``trace`` and ``profile_dir``, the ``league`` block of ``--league``,
``autovec_verify_games``, and a learner of several processes: ``mesh``
(``dp``, and ``sp`` under ``seq_attention: ring``), ``distributed.*``
(actor hosts included) and ``observability.rank_metrics``.
"""

from __future__ import annotations

import copy
import math
from typing import Any, Dict

VALID_TARGETS = ("MC", "TD", "UPGO", "VTRACE")
REMAT_RUNGS = ("auto", "none", "attn", "block")

DEFAULT_TRAIN_ARGS: Dict[str, Any] = {
    "turn_based_training": True,
    "observation": False,
    "gamma": 0.8,
    "forward_steps": 16,
    "burn_in_steps": 0,
    "compress_steps": 4,
    "entropy_regularization": 1.0e-1,
    "entropy_regularization_decay": 0.1,
    "update_episodes": 200,
    "batch_size": 128,
    "minimum_episodes": 400,
    "maximum_episodes": 100000,
    "epochs": -1,            # -1 = run until stopped
    "num_batchers": 2,
    "eval_rate": 0.1,
    "worker": {
        "num_parallel": 6,
        "entry_port": 9999,
        "data_port": 9998,
        # liveness ping cadence of the remote actor plane, both directions;
        # a peer silent for ~3 intervals is presumed dead (0 disables both)
        "heartbeat_interval": 10.0,
        # the longest stall (no byte of progress) of a gather's send or
        # receive, not a bound on a whole frame: a params blob crossing a
        # slow link stays alive while bytes flow
        "socket_timeout": 60.0,
        # the entry handshake's absolute deadline: a client that connects
        # and stalls is dropped so later joins go on
        "entry_timeout": 10.0,
    },
    "lambda": 0.7,
    "policy_target": "TD",
    "value_target": "TD",
    "eval": {"opponent": ["random"]},
    "seed": 0,
    # 0 = fresh start; N > 0 = resume from models/{N}.ckpt (digest-checked);
    # -1 = resume from the newest snapshot that verifies
    "restart_epoch": 0,
    # epoch snapshots kept on disk (0 = all); latest/state always survive
    "keep_checkpoints": 100,
    "model_dir": "models",
    "metrics_path": "metrics.jsonl",
    # the most actor requests the inference engine runs in one forward
    "inference_batch_size": 64,
    # device batches the pipeline's put thread keeps ready
    "prefetch_batches": 2,
    # the batch-assembly plane: 'shm' forks num_batchers processes that
    # write columnar batches into shared-memory ring slots, off the
    # learner's GIL (runtime/shm_batch.py); 'thread' runs the batchers as
    # threads of the learner, and is what 'shm' degrades to, loudly, when
    # its processes cannot run; 'device' uploads host-born episodes once
    # into ring buffers on the card and samples and assembles every batch
    # there (runtime/device_batch.py), degrading loudly to 'shm'
    "batch_pipeline": "shm",
    # batch_pipeline: device geometry: episodes queue over this many ring
    # lanes, each lane holds this many steps, and a chunk of this many
    # steps per lane is uploaded at once
    "device_stage_lanes": 8,
    "device_stage_slots": 1024,
    "device_stage_chunk": 64,
    # ring depth in slots of one (B, T, P, ...) batch, raised to
    # 2 * fused_steps + 2 (effective_shm_slots)
    "shm_slots": 6,
    # a batcher process that dies is respawned this many times in a run;
    # past that, or when the ring stays silent this many seconds after a
    # death, the pipeline degrades to threads
    "batcher_max_restarts": 3,
    "batcher_stall_timeout": 60.0,
    # k updates per pull of the pipeline: the batches travel as one
    # stacked group, and the trainer takes them in a row at one lr
    "fused_steps": 1,
    # feed-forward nets run only on the live prefix of each window
    "compact_padding": True,
    # a step whose loss, gradient norm or lr is not finite leaves the
    # params and the Adam moments untouched; sentinel_rollback_after
    # consecutive bad steps (those skips, and loss spikes above
    # sentinel_spike_factor x the loss EMA, which bad steps never feed) roll
    # the train state back to the newest verified snapshot
    "sentinel": True,
    "sentinel_rollback_after": 8,
    "sentinel_spike_factor": 10.0,
    "sentinel_loss_ema_decay": 0.9,
    # whole-window attention training for models that set supports_seq
    "seq_forward": True,
    # 'auto' (the masked flash kernel for windows >= flash_min_t, the
    # exact einsum below), 'flash' or 'einsum'
    "seq_attention": "auto",
    "flash_min_t": 128,
    # query rows per chunk of the attention backward's recompute; blk_k,
    # the JAX kernel's key block, is checked as there and not read
    "blk_q": 128,
    "blk_k": 128,
    # the seq path's remat ladder: 'none', 'attn' (checkpoint the attention
    # sublayer), 'block' (the attention+FFN block), or 'auto' ('none' on
    # this backend); true/false collapse to 'block'/'none'.  The RNN branch
    # reads it as on/off per time step ('attn'/'block' on, 'none' off),
    # 'auto' on for every device but the CPU
    "remat": "auto",
    # the JAX package's switch to unroll its RNN training scan (an XLA
    # compile knob): accepted and checked ('auto', true, false) so one
    # config serves both packages, and ignored, since eager PyTorch steps
    # the recurrence in a Python loop either way
    "unroll": "auto",
    # 'bfloat16' runs forward and backward in bf16 over fp32 master weights
    "compute_dtype": "float32",
    "lr_scale": 1.0,
    # the network battle server's port (--eval-server / --eval-client)
    "battle_port": 9876,
    # on-device self-play: > 0 runs this many persistent lanes (episodic
    # games for a twin without the streaming hooks) of the env's device
    # twin on the card, beside the host actors (runtime/device_rollout.py)
    "device_rollout_games": 0,
    # on-device evaluation at each epoch boundary: > 0 plays this many
    # games of the net against eval.opponent's first entry (rulebase or
    # random) on the card (runtime/device_eval.py)
    "device_eval_games": 0,
    # N > 0: when the env's device twin is autovec-lifted (envs/autovec.py,
    # __autovec__), play N random step-parity games of the lift against the
    # numpy rules on the learner's device before training, and refuse to
    # train on a divergent lift
    "autovec_verify_games": 0,
    # true: keep the self-play data on the card end to end: the rollout's
    # records go into ring buffers on the card, and every batch is sampled
    # and assembled there (runtime/device_replay.py); needs
    # device_rollout_games > 0, and turn_based_training picks the window
    # mode (one target player, or all players with observation: true)
    "device_replay": False,
    # ring length in steps per lane, and game steps per rollout launch
    "device_replay_slots": 1024,
    "device_replay_k_steps": 32,
    # the rollout thread's watchdog: a thread that dies, or makes no
    # progress for plane_stall_timeout seconds after its first block, is
    # restarted up to plane_max_restarts times
    "plane_stall_timeout": 120.0,
    "plane_max_restarts": 2,
    # the SIGTERM drain: a learner stops, writes a verified checkpoint within
    # this many seconds and exits 75 (resume with restart_epoch: -1); --serve
    # pushes a draining notice to every peer, waits this long for its
    # sessions to be pulled, and exits 75
    "drain_deadline_seconds": 60.0,
    # the learner's ranks (parallel/distributed.py): an axis -> size dict
    # over one device per rank; only 'dp' is acted on (other axes of size 1
    # pass), -1 fills
    "mesh": {"dp": -1},
    # a learner of several processes: set coordinator_address ("host:port"
    # of rank 0) and num_processes (and process_id or PROCESS_ID) to join
    # one torch.distributed group; initialization_timeout bounds startup
    # against a dead or mis-addressed coordinator (a loud error, never a
    # hang); the heartbeat and collective knobs drive the health plane
    # (parallel/health.py): a lost or wedged peer is found within
    # heartbeat_timeout (collective_timeout for a silent wedge), the
    # coordinator drain-saves a verified checkpoint and every survivor
    # exits 75 for a restart_epoch: -1 relaunch
    "distributed": {
        "coordinator_address": None,
        "num_processes": 1,
        "process_id": None,
        "initialization_timeout": 300.0,
        "heartbeat_interval": 5.0,
        "heartbeat_timeout": 30.0,
        "collective_timeout": 300.0,
        # the health plane's TCP port on the coordinator's host (0 =
        # coordinator port + 1)
        "health_port": 0,
        # 'learner' processes join the group and train; 'actor' processes
        # stay outside it (runtime/actor_host.py) and stream self-play
        # records to the learner's plane gateway, polling params back
        "role": "learner",
        # the plane gateway's TCP port on the coordinator's host (0 =
        # health port + 1)
        "plane_port": 0,
        # actor-host processes expected at the gateway (0 = none); a lost
        # one degrades throughput, it never stops the run
        "actor_hosts": 0,
    },
    "observability": {
        # several processes: followers send a per-epoch metric snapshot on
        # their heartbeats, and rank 0's metrics.jsonl carries rank_*
        # aggregates over every rank
        "rank_metrics": True,
    },
    # a torch.profiler capture (CPU and CUDA activities) of the first
    # trained epoch, written as a Chrome trace under this directory
    "profile_dir": None,
    # the inference serving plane (serving/, --serve)
    "serving": {
        # TCP port of the serving front (0 = a free one)
        "port": 9997,
        # resident snapshot engines beyond which the LRU non-latest engine
        # is retired (drained, never dropped); the latest is always kept
        "max_models": 4,
        # default per-request latency budget (not imposed under
        # shed_policy: none; a request's own slo_ms always holds)
        "slo_ms": 200.0,
        # 'deadline' sheds on a predicted SLO miss (queue waves x the EMA
        # batch time), 'queue' only at queue_bound, 'none' never
        "shed_policy": "deadline",
        # the largest power-of-two bucket of one device batch
        "max_batch": 64,
        # straggler wait once a batch's first request arrived
        "max_wait_ms": 2.0,
        # buckets each engine runs once before it serves (and before a hot
        # swap flips to it)
        "warm_buckets": [1, 8],
        # queued requests per engine (both shed policies enforce it)
        "queue_bound": 1024,
        # a silent client is dropped after this many seconds (0 = never)
        "recv_timeout": 0.0,
        # seconds between manifest polls for an automatic hot swap to a
        # newer verified snapshot (0 = swap only when asked)
        "watch_interval": 0.0,
        # seconds between serve_* records appended to metrics_path (0 = off)
        "stats_interval": 30.0,
        # server-resident sessions: hidden states kept on the device before
        # the LRU spills to the host (0 turns sessions off)
        "session_capacity": 1024,
        # the host spill ring beyond session_capacity; past it the oldest
        # spilled session is dropped (its next infer is an affinity miss)
        "session_spill": 4096,
        # engine weights: 'float32', or 'int8' (per-channel int8 codes and
        # fp32 scales resident on the device, models/quantize.py)
        "weight_dtype": "float32",
        # int8 only: replay batches of observations each publish runs
        # through the fp32 and int8 engines to record their measured output
        # deviation (0 = no calibration record)
        "calibration_batches": 4,
    },
    # the fleet tier (fleet/, --fleet): an entry port proxying client frames
    # over --serve replicas, balanced by polled queue depth and shed rate,
    # sessions pinned to the replica holding their state and migrated off a
    # retiring or preempted one, replica-by-replica hot swap
    "fleet": {
        # TCP entry port (0 = a free one)
        "port": 9996,
        # replicas: 'host:port' strings or {host, port, tags} dicts; the tag
        # 'edge' marks feed-forward-only capacity
        "replicas": [],
        # seconds between the stats polls that feed the load scores
        "stats_poll_s": 2.0,
        # retries of a failing poll (exponential backoff from
        # poll_retry_backoff_s) before the replica may be declared lost
        "poll_retry_attempts": 3,
        "poll_retry_backoff_s": 0.1,
        # a replica silent this long with requests pending is lost (0 = only
        # a dropped connection is)
        "replica_stall_s": 30.0,
        # a lost replica is rejoined with backoff from rejoin_backoff_s,
        # doubling up to rejoin_backoff_max_s, forever
        "rejoin_backoff_s": 1.0,
        "rejoin_backoff_max_s": 30.0,
        # seconds between fleet_* records appended to metrics_path (0 = off)
        "stats_interval": 30.0,
        # a retire's drain, export and import must finish within this, else
        # its sessions re-open fresh (counted affinity misses)
        "migrate_timeout_s": 30.0,
        # the replica count driven by the windowed shed rate and queue depth
        # (fleet/autoscale.py): spawned replicas are admitted once warm,
        # retired ones leave through the session migration
        "autoscale": {
            "enabled": False,
            "min_replicas": 1,
            "max_replicas": 4,
            # seconds between decisions
            "interval_s": 1.0,
            # up when the shed rate exceeds shed_slo or the mean depth per
            # replica depth_high; down after scale_down_after_s of no shed
            # and depth under depth_low
            "shed_slo": 0.01,
            "depth_high": 64.0,
            "depth_low": 1.0,
            "scale_down_after_s": 30.0,
            # the least seconds between two scale actions
            "cooldown_s": 10.0,
            # a spawned replica not warm within this is marked lost
            "warm_timeout_s": 120.0,
        },
        # the edge replica (--edge ARTIFACT: a .pt2 export served on the
        # card as feed-forward capacity, tagged 'edge' in fleet.replicas)
        "edge_port": 9995,
        "edge_workers": 2,
        "edge_model": "",
    },
    # int8 observation planes: episodes quantize their observations once at
    # finalize under the env's per-leaf (scale, zero) spec, so the wire
    # blocks, the shm slots and the staged rings carry int8; the train step
    # and the rings' sampler widen them on the card (models/quantize.py)
    "obs_int8": False,
    # league training (``--league``, league/): a persistent population of
    # frozen snapshots and an anchor, PFSP matchmaking over the payoff
    # ledger, frozen opponents on resident router engines, and a promotion
    # gate that freezes the candidate into the population
    "league": {
        # 'var' weights p(1-p) (near-peers), 'hard' (1-p)^2 (the hardest),
        # 'even' uniform; p = the candidate's win rate against the member
        "pfsp_weighting": "var",
        # the share of generation jobs played latest-vs-latest
        "selfplay_rate": 0.2,
        # the gate: >= promote_games games against every active member and
        # pooled win points (wins + draws/2) >= promote_winrate
        "promote_winrate": 0.55,
        "promote_games": 8,
        # the active pool: the anchor and the newest frozen members
        "max_population": 16,
    },
    # the data flywheel (flywheel/): the serving tier harvests served games
    # into episodes, the learner pulls them, and promotions into serving are
    # gated on live win rate with a quality sentinel behind the gate
    "flywheel": {
        "enabled": False,
        # share of each epoch's update_episodes taken from harvested traffic
        # (1.0 = served traffic only, 0.0 = the quality plane alone)
        "harvest_fraction": 0.5,
        # harvested episodes this many model epochs behind are dropped
        "staleness_epochs": 4,
        # where the learner's ingest dials the serving tier (port 0 follows
        # serving.port), its poll cadence and per-poll cap
        "harvest_host": "127.0.0.1",
        "harvest_port": 0,
        "harvest_poll_s": 1.0,
        "harvest_max_pull": 64,
        # an open harvest episode idle past the TTL is dropped (truncated);
        # at most max_open open at once (the oldest sheds)
        "harvest_ttl_s": 600.0,
        "harvest_max_open": 256,
        # the promotion gate: a fresh snapshot is staged as a candidate on
        # shadow_fraction of latest-addressed traffic and latest flips only
        # once its live win points over promote_games games reach
        # promote_winrate; false = every fresh snapshot flips at once
        "gate_promotions": True,
        "promote_winrate": 0.55,
        "promote_games": 16,
        "shadow_fraction": 0.25,
        # the quality sentinel: a promoted snapshot whose live win-point EMA
        # (window quality_window games) falls demote_drop below the
        # incumbent's is demoted, and a rollback signal reaches training
        "quality_window": 32,
        "demote_drop": 0.15,
    },
    # span tracing of the hot paths (utils/trace.py), off by default: spans
    # go to a bounded ring and a background thread appends them to path
    "trace": {
        "enabled": False,
        # rank N > 0 of a run of several processes writes path.rankN.jsonl
        "path": "trace.jsonl",
        # a full ring drops spans (counted in trace_dropped), never blocks
        "ring_size": 4096,
        "flush_interval": 0.5,
        # also enter torch.profiler.record_function per span
        "annotate_device": True,
    },
}

DEFAULT_WORKER_ARGS: Dict[str, Any] = {
    "server_address": "",
    "num_parallel": 8,
    "entry_port": 9999,
    # on a severed or stalled connection the worker machine tears its
    # session down and re-enters through the entry port with exponential
    # backoff; rejoin: false joins once
    "rejoin": True,
    "rejoin_backoff": 1.0,
    "rejoin_backoff_max": 60.0,
    # consecutive failed sessions before giving up (-1 = never)
    "max_rejoins": -1,
    # how long each entry attempt retries the TCP connect
    "entry_retry_seconds": 60.0,
}

# keys of the JAX package's defaults that the port does not act on: the
# key's path in train_args, its JAX default, and the ROADMAP item that ports
# it.  The default passes; any other value is refused naming the item.  What
# is left needs cards of their own: a learner device beside actor devices
# (the split plane), NCCL across cards, tensor parallel axes
_OWN_CARDS = "A8 (cards of their own: plane: split, NCCL across cards, mp)"
NOT_PORTED_KEYS = (
    # the split plane spreads actors and learner over chips of their own
    (("plane",), "fused", _OWN_CARDS),
    # acts only under plane: split
    (("plane_param_lag_bound",), 0, _OWN_CARDS),
    (("actor_chips",), 1, _OWN_CARDS),
    (("param_refresh_updates",), 8, _OWN_CARDS),
)


def effective_shm_slots(train: Dict[str, Any]) -> int:
    """The ring depth the shm pipeline allocates: ``shm_slots`` raised so
    the put thread can hold two fused groups in flight while the children
    keep filling.  ``validate_args`` checks ``num_batchers`` against it."""
    return max(int(train.get("shm_slots", 6)), 2 * int(train.get("fused_steps", 1)) + 2, 3)


def _deep_merge(base: Dict[str, Any], override: Dict[str, Any]) -> Dict[str, Any]:
    out = copy.deepcopy(base)
    for key, value in (override or {}).items():
        if isinstance(value, dict) and isinstance(out.get(key), dict):
            out[key] = _deep_merge(out[key], value)
        else:
            out[key] = value
    return out


def validate_args(args: Dict[str, Any]) -> Dict[str, Any]:
    train = args["train_args"]
    for key in ("policy_target", "value_target"):
        if train[key] not in VALID_TARGETS:
            raise ValueError(f"{key}={train[key]!r} not one of {VALID_TARGETS}")
    for key in ("forward_steps", "batch_size", "compress_steps", "update_episodes"):
        if train[key] <= 0:
            raise ValueError(f"train_args.{key} must be positive, got {train[key]}")
    if train["burn_in_steps"] < 0:
        raise ValueError("train_args.burn_in_steps must be >= 0")
    if train["restart_epoch"] < -1:
        raise ValueError("train_args.restart_epoch must be >= -1 (-1 = auto-resume)")
    if train["keep_checkpoints"] < 0:
        raise ValueError("train_args.keep_checkpoints must be >= 0 (0 = keep all)")
    if not 0.0 <= train["eval_rate"] <= 1.0:
        raise ValueError("train_args.eval_rate must be in [0, 1]")
    if int(train["num_batchers"]) < 0:
        raise ValueError("train_args.num_batchers must be >= 0")
    # no local actor is allowed only where episodes come from elsewhere: the
    # flywheel's served traffic (its e2e mode trains on harvest alone)
    harvest_only = (train["flywheel"]["enabled"]
                    and float(train["flywheel"]["harvest_fraction"]) > 0)
    if int(train["worker"]["num_parallel"]) < (0 if harvest_only else 1):
        raise ValueError("train_args.worker.num_parallel must be >= 1 (0 only with the "
                         "flywheel harvesting)")
    pipeline = train["batch_pipeline"]
    if pipeline not in ("shm", "thread", "device"):
        raise ValueError(
            f"train_args.batch_pipeline={pipeline!r} not one of ('shm', 'thread', 'device')"
        )
    if int(train["fused_steps"]) < 1:
        raise ValueError("train_args.fused_steps must be >= 1")
    if int(train["shm_slots"]) < 2:
        raise ValueError("train_args.shm_slots must be >= 2")
    if int(train["batcher_max_restarts"]) < 0:
        raise ValueError("train_args.batcher_max_restarts must be >= 0")
    if float(train["batcher_stall_timeout"]) <= 0:
        raise ValueError("train_args.batcher_stall_timeout must be > 0")
    # the ring depth promised at any fused_steps (the JAX trainer may clamp
    # fused_steps to 1 at run time, so only that floor is checked there too)
    floor_slots = effective_shm_slots(dict(train, fused_steps=1))
    if pipeline in ("shm", "device") and int(train["num_batchers"]) > floor_slots:  # device degrades to shm
        # a child beyond the ring depth would never be dealt a slot
        raise ValueError(
            f"train_args.num_batchers={train['num_batchers']} exceeds the guaranteed shm "
            f"ring depth {floor_slots} (shm_slots={train['shm_slots']}): each batcher "
            "process needs at least one ring slot to hold; raise shm_slots or lower "
            "num_batchers"
        )
    if pipeline == "device":
        if train["device_replay"]:
            raise ValueError(
                "train_args.batch_pipeline: device is redundant under "
                "device_replay: true (that path never materializes host "
                "episodes, so there is nothing for the stage to upload)"
            )
        if int(train["device_stage_lanes"]) < 1:
            raise ValueError("train_args.device_stage_lanes must be >= 1")
        if int(train["device_stage_chunk"]) < 1:
            raise ValueError("train_args.device_stage_chunk must be >= 1")
        min_slots = train["burn_in_steps"] + train["forward_steps"]
        if int(train["device_stage_slots"]) <= min_slots:
            raise ValueError(
                "train_args.device_stage_slots must exceed burn_in_steps + "
                f"forward_steps = {min_slots}"
            )
    if train["seq_attention"] not in ("auto", "flash", "einsum", "ring"):
        raise ValueError(
            f"train_args.seq_attention={train['seq_attention']!r} "
            "not one of ('auto', 'flash', 'einsum', 'ring')"
        )
    if int(train["flash_min_t"]) < 1:
        raise ValueError("train_args.flash_min_t must be >= 1")
    for key in ("blk_q", "blk_k"):
        b = int(train[key])
        if b < 8 or (b & (b - 1)):
            raise ValueError(f"train_args.{key} must be a power of two >= 8, got {b}")
    rv = train["remat"]
    # bool first: membership would take the ints 0/1 through ==
    if not (isinstance(rv, bool) or rv in REMAT_RUNGS):
        raise ValueError(
            f"train_args.remat={rv!r} not one of ('auto', true, false, 'none', 'attn', 'block')"
        )
    uv = train["unroll"]
    if not (isinstance(uv, bool) or uv in ("auto", None)):
        raise ValueError(f"train_args.unroll={uv!r} not one of ('auto', true, false)")
    if train["compute_dtype"] not in ("float32", "bfloat16"):
        raise ValueError(
            f"train_args.compute_dtype={train['compute_dtype']!r} "
            "not one of ('float32', 'bfloat16')"
        )
    if train["lr_scale"] <= 0:
        raise ValueError(f"train_args.lr_scale must be > 0, got {train['lr_scale']}")
    if train["device_rollout_games"] < 0:
        raise ValueError("train_args.device_rollout_games must be >= 0")
    if train["device_eval_games"] < 0:
        raise ValueError("train_args.device_eval_games must be >= 0")
    if int(train["autovec_verify_games"]) < 0:
        raise ValueError("train_args.autovec_verify_games must be >= 0 (0 = off)")
    _validate_league(train["league"])
    if train["device_replay"]:
        if train["device_rollout_games"] <= 0:
            raise ValueError(
                "train_args.device_replay needs device_rollout_games > 0 "
                "(the lane count of the streaming rollout it feeds from)"
            )
        # the env, net and window-mode checks are DeviceReplay's, at the
        # learner's start, where the env and the net are known
        if train["device_replay_slots"] <= train["forward_steps"]:
            raise ValueError("train_args.device_replay_slots must exceed forward_steps")
        if train["device_replay_k_steps"] < 1:
            raise ValueError("train_args.device_replay_k_steps must be >= 1")
    if train["plane_stall_timeout"] <= 0:
        raise ValueError("train_args.plane_stall_timeout must be > 0")
    if train["plane_max_restarts"] < 0:
        raise ValueError("train_args.plane_max_restarts must be >= 0")
    if train["drain_deadline_seconds"] <= 0:
        raise ValueError("train_args.drain_deadline_seconds must be > 0")
    if train["sentinel_rollback_after"] < 1:
        raise ValueError("train_args.sentinel_rollback_after must be >= 1")
    if train["sentinel_spike_factor"] <= 1.0:
        raise ValueError(
            "train_args.sentinel_spike_factor must be > 1 (a spike is a "
            "multiple of the loss EMA)"
        )
    if not 0.0 < train["sentinel_loss_ema_decay"] < 1.0:
        raise ValueError("train_args.sentinel_loss_ema_decay must be in (0, 1)")
    _validate_serving(train["serving"])
    if not isinstance(train["obs_int8"], bool):
        raise ValueError(
            f"train_args.obs_int8={train['obs_int8']!r} must be a bool "
            "(int8 observation planes on the wire/rings)"
        )
    _validate_flywheel(train["flywheel"])
    _validate_fleet(train["fleet"])
    _validate_trace(train["trace"])
    _validate_not_ported_values(train)
    _validate_distributed(train)
    _validate_ring(train)
    for axis, size in train["mesh"].items():
        if axis not in ("dp", "sp") and size != 1:
            raise ValueError(
                f"train_args.mesh={train['mesh']!r}: the axis {axis!r} selects a plane that is "
                f"not ported to handyrl_tpu_torch yet (only 'dp' and 'sp' are): ROADMAP "
                f"{_OWN_CARDS}"
            )
    for path, default, item in NOT_PORTED_KEYS:
        value = train
        for key in path:
            value = value.get(key, default) if isinstance(value, dict) else default
        if value != default:
            raise ValueError(
                f"train_args.{'.'.join(path)}={value!r} selects a plane that is not ported to "
                f"handyrl_tpu_torch yet: ROADMAP {item}"
            )
    worker_args = args.get("worker_args", {})
    if worker_args and float(worker_args.get("entry_retry_seconds", 60.0)) <= 0:
        raise ValueError("worker_args.entry_retry_seconds must be > 0")
    if "env" not in args.get("env_args", {}):
        raise ValueError("env_args.env is required")
    return args


def _validate_serving(serving: Dict[str, Any]) -> None:
    if serving["shed_policy"] not in ("deadline", "queue", "none"):
        raise ValueError(
            f"train_args.serving.shed_policy={serving['shed_policy']!r} "
            "not one of ('deadline', 'queue', 'none')"
        )
    if int(serving["max_models"]) < 1:
        raise ValueError("train_args.serving.max_models must be >= 1")
    if float(serving["slo_ms"]) <= 0:
        raise ValueError("train_args.serving.slo_ms must be > 0")
    if int(serving["max_batch"]) < 1:
        raise ValueError("train_args.serving.max_batch must be >= 1")
    if float(serving["max_wait_ms"]) < 0:
        raise ValueError("train_args.serving.max_wait_ms must be >= 0")
    if int(serving["queue_bound"]) < 1:
        raise ValueError("train_args.serving.queue_bound must be >= 1")
    buckets = serving["warm_buckets"]
    if not isinstance(buckets, (list, tuple)) or not buckets:
        raise ValueError("train_args.serving.warm_buckets must be a non-empty list of bucket sizes")
    for b in buckets:
        if not isinstance(b, int) or b < 1 or (b & (b - 1)):
            raise ValueError(
                "train_args.serving.warm_buckets entries must be powers of two >= 1 "
                f"(the engine's batch shapes), got {b!r}"
            )
        if b > int(serving["max_batch"]):
            raise ValueError(
                f"train_args.serving.warm_buckets entry {b} exceeds serving.max_batch "
                f"{serving['max_batch']} — it would warm a shape the engine never runs"
            )
    for key in ("recv_timeout", "watch_interval", "stats_interval"):
        if float(serving[key]) < 0:
            raise ValueError(f"train_args.serving.{key} must be >= 0 (0 = off)")
    if not isinstance(serving["port"], int) or not 0 <= serving["port"] <= 65535:
        raise ValueError(f"train_args.serving.port={serving['port']!r} must be a TCP port (0 = a free one)")
    for key in ("session_capacity", "session_spill"):
        if int(serving[key]) < 0:
            raise ValueError(
                f"train_args.serving.{key} must be >= 0 (session_capacity 0 disables the "
                "session cache)"
            )
    if serving["weight_dtype"] not in ("float32", "int8"):
        raise ValueError(
            f"train_args.serving.weight_dtype={serving['weight_dtype']!r} "
            "not one of ('float32', 'int8')"
        )
    if int(serving["calibration_batches"]) < 0:
        raise ValueError(
            "train_args.serving.calibration_batches must be >= 0 (0 = skip "
            "the publish-time calibration record)"
        )


def _validate_flywheel(fly: Dict[str, Any]) -> None:
    if not isinstance(fly["enabled"], bool):
        raise ValueError(f"train_args.flywheel.enabled={fly['enabled']!r} must be a bool")
    for key in ("harvest_fraction", "shadow_fraction"):
        if not 0.0 <= float(fly[key]) <= 1.0:
            raise ValueError(f"train_args.flywheel.{key} must be in [0, 1]")
    if not 0.0 < float(fly["promote_winrate"]) < 1.0:
        raise ValueError(
            "train_args.flywheel.promote_winrate must be in (0, 1) — it is "
            "a live win-points bar, not a guarantee"
        )
    if not 0.0 < float(fly["demote_drop"]) < 1.0:
        raise ValueError(
            "train_args.flywheel.demote_drop must be in (0, 1) — the live "
            "win-point EMA drop that trips the quality sentinel"
        )
    if int(fly["staleness_epochs"]) < 1:
        raise ValueError(
            "train_args.flywheel.staleness_epochs must be >= 1 (0 would "
            "drop every harvested episode as stale)"
        )
    for key in ("promote_games", "quality_window", "harvest_max_pull", "harvest_max_open"):
        if int(fly[key]) < 1:
            raise ValueError(f"train_args.flywheel.{key} must be >= 1")
    for key in ("harvest_poll_s", "harvest_ttl_s"):
        if float(fly[key]) <= 0:
            raise ValueError(f"train_args.flywheel.{key} must be > 0")
    if not isinstance(fly["gate_promotions"], bool):
        raise ValueError(
            f"train_args.flywheel.gate_promotions={fly['gate_promotions']!r} must be a bool"
        )
    if not isinstance(fly["harvest_port"], int) or not 0 <= fly["harvest_port"] <= 65535:
        raise ValueError(
            f"train_args.flywheel.harvest_port={fly['harvest_port']!r} must "
            "be a TCP port in [0, 65535] (0 = follow serving.port)"
        )


def _validate_fleet(fleet: Dict[str, Any]) -> None:
    for key in ("port", "edge_port"):
        if not isinstance(fleet[key], int) or not 0 <= fleet[key] <= 65535:
            raise ValueError(
                f"train_args.fleet.{key}={fleet[key]!r} must be a TCP port (0 = ephemeral)"
            )
    if not isinstance(fleet["replicas"], (list, tuple)):
        raise ValueError(
            "train_args.fleet.replicas must be a list of 'host:port' strings "
            "or {host, port, tags} dicts"
        )
    for entry in fleet["replicas"]:
        if isinstance(entry, str):
            host, sep, port = entry.rpartition(":")
            if not sep or not port.isdigit():
                raise ValueError(f"train_args.fleet.replicas entry {entry!r} is not 'host:port'")
        elif isinstance(entry, dict):
            if "host" not in entry or "port" not in entry:
                raise ValueError(
                    f"train_args.fleet.replicas entry {entry!r} needs 'host' and 'port' keys"
                )
        else:
            raise ValueError(
                f"train_args.fleet.replicas entry {entry!r} must be a 'host:port' string or a dict"
            )
    if int(fleet["poll_retry_attempts"]) < 0:
        raise ValueError("train_args.fleet.poll_retry_attempts must be >= 0 (0 = no retry)")
    if float(fleet["poll_retry_backoff_s"]) <= 0:
        raise ValueError("train_args.fleet.poll_retry_backoff_s must be > 0")
    if float(fleet["stats_poll_s"]) <= 0:
        raise ValueError(
            "train_args.fleet.stats_poll_s must be > 0 (it feeds the load "
            "scores the router balances by)"
        )
    if float(fleet["replica_stall_s"]) < 0:
        raise ValueError(
            "train_args.fleet.replica_stall_s must be >= 0 (0 disables the "
            "stall deadline; failover then only on connection loss)"
        )
    if float(fleet["rejoin_backoff_s"]) <= 0:
        raise ValueError("train_args.fleet.rejoin_backoff_s must be > 0")
    if float(fleet["rejoin_backoff_max_s"]) < float(fleet["rejoin_backoff_s"]):
        raise ValueError(
            "train_args.fleet.rejoin_backoff_max_s must be >= rejoin_backoff_s (it is the "
            "backoff's cap)"
        )
    if float(fleet["stats_interval"]) < 0:
        raise ValueError("train_args.fleet.stats_interval must be >= 0 (0 = off)")
    if float(fleet["migrate_timeout_s"]) <= 0:
        raise ValueError(
            "train_args.fleet.migrate_timeout_s must be > 0 (the planned-"
            "retire drain/export/import budget)"
        )
    if int(fleet["edge_workers"]) < 1:
        raise ValueError("train_args.fleet.edge_workers must be >= 1")
    autoscale = fleet["autoscale"]
    if not isinstance(autoscale["enabled"], bool):
        raise ValueError(
            f"train_args.fleet.autoscale.enabled={autoscale['enabled']!r} must be a bool"
        )
    if int(autoscale["min_replicas"]) < 1:
        raise ValueError(
            "train_args.fleet.autoscale.min_replicas must be >= 1 (a fleet "
            "scaled to zero cannot serve)"
        )
    if int(autoscale["max_replicas"]) < int(autoscale["min_replicas"]):
        raise ValueError("train_args.fleet.autoscale.max_replicas must be >= min_replicas")
    for key in ("interval_s", "warm_timeout_s"):
        if float(autoscale[key]) <= 0:
            raise ValueError(f"train_args.fleet.autoscale.{key} must be > 0")
    if not 0.0 <= float(autoscale["shed_slo"]) <= 1.0:
        raise ValueError(
            "train_args.fleet.autoscale.shed_slo must be in [0, 1] (a shed "
            "RATE: sheds over requests in the window)"
        )
    if float(autoscale["depth_low"]) < 0:
        raise ValueError("train_args.fleet.autoscale.depth_low must be >= 0")
    if float(autoscale["depth_high"]) <= float(autoscale["depth_low"]):
        raise ValueError(
            "train_args.fleet.autoscale.depth_high must be > depth_low "
            "(the hysteresis band between scale-up and scale-down)"
        )
    for key in ("scale_down_after_s", "cooldown_s"):
        if float(autoscale[key]) < 0:
            raise ValueError(f"train_args.fleet.autoscale.{key} must be >= 0")


def _validate_trace(tr: Dict[str, Any]) -> None:
    if not isinstance(tr["enabled"], bool):
        raise ValueError(f"train_args.trace.enabled={tr['enabled']!r} must be a bool")
    if tr["enabled"] and not str(tr["path"] or "").strip():
        raise ValueError(
            "train_args.trace.path must name a file when trace.enabled is "
            "true (writability is probed at startup by trace.configure)"
        )
    if int(tr["ring_size"]) < 1:
        raise ValueError("train_args.trace.ring_size must be >= 1")
    if float(tr["flush_interval"]) <= 0:
        raise ValueError("train_args.trace.flush_interval must be > 0")
    if not isinstance(tr["annotate_device"], bool):
        raise ValueError(
            f"train_args.trace.annotate_device={tr['annotate_device']!r} must be a bool"
        )


def _validate_league(league: Dict[str, Any]) -> None:
    if league["pfsp_weighting"] not in ("var", "hard", "even"):
        raise ValueError(
            f"train_args.league.pfsp_weighting={league['pfsp_weighting']!r} "
            "not one of ('var', 'hard', 'even')"
        )
    if not 0.0 <= float(league["selfplay_rate"]) <= 1.0:
        raise ValueError("train_args.league.selfplay_rate must be in [0, 1]")
    if not 0.0 < float(league["promote_winrate"]) < 1.0:
        raise ValueError(
            "train_args.league.promote_winrate must be in (0, 1) — it is a "
            "win-points bar over the active population"
        )
    if int(league["promote_games"]) < 1:
        raise ValueError("train_args.league.promote_games must be >= 1")
    if int(league["max_population"]) < 2:
        raise ValueError(
            "train_args.league.max_population must be >= 2 (the anchor "
            "plus at least one frozen member)"
        )


def _validate_not_ported_values(train: Dict[str, Any]) -> None:
    """The JAX package's checks of keys the port refuses anyway: a value
    both would refuse gets the JAX package's words."""
    defaults = {path: default for path, default, _ in NOT_PORTED_KEYS}

    def get(*path):
        value = train
        for key in path:
            value = value.get(key, defaults[path]) if isinstance(value, dict) else defaults[path]
        return value

    if int(get("actor_chips")) < 1:
        raise ValueError("train_args.actor_chips must be >= 1")
    if int(get("param_refresh_updates")) < 1:
        raise ValueError("train_args.param_refresh_updates must be >= 1")


def _validate_ring(train: Dict[str, Any]) -> None:
    """``seq_attention: ring`` and the ``sp`` axis: the JAX package's
    checks and words, and the port's own refusals by name."""
    mesh = train["mesh"]
    sp = mesh.get("sp", 1)
    ring = train["seq_attention"] == "ring"
    if ring and train["remat"] in ("attn", "block", True):
        raise ValueError(
            "train_args.remat ladder is unsupported with seq_attention: "
            "'ring' — the ring already partitions activation memory over "
            "'sp' (each device holds one T/sp shard); use remat: none or auto"
        )
    if ring:
        if sp != -1 and sp < 2:
            raise ValueError(
                "train_args.seq_attention: 'ring' needs an 'sp' mesh axis of "
                f"size >= 2 (or -1), got mesh {mesh}"
            )
        T = train["burn_in_steps"] + train["forward_steps"]
        if sp > 0 and T % sp:
            raise ValueError(
                f"train_args.seq_attention: 'ring' window {T} (burn_in_steps "
                f"+ forward_steps) must be divisible by mesh sp={sp}"
            )
        # each rank's ring runs on its own card, fed by its sp leader's host
        # pipeline; the device data plane would need the rings per group
        if train["device_replay"] or train["batch_pipeline"] == "device":
            raise ValueError(
                "train_args.seq_attention: 'ring' with device_replay: true or "
                "batch_pipeline: device is not ported to handyrl_tpu_torch yet (the sp "
                "leader's host pipeline feeds the group): ROADMAP A8"
            )
    elif sp != 1:
        raise ValueError(
            f"train_args.mesh={mesh!r}: an 'sp' axis shards the window only under "
            "seq_attention: 'ring' (the JAX package replicates the step across it); set "
            "seq_attention: ring or drop the axis: ROADMAP A8"
        )


def _validate_distributed(train: Dict[str, Any]) -> None:
    """``mesh``, ``distributed.*`` and ``observability.rank_metrics``, with
    the JAX package's checks and words."""
    mesh = train["mesh"]
    if not isinstance(mesh, dict) or not mesh:
        raise ValueError("train_args.mesh must be a non-empty axis->size dict")
    for axis, size in mesh.items():
        if not isinstance(size, int) or isinstance(size, bool) or (size < 1 and size != -1):
            raise ValueError(f"train_args.mesh={mesh!r}: axis {axis!r} size must be a "
                             "positive int or -1 (fill)")
    if not isinstance(train["observability"]["rank_metrics"], bool):
        raise ValueError(
            f"train_args.observability.rank_metrics={train['observability']['rank_metrics']!r} "
            "must be a bool"
        )
    dist = train["distributed"]
    if dist["coordinator_address"] is not None:
        # the pre-flight, the store and the health plane parse host:port
        # out of this: a missing port fails here, with the knob named
        _host, _, _port = str(dist["coordinator_address"]).rpartition(":")
        if not _host or not _port.isdigit() or not 1 <= int(_port) <= 65535:
            raise ValueError(
                f"train_args.distributed.coordinator_address="
                f"{dist['coordinator_address']!r} must be 'host:port' with a "
                "TCP port (the address of process 0)"
            )
    if int(dist["num_processes"]) < 1:
        raise ValueError("train_args.distributed.num_processes must be >= 1")
    if dist["process_id"] is not None and int(dist["process_id"]) < 0:
        raise ValueError("train_args.distributed.process_id must be >= 0")
    if float(dist["initialization_timeout"]) <= 0:
        raise ValueError(
            "train_args.distributed.initialization_timeout must be > 0 "
            "(it bounds the process group's initialization against a dead or "
            "mis-addressed coordinator — 0 would restore the indefinite "
            "startup hang)"
        )
    if float(dist["heartbeat_interval"]) < 0:
        raise ValueError(
            "train_args.distributed.heartbeat_interval must be >= 0 "
            "(0 disables the cross-host health plane)"
        )
    if float(dist["heartbeat_timeout"]) <= 0:
        raise ValueError("train_args.distributed.heartbeat_timeout must be > 0")
    if (float(dist["heartbeat_interval"]) > 0
            and float(dist["heartbeat_timeout"]) <= 2 * float(dist["heartbeat_interval"])):
        raise ValueError(
            "train_args.distributed.heartbeat_timeout must exceed 2x "
            "heartbeat_interval — a single delayed beat must not count a "
            "live host as lost"
        )
    if float(dist["collective_timeout"]) < 0:
        raise ValueError(
            "train_args.distributed.collective_timeout must be >= 0 "
            "(0 disables the collective watchdog)"
        )
    if not isinstance(dist["health_port"], int) or not 0 <= dist["health_port"] <= 65535:
        raise ValueError(
            f"train_args.distributed.health_port={dist['health_port']!r} "
            "must be a TCP port (0 = coordinator port + 1)"
        )
    if (dist["health_port"] == 0 and dist["coordinator_address"] is not None
            and float(dist["heartbeat_interval"]) > 0
            and int(str(dist["coordinator_address"]).rpartition(":")[2]) >= 65535):
        raise ValueError(
            "train_args.distributed.health_port derives as coordinator "
            "port + 1 = 65536, which is not a TCP port — set "
            "distributed.health_port explicitly"
        )
    if str(dist["role"]) not in ("learner", "actor"):
        raise ValueError(
            f"train_args.distributed.role={dist['role']!r} not one of "
            "('learner', 'actor') — learners join the process group; actor "
            "hosts stream records to the plane gateway"
        )
    if not isinstance(dist["plane_port"], int) or not 0 <= dist["plane_port"] <= 65535:
        raise ValueError(
            f"train_args.distributed.plane_port={dist['plane_port']!r} "
            "must be a TCP port (0 = health port + 1)"
        )
    if int(dist["actor_hosts"]) < 0:
        raise ValueError("train_args.distributed.actor_hosts must be >= 0")
    actor_tier = int(dist["actor_hosts"]) > 0 or str(dist["role"]) == "actor"
    if actor_tier and not dist["coordinator_address"]:
        raise ValueError(
            "train_args.distributed.actor_hosts/role: actor need "
            "distributed.coordinator_address — the plane gateway binds on "
            "(and actor hosts dial) the coordinator host"
        )
    if str(dist["role"]) == "actor" and int(train["device_rollout_games"]) <= 0:
        raise ValueError(
            "train_args.distributed.role: actor needs device_rollout_games "
            "> 0 — a dedicated actor host generates with the on-device "
            "streaming rollout (host self-play already has the worker tier)"
        )
    if (dist["plane_port"] == 0 and dist["coordinator_address"] is not None and actor_tier
            and (dist["health_port"]
                 or int(str(dist["coordinator_address"]).rpartition(":")[2]) + 1) >= 65535):
        raise ValueError(
            "train_args.distributed.plane_port derives as health port + 1 "
            "= 65536, which is not a TCP port — set "
            "distributed.plane_port explicitly"
        )
    # the group only comes up with a coordinator_address, so the shard
    # checks key on both
    if int(dist["num_processes"]) > 1 and dist["coordinator_address"]:
        nprocs = int(dist["num_processes"])
        if int(train["batch_size"]) % nprocs != 0:
            raise ValueError(
                f"train_args.batch_size={train['batch_size']} must divide "
                f"evenly across distributed.num_processes={nprocs} — each "
                "process assembles batch_size/num_processes local rows for "
                "the collective train step"
            )
        if int(train["device_rollout_games"]) > 0 and (
                int(train["device_rollout_games"]) % nprocs != 0):
            raise ValueError(
                f"train_args.device_rollout_games="
                f"{train['device_rollout_games']} must divide evenly across "
                f"distributed.num_processes={nprocs} — each process runs "
                "device_rollout_games/num_processes lanes on its local "
                "actor devices"
            )
        fixed = math.prod(size for size in mesh.values() if size > 0)
        if (fixed != nprocs if -1 not in mesh.values() else nprocs % fixed):
            raise ValueError(
                f"train_args.mesh={mesh!r} must cover the {nprocs} ranks of "
                "distributed.num_processes (one device per rank; -1 fills)"
            )


def normalize_args(raw: Dict[str, Any]) -> Dict[str, Any]:
    """Apply defaults to a raw config dict and validate."""
    train_raw = dict(raw.get("train_args", {}) or {})
    if "attn_mode" in train_raw:  # documented alias of seq_attention
        mode = train_raw.pop("attn_mode")
        if train_raw.get("seq_attention", mode) != mode:
            raise ValueError(
                f"train_args.attn_mode={mode!r} contradicts "
                f"train_args.seq_attention={train_raw['seq_attention']!r} "
                "(attn_mode is an alias; set one)"
            )
        train_raw["seq_attention"] = mode
    args = {
        "env_args": copy.deepcopy(raw.get("env_args", {})),
        "train_args": _deep_merge(DEFAULT_TRAIN_ARGS, train_raw),
        "worker_args": _deep_merge(DEFAULT_WORKER_ARGS, raw.get("worker_args", {}) or {}),
    }
    return validate_args(args)
