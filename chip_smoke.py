#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (handyrl_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                 # every phase, a few minutes on an H100
    python3 chip_smoke.py --kernels-only  # phases 1-3: build, check and time the kernels
    python3 chip_smoke.py --parent DIR    # also: DIR's kernels against these (see phase_parent)
    python3 chip_smoke.py --stream c      # one stream of phases alone (STREAMS)

Phases, each of which fails the run when it fails:

1. device: the card's name and power limit; build every kernel source with
   nvcc, one process per source, all at once, and print ptxas's registers /
   shared memory / spills for each kernel; a spill in any instance fails.
2. kernels vs their plain versions on the card, fp32, bf16 and fp16: the
   masked kernel at the training shape and small ragged ones (head dims
   16 and 24), the plain flash kernel, causal and full, at the JAX
   package's flash-bench shape, the transformer's width at T1024 and a
   small ragged one; both kernels' bf16/fp16 (wgmma) bodies at every
   instantiated head dim, at T100 and T1024, masked with window 32 and
   without; both raw launches on misaligned views; causal in bf16 at
   phase 4's long shape (T8192).
3. kernel timing (CUDA events) beside its bound, the plain version and one
   PyTorch library call computing the same function, with the achieved
   TFLOP/s and the share of the bound.  With ``--parent DIR``, another
   checkout's kernels against these in turns (``phase_parent``).
4. the ``ops.flash_attention`` entry point, forward and backward: the
   gradients of ``(flash_attention(q, k, v) ** 2).sum()`` held against
   autograd through the plain version, ms per forward+backward, one call
   under the profiler, and one long sequence (T8192) with its peak memory.
5. acting: Geister self-play with the full-width memory transformer
   (d_model 1536, 16 heads, 8 layers, memory 32) in step mode on the card.
6. training: the Trainer at batch 16 x window 512 in bf16 on those episodes,
   through the masked flash kernel (launch count checked), its loss held
   against the einsum path on one batch.
7. learner: (a) the repo's config.yaml (TicTacToe, SimpleConvNet) with
   epochs cut to 2 (100 + 50 episodes) through ``python -m handyrl_tpu_torch.main --train`` in a
   temp directory, its checkpoints verified against the manifest, and
   ``--eval models/latest.ckpt 20 4``; (b) the transformer above trained
   by ``Learner(args).run()`` (actor threads through the batched inference
   engine, the shm batch pipeline, 2 epochs), the kernel's launches
   held to n_layers per step, the checkpoints verified and reloaded bit
   for bit; then one train step's time and peak memory under remat 'none'
   and 'block'.
8. recurrent and simultaneous-move training, no kernel on either path:
   (a) Geister with the DRC ``GeisterNet`` at its full width (bench.py's
   geister stage: B128, burn-in 8, forward 16, UPGO, fp32) through
   ``Learner(args).run()`` for 2 epochs with 8 actors, checkpoints verified
   and reloaded bit for bit; one train step's time and peak memory with
   remat on and off, one under the profiler (busy share, launches); the RNN
   branch's forward on the card against the CPU's on one batch, in the
   port's conv mode (TF32) and in strict fp32; (b) HungryGeese (GeeseNet,
   simultaneous moves, 4 players) through ``python -m
   handyrl_tpu_torch.main --train`` for 2 epochs, evaluated against the
   rule-based geese, then ``--eval models/latest.ckpt:rulebase 10 4``.
9. the remote actor plane and network battles, over loopback: (a) the
   repo's config.yaml with epochs cut to 3 (100 + 50 episodes) through ``--train-server`` and
   ``--worker`` processes (8 remote actors on the card, a 1 s heartbeat),
   its checkpoints verified, episodes/s and updates/s per epoch; (b) the
   transformer above through ``Learner(args, remote=True)`` in this process
   with one ``--worker 8`` process on the same card: the masked kernel
   held to n_layers launches per learner step, each params blob the worker
   fetched held by CRC32 against the blob served and the snapshot saved,
   the blob's size and fetch seconds, remote moves/s, the boundaries'
   seconds, jobs_lost and heartbeat drops; (c) ``--eval-server 10`` with
   two ``--eval-client`` processes, (a)'s ``models/latest.ckpt`` on the
   card and random: 10 games, no forfeit.  Alone: ``python3 -c "import
   chip_smoke as cs; cs.phase_remote({})"``.
10. the batch-assembly plane at full width: (a) the C codec against the
   pure-Python one, byte for byte and decode for decode, on episodes of
   every env, and the ms to encode and decode 64 Geister episodes both
   ways; (b) the C fill against the numpy fill, bit for bit, with the ms,
   on 8a's B128 x T24 batch and 7b's B16 x T512 batch, and the copy of a
   ring slot to the card: registered pages seen as pinned, the put's host
   time against its copy's event time, and 7a's feed-forward cut made on
   the host or on the card; (c) 8a's and 7a's learners under
   ``batch_pipeline: thread`` and ``shm`` in turns, each run's second
   epoch; (d) a batcher child
   SIGKILLed mid-run: respawned, batches flow, the learner ends, the
   segment is unlinked; (e) no batcher pid holds a CUDA context.  Alone:
   ``python3 -c "import chip_smoke as cs; cs.phase_assembly({})"``.
11. on-device self-play and evaluation, random weights from seed 0, full
   width: (a) each rollout alone: HungryGeese (``GeeseNet``, 256 lanes x 32
   steps), Geister (the DRC ``GeisterNet``, ``observation: true``, 128
   lanes x 32 steps), TicTacToe (``SimpleConvNet``, episodic, 2048 games),
   ParallelTicTacToe (256 lanes): env-steps/s, player-steps/s and
   episodes/s over a timed window with the episode assembly inside it; a
   generate's host launch, device (events), wait and assembly ms; the
   launches per game step from one profiled call (HungryGeese, Geister);
   (b) gates: 32 episodes per env replayed through the port's host env
   (every action legal, every observation and outcome equal), one step of
   each streaming twin on the card equal to the CPU's from the same state
   and noise, ties taken first by argmax/argmin and the rule-based twin on
   the card, every rollout tensor on the card; (c) HungryGeese through
   ``--train`` with ``device_rollout_games: 256`` and ``device_eval_games:
   64`` against rulebase, 2 epochs (64 + 64 episodes): updates/s,
   the pipeline's stages, episodes/s from the device
   and from host workers, ``device_mean_episode_len``, the device-rulebase
   win rate, ``input_wait_frac``; every epoch on the fused plane with its
   device-rulebase win rate, no failed device evaluation, no watchdog
   stall, no batcher fallback; (d) Geister's DRC through
   ``Learner(args).run()`` with ``device_rollout_games: 128``, cut as 8a:
   finite losses, every epoch on the fused plane, no watchdog stall.  Alone:
   ``python3 -c "import chip_smoke as cs; cs.phase_selfplay({})"``.
12. the device data plane (rings on the card, ``device_replay`` and
   ``batch_pipeline: device``), random weights from seed 0, full width:
   (a) HungryGeese ``GeeseNet`` in ff mode, bench.py's north-star loop: 128
   lanes x 32 steps per rollout launch into 512-slot rings, 16 train calls
   of fused_steps 8 (B128 x T16) per launch, a 3 s window after a prefill:
   updates/s, trained and self-play env-steps/s, the rollout's share of
   the window, launches per ingest and per train call, the rings' bytes,
   peak memory; (b) Geister's DRC in turn mode (64 lanes, B16, burn-in 4 +
   forward 8, UPGO, fused 4, 2 train calls per launch), the same numbers;
   (c) the transformer above in turn mode from rings (32 lanes, 1024 slots)
   through B1: one train call's ms and peak memory, B1 launched n_layers
   times per update, the loss finite and held against the einsum path on
   one sampled batch; (d) 11(c)'s HungryGeese through ``--train`` and
   11(d)'s DRC through ``Learner(args).run()`` with ``device_replay:
   true``, 2 epochs each: updates/s, ``device_episodes``,
   ``device_mean_episode_len``, the device-rulebase rate and
   ``input_wait_frac`` beside 11(c)/(d)'s; finite losses, no watchdog
   stall, every returned episode a device one (host workers only
   evaluate); (e) 8b's and 8a's learners under ``batch_pipeline: device``
   and ``shm`` in turns, one epoch each: updates/s, input wait, the stage's
   assemble/put seconds; every device epoch live in mode ``device``;
   (f) gates: every ring tensor on the card, one ingest on the card equal
   to the CPU's bit for bit, one sampled batch equal to the CPU's from the
   same rings and draws, nothing of the port outliving the phase.  Alone:
   ``python3 -c "import chip_smoke as cs; cs.phase_device_data({})"``.
13. the inference serving plane, random weights from seeds: (a) bench.py's
   serving legs on the port (TicTacToe ``SimpleConvNet`` served on the card
   by this process, 8 connections x 8 outstanding, max_batch 64, buckets
   1-64 warmed): a 4 s closed loop (saturation QPS, the client's p50/p99),
   a hot swap under load (warm ms, the first reply from the new model,
   dropped), an open loop at 0.25x and 2x saturation against a 25 ms SLO
   (shed rates); gates: nothing dropped, the flip seen, less shed at the
   low load than at the high, no error frame; (b) ``python -m
   handyrl_tpu_torch.main --serve`` from a config.yaml: Geister with the
   training slice's transformer at full width from a verified seed-0
   snapshot, 256 sessions resident, 1024 spilled: 8 connections x 64
   sessions (256 games of the model against itself, a session per seat)
   for 6 s, session steps/s,
   p50/p99, mean batch, restores and evictions (both > 0), a seed-1
   snapshot entered into the manifest mid-run and swapped in by the
   watcher, the hidden state's D2H and H2D ms per batch of 64, one batch
   under the profiler, the card's peak memory, and SIGTERM: the draining
   notice, the sessions exported, exit 75 inside the deadline; (c) 4
   sessions x 4 steps through the server against the ``InferenceModel`` on
   the card with an explicit hidden state at the same bucket: the
   transformer within 2e-2 of the outputs' scale, the DRC ``GeisterNet`` in
   fp32 (served by this process) within 1e-4.  Alone: ``python3 -c "import
   chip_smoke as cs; cs.phase_serving({})"``.
14. the fleet tier and the learner's fault machinery, random weights from
   seeds: (a) ``python -m handyrl_tpu_torch.main --fleet`` over two
   ``--serve`` processes (TicTacToe ``SimpleConvNet``, 13(a)'s load shape),
   closed loops in turns through the fleet and direct to one replica
   (req/s, p50/p99: the router's cost per request), a fleet-wide swap under
   load (0 dropped, both replicas flipped), SIGTERM: the fleet exits 0, the
   replicas 75; (b) the training slice's transformer at full width in two
   ``--serve`` processes behind a ``FleetRouter`` in this process, 256
   sessions of Geister self-play, one replica SIGTERMing itself
   (``HANDYRL_FAULT_SIGTERM_REPLICA``) mid-load: its sessions migrate to
   the survivor with no error and no affinity miss, it exits 75; session
   steps/s before and after, the migration's ms and MB, notice-to-exit
   seconds, each replica's peak memory; 4 migrated sessions against a
   replay on the card (2e-2 of scale); (c) ``fleet.autoscale`` over
   ``ProcessReplicaFactory`` replicas (spawned processes on the card,
   TicTacToe at max_batch 1) under an open loop above one replica's
   saturation: the new replica takes its first request only once admitted
   warm (decision-to-admission and first-request seconds, shed rates before
   and after), calm retires it through the migration with no session lost;
   (d) config.yaml's learner (episodes cut) through the CLI with
   ``HANDYRL_FAULT_NAN_AT_STEP`` (skips, rolls back, finite losses) plus
   ``trace.enabled`` (spans read back) and ``profile_dir`` (CUDA kernel
   events in the trace), with ``HANDYRL_FAULT_SIGTERM_AT_STEP`` (exit 75, a
   verified drain checkpoint, a ``restart_epoch: -1`` relaunch resuming
   there), and updates/s with tracing on and off in turns.  Alone:
   ``python3 -c "import chip_smoke as cs; cs.phase_fleet({})"``.
15. int8, export and the edge, the data flywheel, random weights from
   seeds: (a) the training slice's transformer as an int8 engine on the
   card: its codes and scales equal the host quantize bit for bit, its
   outputs an fp32 engine of the dequantized tree within 1e-5 of scale;
   param bytes, the dequantize's share of a batch of 64 (CUDA events), a
   profiled batch, the calibration report; 13(b)'s session load (256
   resident sessions) and 13(a)'s TicTacToe load on int8 and fp32 servers
   in turns; ``--serve`` with ``serving.weight_dtype: int8``: no error
   frame, sessions against a replay of the int8 engine (2e-2 of scale), a
   swap from disk to an int8 engine, its peak memory at the SIGTERM drain;
   (b) (i) the transformer (B16 x T512 bf16) on Geister episodes made with
   ``obs_int8`` true and false from one seed: the int8 windows widened on
   the card equal the fp32 ones bit for bit, train steps through B1 on
   each (finite, the first losses within 2e-2, n_layers launches per
   update), encoded and batch bytes; (ii) config.yaml's learner (2 epochs
   of 32 + 32) with ``obs_int8`` true and false in turns on ``shm`` and
   ``device`` (finite losses, updates/s, input wait), the staged rings'
   bytes; (c) (i) the transformer (step mode, KV-cache hidden) and GeeseNet
   exported to ``.pt2`` on the card, reloaded in fresh processes on the
   card and the CPU (batch 1 and 64 within 1e-5 of scale, strict fp32),
   ``--eval`` of the GeeseNet artifact (20 games); (ii) ``--edge model.pt2``
   tagged edge beside a ``--serve`` replica behind ``--fleet`` under 13(a)'s
   load: req/s served by each, no session on the edge, a sid or a swap sent
   to it refused, its peak memory; (d) ``--serve`` with ``flywheel.enabled``
   (TicTacToe): one harvested episode against the self-play encoding of its
   trajectory byte for byte, harvest and judge clients, ``--train`` on
   harvested traffic only with ``HANDYRL_FAULT_POISON_SNAPSHOT_AT_EPOCH=2``:
   no malformed episode or error frame, the poisoned snapshot staged and
   failed or demoted, the learner rolls back, the served epochs survive
   ``gc_snapshots``.  Alone: ``python3 -c "import chip_smoke as cs;
   cs.phase_quantize_edge_flywheel({})"``.
16. the autovec twins, the host-sync sanitizer and the league, random
   weights from seeds: (a) ``TicTacToeRules`` and ``ConnectFourRules``
   lifted by ``envs/autovec.py``, ``verify(64)`` of each on the card; the
   lifted TicTacToe against ``VectorTicTacToe`` over 2048 games on the same
   random legal actions, bit for bit; device self-play at 2048 games, hand
   twin and lift in turns (A, B, B, A) with one ``SimpleConvNet`` and seed:
   env-steps/s, their ratio (printed, not gated) and launches per game step;
   the lifted ConnectFour's; ``--train`` on ConnectFour with
   ``device_rollout_games`` and ``autovec_verify_games: 8``: the verified
   line, device episodes, a finite loss; (b) ``HostSyncSanitizer`` and
   ``RecompileSentinel`` (and CUDA's sync debug mode, counted) around 4
   ``batch()`` calls and train steps of 7a's config on ``batch_pipeline:
   device``: no sync, no build; a deliberate ``.cpu()`` named by its line;
   (c) ``--league`` on TicTacToe at tests/test_league.py's geometry (8
   epochs of 16 + 24, ``keep_checkpoints`` 2): >= 2 promotions by the gate,
   each frozen member's books covering the pool of its time, LEAGUE.json
   reloaded, the ``league_*`` keys, frozen epochs kept by GC, no
   substitution; (d) the training slice's transformer through
   ``LeagueLearner(args).run()``: 2 epochs, epoch 1 frozen as main-1, one
   more epoch resumed with main-1 in the pool: its match jobs served by the
   router's resident engine for epoch 1 (0 substituted), the frozen seats'
   masks zero, candidate-vs-main-1 games on the books, B1 8 per update,
   epoch 1 kept by a GC of ``keep_checkpoints`` 1; peak memory and seconds
   per boundary.  (a)'s CLI and (c) run in processes of their own beside
   (d).  Alone: ``python3 -c "import chip_smoke as cs;
   cs.phase_league_autovec({})"``.
17. a learner of several processes and an actor host, each process run as
   a user runs it (``main(["--train"])`` from a directory holding
   config.yaml, ``PROCESS_ID`` set), B1 launches reported by each through
   a file: (a) two ranks of the training slice's transformer on the one
   card (global B16 = 8 per rank x T512 bf16, 4 + 2 x 4 episodes, 8 actors
   each, a 1 s heartbeat): backend gloo as the placement gives it, B1
   n_layers times per update on each rank, rank 1's params CRC32 equal to
   the coordinator's saved epoch 2, only rank 0 wrote models/ and
   metrics.jsonl, updates/s and the gradient all-reduce's ms and bytes per
   step; with two cards or more the same with one rank per card under
   NCCL (else "not run (1 card)"); (b) 7a's config on two ranks with
   ``HANDYRL_FAULT_KILL_PROCESS_AT_EPOCH=1:1``: the coordinator
   drain-saves a verified checkpoint and exits 75 within heartbeat_timeout
   plus the drain deadline, a relaunch resumes that epoch on both ranks and
   ends 0 (minimum and update episodes cut to 24 and 12); (c) a learner of
   12(c)'s transformer (``device_replay``, 32
   lanes, ``actor_hosts: 1``) fed by one ``distributed.role: actor``
   process at 32 lanes: records in its rings, the param versions the host
   polls rise, the host SIGKILLed and the learner ends 0 with
   ``dist_actor_host_losses`` >= 1; the gateway's record bytes/s, the
   params blob's bytes and fetch seconds, the lag.  Alone: ``python3 -c
   "import chip_smoke as cs; cs.phase_distributed({})"``.
18. sequence-parallel training (``seq_attention: ring``), ranks of one gloo
   group sharing the card, each a process of its own: (a) the masked ring
   op at the slice's shapes (rows 32 = B16 x 2 players, T512, 16 heads,
   D96, bf16, window 32, key mask from the seed) on sp 2 and sp 4: each
   rank's output and dQ/dK/dV against B1 and its recompute backward on the
   whole window in this process (2e-2 of scale); ms per forward+backward,
   ring bytes per layer, peak memory per rank; (b) one train step of
   ``TrainContext(seq_attention='ring')`` on sp 2 against a one-process
   ``TrainContext(seq_attention='flash')``, both from seed 0's weights at
   7b's width on one seeded batch (B16 x T512 bf16): total, p, v within
   5e-2 of scale, dcnt equal, the updates (Adam's first step) within 2 lr
   and 90% of them within 0.1 lr, both ranks' params crc32 equal, B1 8
   launches in the flash step; (c) 7b's configuration through ``--train``
   on two ranks with ``mesh: {sp: 2}`` (2 epochs of 4 + 4 episodes, 8
   actors on the sp leader, none on the member): both exit 0, their params
   crc32 equal to the saved epoch 2's, only rank 0 wrote; updates/s while
   training beside 7b's, ``dist_ring_ms``/``_bytes`` and
   ``dist_allreduce_ms`` per step, peak memory per rank.  No kernel on the
   ring path; the NCCL leg needs a card per rank ("not run (1 card)").
   (c) runs beside (a) and (b).  Alone: ``python3 -c "import chip_smoke
   as cs; cs.phase_ring({})"``.
19. the split device plane, each learner run as a user runs it
   (``main(["--train"])`` in a process of its own): (a) 17(c)'s learner
   (12(c)'s transformer from the rings, 32 lanes, 2 epochs) with ``plane:
   split``, ``actor_chips: 1`` and ``param_refresh_updates: 2``, its actor
   member sharing the card on a stream of its own: exit 0, every epoch
   record says ``plane: "split"``, the actor member busy and bytes crossing
   the planes in some epoch, more than one refresh, B1 n_layers times per
   update, the rollout's launches all on the actor member's stream and B1's
   (the train step's) all on the learner member's; updates/s while
   training, the refresh's bytes and device ms, the records' bytes/s, the
   lag, peak memory; (b) the same with ``plane: fused``, in turn, its
   updates/s beside (a)'s; (c), beside (a)'s start,
   tests/test_sentinel.py:525-560's ParallelTicTacToe learner (3 epochs)
   under split with
   ``HANDYRL_FAULT_WEDGE_ROLLOUT=2`` and ``plane_max_restarts: 0``: it
   degrades to fused, ends 0, and its last record says ``plane: "fused"``
   and ``plane_watchdog_degraded: 1``.  Alone: ``python3 -c "import
   chip_smoke as cs; cs.phase_split_plane({})"``.

Every learner phase (7a, 7b, 8a, 8b, 9a, 9b, 11c, 11d, 16(a)'s CLI, 16(c), 16(d); 12(e)'s shm
runs) runs on the port's default
``batch_pipeline: shm`` and fails unless every epoch's live pipeline mode
is ``shm``, the codec accelerator and the C fill are loaded, and no
batcher died or fell back; it prints the pipeline's stage seconds and the
put's ms per batch.  The script fails if a shared-memory segment or a
process of the port outlives it.

Phases 4, 5-6, 7b, 9b, 12(c), 15(b)(i), 16(d), 17(a), 17(c), 18(b)'s
flash reference and 19(a)-(b) are the paths through the port's kernels.  Every phase after 3 starts with every launch
count at 0, and the counts are read at its end (8b, 9a, 9c, 11c, 12(d)'s
CLI, 13(b)'s server and 14's replicas, fleet and CLI learners run in
processes of their own and launch neither kernel; 17's ranks and learner,
processes of their own too, write their counts to a file each, which the
phase adds).

Phases 1-3 run alone.  After them the phases run in three streams at once
(``STREAMS``): 4, 5-6, 7b, 16, 9(a)+(c), 17(a)-(b) (side by side), 18
and 19 in this process; 7a, 8, 14(a)-(c), 15(c)-(d), 10 and 14(d) in one
child process of this script (``--stream b``); 11, 12, 13, 15(a)-(b),
17(c) and 9b in another (``--stream c``).  The kernels line's launches are
7b's, 16(d)'s, 17(a)'s ranks', 18(b)'s flash step's and 19's learners'
here plus those the streams report when they end (9b, 12(c), 15(b)(i),
17(c)'s learner).  A stream's output
is printed whole once it has ended; a stream that fails fails the run,
and a failure kills the streams still running.  Each phase's lap line
gives its seconds and the CPU seconds its stream's processes spent on
it.  The times and rates after phase 3 are taken with other phases
running beside them: compare them only within one run, and within a
leg's turns.

The last two lines are a JSON ``kernels`` record and the verdict
``{"ok": true, "device": {...}}``.  Nothing of JAX or of handyrl_tpu is
imported.  Weights are random, made from a seed.
"""

from __future__ import annotations

import gc
import json
import math
import os
import random
import re
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# the training configuration: the JAX package's long-window transformer
# point (bench.py TRANSFORMER_LONG_TPU at T512)
NET_ARGS = {"d_model": 1536, "n_heads": 16, "n_layers": 8, "memory_len": 32}
TRAIN_ARGS = {
    "batch_size": 16, "forward_steps": 512, "burn_in_steps": 0, "observation": True,
    "compute_dtype": "bfloat16", "seq_attention": "auto", "flash_min_t": 128,
}
# phase 8a: the recurrent configuration, bench.py's geister stage (the DRC
# GeisterNet at its defaults, batch_size at its default of 128, fp32)
DRC_TRAIN_ARGS = {
    "burn_in_steps": 8, "forward_steps": 16, "observation": True,
    "policy_target": "UPGO", "value_target": "UPGO",
}
TRANSFORMER_EPISODES = 4  # minimum_episodes and update_episodes of phases 7b and 9b
DRC_EPISODES = 8         # minimum_episodes and update_episodes of phase 8a
GEESE_EPISODES = 16      # the same for phase 8b
REMOTE_HEARTBEAT = 1.0   # phase 9's heartbeat interval, seconds (the default is 10)
BATTLE_GAMES = 10        # phase 9c's games
EVAL_GAMES = 10          # the --eval games of phases 7a and 8b
# config.yaml's minimum_episodes and update_episodes (400 and 200) in phases 7a and 9a
CLI_EPISODES = (100, 50)
# the card against the CPU on the RNN branch's outputs, absolute, times
# max(1, the outputs' scale): cuDNN's TF32 convolutions round their inputs
# to 10 bits of mantissa; in strict fp32 the two devices' conv algorithms
# sum in other orders, through 24 recurrent steps
DRC_TOLERANCE = {"tf32": 2e-2, "fp32": 1e-3}
HEAD_DIMS = (16, 32, 64, 96, 128)   # the kernels' instantiated head dims
TRAIN_STEPS = 4          # the first one is warm-up, left out of the rates
EPISODES = 4
SEED = 0
RATES = {}               # updates/s while training, by phase (7b's, printed beside 18(c)'s)
# The phases after 3 run in three streams at once: "main" in this process
# (it holds every phase whose launches the kernels line counts: 4, 6, 7b
# and 16), the others each in a child process of this script.  A stream
# runs its phases in order; phase 12 reads 11's records, so both are in one,
# and 9c plays 9a's checkpoint.  9, 14 and 15 are split into legs
# (``PHASES``) so that the streams take about as long as each other.
STREAMS = {
    "main": ("4", "6", "7b", "16", "9ac", "17ab", "18", "19"),
    "b": ("7a", "8", "14abc", "15cd", "10", "14d"),
    "c": ("11", "12", "13", "15ab", "17c", "9b"),
}
STREAM_ENV = "CHIP_SMOKE_STREAM"   # the stream a process (and all it starts) belongs to
T0_ENV = "CHIP_SMOKE_T0"           # the script's start (time.time()), for a stream's laps
RESULTS_ENV = "CHIP_SMOKE_RESULTS" # where a stream writes its kernels' launch counts
STREAM_DEADLINE = 1080             # seconds after the script's start by which every stream ends

# what each kernel replaces, and its source (the kernels line)
KERNELS = {
    "masked_flash_attention": ("handyrl_tpu_torch/csrc/flash_attention.cu",
                               "handyrl_tpu/ops/flash_attention.py:240"),
    "flash_attention": ("handyrl_tpu_torch/csrc/flash_attention.cu",
                        "handyrl_tpu/ops/flash_attention.py:67"),
}

# (memory bytes/s, dense bf16 FLOP/s, fp32 FLOP/s without tensor cores) by
# nvidia-smi name; NVIDIA's data sheets, dense rates
PEAKS = (
    ("H100 PCIe", 2.0e12, 756e12, 51e12),
    ("H100 NVL", 3.9e12, 835e12, 60e12),
    ("H100", 3.35e12, 989e12, 67e12),     # SXM (e.g. "NVIDIA H100 80GB HBM3")
    ("H200", 4.8e12, 989e12, 67e12),
)


class SmokeError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeError(msg)


def peaks_for(name):
    for tag, bw, bf16, fp32 in PEAKS:
        if tag in name:
            return bw, bf16, fp32
    return PEAKS[2][1:]


def tolerance(dtype):
    """Kernel vs plain version, absolute, on O(1) outputs.  fp32: the
    kernel's FMA sums run in another order than the einsum's; bf16 (8 bits
    of mantissa) and fp16 (11): inputs and output rounded to the type,
    against the fp32 plain version of the same rounded inputs."""
    import torch

    return {torch.float32: 1e-4, torch.bfloat16: 2e-2, torch.float16: 2e-3}[dtype]


def cuda_ms(fn, warmup=3, iters=20):
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def qkv(B, T, H, D, dtype, g):
    import torch

    return [torch.randn(B, T, H, D, device="cuda", generator=g).to(dtype) for _ in range(3)]


def attention_inputs(rows, T, H, D, dtype, seed, observed=0.7, device="cuda"):
    """q, k, v ~ N(0, 1); key masks ~70% observed up to a per-row episode
    end, then unobserved padding — the shape of the training windows."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    q, k, v = (torch.randn(rows, T, H, D, device=device, generator=g).to(dtype)
               for _ in range(3))
    ends = torch.randint(T // 4, T + 1, (rows, 1), device=device, generator=g)
    t = torch.arange(T, device=device)[None]
    key_mask = ((torch.rand(rows, T, device=device, generator=g) < observed) & (t < ends)).float()
    slopes = torch.tensor([2.0 ** (-8.0 * (i + 1) / H) for i in range(H)], device=device)
    return q, k, v, key_mask, slopes


def visible(key_mask, window):
    """(rows, T, T) bool: which keys each query sees, and the ages."""
    import torch

    counts = torch.cumsum(key_mask, dim=1)
    T = key_mask.shape[1]
    pos = torch.arange(T, device=key_mask.device)
    age = counts[:, :, None] - counts[:, None, :]
    valid = (key_mask[:, None, :] > 0) & (pos[:, None] >= pos[None, :]) & (age >= 0) & (age < window)
    return valid | (pos[:, None] == pos[None, :]), age


def card_line():
    """The card's name and power limit, as nvidia-smi reports them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    return smi.stdout.strip().splitlines()[0]


def phase_device(results):
    import torch

    from handyrl_tpu_torch.ops.flash_attention import FLASH, MASKED_FLASH

    print(card_line())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    sources = {kernel.source: kernel for kernel in (MASKED_FLASH, FLASH)}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:   # one nvcc per source, all at once
        list(pool.map(lambda kernel: kernel.build(), sources.values()))
    print(f"[build] {', '.join(source.name for source in sources)} in "
          f"{time.perf_counter() - t0:.1f} s")
    spills = []
    for kernel in sources.values():
        for line in kernel.build_log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"[ptxas] {kernel.source.name}: {line.strip()}")
            spills += [line.strip() for n in re.findall(r"(\d+) bytes spill", line) if int(n)]
    check(not spills, f"ptxas reports spills: {spills}")
    smem = FLASH.library().flash_smem_bytes
    for dtype, body in ((0, "fp32 FMA"), (1, "bf16/fp16 wgmma")):
        for masked, name in ((1, "masked"), (0, "plain")):
            print(f"[smem] {name} kernel, {body} body: dynamic shared memory per block, by head "
                  "dim: " + ", ".join(f"D={d}: {smem(d, masked, dtype)} B" for d in HEAD_DIMS))


def phase_kernel_check(results):
    import torch

    from handyrl_tpu_torch.ops.flash_attention import (
        flash_kernel, full_attention_reference, masked_attention_reference, masked_flash_kernel,
    )

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions in full fp32
    dtypes = (torch.float32, torch.bfloat16, torch.float16)
    worst, seed = {}, 0
    for shape in ((32, 512, 16, 96), (3, 100, 2, 16), (3, 100, 2, 24)):
        for window in (32, 1 << 30):
            for dtype in dtypes:
                seed += 1
                q, k, v, km, sl = attention_inputs(*shape, dtype, seed=seed)
                out = masked_flash_kernel(q, k, v, km, sl, window)
                ref = masked_attention_reference(q.float(), k.float(), v.float(), km, sl, window)
                torch.cuda.synchronize()
                tag = f"masked {shape} window={window} {str(dtype)[6:]}"
                worst[tag] = check_close(out, ref, dtype, tag)
    results["masked_flash_attention"]["max_abs_err"] = worst[
        f"masked {(32, 512, 16, 96)} window=32 bfloat16"]

    for shape in ((16, 1024, 16, 96), (8, 1024, 4, 64), (3, 100, 2, 24)):
        for causal in (True, False):
            for dtype in dtypes:
                seed += 1
                check_flash(shape, causal, dtype, seed, worst)
    results["flash_attention"]["max_abs_err"] = worst[f"flash {(16, 1024, 16, 96)} causal bfloat16"]

    # the tensor-core body at every instantiated head dim, at a ragged T and
    # at T1024 (window 32 there: all but the diagonal and window tiles skipped)
    for D in HEAD_DIMS:
        for T in (100, 1024):
            for dtype in (torch.bfloat16, torch.float16):
                for window in (32, 1 << 30):
                    seed += 1
                    q, k, v, km, sl = attention_inputs(2, T, 2, D, dtype, seed=seed)
                    out = masked_flash_kernel(q, k, v, km, sl, window)
                    ref = masked_attention_reference(q.float(), k.float(), v.float(), km, sl,
                                                     window)
                    torch.cuda.synchronize()
                    tag = f"masked {(2, T, 2, D)} window={window} {str(dtype)[6:]}"
                    worst[tag] = check_close(out, ref, dtype, tag)
                for causal in (True, False):
                    seed += 1
                    check_flash((2, T, 2, D), causal, dtype, seed, worst)

    # views that start 2 bytes past a 16-byte boundary reach TMA as aligned copies
    g = torch.Generator(device="cuda").manual_seed(seed + 2)
    flat = torch.randn(3 * 2 * 100 * 2 * 96 + 1, device="cuda", generator=g).to(torch.bfloat16)
    q, k, v = flat[1:].view(3, 2, 100, 2, 96).unbind(0)
    q, k, v = (x.view(2, 100, 2, 96) for x in (q, k, v))
    check(q.data_ptr() % 16 != 0 and q.is_contiguous(), "the view is meant to be misaligned")
    km = torch.ones(2, 100, device="cuda")
    sl = torch.tensor([0.5, 0.25], device="cuda")
    for tag, out, ref in (
        ("masked misaligned view bfloat16", masked_flash_kernel(q, k, v, km, sl, 32),
         masked_attention_reference(q.float(), k.float(), v.float(), km, sl, 32)),
        ("flash misaligned view bfloat16", flash_kernel(q, k, v, True),
         full_attention_reference(q.float(), k.float(), v.float(), True)),
    ):
        torch.cuda.synchronize()
        check_close(out, ref, torch.bfloat16, tag)

    # phase 4's long shape, where a query tile walks up to 128 key tiles; the
    # plain version's fp32 score slabs are 8.6 GB each, ~26 GB at its peak
    shape = (2, 8192, 16, 96)
    q, k, v = qkv(*shape, torch.bfloat16, torch.Generator(device="cuda").manual_seed(seed + 1))
    out = flash_kernel(q, k, v, True)
    ref = full_attention_reference(q.float(), k.float(), v.float(), True)
    torch.cuda.synchronize()
    check_close(out, ref, torch.bfloat16, f"flash {shape} causal bfloat16")
    del q, k, v, out, ref
    torch.cuda.empty_cache()


def check_flash(shape, causal, dtype, seed, worst):
    import torch

    from handyrl_tpu_torch.ops.flash_attention import flash_kernel, full_attention_reference

    q, k, v = qkv(*shape, dtype, torch.Generator(device="cuda").manual_seed(seed))
    out = flash_kernel(q, k, v, causal)
    ref = full_attention_reference(q.float(), k.float(), v.float(), causal)
    torch.cuda.synchronize()
    tag = f"flash {shape} {'causal' if causal else 'full'} {str(dtype)[6:]}"
    worst[tag] = check_close(out, ref, dtype, tag)


def check_close(out, ref, dtype, tag):
    check(out.shape == ref.shape and out.dtype == dtype, f"wrong shape or dtype at {tag}")
    check(torch_finite(out), f"non-finite kernel output at {tag}")
    err = (out.float() - ref).abs().max().item()
    print(f"[kernel] {tag}: max_abs_err {err:.3e} (tolerance {tolerance(dtype):g})")
    check(err <= tolerance(dtype), f"kernel disagrees with its plain version at {tag}")
    return err


def torch_finite(x):
    import torch

    return bool(torch.isfinite(x.float()).all().item())


def phase_kernel_timing(results, device_name):
    import torch
    import torch.nn.functional as F

    from handyrl_tpu_torch.ops.flash_attention import (
        flash_kernel, full_attention_reference, masked_attention_reference, masked_flash_kernel,
    )

    bw, bf16_peak, fp32_peak = peaks_for(device_name)

    rows, T, H, D = 32, 512, 16, 96
    window = NET_ARGS["memory_len"]
    q, k, v, km, sl = attention_inputs(rows, T, H, D, torch.bfloat16, seed=11)
    ms = cuda_ms(lambda: masked_flash_kernel(q, k, v, km, sl, window))
    plain_ms = cuda_ms(lambda: masked_attention_reference(q, k, v, km, sl, window))

    # the library yardstick: SDPA with the mask and ALiBi ages as one float mask
    valid, age = visible(km, window)
    bias = torch.where(valid[:, None], -sl[None, :, None, None] * age[:, None], float("-inf"))
    bias = bias.to(torch.bfloat16)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=bias))
    lib_err = (F.scaled_dot_product_attention(qt, kt, vt, attn_mask=bias).transpose(1, 2).float()
               - masked_flash_kernel(q, k, v, km, sl, window).float()).abs().max().item()

    nbytes = 4 * q.numel() * q.element_size() + km.numel() * 4 + sl.numel() * 4
    flops = 4 * D * H * int(valid.sum())   # q.k and p.v over the pairs the data lets through
    bytes_ms, ops_ms = nbytes / bw * 1e3, flops / bf16_peak * 1e3
    masked = results["masked_flash_attention"]
    masked.update(
        ms=ms, plain_ms=plain_ms, library_ms=library_ms,
        bound_ms=max(bytes_ms, ops_ms), bound_by="bytes" if bytes_ms >= ops_ms else "operations",
    )
    print(f"[timing] masked_flash_attention ({rows}, {T}, {H}, {D}) bf16 window {window}: "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms "
          f"(sdpa vs kernel max_abs_err {lib_err:.3e}); bound {masked['bound_ms']:.4f} ms by "
          f"{masked['bound_by']} ({nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP of valid pairs); "
          + achieved(flops, nbytes, ms, masked["bound_ms"]))

    # the plain flash kernel, causal: the first shape's numbers go to the
    # kernels line
    for n, (shape, dtype) in enumerate((((16, 1024, 16, 96), torch.bfloat16),
                                        ((8, 1024, 4, 64), torch.float32))):
        B, T, H, D = shape
        q, k, v = qkv(*shape, dtype, torch.Generator(device="cuda").manual_seed(31 + n))
        ms = cuda_ms(lambda: flash_kernel(q, k, v, True))
        plain_ms = cuda_ms(lambda: full_attention_reference(q, k, v, True))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True))
        lib_err = (F.scaled_dot_product_attention(qt, kt, vt, is_causal=True).transpose(1, 2).float()
                   - flash_kernel(q, k, v, True).float()).abs().max().item()
        nbytes = 4 * q.numel() * q.element_size()          # q, k, v read once, out written once
        flops = 4 * B * H * D * (T * (T + 1) // 2)         # q.k and p.v over the causal pairs
        peak = fp32_peak if dtype == torch.float32 else bf16_peak
        bytes_ms, ops_ms = nbytes / bw * 1e3, flops / peak * 1e3
        timing = dict(
            ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        )
        if n == 0:
            results["flash_attention"].update(timing)
        print(f"[timing] flash_attention {shape} {str(dtype)[6:]} causal: kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms (sdpa vs kernel max_abs_err "
              f"{lib_err:.3e}); bound {timing['bound_ms']:.4f} ms by {timing['bound_by']} "
              f"({nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP at "
              f"{peak / 1e12:.0f} TFLOP/s); " + achieved(flops, nbytes, ms, timing["bound_ms"]))


def achieved(flops, nbytes, ms, bound_ms):
    """The kernel's rates over the work its inputs need, and its share of
    the bound (bound time over kernel time)."""
    return (f"achieved {flops / ms / 1e9:.1f} TFLOP/s, {nbytes / ms / 1e9:.3f} TB/s, "
            f"{bound_ms / ms:.1%} of the bound")


def phase_parent(parent_root, device_name):
    """--parent DIR: the kernels built from another checkout's source (DIR,
    e.g. an unpacked ``git archive`` of the parent commit) beside this one's,
    in one process on one card: the fp32 outputs compared bit for bit, and
    both timed in turns (parent, this, this, parent) at phase 3's shapes."""
    import importlib

    import torch

    fa = importlib.import_module("handyrl_tpu_torch.ops.flash_attention")
    from handyrl_tpu_torch.ops.cuda_build import CudaKernel

    source = Path(parent_root).resolve() / "handyrl_tpu_torch" / "csrc" / "flash_attention.cu"
    check(source.exists(), f"no kernel source at {source}")
    ours = (fa.MASKED_FLASH, fa.FLASH)
    theirs = tuple(CudaKernel(str(source), k.symbol, k.argtypes) for k in ours)
    t0 = time.perf_counter()
    theirs[0].build()
    print(f"[parent] built {source} in {time.perf_counter() - t0:.1f} s")

    def run(kernels, fn):
        fa.MASKED_FLASH, fa.FLASH = kernels
        try:
            return fn()
        finally:
            fa.MASKED_FLASH, fa.FLASH = ours

    def g(seed):
        return torch.Generator(device="cuda").manual_seed(seed)

    mq, mk, mv, km, sl = attention_inputs(32, 512, 16, 96, torch.float32, seed=51)
    fq, fk, fv = qkv(8, 1024, 4, 64, torch.float32, g(52))
    for tag, fn in (
        ("masked (32, 512, 16, 96) fp32 window 32",
         lambda: fa.masked_flash_kernel(mq, mk, mv, km, sl, NET_ARGS["memory_len"])),
        ("flash (8, 1024, 4, 64) fp32 causal", lambda: fa.flash_kernel(fq, fk, fv, True)),
        ("flash (8, 1024, 4, 64) fp32 full", lambda: fa.flash_kernel(fq, fk, fv, False)),
    ):
        same = torch.equal(run(theirs, fn), run(ours, fn))
        print(f"[parent] {tag}: outputs {'bit for bit the same' if same else 'DIFFER'}")
        check(same, f"fp32 outputs moved against the parent at {tag}")

    mq, mk, mv = (x.to(torch.bfloat16) for x in (mq, mk, mv))
    bq, bk, bv = qkv(16, 1024, 16, 96, torch.bfloat16, g(53))
    hq, hk, hv = (x.to(torch.bfloat16) for x in (fq, fk, fv))
    for tag, fn in (
        ("masked_flash_attention (32, 512, 16, 96) bf16 window 32",
         lambda: fa.masked_flash_kernel(mq, mk, mv, km, sl, NET_ARGS["memory_len"])),
        ("flash_attention (16, 1024, 16, 96) bf16 causal", lambda: fa.flash_kernel(bq, bk, bv)),
        ("flash_attention (8, 1024, 4, 64) bf16 causal", lambda: fa.flash_kernel(hq, hk, hv)),
        ("flash_attention (8, 1024, 4, 64) fp32 causal", lambda: fa.flash_kernel(fq, fk, fv)),
    ):
        turns = [run(kernels, lambda: cuda_ms(fn)) for kernels in (theirs, ours, ours, theirs)]
        print(f"[parent] {tag} on {device_name}: parent {turns[0]:.4f} / {turns[3]:.4f} ms, "
              f"this {turns[1]:.4f} / {turns[2]:.4f} ms: "
              f"{(turns[0] + turns[3]) / (turns[1] + turns[2]):.2f}x")


def phase_flash_op(results):
    """The ops.flash_attention entry point as its users call it: forward
    through the kernel, backward through the chunked recompute."""
    import torch

    from handyrl_tpu_torch.ops import flash_attention, full_attention_reference
    from handyrl_tpu_torch.ops.flash_attention import FLASH

    def grads(fn, q, k, v):
        xs = [x.detach().requires_grad_() for x in (q, k, v)]
        (fn(*xs, True) ** 2).sum().backward()
        return [x.grad for x in xs]

    shape = (8, 1024, 4, 64)
    q, k, v = qkv(*shape, torch.float32, torch.Generator(device="cuda").manual_seed(41))
    launches = FLASH.launches
    got = grads(flash_attention, q, k, v)
    torch.cuda.synchronize()
    check(FLASH.launches == launches + 1, f"flash_attention launched the kernel "
          f"{FLASH.launches - launches} times in one forward+backward, expected 1")
    want = grads(full_attention_reference, q, k, v)
    # fp32 sums over 1,024 keys, taken in another order
    err = max((a - b).abs().max().item() for a, b in zip(got, want))
    check(all(torch_finite(g) for g in got), "non-finite gradients")
    print(f"[flash op] {shape} fp32 causal: d(out^2)/dq,dk,dv vs autograd through the plain "
          f"version: max_abs_err {err:.3e} (tolerance 1e-3)")
    check(err <= 1e-3, "flash_attention gradients disagree with the plain version's")
    launches = FLASH.launches
    ms = cuda_ms(lambda: grads(flash_attention, q, k, v), warmup=2, iters=10)
    check(FLASH.launches == launches + 12, "one launch per call of flash_attention expected")
    print(f"[flash op] {shape} fp32 causal: {ms:.3f} ms per forward+backward")
    profile_call(f"flash_attention forward+backward {shape} fp32 causal",
                 lambda: grads(flash_attention, q, k, v))

    # the regime the op exists for: the plain version's fp32 scores alone
    # would take 2 * 16 * 8192^2 * 4 B = 8.6 GB here
    shape = (2, 8192, 16, 96)
    q, k, v = qkv(*shape, torch.bfloat16, torch.Generator(device="cuda").manual_seed(42))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    last = {}

    def step():
        last["grads"] = grads(flash_attention, q, k, v)

    ms = cuda_ms(step, warmup=1, iters=3)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(all(g.shape == shape and g.dtype == torch.bfloat16 and torch_finite(g)
              for g in last["grads"]), "bad gradients at T8192")
    print(f"[flash op] {shape} bf16 causal: {ms:.2f} ms per forward+backward, "
          f"peak memory {peak_gb:.2f} GB; kernel launches in this phase {FLASH.launches}")
    results["flash_attention"]["launches"] = FLASH.launches


def phase_acting(results):
    import torch

    from handyrl_tpu_torch.envs import make_env
    from handyrl_tpu_torch.models import InferenceModel, init_variables
    from handyrl_tpu_torch.runtime import Generator

    env_args = {"env": "Geister", "net": "transformer", "net_args": NET_ARGS}
    env = make_env(env_args)
    module = init_variables(env.net(), SEED)
    model = InferenceModel(module)                 # on the card
    gen = Generator(env, {"observation": True, "gamma": 0.8, "compress_steps": 4})
    random.seed(SEED)
    episodes, t0 = [], time.perf_counter()
    while len(episodes) < EPISODES:
        ep = gen.generate({0: model, 1: model}, {"player": [0, 1]})
        if ep is not None:
            episodes.append(ep)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    moves = sum(ep["steps"] for ep in episodes)
    check(all(ep["outcome"][0] in (-1, 0, 1) for ep in episodes), "bad episode outcome")
    print(f"[acting] {len(episodes)} Geister episodes, {moves} moves in {elapsed:.2f} s: "
          f"{moves / elapsed:.1f} moves/s (d{NET_ARGS['d_model']} L{NET_ARGS['n_layers']} step mode)")
    return env_args, module, episodes


def phase_training(results, env_args, module, episodes):
    import torch

    from handyrl_tpu_torch.config import normalize_args
    from handyrl_tpu_torch.ops.flash_attention import MASKED_FLASH
    from handyrl_tpu_torch.parallel.train_step import forward_prediction
    from handyrl_tpu_torch.runtime import Trainer

    cfg = normalize_args({"env_args": env_args, "train_args": TRAIN_ARGS})
    args = dict(cfg["train_args"], env=env_args)
    trainer = Trainer(args, module)
    trainer.store.extend(episodes)
    before = [p.detach().clone() for p in module.parameters()]
    torch.cuda.reset_peak_memory_stats()

    history, times = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        history += trainer.train_epoch(1)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = MASKED_FLASH.launches

    per_step = launches_per_step(args)
    check(launches == per_step * TRAIN_STEPS,
          f"kernel launched {launches} times in {TRAIN_STEPS} steps, expected {per_step * TRAIN_STEPS}")
    check(all(torch.isfinite(torch.tensor(m["total"])) and m["sentinel_bad"] == 0 for m in history),
          f"non-finite or skipped step: {history}")
    changed = max((a - b).abs().max().item() for a, b in zip(before, module.parameters()))
    check(changed > 0, "params did not change")
    steady = sum(times[1:]) / (len(times) - 1)
    B, T = TRAIN_ARGS["batch_size"], TRAIN_ARGS["forward_steps"]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"[training] {TRAIN_STEPS} steps B{B} T{T} bf16, losses "
          f"{[round(m['total'], 3) for m in history]}; first step {times[0]:.3f} s, then "
          f"{1 / steady:.3f} updates/s, {B * 2 * T / steady:.0f} tokens/s; "
          f"peak memory {peak_gb:.2f} GB; kernel launches {launches} ({per_step} per step)")
    profile_call("one train step", lambda: trainer.train_epoch(1))

    # the path's output against its reference: the same batch through the
    # einsum attention (no kernel)
    flash_vs_einsum("training", module, trainer.ctx.put_batch(trainer.sample_batch()), args)


def flash_vs_einsum(tag, module, batch, args):
    """One batch through the masked flash kernel and through the einsum
    attention (no kernel), forward and loss in bf16.  bf16 activations
    through 8 layers: the two attentions round at other places (the kernel
    keeps probabilities in fp32, the einsum casts them to bf16), so they
    are held to 5% of the outputs' scale."""
    import torch

    from handyrl_tpu_torch.ops import compute_loss_from_outputs
    from handyrl_tpu_torch.parallel.train_step import forward_prediction, trim_burn_in

    with torch.no_grad():
        params = {n: p.to(torch.bfloat16) for n, p in module.named_parameters()}
        outs = [forward_prediction(module, params, batch, dict(args, seq_attention=mode))
                for mode in ("flash", "einsum")]
        trimmed = trim_burn_in(batch, args["burn_in_steps"])
        losses = [compute_loss_from_outputs(o, trimmed, args)[0]["total"].item() for o in outs]
    acting = batch["turn_mask"][:, args["burn_in_steps"]:][..., 0] > 0
    for key in ("value", "return", "policy"):
        a, b = outs[0][key], outs[1][key]
        if key == "policy":  # legal logits of acting steps (illegal ones are -1e32 on both)
            a, b = a[acting], b[acting]
            legal = b > -1e30
            a, b = a[legal], b[legal]
        err, scale = (a - b).abs().max().item(), max(1.0, b.abs().max().item())
        print(f"[{tag}] kernel vs einsum path, one batch in bf16: {key} max_abs_err {err:.3e} "
              f"(tolerance {5e-2 * scale:.3e})")
        check(err <= 5e-2 * scale, f"{tag}: the forward disagrees with the einsum path on {key}")
    err, scale = abs(losses[0] - losses[1]), max(1.0, abs(losses[1]))
    print(f"[{tag}] kernel vs einsum path: loss {losses[0]:.5f} against {losses[1]:.5f} "
          f"(tolerance {5e-2 * scale:.3e})")
    check(math.isfinite(losses[0]) and err <= 5e-2 * scale,
          f"{tag}: the loss disagrees with the einsum path")


def launches_per_step(args):
    """Masked kernel launches in one train step: one per layer, two under a
    remat rung (the checkpoint replays the attention forward)."""
    from handyrl_tpu_torch.parallel import resolve_seq_remat

    rung = resolve_seq_remat(args)
    return NET_ARGS["n_layers"] * (1 if rung == "none" else 2)


def cli_env():
    """This environment with the repo on PYTHONPATH, for the CLI's processes."""
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(ROOT), os.environ.get("PYTHONPATH")) if p))


def run_cli(cwd, *argv, timeout=600, env=None, code=0):
    """``python -m handyrl_tpu_torch.main ARGV`` in ``cwd``, as a user runs
    it, with ``env`` added to this environment; fails the phase on another
    exit than ``code``, printing the output's tail."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "handyrl_tpu_torch.main", *argv], cwd=cwd,
                          env=dict(cli_env(), **(env or {})), capture_output=True, text=True,
                          timeout=timeout)
    elapsed = time.perf_counter() - t0
    if proc.returncode != code:
        print(proc.stdout[-3000:] + proc.stderr[-3000:])
    check(proc.returncode == code, f"main {' '.join(argv)} exited {proc.returncode}, not {code}")
    return proc.stdout + proc.stderr if code else proc.stdout, elapsed


def start_cli(cwd, *argv):
    """``python -m handyrl_tpu_torch.main ARGV`` started in ``cwd`` and left
    running beside this process's work, its output in files there;
    ``finish_cli`` waits for it as ``run_cli`` does."""
    with open(os.path.join(cwd, "cli.out"), "w") as out, \
            open(os.path.join(cwd, "cli.err"), "w") as err:
        proc = subprocess.Popen([sys.executable, "-m", "handyrl_tpu_torch.main", *argv],
                                cwd=cwd, env=cli_env(), stdout=out, stderr=err)
    return {"proc": proc, "cwd": cwd, "argv": argv, "t0": time.perf_counter()}


def finish_cli(job, timeout=600):
    """(stdout, seconds) of a ``start_cli`` child once it exits 0; fails the
    phase on another exit, or kills it at ``timeout``."""
    proc = job["proc"]
    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    elapsed = time.perf_counter() - job["t0"]
    out, err = (Path(job["cwd"], name).read_text() for name in ("cli.out", "cli.err"))
    if proc.returncode != 0:
        print(out[-3000:] + err[-3000:])
    check(proc.returncode == 0,
          f"main {' '.join(job['argv'])} exited {proc.returncode}, not 0")
    return out, elapsed


def check_snapshots(model_dir, epochs):
    """Every epoch's snapshot, latest.ckpt and state.ckpt verify against the
    manifest's digests."""
    from handyrl_tpu_torch.runtime import checkpoint as ckpt

    entries = ckpt.load_manifest(model_dir, strict=True)["epochs"]
    for epoch in epochs:
        check(ckpt.verify_snapshot(model_dir, epoch) is True, f"snapshot {epoch} does not verify")
    last = entries[str(epochs[-1])]["files"]
    check(ckpt.file_digest(os.path.join(model_dir, "latest.ckpt"))
          == (last["latest.ckpt"]["crc32"], last["latest.ckpt"]["size"]),
          "latest.ckpt does not verify")
    check(ckpt.verify_state(model_dir, epochs[-1]) is True, "state.ckpt does not verify")


def read_records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def print_epochs(tag, records, opponent="random"):
    for r in records:
        win = (r.get("win_rate") or {}).get("total")
        print(f"[{tag}] epoch {r['epoch']}: steps {r['steps']}, episodes {r['episodes']}, "
              f"{r['episodes_per_sec']:.2f} episodes/s, {r['updates_per_sec']:.2f} updates/s, "
              f"win rate vs {opponent} {'n/a' if win is None else f'{win:.3f}'}; boundary: trainer "
              f"snapshot {r['boundary_snapshot_s']:.2f} s, save {r['boundary_save_s']:.2f} s, "
              f"publish {r['boundary_publish_s']:.2f} s")
        if "pipe_sample_s" in r:  # the batch pipeline's stage seconds over the epoch
            put_ms = r["pipe_put_s"] / max(r["pipe_batches"], 1) * 1e3
            print(f"[{tag}] epoch {r['epoch']} pipeline {r['pipeline']}: {r['pipe_batches']:.0f} "
                  f"batches, sample {r['pipe_sample_s']:.3f} s, assemble {r['pipe_assemble_s']:.3f} "
                  f"s, put {r['pipe_put_s']:.3f} s ({put_ms:.2f} ms per batch), batchers waiting "
                  f"for a free slot {r['pipe_free_wait_s']:.3f} s, put thread waiting for a batch "
                  f"{r['pipe_ready_wait_s']:.3f} s, device queue depth "
                  f"{r.get('pipe_device_queue_depth', 0):.2f}; batcher deaths "
                  f"{r['pipe_batcher_deaths']:.0f}, restarts {r['pipe_batcher_restarts']:.0f}, "
                  f"fallback {r['pipe_batcher_fallback']:.0f}; trainer: "
                  f"{r['train_steps_per_sec']:.2f} steps/s while training, input wait "
                  f"{r['input_wait_frac']:.1%}")


ACCEL_LINE = re.compile(r"batch pipeline: (\w+) configured \(num_batchers=(\d+)\); "
                        r"codec accelerator (on|off), C fill (on|off)")


def check_shm(tag, records, learner_out=None):
    """A learner phase that injects nothing ran on the shm plane: every
    epoch's live mode is 'shm', no batcher died or fell back, and the codec
    accelerator and the C fill were loaded in the learner's process (this
    one, or the CLI's, read from its output ``learner_out``)."""
    if learner_out is None:
        from handyrl_tpu_torch.runtime import batch, codec

        accel = ("on" if codec.get_accel() is not None else "off",
                 "on" if batch._fill_accel() is not None else "off")
    else:
        found = ACCEL_LINE.findall(learner_out)
        check(len(found) == 1, f"[{tag}] the learner printed {len(found)} pipeline lines")
        configured, _, *accel = found[0]
        check(configured == "shm", f"[{tag}] the learner's configured pipeline is {configured}")
    check(tuple(accel) == ("on", "on"),
          f"[{tag}] codec accelerator {accel[0]}, C fill {accel[1]}: both must be on")
    for r in records:
        check(r.get("pipeline") == "shm",
              f"[{tag}] epoch {r['epoch']}: live pipeline {r.get('pipeline')!r}, not 'shm'")
        for key in ("pipe_batcher_deaths", "pipe_batcher_fallback"):
            check(r.get(key, 0) == 0, f"[{tag}] epoch {r['epoch']}: {key} {r.get(key)}")
    check(any("pipe_batches" in r for r in records), f"[{tag}] no epoch trained")
    print(f"[{tag}] batch pipeline shm in every epoch, codec accelerator and C fill on, "
          "no batcher death or fallback")


def phase_learner_cli(results):
    """7a: the default config.yaml (TicTacToe, SimpleConvNet), epochs cut to
    2, through ``python -m handyrl_tpu_torch.main --train`` and then
    ``--eval models/latest.ckpt EVAL_GAMES 4``, on the card."""
    with tempfile.TemporaryDirectory() as tmp:
        text = (ROOT / "config.yaml").read_text()
        for key, value in (("epochs", 2), ("minimum_episodes", CLI_EPISODES[0]),
                           ("update_episodes", CLI_EPISODES[1])):
            text, n = re.subn(rf"(?m)^(\s+{key}:\s*)-?\d+", rf"\g<1>{value}", text)
            check(n == 1, f"config.yaml has no single train_args.{key} line")
        Path(tmp, "config.yaml").write_text(text)
        train_out, train_s = run_cli(tmp, "--train")
        check_snapshots(os.path.join(tmp, "models"), [1, 2])
        records = read_records(os.path.join(tmp, "metrics.jsonl"))
        check(len(records) == 2 and records[-1]["steps"] > 0,
              f"metrics.jsonl: {len(records)} records, expected 2 with steps > 0 on the last")
        print_epochs("cli", records)
        check_shm("cli", records, train_out)
        out, eval_s = run_cli(tmp, "--eval", "models/latest.ckpt", str(EVAL_GAMES), "4")
        total = [line for line in out.splitlines() if line.startswith("total =")]
        check(len(total) == 1, "--eval printed no 'total =' line")
        print(f"[cli] --train 2 epochs in {train_s:.1f} s; --eval models/latest.ckpt "
              f"{EVAL_GAMES} 4 in {eval_s:.1f} s: {total[0]} (win points vs random); final epoch's win rate "
              f"{(records[-1].get('win_rate') or {}).get('total')}")


def phase_learner(results):
    """7b: the slice's transformer at full width trained through
    ``Learner(args).run()``: actors through the batched engine, the
    threaded pipeline, checkpoints.  Launch counts start from 0."""
    import torch

    from handyrl_tpu_torch.config import normalize_args
    from handyrl_tpu_torch.ops.flash_attention import MASKED_FLASH
    from handyrl_tpu_torch.runtime import checkpoint as ckpt
    from handyrl_tpu_torch.runtime.learner import Learner

    with tempfile.TemporaryDirectory() as tmp:
        cfg = normalize_args({
            "env_args": {"env": "Geister", "net": "transformer", "net_args": NET_ARGS},
            "train_args": dict(TRAIN_ARGS, minimum_episodes=TRANSFORMER_EPISODES,
                               update_episodes=TRANSFORMER_EPISODES, epochs=2,
                               worker={"num_parallel": 8}, seed=SEED,
                               model_dir=os.path.join(tmp, "models"),
                               metrics_path=os.path.join(tmp, "metrics.jsonl")),
        })
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        learner = Learner(cfg)
        MASKED_FLASH.launches = 0
        t0 = time.perf_counter()
        learner.run()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches, steps = MASKED_FLASH.launches, learner.trainer.steps
        peak_gb = torch.cuda.max_memory_allocated() / 1e9

        per_step = launches_per_step(learner.args)
        check(launches > 0 and launches == per_step * steps,
              f"masked kernel launched {launches} times in {steps} learner steps, "
              f"expected {per_step} per step")
        check(learner.trainer.sentinel_skipped_steps == 0, "the sentinel skipped a step")
        records = read_records(cfg["train_args"]["metrics_path"])
        check(len(records) == 2, f"{len(records)} epoch records, expected 2")
        check(all(torch.isfinite(torch.tensor(r["loss"]["total"])) for r in records if "loss" in r),
              "non-finite epoch loss")
        model_dir = cfg["train_args"]["model_dir"]
        check_snapshots(model_dir, [1, 2])
        saved = ckpt.load_params(os.path.join(model_dir, "2.ckpt"))
        fresh = learner.env.net()
        fresh.load_state_dict(saved)
        served = learner.model_server.engine.model.module.state_dict()
        check(all(torch.equal(fresh.state_dict()[k], v) and torch.equal(served[k].cpu(), v)
                  for k, v in saved.items()),
              "models/2.ckpt does not load bit for bit, or is not what the actors were served")
        engine = learner.model_server.engine
        print_epochs("learner", records)
        RATES["7b"] = [r for r in records if "loss" in r][-1]["train_steps_per_sec"]
        check_shm("learner", records)
        # epoch 0's games are the random model's (model id 0): the engine
        # serves epoch 1's, two requests per Geister move (both players
        # observe under observation: true), while the actors are not held
        # by the boundary that closes the epoch
        r0, r1 = records
        play_s = (r1["t_mono"] - r0["t_mono"]) - (
            r1["boundary_snapshot_s"] + r1["boundary_save_s"] + r1["boundary_publish_s"])
        moves = (r1["engine_requests"] - r0["engine_requests"]) / 2
        print(f"[learner] Geister d{NET_ARGS['d_model']} L{NET_ARGS['n_layers']} B"
              f"{TRAIN_ARGS['batch_size']} T{TRAIN_ARGS['forward_steps']} bf16: {steps} steps, "
              f"{learner.num_returned_episodes} episodes in {run_s:.1f} s; engine: "
              f"{engine.requests_served} requests in {engine.batches_served} batches "
              f"({engine.requests_served / max(engine.batches_served, 1):.1f} per batch); epoch 1: "
              f"{moves:.0f} moves in {play_s:.1f} s of play, {moves / play_s:.1f} moves/s beside "
              f"the trainer; peak memory {peak_gb:.2f} GB; masked kernel launches {launches} "
              f"({per_step} per step)")
        checkpoint_line(learner, tmp)
        results["masked_flash_attention"]["launches"] = launches
        remat_line(learner)


def checkpoint_line(learner, tmp):
    """What one epoch's state.ckpt costs at full width: serialising the
    trainer's host snapshot, the atomic write with fsync, the CRC32."""
    import zlib

    from handyrl_tpu_torch.runtime import checkpoint as ckpt

    t0 = time.perf_counter()
    blob = ckpt.to_bytes(learner.trainer.save_payload(0))
    t1 = time.perf_counter()
    ckpt.atomic_write_bytes(os.path.join(tmp, "probe.ckpt"), blob)
    t2 = time.perf_counter()
    zlib.crc32(blob)
    t3 = time.perf_counter()
    print(f"[checkpoint] state.ckpt {len(blob) / 1e9:.2f} GB: serialise {t1 - t0:.2f} s, write + "
          f"fsync {t2 - t1:.2f} s ({len(blob) / 1e9 / (t2 - t1):.2f} GB/s), CRC32 {t3 - t2:.2f} s")


def remat_line(learner):
    """One train step at the slice shape under remat 'none' and 'block':
    ms (host clock around synchronised steps) and peak memory.  Under
    'block' the kernel runs twice per layer (the checkpoint replays it)."""
    import torch

    from handyrl_tpu_torch.ops.flash_attention import MASKED_FLASH

    trainer = learner.trainer
    batch = trainer.ctx.put_batch(trainer.sample_batch())
    base = trainer.ctx.args
    try:
        for rung in ("none", "block"):
            trainer.ctx.args = dict(base, remat=rung)
            trainer.ctx.train_step(batch, trainer.lr)   # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            launches, times = MASKED_FLASH.launches, []
            for _ in range(3):
                t0 = time.perf_counter()
                trainer.ctx.train_step(batch, trainer.lr)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            per_step = launches_per_step(trainer.ctx.args)
            check(MASKED_FLASH.launches - launches == 3 * per_step,
                  f"remat {rung}: {MASKED_FLASH.launches - launches} launches in 3 steps")
            print(f"[remat] {rung}: one train step B{TRAIN_ARGS['batch_size']} "
                  f"T{TRAIN_ARGS['forward_steps']} d{NET_ARGS['d_model']} L{NET_ARGS['n_layers']} "
                  f"bf16 {sorted(times)[1]:.1f} ms (median of 3), peak memory "
                  f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB, {per_step} kernel "
                  "launches per step")
    finally:
        trainer.ctx.args = base


def phase_drc_learner(results):
    """8a: Geister with the DRC GeisterNet at the recurrent configuration,
    through ``Learner(args).run()``: actors carry the DRC's hidden state
    through the batched engine, the trainer steps the RNN branch."""
    import torch

    from handyrl_tpu_torch.config import normalize_args
    from handyrl_tpu_torch.models import GeisterNet
    from handyrl_tpu_torch.runtime import checkpoint as ckpt
    from handyrl_tpu_torch.runtime.learner import Learner

    with tempfile.TemporaryDirectory() as tmp:
        cfg = normalize_args({
            "env_args": {"env": "Geister"},
            "train_args": dict(DRC_TRAIN_ARGS, minimum_episodes=DRC_EPISODES,
                               update_episodes=DRC_EPISODES, epochs=2,
                               worker={"num_parallel": 8}, seed=SEED,
                               model_dir=os.path.join(tmp, "models"),
                               metrics_path=os.path.join(tmp, "metrics.jsonl")),
        })
        gc.collect()  # earlier phases' learners hold card memory until their cycles go
        torch.cuda.synchronize()
        held_gb = torch.cuda.memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()
        learner = Learner(cfg)
        check(type(learner.module) is GeisterNet, "Geister's default net is not the DRC GeisterNet")
        t0 = time.perf_counter()
        learner.run()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        steps = learner.trainer.steps
        peak_gb = torch.cuda.max_memory_allocated() / 1e9

        check(steps > 0, "the DRC learner took no step")
        check(learner.trainer.sentinel_skipped_steps == 0, "the sentinel skipped a DRC step")
        records = read_records(cfg["train_args"]["metrics_path"])
        check(len(records) == 2, f"{len(records)} epoch records, expected 2")
        losses = [r["loss"]["total"] for r in records if "loss" in r]
        check(losses and all(torch.isfinite(torch.tensor(x)) for x in losses),
              f"no loss or a non-finite epoch loss: {losses}")
        model_dir = cfg["train_args"]["model_dir"]
        check_snapshots(model_dir, [1, 2])
        saved = ckpt.load_params(os.path.join(model_dir, "2.ckpt"))
        fresh = GeisterNet()
        fresh.load_state_dict(saved)
        served = learner.model_server.engine.model.module.state_dict()
        check(all(torch.equal(fresh.state_dict()[k], v) and torch.equal(served[k].cpu(), v)
                  for k, v in saved.items()),
              "models/2.ckpt does not load bit for bit, or is not what the actors were served")
        engine = learner.model_server.engine
        print_epochs("drc", records)
        check_shm("drc", records)
        B = cfg["train_args"]["batch_size"]
        T = DRC_TRAIN_ARGS["burn_in_steps"] + DRC_TRAIN_ARGS["forward_steps"]
        print(f"[drc] Geister GeisterNet (filters 32, DRC 3x3) B{B} T{T} (burn-in "
              f"{DRC_TRAIN_ARGS['burn_in_steps']}) P2 fp32 UPGO: {steps} steps, "
              f"{learner.num_returned_episodes} episodes in {run_s:.1f} s; engine: "
              f"{engine.requests_served} requests in {engine.batches_served} batches "
              f"({engine.requests_served / max(engine.batches_served, 1):.1f} per batch); "
              f"peak memory {peak_gb:.2f} GB ({held_gb:.2f} GB of it held before the phase); "
              f"loss {losses}")
        drc_step_lines(learner)
        drc_device_check(learner)


def drc_step_lines(learner):
    """One train step at the recurrent configuration with remat off and on
    (a checkpoint per post-burn-in step): ms (host clock around
    synchronised steps, median of 3) and peak memory; then one step under
    the profiler at remat 'auto' (on, on the card)."""
    import torch

    from handyrl_tpu_torch.parallel import resolve_rnn_remat

    ctx = learner.trainer.ctx
    batch = ctx.put_batch(learner.trainer.sample_batch())
    lr = learner.trainer.lr
    base = ctx.args
    try:
        for remat in (False, True):
            ctx.args = dict(base, remat=remat)
            ctx.train_step(batch, lr)   # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                metrics = ctx.train_step(batch, lr)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            check(metrics["sentinel_bad"] == 0, f"remat {remat}: a non-finite step")
            print(f"[drc remat] {'on' if remat else 'off'}: one train step B{base['batch_size']} "
                  f"T{base['burn_in_steps'] + base['forward_steps']} fp32 {sorted(times)[1]:.1f} ms "
                  f"(median of 3: {', '.join(f'{t:.1f}' for t in times)}), peak memory "
                  f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    finally:
        ctx.args = base
    check(resolve_rnn_remat(base, ctx.device), "remat 'auto' should be on for the card")
    profile_call("one DRC train step (remat auto = on)", lambda: ctx.train_step(batch, lr))


def drc_device_check(learner):
    """The RNN branch of forward_prediction on the card against the same
    function on the CPU, the same weights and batch: in the port's mode
    (cuDNN convolutions in TF32, PyTorch's default) and in strict fp32."""
    import copy

    import numpy as np
    import torch

    from handyrl_tpu_torch.parallel.train_step import forward_prediction
    from handyrl_tpu_torch.utils import tree_map

    ctx = learner.trainer.ctx
    host = learner.trainer.sample_batch()
    cpu_module = copy.deepcopy(ctx.module).cpu()
    with torch.no_grad():
        t0 = time.perf_counter()
        want = forward_prediction(cpu_module, None,
                                  tree_map(lambda x: torch.from_numpy(np.ascontiguousarray(x)), host),
                                  ctx.args)
        cpu_s = time.perf_counter() - t0
    burn_in = ctx.args["burn_in_steps"]
    acting = torch.from_numpy(host["turn_mask"][:, burn_in:, :, 0] > 0)
    tf32 = torch.backends.cudnn.allow_tf32
    try:
        for mode, allow in (("tf32", True), ("fp32", False)):
            torch.backends.cudnn.allow_tf32 = allow
            with torch.no_grad():
                got = forward_prediction(ctx.module, None, ctx.put_batch(host), ctx.args)
            for key in ("policy", "value", "return"):
                a, b = got[key].cpu(), want[key]
                check(a.shape == b.shape and torch_finite(a), f"bad {key} from the card")
                if key == "policy":  # legal logits of acting steps
                    a, b = a[acting], b[acting]
                    legal = b > -1e30
                    a, b = a[legal], b[legal]
                err, scale = (a - b).abs().max().item(), max(1.0, b.abs().max().item())
                tol = DRC_TOLERANCE[mode] * scale
                print(f"[drc check] RNN forward_prediction, card ({mode} convs) vs CPU, one batch "
                      f"B{host['action'].shape[0]}: {key} max_abs_err {err:.3e} (tolerance {tol:.3e})")
                check(err <= tol, f"the card's RNN forward disagrees with the CPU's on {key} ({mode})")
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    print(f"[drc check] the CPU's forward took {cpu_s:.1f} s")


def phase_geese_cli(results):
    """8b: HungryGeese (GeeseNet, 4 players moving at once) through
    ``python -m handyrl_tpu_torch.main --train`` with the rule-based geese
    as the evaluation opponent, then ``--eval models/latest.ckpt:rulebase
    EVAL_GAMES 4``, on the card."""
    import yaml

    config = {
        "env_args": {"env": "HungryGeese"},
        "train_args": {"turn_based_training": False, "observation": False, "epochs": 2,
                       "minimum_episodes": GEESE_EPISODES, "update_episodes": GEESE_EPISODES,
                       "eval": {"opponent": ["rulebase"]}, "seed": SEED},
    }
    with tempfile.TemporaryDirectory() as tmp:
        Path(tmp, "config.yaml").write_text(yaml.safe_dump(config))
        train_out, train_s = run_cli(tmp, "--train")
        check_snapshots(os.path.join(tmp, "models"), [1, 2])
        records = read_records(os.path.join(tmp, "metrics.jsonl"))
        check(len(records) == 2 and records[-1]["steps"] > 0,
              f"metrics.jsonl: {len(records)} records, expected 2 with steps > 0 on the last")
        check(all(math.isfinite(r["loss"]["total"]) for r in records if "loss" in r),
              "non-finite epoch loss")
        print_epochs("geese", records, "rulebase")
        check_shm("geese", records, train_out)
        out, eval_s = run_cli(tmp, "--eval", "models/latest.ckpt:rulebase", str(EVAL_GAMES), "4")
        total = [line for line in out.splitlines() if line.startswith("total =")]
        check(len(total) == 1, "--eval printed no 'total =' line")
        print(f"[geese] --train 2 epochs ({GEESE_EPISODES} + 2 x {GEESE_EPISODES} episodes, B128 "
              f"T16, 6 actors) in {train_s:.1f} s; --eval models/latest.ckpt:rulebase "
              f"{EVAL_GAMES} 4 in {eval_s:.1f} s: {total[0]} (win points of seat 0 vs 3 rule-based geese)")


def free_port():
    """A TCP port that is free now (bound to port 0, then released)."""
    import socket

    with socket.socket() as sock:
        sock.bind(("", 0))
        return sock.getsockname()[1]


class Children:
    """``python -m handyrl_tpu_torch.main`` processes run side by side in
    ``cwd``, each one's output in a log file there; every one is reaped when
    the block ends, killed first if it still runs."""

    def __init__(self, cwd):
        self.cwd, self.procs = cwd, {}

    def __enter__(self):
        return self

    def start(self, tag, *argv, cwd=None, env=None):
        """``main ARGV`` in ``cwd`` (the block's by default), with ``env``
        added to this environment."""
        cwd = cwd or self.cwd
        log = open(os.path.join(self.cwd, f"{tag}.log"), "w")
        proc = subprocess.Popen([sys.executable, "-m", "handyrl_tpu_torch.main", *argv],
                                cwd=cwd, env=dict(cli_env(), **(env or {})), stdout=log,
                                stderr=subprocess.STDOUT, text=True)
        self.procs[tag] = (proc, log)
        return proc

    def output(self, tag):
        self.procs[tag][1].flush()
        return Path(self.cwd, f"{tag}.log").read_text()

    def running(self, tag):
        return self.procs[tag][0].poll() is None

    def wait_all(self, timeout, alive=lambda: False):
        """Wait for every process to exit 0 within ``timeout`` seconds; a
        nonzero exit fails at once, printing its log's tail.  ``alive`` says
        whether work in this process is still going on."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            codes = {tag: proc.poll() for tag, (proc, _) in self.procs.items()}
            for tag, code in codes.items():
                if code not in (None, 0):
                    print(self.output(tag)[-3000:])
                    check(False, f"main {' '.join(self.procs[tag][0].args[3:])} exited {code}")
            if all(code == 0 for code in codes.values()) and not alive():
                return {tag: self.output(tag) for tag in self.procs}
            time.sleep(0.2)
        for tag in self.procs:
            print(f"--- {tag} ---\n" + self.output(tag)[-2000:])
        check(False, f"processes still running after {timeout} s: "
              + ", ".join(tag for tag in self.procs if self.running(tag)))

    def __exit__(self, *exc):
        for proc, log in self.procs.values():
            if proc.poll() is None:
                proc.kill()
            proc.wait()
            log.close()


REMOTE_LINE = re.compile(r"\[remote\] model (\d+): (\d+) bytes in ([\d.]+) s, crc32 ([0-9a-f]+)")
SESSION_LINE = re.compile(r"\[remote\] session (\d+): (\d+) inference requests in (\d+) "
                          r"batches over ([\d.]+) s of play")


def remote_books(tag, records, worker_out):
    """The remote plane's books: the epochs' jobs_lost and heartbeat drops,
    every params fetch the worker made, its sessions' inference."""
    last = records[-1]
    print(f"[{tag}] remote plane: jobs_lost {last['jobs_lost']}, heartbeat drops "
          f"{last['heartbeat_drops']}, blobs serialised by the server (id, bytes, s) "
          f"{last['blobs_served']}")
    fetches = [(int(i), int(n), float(s), c) for i, n, s, c in REMOTE_LINE.findall(worker_out)]
    for model_id, nbytes, seconds, crc in fetches:
        print(f"[{tag}] worker fetched model {model_id}: {nbytes / 1e9:.4f} GB in {seconds:.3f} s "
              f"({nbytes / 1e9 / max(seconds, 1e-9):.2f} GB/s), crc32 {crc}")
    sessions = [(int(a), int(b), int(c), float(d)) for a, b, c, d in SESSION_LINE.findall(worker_out)]
    check(fetches and sessions, "the worker printed no fetch or no session line")
    return fetches, sessions


def phase_remote_cli(tmp):
    """9a: the default config.yaml with epochs cut to 3 (CLI_EPISODES) through ``python -m
    handyrl_tpu_torch.main --train-server`` and ``--worker`` (8 actors on
    the card) over loopback, a short heartbeat."""
    import yaml

    cfg = yaml.safe_load((ROOT / "config.yaml").read_text())
    entry_port = free_port()
    cfg["train_args"].update(epochs=3, minimum_episodes=CLI_EPISODES[0],
                             update_episodes=CLI_EPISODES[1])
    cfg["train_args"]["worker"].update(entry_port=entry_port, data_port=0,
                                       heartbeat_interval=REMOTE_HEARTBEAT)
    cfg["worker_args"].update(server_address="127.0.0.1", entry_port=entry_port)
    Path(tmp, "config.yaml").write_text(yaml.safe_dump(cfg))
    t0 = time.perf_counter()
    with Children(tmp) as kids:
        kids.start("train_server", "--train-server")
        kids.start("worker", "--worker")
        outs = kids.wait_all(600)
    run_s = time.perf_counter() - t0
    check_snapshots(os.path.join(tmp, "models"), [1, 2, 3])
    records = read_records(os.path.join(tmp, "metrics.jsonl"))
    check(len(records) == 3 and records[-1]["steps"] > 0,
          f"metrics.jsonl: {len(records)} records, expected 3 with steps > 0 on the last")
    print_epochs("remote cli", records)
    check_shm("remote cli", records, outs["train_server"])
    _, sessions = remote_books("remote cli", records, outs["worker"])
    requests = sum(s[1] for s in sessions)
    print(f"[remote cli] --train-server + --worker (config.yaml, 3 epochs, {cfg['worker_args']['num_parallel']} "
          f"remote actors, heartbeat {REMOTE_HEARTBEAT} s) in {run_s:.1f} s; worker: {len(sessions)} "
          f"session(s), {requests} inference requests in {sum(s[2] for s in sessions)} batches")


def phase_remote_learner(results):
    """9b: the slice's transformer at full width through ``Learner(args,
    remote=True)`` in this process, fed by one ``--worker 8`` process on the
    same card: the masked kernel's launches per learner step, the params
    the worker served against the learner's snapshots by CRC32."""
    import zlib

    import torch
    import yaml

    from handyrl_tpu_torch.config import normalize_args
    from handyrl_tpu_torch.ops.flash_attention import FLASH, MASKED_FLASH
    from handyrl_tpu_torch.runtime import checkpoint as ckpt
    from handyrl_tpu_torch.runtime.learner import Learner

    with tempfile.TemporaryDirectory() as tmp:
        cfg = normalize_args({
            "env_args": {"env": "Geister", "net": "transformer", "net_args": NET_ARGS},
            "train_args": dict(TRAIN_ARGS, minimum_episodes=TRANSFORMER_EPISODES,
                               update_episodes=TRANSFORMER_EPISODES, epochs=2,
                               worker={"num_parallel": 8, "entry_port": 0, "data_port": 0,
                                       "heartbeat_interval": REMOTE_HEARTBEAT},
                               seed=SEED, model_dir=os.path.join(tmp, "models"),
                               metrics_path=os.path.join(tmp, "metrics.jsonl")),
        })
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        learner = Learner(cfg, remote=True)
        Path(tmp, "config.yaml").write_text(yaml.safe_dump({
            "env_args": cfg["env_args"],
            "worker_args": {"server_address": "127.0.0.1", "entry_port": learner.worker.entry_port},
        }))
        with Children(tmp) as kids:
            kids.start("worker", "--worker", "8")
            MASKED_FLASH.launches = FLASH.launches = 0
            thread = threading.Thread(target=learner.run, daemon=True)
            t0 = time.perf_counter()
            thread.start()
            while thread.is_alive() and time.perf_counter() - t0 < 600:
                if not kids.running("worker"):
                    learner.shutdown_flag = True  # drained, or dead: no episodes come
                thread.join(0.5)
            check(not thread.is_alive(), "the remote learner did not finish in 600 s")
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            launches, flash_launches = MASKED_FLASH.launches, FLASH.launches
            outs = kids.wait_all(120)
        steps = learner.trainer.steps
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        per_step = launches_per_step(learner.args)
        check(steps > 0 and launches == per_step * steps and flash_launches == 0,
              f"masked kernel launched {launches} times (plain {flash_launches}) in {steps} "
              f"learner steps, expected {per_step} per step")
        check(learner.trainer.sentinel_skipped_steps == 0, "the sentinel skipped a step")
        # the kernels line counts the launches of both learner paths, 7b's and this one
        results.setdefault("masked_flash_attention", {"launches": 0})["launches"] += launches
        records = read_records(cfg["train_args"]["metrics_path"])
        check(len(records) == 2, f"{len(records)} epoch records, expected 2")
        check(all(math.isfinite(r["loss"]["total"]) for r in records if "loss" in r)
              and any("loss" in r for r in records), "no loss or a non-finite epoch loss")
        model_dir = cfg["train_args"]["model_dir"]
        check_snapshots(model_dir, [1, 2])
        print_epochs("remote learner", records)
        check_shm("remote learner", records)
        fetches, sessions = remote_books("remote learner", records, outs["worker"])
        manifest = ckpt.load_manifest(model_dir)["epochs"]
        for model_id, nbytes, _, crc in fetches:
            blob = learner.worker._blob_cache.get(model_id)
            check(blob is not None, f"the server holds no blob of model {model_id}")
            ours = zlib.crc32(blob)
            recorded = manifest.get(str(model_id), {}).get("files", {}).get(f"{model_id}.ckpt")
            print(f"[remote learner] model {model_id}: served blob crc32 {ours:08x} "
                  f"({len(blob)} bytes), worker's {crc} ({nbytes} bytes), the manifest's "
                  f"{'n/a (the initial params)' if recorded is None else format(recorded['crc32'], '08x')}")
            check(ours == int(crc, 16) and len(blob) == nbytes,
                  f"model {model_id}: the worker's params are not the learner's snapshot")
            check(recorded is None or recorded["crc32"] == ours,
                  f"model {model_id}: the blob served is not the snapshot saved")
        _, requests, batches, play_s = sessions[-1]
        boundary_s = sum(r["boundary_snapshot_s"] + r["boundary_save_s"] + r["boundary_publish_s"]
                         for r in records)
        # the actors are held while the learner is inside a boundary (the
        # server's dispatch waits on it) and while a gather fetches a blob;
        # the first fetch precedes the play
        held_s = boundary_s + sum(f[2] for f in fetches[1:])
        moves = requests / 2  # both Geister players are inferred per move
        print(f"[remote learner] Geister d{NET_ARGS['d_model']} L{NET_ARGS['n_layers']} B"
              f"{TRAIN_ARGS['batch_size']} T{TRAIN_ARGS['forward_steps']} bf16, 8 remote actors: "
              f"{steps} steps, {learner.num_returned_episodes} episodes in {run_s:.1f} s; worker: "
              f"{requests} requests in {batches} batches ({requests / max(batches, 1):.1f} per "
              f"batch) over {play_s:.1f} s of session: {moves / max(play_s, 1e-9):.1f} moves/s in "
              f"all, {moves / max(play_s - held_s, 1e-9):.1f} moves/s outside the boundaries "
              f"({boundary_s:.1f} s) and later fetches ({held_s - boundary_s:.1f} s); peak memory "
              f"in this process {peak_gb:.2f} GB; masked kernel launches {launches} ({per_step} "
              "per step)")


def phase_battle(tmp):
    """9c: ``--eval-server 20`` with two ``--eval-client`` processes, one
    playing 9a's ``models/latest.ckpt`` on the card, one random."""
    import yaml

    cfg = yaml.safe_load(Path(tmp, "config.yaml").read_text())
    cfg["train_args"]["battle_port"] = free_port()
    Path(tmp, "config.yaml").write_text(yaml.safe_dump(cfg))
    t0 = time.perf_counter()
    with Children(tmp) as kids:
        kids.start("eval_server", "--eval-server", str(BATTLE_GAMES))
        kids.start("client_model", "--eval-client", "models/latest.ckpt", "127.0.0.1")
        kids.start("client_random", "--eval-client", "random", "127.0.0.1")
        outs = kids.wait_all(300)
    run_s = time.perf_counter() - t0
    lines = outs["eval_server"].splitlines()
    total = [line for line in lines if line.startswith("total =")]
    payoff = [line for line in lines if line.startswith("payoff:")]
    check(len(total) == 1 and total[0].endswith(f"({BATTLE_GAMES})"),
          f"the battle server's total line: {total}")
    check(len(payoff) == 1 and f"over {BATTLE_GAMES} match(es), 0 forfeit(s)" in payoff[0],
          f"the battle server's payoff line: {payoff}")
    games = [line for line in outs["client_model"].splitlines() if line.startswith("outcome =")]
    print(f"[battle] --eval-server {BATTLE_GAMES} with --eval-client models/latest.ckpt (9a's, on "
          f"the card) and --eval-client random in {run_s:.1f} s: {total[0]} (seat 0); {payoff[0]}; "
          f"the model client played {len(games)} games, won "
          f"{sum(float(line.split('=')[1]) > 0 for line in games)}")


def phase_remote(results, parts="abc"):
    """9: the remote actor plane and network battles; 9b's kernel counts
    start from 0.  ``parts`` picks the legs (c plays a's checkpoint)."""
    with tempfile.TemporaryDirectory() as tmp:
        if "a" in parts:
            phase_remote_cli(tmp)
        if "b" in parts:
            phase_remote_learner(results)
        if "c" in parts:
            phase_battle(tmp)


# -- phase 10: the batch-assembly plane ---------------------------------------

# the envs whose episodes 10(a) encodes: env args and the generator's args
ASSEMBLY_ENVS = {
    "TicTacToe": ({"env": "TicTacToe"}, {"observation": False}),
    "Geister": ({"env": "Geister"}, {"observation": True}),
    "HungryGeese": ({"env": "HungryGeese"}, {"observation": False}),
    "ParallelTicTacToe": ({"env": "ParallelTicTacToe"}, {"observation": False}),
    "ConnectFour": ({"env": "ConnectFour"}, {"observation": False}),
}
CODEC_EPISODES = 64      # Geister episodes 10(a) encodes and decodes, and 10(b) samples
PUT_REPEATS = 20         # copies of one slot timed in 10(b), the median kept
KILL_EPISODES = 50       # minimum_episodes and update_episodes of 10(d)
# minimum_episodes and update_episodes of 10(c)'s 8a and 7a runs
TURN_EPISODES = {"8a": (4, 4), "7a": (16, 16)}
# 10(c)'s runs in order: one of each pipeline (depth cut to fit the time limit)
ASSEMBLY_TURNS = ("thread", "shm")


def random_episodes(env_args, gen_args, n, seed):
    """``n`` self-play episodes of uniform play (a zero-logit model shaped
    like the env's net), seeded."""
    from handyrl_tpu_torch.envs import make_env
    from handyrl_tpu_torch.models import InferenceModel, RandomModel
    from handyrl_tpu_torch.runtime import Generator

    env = make_env(env_args)
    env.reset()
    model = RandomModel.from_model(InferenceModel(env.net(), device="cpu"),
                                   env.observation(env.players()[0]))
    gen = Generator(env, dict(gen_args, gamma=0.8, compress_steps=4))
    random.seed(seed)
    episodes = []
    while len(episodes) < n:
        ep = gen.generate({p: model for p in env.players()}, {"player": env.players()})
        if ep is not None:
            episodes.append(ep)
    return episodes


def same_tree(a, b):
    import numpy as np

    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape
                and a.tobytes() == b.tobytes())
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(map(same_tree, a, b))
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(same_tree(a[k], b[k]) for k in a)
    return type(a) is type(b) and a == b


def best_ms(fn, repeats=3):
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return min(times)


def assembly_codec():
    """10(a): the C codec against the pure-Python specification."""
    from handyrl_tpu_torch.runtime import codec
    from handyrl_tpu_torch.runtime.replay import decompress_block

    acc = codec.get_accel()
    check(acc is not None, "the codec accelerator did not load")
    for name, (env_args, gen_args) in ASSEMBLY_ENVS.items():
        objs = 0
        for ep in random_episodes(env_args, gen_args, 2, SEED):
            for obj in [ep] + [decompress_block(b) for b in ep["blocks"]]:
                raw = acc.dumps(obj)
                check(raw == codec.py_dumps(obj), f"{name}: the C codec's bytes differ")
                check(same_tree(acc.loads(raw), codec.py_loads(raw)) and same_tree(acc.loads(raw), obj),
                      f"{name}: the C and Python decodes differ")
                objs += 1
        print(f"[codec] {name}: {objs} episodes and blocks byte-equal and decode-equal, C and Python")
    episodes = random_episodes(*ASSEMBLY_ENVS["Geister"], CODEC_EPISODES, SEED)
    # what the actors encode and the batchers decode: each episode's columns
    columns = [[decompress_block(b) for b in ep["blocks"]] for ep in episodes]
    blobs = [codec.py_dumps(c) for c in columns]
    nbytes = sum(map(len, blobs))
    impls = {"C": (acc.dumps, acc.loads), "Python": (codec.py_dumps, codec.py_loads)}
    times = {impl: [] for impl in impls}
    for impl in ("C", "Python", "Python", "C"):  # in turns
        dumps, loads = impls[impl]
        times[impl].append((best_ms(lambda: [dumps(c) for c in columns]),
                            best_ms(lambda: [loads(b) for b in blobs])))
    print(f"[codec] {CODEC_EPISODES} Geister episodes ({sum(ep['steps'] for ep in episodes)} steps, "
          f"{nbytes / 1e6:.2f} MB of columns), best of 3, two turns: " + "; ".join(
              f"{impl} encode {', '.join(f'{e:.2f}' for e, _ in ts)} ms, decode "
              f"{', '.join(f'{d:.2f}' for _, d in ts)} ms" for impl, ts in times.items()))
    return episodes


def assembly_fill(episodes):
    """10(b): the C fill against numpy at 8a's and 7b's batch shapes; then
    the copy of one ring slot to the card."""
    from handyrl_tpu_torch.config import normalize_args
    from handyrl_tpu_torch.runtime import EpisodeStore, make_batch

    store = EpisodeStore(1000)
    store.extend(episodes)
    shapes = {}
    for tag, over in (("8a B128 x T24", DRC_TRAIN_ARGS), ("7b B16 x T512", TRAIN_ARGS)):
        args = normalize_args({"env_args": {"env": "Geister"}, "train_args": over})["train_args"]
        random.seed(SEED)
        windows = [store.sample_window(args["forward_steps"], args["burn_in_steps"],
                                       args["compress_steps"]) for _ in range(args["batch_size"])]
        got, times = {}, {"C": [], "numpy": []}
        for impl in ("C", "numpy", "numpy", "C"):  # in turns
            if impl == "numpy":
                os.environ["HANDYRL_NO_FILL_ACCEL"] = "1"
            try:
                got[impl] = make_batch(windows, args)
                times[impl].append(best_ms(lambda: make_batch(windows, args), 5))
            finally:
                os.environ.pop("HANDYRL_NO_FILL_ACCEL", None)
        check(same_tree(got["C"], got["numpy"]), f"{tag}: the C fill differs from the numpy fill")
        nbytes = sum(leaf.nbytes for leaf in _leaves(got["C"]))
        print(f"[fill] {tag} ({nbytes / 1e6:.1f} MB): C fill bit-identical to numpy; make_batch "
              f"best of 5, two turns: C {', '.join(f'{t:.2f}' for t in times['C'])} ms, numpy "
              f"{', '.join(f'{t:.2f}' for t in times['numpy'])} ms")
        shapes[tag] = (args, windows)
    put_lines(*shapes["7b B16 x T512"], "7b B16 x T512", ff=False)
    ttt = random_episodes(*ASSEMBLY_ENVS["TicTacToe"], 64, SEED)
    store = EpisodeStore(1000)
    store.extend(ttt)
    args = normalize_args({"env_args": {"env": "TicTacToe"}, "train_args": {}})["train_args"]
    random.seed(SEED)
    windows = [store.sample_window(args["forward_steps"], 0, 4) for _ in range(args["batch_size"])]
    put_lines(args, windows, "7a B128 x T16", ff=True)


def _leaves(tree):
    from handyrl_tpu_torch.utils import tree_leaves

    return tree_leaves(tree)


def put_lines(args, windows, tag, ff):
    """One batch filled into a shared-memory slot and copied to the card
    with ``put_batch(non_blocking=True)``: from the slot registered with
    cudaHostRegister (what the shm pipeline does), and staged through
    freshly pinned memory (what the threaded pipeline does).  Host ms of
    the call against the event ms of the copies, medians.  ``ff``: a
    feed-forward batch, whose observation is cut to its live prefix, on
    the card (registered) or on the host (staged)."""
    from multiprocessing import shared_memory

    import torch

    from handyrl_tpu_torch.models import SimpleConvNet
    from handyrl_tpu_torch.parallel import TrainContext, live_steps
    from handyrl_tpu_torch.runtime import make_batch
    from handyrl_tpu_torch.runtime.batch import fill_batch
    from handyrl_tpu_torch.runtime.shm_batch import _buffer_address, slot_spec, slot_views

    template = make_batch(windows, args)
    spec, nbytes = slot_spec(template)
    # the put path reads only the context's device and its feed-forward cut
    ctx = TrainContext(SimpleConvNet(), dict(args, burn_in_steps=0, compact_padding=ff))
    shm = shared_memory.SharedMemory(create=True, size=nbytes)
    addr = 0
    try:
        views = slot_views(spec, shm.buf, 0)
        fill_batch(windows, args, views)
        probe = views["action_mask"]
        t_eff = live_steps(template) if ff else None
        results = {}
        for mode in ("staged", "registered", "registered", "staged"):
            pinned = mode == "registered"
            if pinned and not addr:
                check(not torch.from_numpy(probe).is_pinned(), f"{tag}: pageable pages seen as pinned")
                addr = _buffer_address(shm.buf)
                torch.cuda.check_error(torch.cuda.cudart().cudaHostRegister(addr, nbytes, 0))
                check(torch.from_numpy(probe).is_pinned(), f"{tag}: registered pages not seen as pinned")
            elif not pinned and addr:
                torch.cuda.synchronize()
                torch.cuda.check_error(torch.cuda.cudart().cudaHostUnregister(addr))
                addr = 0
            host, event = [], []
            for _ in range(PUT_REPEATS):
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                start.record()
                t0 = time.perf_counter()
                out = ctx.put_batch(views, non_blocking=True, pinned=pinned)
                host.append((time.perf_counter() - t0) * 1e3)
                end.record()
                torch.cuda.synchronize()
                event.append(start.elapsed_time(end))
            for key in ("action_mask", "turn_mask", "value"):
                check(torch.equal(out[key].cpu(), torch.from_numpy(template[key])),
                      f"{tag}: {key} differs after the copy ({mode})")
            obs = _leaves(out["observation"])[0]
            if ff:
                check(obs.shape[1] == t_eff, f"{tag}: observation cut to {obs.shape[1]}, not {t_eff}")
            results.setdefault(mode, []).append((sorted(host)[len(host) // 2],
                                                 sorted(event)[len(event) // 2]))
        for mode, runs in results.items():
            how = {"registered": "from the registered slot", "staged": "through fresh pinned memory"}
            print(f"[put] {tag} ({nbytes / 1e6:.1f} MB slot), {how[mode]}"
                  f"{' (observation cut on the card)' if ff and mode == 'registered' else ''}"
                  f"{' (observation cut on the host)' if ff and mode == 'staged' else ''}: "
                  + ", ".join(f"call {h:.3f} ms on the host, copies {e:.3f} ms by events"
                              for h, e in runs) + f" (medians of {PUT_REPEATS}, two turns)")
        print(f"[put] {tag}: pageable slot pages not pinned, registered ones pinned (is_pinned)")
        if not ff:
            host_ms, event_ms = results["registered"][0]
            check(host_ms < event_ms,
                  f"{tag}: the registered put took {host_ms:.3f} ms on the host, its copies "
                  f"{event_ms:.3f} ms: the call did not return before the copy ended")
    finally:
        views = probe = None
        gc.collect()
        if addr:
            torch.cuda.synchronize()
            torch.cuda.check_error(torch.cuda.cudart().cudaHostUnregister(addr))
        shm.close()
        shm.unlink()


def turn_run(config, pipeline, tmp, epochs=2, episodes=TURN_EPISODES):
    """One learner in-process under ``pipeline``: 8a's DRC, 8b's HungryGeese
    or 7a's config.yaml, with ``episodes[config]`` minimum and update
    episodes.  Returns its last epoch's record (of 2, 10(c): the first holds
    the trainer's warm-up, its first batch and the first step's one-off
    costs), its pipeline's stats and its seconds."""
    import torch
    import yaml

    from handyrl_tpu_torch.config import normalize_args
    from handyrl_tpu_torch.runtime.learner import Learner

    run_dir = os.path.join(tmp, f"{config}_{pipeline}_{time.monotonic_ns()}")
    paths = dict(epochs=epochs, batch_pipeline=pipeline, seed=SEED,
                 model_dir=os.path.join(run_dir, "models"),
                 metrics_path=os.path.join(run_dir, "metrics.jsonl"))
    if config == "8a":
        cfg = normalize_args({"env_args": {"env": "Geister"}, "train_args": dict(
            DRC_TRAIN_ARGS, minimum_episodes=episodes["8a"][0], update_episodes=episodes["8a"][1],
            worker={"num_parallel": 8}, **paths)})
    elif config == "8b":
        cfg = normalize_args({"env_args": {"env": "HungryGeese"}, "train_args": dict(
            turn_based_training=False, observation=False, minimum_episodes=episodes["8b"][0],
            update_episodes=episodes["8b"][1], eval={"opponent": ["rulebase"]}, **paths)})
    else:  # 7a: config.yaml
        raw = yaml.safe_load((ROOT / "config.yaml").read_text())
        raw["train_args"].update(minimum_episodes=episodes["7a"][0],
                                 update_episodes=episodes["7a"][1], **paths)
        cfg = normalize_args(raw)
    gc.collect()
    t0 = time.perf_counter()
    learner = Learner(cfg)
    learner.run()
    torch.cuda.synchronize()
    records = read_records(cfg["train_args"]["metrics_path"])
    check(len(records) == epochs and "loss" in records[-1]
          and records[-1]["pipeline"] == pipeline and math.isfinite(records[-1]["loss"]["total"]),
          f"{config} {pipeline}: records {[(r['epoch'], r.get('pipeline')) for r in records]}")
    return records[-1], learner.trainer.batcher.stats(), time.perf_counter() - t0


def assembly_turns():
    """10(c): 8a's and 7a's learners under the threaded and the shm pipeline,
    in turns (thread, shm); the second epoch of each run."""
    with tempfile.TemporaryDirectory() as tmp:
        for config in ("8a", "7a"):
            runs = []
            for pipeline in ASSEMBLY_TURNS:
                r, _, run_s = turn_run(config, pipeline, tmp)
                if pipeline == "shm":
                    check_shm(f"turns {config}", [r])
                runs.append((pipeline, r))
                print_epochs(f"turns {config} {pipeline}", [r])
                print(f"[turns] {config} {pipeline}: the run took {run_s:.1f} s")
            for pipeline in ("thread", "shm"):
                rs = [r for p, r in runs if p == pipeline]
                rate = ", ".join(f"{r['updates_per_sec']:.3f}" for r in rs)
                train = ", ".join(f"{r['train_steps_per_sec']:.3f}" for r in rs)
                wait = ", ".join(f"{r['input_wait_frac']:.1%}" for r in rs)
                put = ", ".join(f"{r['pipe_put_s'] / max(r['pipe_batches'], 1) * 1e3:.2f}" for r in rs)
                paced = ", ".join("the pipeline" if r["input_wait_frac"] > 0.5 else "the trainer"
                                  for r in rs)
                print(f"[turns] {config} {pipeline}: epoch 1 at {rate} updates/s, {train} steps/s "
                      f"while training, input wait {wait}, put {put} ms per batch: {paced} sets "
                      "the pace")


def compute_app_pids():
    smi = subprocess.run(["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi --query-compute-apps failed: {smi.stderr}")
    return {int(x) for x in smi.stdout.split() if x.strip().isdigit()}


def check_no_cuda_context(tag, pids):
    """(e): none of ``pids`` (batcher processes) holds a context on the
    card; the card lists at most this process."""
    apps = compute_app_pids()
    visible = os.getpid() in apps
    print(f"[no context] {tag}: compute apps on the card {sorted(apps)}, this process "
          f"{os.getpid()} ({'listed' if visible else 'not listed: another pid namespace'}), "
          f"batchers {sorted(pids)}")
    check(not (apps & set(pids)), f"{tag}: a batcher process holds a CUDA context")
    check(len(apps) <= 1, f"{tag}: {len(apps)} processes hold a context on the card")


def assembly_kill():
    """10(d) and (e): the default config in-process, a batcher child
    SIGKILLed once batches flow."""
    import signal

    import torch
    import yaml

    from handyrl_tpu_torch.config import normalize_args
    from handyrl_tpu_torch.runtime.learner import Learner
    from handyrl_tpu_torch.runtime.shm_batch import ShmBatchPipeline

    raw = yaml.safe_load((ROOT / "config.yaml").read_text())
    with tempfile.TemporaryDirectory() as tmp:
        raw["train_args"].update(epochs=2, minimum_episodes=KILL_EPISODES,
                                 update_episodes=KILL_EPISODES,
                                 model_dir=os.path.join(tmp, "models"),
                                 metrics_path=os.path.join(tmp, "metrics.jsonl"))
        cfg = normalize_args(raw)
        gc.collect()
        learner = Learner(cfg)
        pipe = learner.trainer.batcher
        check(isinstance(pipe, ShmBatchPipeline), f"config.yaml builds {type(pipe).__name__}")
        thread = threading.Thread(target=learner.run, daemon=True)
        thread.start()
        deadline = time.monotonic() + 300
        while pipe.stats()["batches"] < 4 and thread.is_alive() and time.monotonic() < deadline:
            time.sleep(0.1)
        check(pipe.stats()["batches"] >= 4, "no batch flowed before the kill")
        check_no_cuda_context("before the kill", [p.pid for p in pipe._procs])
        victim = pipe._procs[0]
        at_kill = pipe.stats()["batches"]
        os.kill(victim.pid, signal.SIGKILL)
        t_kill = time.monotonic()
        while pipe.stats()["batcher_restarts"] < 1 and time.monotonic() < t_kill + 30:
            time.sleep(0.05)
        respawn_s = time.monotonic() - t_kill
        check(pipe.stats()["batcher_restarts"] == 1, "the killed batcher was not respawned")
        check_no_cuda_context("after the respawn", [p.pid for p in pipe._procs if p is not None])
        thread.join(timeout=max(1.0, deadline - time.monotonic()))
        check(not thread.is_alive(), "the learner did not finish after the kill")
        torch.cuda.synchronize()
        stats = pipe.stats()
        records = read_records(cfg["train_args"]["metrics_path"])
        print_epochs("kill", records)
        last = records[-1]
        check(stats["mode"] == "shm" and stats["batcher_deaths"] == 1
              and stats["batcher_fallback"] == 0 and last["pipe_batcher_deaths"] == 1
              and last["pipe_batcher_restarts"] == 1 and last["pipeline"] == "shm",
              f"after the kill: {stats}, last record {last.get('pipeline')}")
        check(stats["batches"] >= at_kill + 2 * pipe._n_slots,
              f"{stats['batches'] - at_kill:.0f} batches after the kill")
        check(all(p is None or not p.is_alive() for p in pipe._procs), "a batcher outlived the learner")
        check(not segment_linked(pipe._shm.name), "the ring's segment outlived the learner")
        print(f"[kill] batcher {victim.pid} SIGKILLed after {at_kill:.0f} batches, respawned in "
              f"{respawn_s:.2f} s; {stats['batches'] - at_kill:.0f} batches after it; the learner "
              f"ended after {last['steps']} steps, deaths {stats['batcher_deaths']:.0f}, restarts "
              f"{stats['batcher_restarts']:.0f}, fallback {stats['batcher_fallback']:.0f}; every "
              "batcher reaped, the segment unlinked")


def segment_linked(name):
    return os.path.exists(os.path.join("/dev/shm", name.lstrip("/")))


def phase_assembly(results):
    """10: the batch-assembly plane (no kernel on it)."""
    print(f"[assembly] {card_line()}")
    times, t0 = [], time.perf_counter()
    episodes = assembly_codec()
    times.append(time.perf_counter())
    assembly_fill(episodes)
    times.append(time.perf_counter())
    assembly_turns()
    times.append(time.perf_counter())
    assembly_kill()
    times.append(time.perf_counter())
    parts = ", ".join(f"({tag}) {t1 - t:.1f} s"
                      for tag, t, t1 in zip("abcd", [t0] + times, times))
    print(f"[assembly] phase 10 in {times[-1] - t0:.1f} s: {parts}, (e) within (d)")


# -- phase 11: on-device self-play and evaluation ----------------------------

# (a)'s rollouts at full width: env, train args, lanes (games for the
# episodic TicTacToe rollout); bench.py's device self-play configurations
SELFPLAY = (
    ("HungryGeese", {"turn_based_training": False, "observation": False}, 256),
    ("Geister", {"observation": True}, 128),
    ("TicTacToe", {}, 2048),
    ("ParallelTicTacToe", {"turn_based_training": False, "observation": False}, 256),
)
SELFPLAY_WINDOW = 2.0    # seconds of each rollout's timed window in 11(a)
REPLAY_EPISODES = 32     # episodes per env replayed through the host env in 11(b)
# 11(c): 8b's HungryGeese configuration with device self-play and evaluation
DEVICE_GEESE = {
    "turn_based_training": False, "observation": False, "epochs": 2,
    "minimum_episodes": 64, "update_episodes": 64,
    "device_rollout_games": 256, "device_eval_games": 64,
    "eval": {"opponent": ["rulebase"]}, "seed": SEED,
}
# 11(c)'s and 11(d)'s epoch records, printed beside 12(d)'s
SELFPLAY_RECORDS = {}


def card_generator():
    import torch

    return torch.Generator(device="cuda").manual_seed(SEED)


def episode_columns(episode):
    """An episode's blocks, decompressed and concatenated over time."""
    from handyrl_tpu_torch.runtime import decompress_block
    from handyrl_tpu_torch.utils import tree_concat

    return tree_concat([decompress_block(b) for b in episode["blocks"]])


def same_obs(got, want):
    import numpy as np

    if isinstance(want, dict):
        return sorted(got) == sorted(want) and all(same_obs(got[k], want[k]) for k in want)
    return np.array_equal(np.asarray(got), np.asarray(want, np.float32))


def _legal_set(amask_row):
    import numpy as np

    return sorted(np.flatnonzero(amask_row == 0).tolist())


def _replay_turns(env, cols, T, tag):
    """TicTacToe and Geister: one acting player per step, in turn."""
    for t in range(T):
        p = env.turn()
        check(int(cols["turn"][t]) == p and cols["tmask"][t, p] == 1 and cols["tmask"][t].sum() == 1,
              f"{tag} step {t}: the acting player is not the host's turn player {p}")
        for q in env.players():
            obs_q = {k: v[t, q] for k, v in cols["obs"].items()} if isinstance(cols["obs"], dict) \
                else cols["obs"][t, q]
            if cols["omask"][t, q] > 0:
                check(same_obs(obs_q, env.observation(q)),
                      f"{tag} step {t}: player {q}'s observation differs from the host env's")
        legal = sorted(env.legal_actions(p))
        check(_legal_set(cols["amask"][t, p]) == legal, f"{tag} step {t}: the legal set differs")
        a = int(cols["action"][t, p])
        check(a in legal, f"{tag} step {t}: illegal action {a}")
        env.play(a, p)
    return env


def _replay_parallel(env, cols, T, tag):
    """ParallelTicTacToe: both players act; the move played is read off
    the next board, the last step's chooser from the outcome."""
    import copy

    import numpy as np

    obs = cols["obs"]
    for t in range(T):
        check((cols["tmask"][t] == 1).all(), f"{tag} step {t}: a player did not act")
        legal = sorted(env.legal_actions(0))
        for p in env.players():
            check(same_obs(obs[t, p], env.observation(p)),
                  f"{tag} step {t}: player {p}'s observation differs from the host env's")
            check(_legal_set(cols["amask"][t, p]) == legal and int(cols["action"][t, p]) in legal,
                  f"{tag} step {t}: player {p}'s legal set or action")
        if t + 1 < T:
            diff = (obs[t + 1, 0, 1] - obs[t + 1, 0, 2]).ravel() - (obs[t, 0, 1] - obs[t, 0, 2]).ravel()
            placed = np.flatnonzero(diff)
            check(len(placed) == 1, f"{tag} step {t}: {len(placed)} stones placed")
            chooser = 0 if diff[placed[0]] > 0 else 1
            check(int(cols["action"][t, chooser]) == placed[0], f"{tag} step {t}: the played move")
            env._apply(int(placed[0]), chooser)
            check(not env.terminal(), f"{tag} step {t}: the host game ended early")
        else:
            ends = []
            for chooser in env.players():
                trial = copy.deepcopy(env)
                trial._apply(int(cols["action"][t, chooser]), chooser)
                if trial.terminal():
                    ends.append(trial)
            match = [e for e in ends if e.outcome() == cols["_outcome"]]
            check(ends, f"{tag}: no chooser's last move ends the host game")
            env = (match or ends)[0]
    return env


def _replay_geese(env, cols, T, tag):
    """HungryGeese: every active goose acts; the device's food spawns are
    put into the host env after each step, once the food both kept agrees
    (spawn positions are the only randomness)."""
    import numpy as np

    obs, omask = cols["obs"], cols["omask"]

    def food_at(t):
        p = int(np.flatnonzero(omask[t])[0])
        return {int(c) for c in np.flatnonzero(obs[t, p, 16].ravel())}

    env.reset()
    env.geese = [[int(np.flatnonzero(obs[0, p, 0].ravel())[0])] for p in env.players()]
    env.food = sorted(food_at(0))
    for t in range(T):
        for p in env.players():
            check(bool(cols["tmask"][t, p]) == env.active[p], f"{tag} step {t}: goose {p} activity")
            if omask[t, p] > 0:
                check(same_obs(obs[t, p], env.observation(p)),
                      f"{tag} step {t}: goose {p}'s observation differs from the host env's")
            else:
                check(not obs[t, p].any(), f"{tag} step {t}: an unobserved view is not zero")
        actions = {p: int(cols["action"][t, p]) for p in env.turns()}
        check(all(a in env.legal_actions(p) for p, a in actions.items()), f"{tag} step {t}: illegal")
        before = set(env.food)
        env.step(actions)
        if t + 1 < T:
            after = food_at(t + 1)
            check(set(env.food) & before == after & before and len(env.food) == len(after),
                  f"{tag} step {t}: the food kept or its count differs")
            env.food = sorted(after)
    return env


def replay_episode(env_name, episode, tag=""):
    """Replay one device episode through the port's host env: every action
    legal, every recorded observation equal to the host env's, the same
    outcome.  Returns the steps replayed."""
    from handyrl_tpu_torch.envs import make_env

    cols = episode_columns(episode)
    cols["_outcome"] = episode["outcome"]
    T = episode["steps"]
    replay = {"TicTacToe": _replay_turns, "Geister": _replay_turns,
              "ParallelTicTacToe": _replay_parallel, "HungryGeese": _replay_geese}[env_name]
    env = replay(make_env({"env": env_name}), cols, T, tag or env_name)
    check(env.terminal(), f"{tag or env_name}: the host game has not ended after {T} steps")
    want = env.outcome()
    check(all(abs(want[p] - episode["outcome"][p]) < 1e-6 for p in want),
          f"{tag or env_name}: outcome {episode['outcome']} against the host's {want}")
    return T


def selfplay_rollout(env_name, train_args, lanes, device=None):
    """(roll, args) for one of (a)'s rollouts, random weights from SEED."""
    from handyrl_tpu_torch.config import normalize_args
    from handyrl_tpu_torch.envs import make_env
    from handyrl_tpu_torch.models import init_variables
    from handyrl_tpu_torch.runtime.device_rollout import make_device_rollout

    cfg = normalize_args({"env_args": {"env": env_name}, "train_args": train_args})
    args = dict(cfg["train_args"], env=cfg["env_args"])
    env = make_env(cfg["env_args"])
    module = init_variables(env.net(), SEED)
    return make_device_rollout(env.vector_env(), module, args, lanes, device=device), args


def profile_launches(fn):
    """(wall ms, device ms, launches, launch calls) of one call of fn under
    torch.profiler; launches are the device-side events (kernels and
    copies), launch calls the host's CUDA runtime calls that enqueue work
    (kernels, copies, memsets), counted on the host side."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    averages = prof.key_averages()
    events = [e for e in averages
              if e.device_type == torch.autograd.DeviceType.CUDA and "#" not in e.key]
    calls = sum(e.count for e in averages if e.key.startswith(
        ("cudaLaunchKernel", "cuLaunchKernel", "cudaMemcpyAsync", "cudaMemsetAsync")))
    return (wall_ms, sum(e.self_device_time_total for e in events) / 1e3,
            sum(e.count for e in events), calls)


def selfplay_rates(env_name, train_args, lanes, gen):
    """11(a) for one rollout: a warm-up, the timed window (episode assembly
    inside it, as bench.py's streaming bench), the split of a generate, and
    the launches per game step from one profiled call.  Returns the
    episodes of the window."""
    import numpy as np

    roll, _ = selfplay_rollout(env_name, train_args, lanes)
    streaming = hasattr(roll, "k_steps")
    episodes = roll.generate(None, gen) + roll.generate(None, gen)   # builds and warms
    steps0, psteps0 = getattr(roll, "game_steps", 0), getattr(roll, "player_steps", 0)
    window, timings = [], []
    t0 = time.perf_counter()
    while True:
        dt = time.perf_counter() - t0
        if dt >= SELFPLAY_WINDOW and (window or dt >= 4 * SELFPLAY_WINDOW):
            break
        window += roll.generate(None, gen)
        timings.append(dict(roll.timing))
    dt = time.perf_counter() - t0
    if streaming:
        roll.drain()
        env_steps, player_steps = roll.game_steps - steps0, roll.player_steps - psteps0
        shape = f"{lanes} lanes x {roll.k_steps} steps"
    else:
        env_steps = player_steps = sum(ep["steps"] for ep in window)
        shape = f"{lanes} games x {roll.venv.max_steps} plies"
    split = {key: np.mean([t[key] for t in timings if t.get(key) is not None])
             for key in ("launch_ms", "device_ms", "wait_ms", "assemble_ms")}
    print(f"[selfplay] {env_name} {type(roll.module).__name__} {shape}: "
          f"{env_steps / dt:.1f} env-steps/s, {player_steps / dt:.1f} player-steps/s, "
          f"{len(window) / dt:.2f} episodes/s over {dt:.2f} s ({len(timings)} generate calls, "
          f"{len(window)} episodes, mean length {np.mean([e['steps'] for e in window]):.1f})")
    print(f"[selfplay] {env_name} one generate, means: host launch {split['launch_ms']:.1f} ms, "
          f"device {split['device_ms']:.1f} ms (events, its block), wait for the block "
          f"{split['wait_ms']:.1f} ms, host assembly {split['assemble_ms']:.1f} ms")
    if env_name in ("HungryGeese", "Geister"):
        wall, device_ms, launches, _ = profile_launches(lambda: roll.generate(None, gen))
        per_step = launches / roll.k_steps
        print(f"[selfplay] {env_name} one generate under the profiler: wall {wall:.1f} ms, "
              f"device {device_ms:.1f} ms ({device_ms / wall:.1%} busy), {launches} launches, "
              f"{per_step:.1f} per game step")
        check(per_step > 0, f"{env_name}: the profiler saw no launch")
    check_on_card(env_name, roll)
    return roll, episodes + window


def check_on_card(env_name, roll):
    """11(b): every tensor of the rollout (lanes, hidden state, module) is on
    the card."""
    import torch

    from handyrl_tpu_torch.utils import tree_leaves

    tensors = list(roll.module.parameters()) + list(roll.module.buffers())
    if hasattr(roll, "k_steps"):
        tensors += tree_leaves(roll._state) + [h for h in tree_leaves(roll._hidden) if h is not None]
    check(tensors and all(isinstance(t, torch.Tensor) and t.is_cuda for t in tensors),
          f"{env_name}: a rollout tensor is not on the card")


def twin_cpu_gate(env_name, roll, gen):
    """11(b): one step of a streaming twin on the card and on the CPU from
    the same state with the same injected noise: equal states, observations,
    legal masks (and rule-based choices for HungryGeese)."""
    import importlib

    import torch

    venv = roll.venv
    mod = importlib.import_module(venv.__module__)
    state = roll._state
    cpu = {k: v.cpu() for k, v in state.items()}
    legal = venv.legal_mask_all(state)
    actions = torch.argmax(torch.rand(legal.shape, device=legal.device, generator=gen) + legal, -1)
    B = legal.shape[0]
    noise = {"HungryGeese": ("_gumbel", [(B, 77), (B, 77)]),
             "ParallelTicTacToe": ("_bernoulli", [(B,)]), "Geister": (None, [])}[env_name]
    name, shapes = noise
    draws = [torch.rand(s, device=legal.device, generator=gen) for s in shapes]
    if name == "_bernoulli":
        draws = [d < 0.5 for d in draws]
    elif name == "_gumbel":
        draws = [-torch.log(-torch.log(d.clamp(min=torch.finfo(torch.float32).tiny))) for d in draws]

    def stepped(s, a, device):
        if name is not None:
            queue = [d.to(device) for d in draws]
            saved = getattr(mod, name)
            setattr(mod, name, lambda *args, **kw: queue.pop(0))
        try:
            with torch.inference_mode():
                return venv.step(s, a, None)
        finally:
            if name is not None:
                setattr(mod, name, saved)

    pairs = [("step", stepped(state, actions, state["done"].device), stepped(cpu, actions.cpu(), "cpu")),
             ("observation", venv.observation(state), venv.observation(cpu)),
             ("legal", {"mask": legal}, {"mask": venv.legal_mask_all(cpu)})]
    if env_name == "HungryGeese":
        g = [torch.rand((B, 4, 4), device=legal.device, generator=gen).clamp(min=1e-30)]
        noise_cpu = [g[0].cpu()]
        saved = mod._gumbel
        try:
            mod._gumbel = lambda *a, **k: g[0]
            card_rule = venv.rule_based_action_all(state, None)
            mod._gumbel = lambda *a, **k: noise_cpu[0]
            cpu_rule = venv.rule_based_action_all(cpu, None)
        finally:
            mod._gumbel = saved
        pairs.append(("rule_based_action_all", {"a": card_rule}, {"a": cpu_rule}))
    for what, card_tree, cpu_tree in pairs:
        card_tree = card_tree if isinstance(card_tree, dict) else {"x": card_tree}
        cpu_tree = cpu_tree if isinstance(cpu_tree, dict) else {"x": cpu_tree}
        for key in card_tree:
            check(torch.equal(card_tree[key].cpu(), cpu_tree[key]),
                  f"{env_name} {what}: {key} differs between the card and the CPU")
    print(f"[selfplay gate] {env_name}: one step of the twin on the card equals the CPU's "
          f"({B} lanes, {int(state['done'].sum())} of them finished): every state leaf, "
          f"{', '.join(w for w, _, _ in pairs[1:])}")


def ties_gate():
    """11(b): on the card, argmax and argmin take the first of tied values,
    and the rule-based twin picks the first tied direction (as the JAX
    twin and the host agent)."""
    import torch

    from handyrl_tpu_torch.envs.vector_hungry_geese import VectorHungryGeese

    x = torch.zeros(64, 9, device="cuda")
    x[:, 4:] = 1.0
    check((torch.argmax(x, -1) == 4).all() and (torch.argmin(x, -1) == 0).all(),
          "argmax/argmin on the card do not take the first of tied values")
    g = card_generator()
    state = VectorHungryGeese.init(2, g, "cuda")
    centre = 3 * 11 + 5
    cases = {(centre - 22, centre + 22): 0, (centre - 2, centre + 2): 2,
             (centre + 22, centre + 2): 1, (centre - 12, centre + 12): 0}
    for food, first in cases.items():
        s = {k: v.clone() for k, v in state.items()}
        s["cells"].zero_()
        s["cells"][:, 0, 0] = centre
        s["length"].zero_()
        s["length"][:, 0] = 1
        s["occ"].zero_()
        s["occ"][:, 0, centre] = 1
        s["active"].zero_()
        s["active"][:, 0] = True
        s["food"].zero_()
        for cell in food:
            s["food"][:, cell] = 1
        got = VectorHungryGeese.rule_based_action_all(s, g)
        check(int(got[0, 0]) == first, f"tie {food}: the card's rule-based twin picked {int(got[0, 0])}")
    print("[selfplay gate] argmax / argmin and the rule-based twin take the first tied value on "
          "the card")


def phase_selfplay(results):
    """11: on-device self-play and evaluation (no kernel on these paths)."""
    import torch

    print(f"[selfplay] {card_line()}")
    t0 = time.perf_counter()
    gen = card_generator()
    for env_name, train_args, lanes in SELFPLAY:
        roll, episodes = selfplay_rates(env_name, train_args, lanes, gen)
        for _ in range(16):   # long games (Geister's) may need more blocks
            if len(episodes) >= REPLAY_EPISODES:
                break
            episodes += roll.generate(None, gen)
        check(len(episodes) >= REPLAY_EPISODES,
              f"{env_name}: {len(episodes)} episodes, fewer than {REPLAY_EPISODES} to replay")
        steps = sum(replay_episode(env_name, ep, f"{env_name} episode {i}")
                    for i, ep in enumerate(episodes[:REPLAY_EPISODES]))
        print(f"[selfplay gate] {env_name}: {REPLAY_EPISODES} device episodes ({steps} steps) "
              "replay through the host env: every action legal, every observation and outcome "
              "equal")
        if hasattr(roll, "k_steps"):
            twin_cpu_gate(env_name, roll, gen)
        del roll, episodes
    ties_gate()
    t1 = time.perf_counter()
    device_geese_cli()
    t2 = time.perf_counter()
    device_drc_learner()
    t3 = time.perf_counter()
    print(f"[selfplay] phase 11 in {t3 - t0:.1f} s: (a)+(b) {t1 - t0:.1f} s, (c) {t2 - t1:.1f} s, "
          f"(d) {t3 - t2:.1f} s")


def check_plane(tag, record):
    """An epoch of a learner with device self-play ran on the fused plane
    with no watchdog stall (a watchdog that gave up records plane none)."""
    check(record.get("plane") == "fused", f"{tag} epoch {record['epoch']}: plane "
          f"{record.get('plane')!r}, not 'fused'")
    check(record.get("plane_watchdog_stalls") == 0, f"{tag} epoch {record['epoch']}: "
          f"{record.get('plane_watchdog_stalls')} watchdog stalls")


def device_geese_cli():
    """11(c): HungryGeese through ``python -m handyrl_tpu_torch.main
    --train`` with device self-play and device evaluation vs rulebase."""
    import yaml

    with tempfile.TemporaryDirectory() as tmp:
        Path(tmp, "config.yaml").write_text(yaml.safe_dump(
            {"env_args": {"env": "HungryGeese"}, "train_args": DEVICE_GEESE}))
        train_out, train_s = run_cli(tmp, "--train")
        records = read_records(os.path.join(tmp, "metrics.jsonl"))
        SELFPLAY_RECORDS["11(c)"] = records
        print_epochs("device geese", records, "rulebase")
        check(len(records) == DEVICE_GEESE["epochs"] and records[-1]["steps"] > 0,
              f"metrics.jsonl: {len(records)} records, expected {DEVICE_GEESE['epochs']} "
              "with steps > 0 on the last")
        check_shm("device geese", records, train_out)
        check("device eval failed" not in train_out, "the device evaluation failed: "
              + "; ".join(line for line in train_out.splitlines() if "device eval failed" in line))
        episodes0 = 0
        for r in records:
            check_plane("device geese", r)
            check(math.isfinite((r.get("loss") or {}).get("total", 0.0)), "non-finite epoch loss")
            n = r["episodes"] - episodes0
            episodes0 = r["episodes"]
            device = r.get("device_episodes", 0)
            share = device / n if n else 0.0
            # the learner names each opponent under device evaluation: only
            # games the device evaluator filed count here
            win = (r.get("win_rate") or {}).get("device-rulebase")
            check(win is not None, f"epoch {r['epoch']}: no device-rulebase win rate")
            print(f"[device geese] epoch {r['epoch']}: {r['updates_per_sec']:.2f} updates/s, "
                  f"episodes/s {r['episodes_per_sec'] * share:.1f} from the device and "
                  f"{r['episodes_per_sec'] * (1 - share):.1f} from host workers ({device} of {n}), "
                  f"device_mean_episode_len {r.get('device_mean_episode_len', float('nan')):.2f}, "
                  f"win rate vs device-rulebase {win:.3f}, "
                  f"input_wait_frac {r.get('input_wait_frac', float('nan')):.1%}, watchdog "
                  f"stalls {r['plane_watchdog_stalls']} restarts {r['plane_watchdog_restarts']}")
        check(any(r.get("device_episodes") for r in records), "no device episode reached the store")
        print(f"[device geese] --train {DEVICE_GEESE['epochs']} epochs with "
              f"device_rollout_games {DEVICE_GEESE['device_rollout_games']}, device_eval_games "
              f"{DEVICE_GEESE['device_eval_games']} in {train_s:.1f} s")


def device_drc_learner():
    """11(d): Geister with the DRC GeisterNet through ``Learner(args).run()``
    with device self-play, cut as 8a."""
    import torch

    from handyrl_tpu_torch.config import normalize_args
    from handyrl_tpu_torch.runtime.learner import Learner

    with tempfile.TemporaryDirectory() as tmp:
        cfg = normalize_args({
            "env_args": {"env": "Geister"},
            "train_args": dict(DRC_TRAIN_ARGS, minimum_episodes=DRC_EPISODES,
                               update_episodes=DRC_EPISODES, epochs=2,
                               worker={"num_parallel": 8}, seed=SEED, device_rollout_games=128,
                               model_dir=os.path.join(tmp, "models"),
                               metrics_path=os.path.join(tmp, "metrics.jsonl")),
        })
        gc.collect()
        learner = Learner(cfg)
        t0 = time.perf_counter()
        learner.run()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        records = read_records(cfg["train_args"]["metrics_path"])
        SELFPLAY_RECORDS["11(d)"] = records
        losses = [r["loss"]["total"] for r in records if "loss" in r]
        check(losses and all(math.isfinite(x) for x in losses), f"non-finite or no loss: {losses}")
        for r in records:
            check_plane("device drc", r)
        check(any(r.get("device_episodes") for r in records), "no device episode reached the store")
        check_shm("device drc", records)
        for r in records:
            print(f"[device drc] epoch {r['epoch']}: {r['updates_per_sec']:.2f} updates/s, "
                  f"{r['episodes_per_sec']:.2f} episodes/s, device episodes "
                  f"{r.get('device_episodes', 0)} of the epoch's, device_mean_episode_len "
                  f"{r.get('device_mean_episode_len', float('nan')):.1f}, loss {r['loss']['total'] if 'loss' in r else None}")
        print(f"[device drc] Geister DRC B{cfg['train_args']['batch_size']} with "
              f"device_rollout_games 128: {learner.trainer.steps} steps, "
              f"{learner.num_returned_episodes} episodes in {run_s:.1f} s")


# -- phase 12: the device data plane ------------------------------------------

# (a) the JAX package's north-star loop on 8b's args (bench.py:928-1050) and
# (b) its Geister turn mode with the DRC (bench.py:1452-1489): env args,
# train args, lanes, steps per rollout launch, ring slots, train calls per
# rollout launch
DATA_LOOPS = {
    "12(a) geese ff": ({"env": "HungryGeese"}, {
        "turn_based_training": False, "observation": False, "batch_size": 128,
        "forward_steps": 16, "fused_steps": 8, "seed": SEED}, 128, 32, 512, 16),
    "12(b) drc turn": ({"env": "Geister"}, {
        "observation": True, "batch_size": 16, "forward_steps": 8, "burn_in_steps": 4,
        "policy_target": "UPGO", "value_target": "UPGO", "fused_steps": 4, "seed": SEED},
        64, 32, 512, 2),
}
DATA_WINDOW = 2.0        # seconds of (a)'s and (b)'s timed windows
DATA_LR = 1e-5           # bench.py's lr for these loops
# (c) the transformer of phases 5-7 in turn mode from rings: lanes, slots,
# and the finished episodes the rings hold before the train calls
DATA_TRANSFORMER = (32, 1024, 16)
# (d): 11(c)'s and 11(d)'s learners with device_replay: true
DATA_GEESE_CLI = dict(DEVICE_GEESE, device_replay=True, device_rollout_games=128)
# (e): 8b's and 8a's learners, one epoch each, device and shm in turns, one
# run of each (depth cut to fit the time limit)
DATA_TURNS = ("device", "shm")
# (e)'s minimum_episodes and update_episodes: a one-epoch run trains on them
DATA_TURN_EPISODES = {"8b": (64, 64), "8a": (8, 16)}


def ring_bytes(replay):
    from handyrl_tpu_torch.utils import tree_leaves

    return sum(t.numel() * t.element_size() for t in tree_leaves(replay.rings)
               if hasattr(t, "numel"))


def check_rings_on_card(tag, replay):
    """(f): every ring tensor lives on the card."""
    from handyrl_tpu_torch.utils import tree_leaves

    tensors = [t for t in tree_leaves(replay.rings) if hasattr(t, "is_cuda")]
    check(tensors and all(t.is_cuda for t in tensors), f"{tag}: a ring tensor is not on the card")


def data_parts(env_args, train_args, lanes, k_steps, slots):
    """(args, rollout, replay, trainer context) of one on-card data loop,
    random weights from SEED, on the card."""
    from handyrl_tpu_torch.config import normalize_args
    from handyrl_tpu_torch.envs import make_env
    from handyrl_tpu_torch.models import init_variables
    from handyrl_tpu_torch.parallel import TrainContext
    from handyrl_tpu_torch.runtime.device_replay import DeviceReplay
    from handyrl_tpu_torch.runtime.device_rollout import StreamingDeviceRollout

    cfg = normalize_args({"env_args": env_args, "train_args": train_args})
    args = dict(cfg["train_args"], env=cfg["env_args"])
    env = make_env(cfg["env_args"])
    venv = env.vector_env()
    module = init_variables(env.net(), SEED)
    roll = StreamingDeviceRollout(venv, module, args, n_lanes=lanes, k_steps=k_steps)
    replay = DeviceReplay(venv, module, args, lanes, slots=slots)
    return args, roll, replay, TrainContext(module, args)


def prefill(tag, roll, replay, gen, eligible, limit=100):
    """Rollout launches into the rings until ``eligible`` window starts are
    sampleable; returns the launches and seconds it took."""
    import torch

    t0, n = time.perf_counter(), 0
    while replay.eligible_count() < eligible:
        check(n < limit, f"{tag}: {replay.eligible_count()} sampleable windows after {n} "
              "rollout launches")
        replay.ingest_counted(roll.launch(None, gen))
        n += 1
    torch.cuda.synchronize()
    return n, time.perf_counter() - t0


def data_loop(tag, env_args, train_args, lanes, k_steps, slots, calls):
    """12(a)/(b): rollout launch -> ring ingest -> ``calls`` train calls of
    fused_steps sample+step updates each, all on the card, timed over a
    window after a prefill and a warm-up call, as bench.py's loop."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    args, roll, replay, ctx = data_parts(env_args, train_args, lanes, k_steps, slots)
    fused, B, T = args["fused_steps"], args["batch_size"], args["forward_steps"]
    train = replay.train_fn(ctx, fused)
    gen = card_generator()
    launches, fill_s = prefill(tag, roll, replay, gen, B)
    train(gen, DATA_LR)          # warm-up: the allocator, cuDNN's algorithm search
    torch.cuda.synchronize()
    steps0, episodes0 = replay.counters["game_steps"], replay.counters["episodes"]
    updates, losses, rollout_s, spans = 0, [], 0.0, []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < DATA_WINDOW:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t1 = time.perf_counter()
        start.record()
        replay.ingest_counted(roll.launch(None, gen), defer=True)
        end.record()
        rollout_s += time.perf_counter() - t1
        spans.append((start, end))
        for _ in range(calls):
            m = train(gen, DATA_LR)
            check(m["sentinel_bad"] == 0 and math.isfinite(m["total"]),
                  f"{tag}: a non-finite or skipped update: {m}")
            losses.append(m["total"] / max(m["dcnt"], 1))
            updates += fused
    replay.flush_counted()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    rollout_card_s = sum(s.elapsed_time(e) for s, e in spans) / 1e3
    selfplay = replay.counters["game_steps"] - steps0
    episodes = replay.counters["episodes"] - episodes0
    check_rings_on_card(tag, replay)
    records = roll.launch(None, gen)
    torch.cuda.synchronize()
    _, ingest_ms, ingest_events, ingest_launches = profile_launches(lambda: replay.ingest(records))
    wall_ms, train_ms, train_events, train_launches = profile_launches(lambda: train(gen, DATA_LR))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"[data] {tag}: {type(roll.module).__name__}, {lanes} lanes x {k_steps} steps per "
          f"rollout launch, {slots} slots, B{B} x T{args['burn_in_steps']}+{T}, fused_steps "
          f"{fused}, {calls} train calls per rollout launch; prefill {launches} launches in "
          f"{fill_s:.2f} s")
    print(f"[data] {tag}: {updates / dt:.2f} updates/s, {updates * B * T / dt:.0f} trained "
          f"env-steps/s, {selfplay / dt:.1f} self-play env-steps/s ({episodes} episodes) over "
          f"{dt:.2f} s ({len(spans)} rollout launches, {updates} updates); the rollout's share of "
          f"the window {rollout_s / dt:.1%} on the host, {rollout_card_s / dt:.1%} by events on "
          f"the card; mean loss per sample {sum(losses) / len(losses):.4f}")
    print(f"[data] {tag}: launches per ingest {ingest_launches} ({ingest_events} device events, "
          f"{ingest_ms:.2f} ms of card time), per train call {train_launches} ({train_events} "
          f"device events, {train_ms:.1f} ms of card time in "
          f"{wall_ms:.1f} ms of wall, {train_ms / wall_ms:.1%} busy, {fused} updates); rings "
          f"{ring_bytes(replay) / 1e6:.1f} MB, peak memory {peak_gb:.2f} GB")
    return args, roll, replay, gen


def same_leaves(tag, what, got, want, float_tol=0.0):
    """Leaf by leaf: ints and bools equal, floats within ``float_tol``;
    returns the largest float difference."""
    import torch

    from handyrl_tpu_torch.utils import tree_leaves

    worst = 0.0
    for key in sorted(want):
        a, b = tree_leaves(got[key]), tree_leaves(want[key])
        check(len(a) == len(b), f"{tag} {what}: {key} has another structure")
        for x, y in zip(a, b):
            if not torch.is_tensor(y):
                check(x == y, f"{tag} {what}: {key} {x} != {y}")
                continue
            x = x.cpu()
            check(x.dtype == y.dtype and x.shape == y.shape, f"{tag} {what}: {key} dtype/shape")
            if y.is_floating_point():
                err = (x - y).abs().max().item() if y.numel() else 0.0
                worst = max(worst, err)
                check(err <= float_tol, f"{tag} {what}: {key} differs by {err:.3e}")
            else:
                check(torch.equal(x, y), f"{tag} {what}: {key} differs")
    return worst


def data_gates(tag, args, roll, replay, gen):
    """12(f): one ingest on the card equals the CPU's ingest of the same
    records, bit for bit; one sampled batch on the card equals the CPU's
    from the same rings and the same drawn starts and players."""
    import torch

    from handyrl_tpu_torch.runtime import device_replay
    from handyrl_tpu_torch.runtime.device_replay import DeviceReplay, _eligibility

    cpu = DeviceReplay(replay.venv, roll.module, replay.args, replay.n_lanes,
                       slots=replay.slots, device="cpu")
    rings = replay.rings
    cpu.rings = {"rec": {k: v.cpu() for k, v in rings["rec"].items()}, "g": rings["g"],
                 **{k: rings[k].cpu() for k in ("ep_start_g", "ep_end_g", "valid", "cur_start_g")}}
    records = roll.launch(None, gen)
    card_stats = replay.ingest(records).numpy()
    cpu_stats = cpu.ingest({k: v.cpu() for k, v in records.items()}).numpy()
    same_leaves(tag, "ingest rings", replay.rings, cpu.rings)
    # the counts exactly; the outcome sums are fp32 reductions in another
    # order, equal within 1e-5 of their size
    check(all(int(card_stats[k]) == int(cpu_stats[k])
              for k in ("episodes", "game_steps", "player_steps"))
          and all(abs(a - b) <= 1e-5 * max(1.0, abs(b))
                  for k in ("outcome_sum", "outcome_sq_sum")
                  for a, b in zip(card_stats[k].reshape(-1).tolist(),
                                  cpu_stats[k].reshape(-1).tolist())),
          f"{tag}: the ingest's stats differ between the card and the CPU: {card_stats}, "
          f"{cpu_stats}")
    n = 64
    ok = _eligibility(replay.rings, args["forward_steps"], args["burn_in_steps"]).reshape(-1)
    flat = device_replay._draw_starts(gen, ok, n)
    player = device_replay._draw_players(gen, n, replay.venv.num_players, flat.device)
    draws = (device_replay._draw_starts, device_replay._draw_players)
    device_replay._draw_starts = lambda g, ok, n: flat.to(ok.device)
    device_replay._draw_players = lambda g, n, P, device: player.to(device)
    try:
        card_batch = replay.sample(gen, n)
        cpu_batch = cpu.sample(torch.Generator(), n)
    finally:
        device_replay._draw_starts, device_replay._draw_players = draws
    err = same_leaves(tag, "sampled batch", card_batch, cpu_batch, float_tol=1e-6)
    print(f"[data gate] {tag}: rings on the card; one ingest ({records['done'].shape[0]} x "
          f"{replay.n_lanes} records) on the card equals the CPU's bit for bit, every ring leaf, "
          f"and its stats (counts equal, sums within 1e-5 relative); one sampled batch of {n} windows equals the CPU's from the same rings "
          f"and draws (ints and masks equal, floats within {err:.1e})")


def data_transformer(results):
    """12(c): the memory transformer trained in turn mode from rings through
    B1: B1 launched n_layers times per update, the loss finite and held
    against the einsum path on one sampled batch.  Returns B1's launches."""
    import torch

    from handyrl_tpu_torch.ops.flash_attention import MASKED_FLASH

    lanes, slots, finished = DATA_TRANSFORMER
    gc.collect()
    torch.cuda.empty_cache()
    env_args = {"env": "Geister", "net": "transformer", "net_args": NET_ARGS}
    args, roll, replay, ctx = data_parts(env_args, dict(TRAIN_ARGS, seq_attention="flash"),
                                         lanes, 32, slots)
    gen = card_generator()
    t0 = time.perf_counter()
    while replay.counters["episodes"] < finished:
        replay.ingest_counted(roll.launch(None, gen))
        check(replay.rings["g"] <= 40 * 32, f"12(c): {replay.counters['episodes']} episodes "
              "after 40 rollout launches")
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0
    check_rings_on_card("12(c)", replay)
    train = replay.train_fn(ctx, 1)
    MASKED_FLASH.launches = 0
    m0 = train(gen, DATA_LR)                                   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    m1 = train(gen, DATA_LR)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t1) * 1e3
    launches = MASKED_FLASH.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    per_step = launches_per_step(args)
    check(launches == 2 * per_step, f"12(c): B1 launched {launches} times in 2 updates, "
          f"expected {2 * per_step}")
    check(all(m["sentinel_bad"] == 0 and math.isfinite(m["total"]) for m in (m0, m1)),
          f"12(c): a non-finite or skipped update: {m0}, {m1}")
    results.setdefault("masked_flash_attention", {"launches": 0})["launches"] += launches
    print(f"[data] 12(c) transformer d{NET_ARGS['d_model']} L{NET_ARGS['n_layers']} turn mode "
          f"from rings ({lanes} lanes, {slots} slots, {replay.counters['episodes']} episodes, "
          f"{replay.rings['g']} steps in {fill_s:.1f} s): one train call B{args['batch_size']} x "
          f"T{args['forward_steps']} {args['compute_dtype']} {step_ms:.1f} ms, peak memory {peak_gb:.2f} GB, "
          f"loss per sample {m0['total'] / m0['dcnt']:.4f}, {m1['total'] / m1['dcnt']:.4f}; B1 "
          f"launched {launches} times in 2 "
          f"updates ({per_step} per update); rings {ring_bytes(replay) / 1e6:.1f} MB")
    flash_vs_einsum("data 12(c)", ctx.module, replay.sample(gen, args["batch_size"]), args)
    return launches


def beside(tag, records, other, key):
    """``key`` of each epoch of ``records``, with ``other``'s same epoch."""
    def fmt(r):
        v = r.get(key)
        if isinstance(v, float):
            return f"{v:.1%}" if key.endswith("frac") else f"{v:.2f}"
        return "n/a" if v is None else str(v)

    rows = [f"epoch {r['epoch']} {fmt(r)}"
            + (f" (11: {fmt(other[i])})" if other and i < len(other) else "")
            for i, r in enumerate(records)]
    print(f"[data] {tag} {key}: " + "; ".join(rows))


def data_replay_books(tag, records):
    """12(d)'s gates on a learner's records under device_replay: finite
    losses, every epoch on the fused plane with no watchdog stall, and every
    returned episode a device episode (host workers only evaluate)."""
    check(len(records) == 2 and records[-1]["steps"] > 0,
          f"{tag}: {len(records)} records, expected 2 with steps > 0 on the last")
    check(all(math.isfinite(r["loss"]["total"]) for r in records if "loss" in r),
          f"{tag}: a non-finite epoch loss")
    for r in records:
        check_plane(tag, r)
    device = sum(r.get("device_episodes", 0) for r in records)
    check(device == records[-1]["episodes"] > 0,
          f"{tag}: {device} device episodes of {records[-1]['episodes']} returned")


def data_learners():
    """12(d): 11(c)'s HungryGeese through ``--train`` and 11(d)'s DRC through
    ``Learner(args).run()``, both with ``device_replay: true``."""
    import torch
    import yaml

    from handyrl_tpu_torch.config import normalize_args
    from handyrl_tpu_torch.runtime.learner import Learner

    with tempfile.TemporaryDirectory() as tmp:
        Path(tmp, "config.yaml").write_text(yaml.safe_dump(
            {"env_args": {"env": "HungryGeese"}, "train_args": DATA_GEESE_CLI}))
        out, run_s = run_cli(tmp, "--train")
        records = read_records(os.path.join(tmp, "metrics.jsonl"))
        data_replay_books("12(d) geese", records)
        check("device eval failed" not in out, "12(d): the device evaluation failed")
        other = SELFPLAY_RECORDS.get("11(c)")
        for r in records + (other or []):
            r["device_rulebase"] = (r.get("win_rate") or {}).get("device-rulebase")
        for r in records:
            check(r["device_rulebase"] is not None,
                  f"12(d) epoch {r['epoch']}: no device-rulebase win rate")
        for key in ("updates_per_sec", "device_episodes", "device_mean_episode_len",
                    "device_rulebase", "input_wait_frac"):
            beside("12(d) geese --train, device_replay", records, other, key)
        print(f"[data] 12(d) geese: --train 2 epochs with device_replay, "
              f"{DATA_GEESE_CLI['device_rollout_games']} lanes, device_eval_games "
              f"{DATA_GEESE_CLI['device_eval_games']} in {run_s:.1f} s")

        cfg = normalize_args({"env_args": {"env": "Geister"}, "train_args": dict(
            DRC_TRAIN_ARGS, minimum_episodes=DRC_EPISODES, update_episodes=DRC_EPISODES,
            epochs=2, worker={"num_parallel": 8}, seed=SEED, device_rollout_games=128,
            device_replay=True, model_dir=os.path.join(tmp, "drc", "models"),
            metrics_path=os.path.join(tmp, "drc", "metrics.jsonl"))})
        gc.collect()
        learner = Learner(cfg)
        roles = []
        assign = learner._assign_role
        learner._assign_role = lambda: (lambda a: roles.append(a["role"]) or a)(assign())
        t0 = time.perf_counter()
        learner.run()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        records = read_records(cfg["train_args"]["metrics_path"])
        data_replay_books("12(d) drc", records)
        check(set(roles) <= {"e"}, f"12(d) drc: host workers were given roles {set(roles)}")
        check(len(learner.trainer.store) == 0, "12(d) drc: host episodes reached the store")
        other = SELFPLAY_RECORDS.get("11(d)")
        for key in ("updates_per_sec", "device_episodes", "device_mean_episode_len",
                    "input_wait_frac"):
            beside("12(d) drc Learner, device_replay", records, other, key)
        print(f"[data] 12(d) drc: Learner(args).run() with device_replay, 128 lanes: "
              f"{learner.trainer.steps} steps, {learner.num_returned_episodes} episodes, "
              f"{len(roles)} host jobs, all evaluations, in {run_s:.1f} s")


def data_pipeline_turns():
    """12(e): 8b's and 8a's learners under ``batch_pipeline: device`` and
    ``shm`` in turns, one epoch each; every device epoch live in mode
    device (a degrade to shm fails the phase)."""
    with tempfile.TemporaryDirectory() as tmp:
        for config in ("8b", "8a"):
            runs = []
            for pipeline in DATA_TURNS:
                r, stats, run_s = turn_run(config, pipeline, tmp, epochs=1,
                                           episodes=DATA_TURN_EPISODES)
                if pipeline == "shm":
                    check_shm(f"12(e) {config}", [r])
                else:
                    check(stats["mode"] == "device" and stats["chunks_flushed"] > 0,
                          f"12(e) {config}: the device pipeline {stats}")
                runs.append(r)
                staged = (f", {stats['episodes_staged']} episodes staged in "
                          f"{stats['chunks_flushed']} chunks" if pipeline == "device" else "")
                print(f"[data] 12(e) {config} {pipeline}: {r['updates_per_sec']:.3f} updates/s, "
                      f"{r['train_steps_per_sec']:.3f} steps/s while training, input wait "
                      f"{r['input_wait_frac']:.1%}, {r['pipe_batches']:.0f} batches, assemble "
                      f"{r['pipe_assemble_s']:.3f} s, put {r['pipe_put_s']:.3f} s, sample "
                      f"{r['pipe_sample_s']:.3f} s{staged}; the run took {run_s:.1f} s")


def phase_device_data(results):
    """12: the device data plane: rings on the card under the north-star
    loops, the transformer through B1, the learners with ``device_replay``
    and ``batch_pipeline: device``, and the card-vs-CPU gates."""
    import torch

    print(f"[data] {card_line()}")
    shm_before = set(os.listdir("/dev/shm"))
    times = [time.perf_counter()]
    for tag, (env_args, train_args, lanes, k_steps, slots, calls) in DATA_LOOPS.items():
        args, roll, replay, gen = data_loop(tag, env_args, train_args, lanes, k_steps, slots,
                                            calls)
        data_gates(tag, args, roll, replay, gen)
        del args, roll, replay
    times.append(time.perf_counter())
    data_transformer(results)
    torch.cuda.empty_cache()
    times.append(time.perf_counter())
    data_learners()
    times.append(time.perf_counter())
    data_pipeline_turns()
    times.append(time.perf_counter())
    segments, procs = leftovers(shm_before, os.environ.get(STREAM_ENV))
    check(not segments and not procs, f"outlived phase 12: segments {segments}, processes {procs}")
    parts = ", ".join(f"{tag} {t1 - t:.1f} s"
                      for tag, t, t1 in zip(("(a)+(b)+(f)", "(c)", "(d)", "(e)"), times, times[1:]))
    print(f"[data] phase 12 in {times[-1] - times[0]:.1f} s: {parts}")


# ---------------------------------------------------------------------------
# 13: the inference serving plane (--serve)
# ---------------------------------------------------------------------------

SERVE_CLIENTS = 8        # 13(a): closed-loop connections (bench.py's SERVING_CLIENTS)
SERVE_WINDOW = 8         # outstanding requests per connection
SERVE_SLO_MS = 25.0      # the open-loop legs' SLO
SERVE_LOOP_S = 4.0       # the closed-loop window; each open-loop leg takes half of it
SERVE_BUCKETS = [1, 2, 4, 8, 16, 32, 64]
SESSION_CONNS = 8        # 13(b): connections, each playing SESSION_GAMES games at once,
SESSION_GAMES = 32       # both seats of a game served, each by a session of its own
SESSION_RUN_S = 6.0
SESSION_SERVING = {
    "port": 0, "max_batch": 64, "warm_buckets": SERVE_BUCKETS, "shed_policy": "none",
    "session_capacity": 256, "session_spill": 1024, "watch_interval": 1, "stats_interval": 0,
}
DRAIN_DEADLINE_S = 10
CHECK_SESSIONS = 4       # 13(c): sessions replayed on the card, CHECK_STEPS steps each
CHECK_STEPS = 4
# 13(c)'s DRC leg: fp32 on both sides, the same bucket, the same card
DRC_SERVE_TOLERANCE = 1e-4


def serve_bench(tmp):
    """13(a): bench.py's serving legs on the port, TicTacToe with
    ``SimpleConvNet`` served on the card by this process: a closed loop
    (saturation QPS, the client's p50/p99), a hot swap under load, then an
    open loop at 0.25x and at 2x saturation against a 25 ms SLO."""
    import torch

    from handyrl_tpu_torch.envs import make_env
    from handyrl_tpu_torch.models import init_variables
    from handyrl_tpu_torch.serving import ModelRouter, ServingClient, ServingError, ServingServer
    from handyrl_tpu_torch.serving.batcher import percentiles_ms

    env = make_env({"env": "TicTacToe"})
    env.reset()
    obs = env.observation(0)
    module = env.net()
    p1 = {k: v.clone() for k, v in init_variables(module, 1).state_dict().items()}
    p2 = {k: v.clone() for k, v in init_variables(module, 2).state_dict().items()}
    base_cfg = {
        "port": 0, "max_models": 4, "slo_ms": 1000.0, "shed_policy": "none", "max_batch": 64,
        "max_wait_ms": 1.0, "warm_buckets": SERVE_BUCKETS, "queue_bound": 8192,
        "recv_timeout": 0.0, "watch_interval": 0.0, "stats_interval": 0.0,
    }

    def start_server(**overrides):
        cfg = dict(base_cfg, **overrides)
        router = ModelRouter(module, obs, cfg, model_dir=tmp)   # on the card
        router.publish(1, p1)
        check(router._engines[1].device.type == "cuda", "13(a): the engine is not on the card")
        return ServingServer(router, cfg).run()

    def closed_loop(port, dur, lat, counts, models=None, stop=None):
        """One connection keeping SERVE_WINDOW requests outstanding."""
        client = ServingClient("127.0.0.1", port)
        inflight = []
        end = time.perf_counter() + dur
        try:
            while time.perf_counter() < end and not (stop and stop.is_set()):
                while len(inflight) < SERVE_WINDOW:
                    inflight.append((time.perf_counter(), client.submit(obs)))
                t0, fut = inflight.pop(0)
                try:
                    reply = fut.result(timeout=120)
                    lat.append((time.perf_counter() - t0) * 1000.0)
                    counts["ok"] += 1
                    if models is not None:
                        models.append((time.perf_counter(), reply["model"]))
                except Exception:
                    counts["err"] += 1
            for _t0, fut in inflight:
                try:
                    fut.result(timeout=120)
                    counts["ok"] += 1
                except Exception:
                    counts["err"] += 1
        finally:
            client.close()

    def join_all(threads):
        for t in threads:
            t.join(180)
        check(not any(t.is_alive() for t in threads), "13(a): a load thread did not end")

    out = {}
    server = start_server()
    lats = [[] for _ in range(SERVE_CLIENTS)]
    counts = [dict(ok=0, err=0) for _ in range(SERVE_CLIENTS)]
    threads = [threading.Thread(target=closed_loop, daemon=True,
                                args=(server.bound_port, SERVE_LOOP_S, lats[i], counts[i]))
               for i in range(SERVE_CLIENTS)]
    before = server.stats_record()
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    join_all(threads)
    elapsed = time.perf_counter() - t0
    after = server.stats_record()
    pct = percentiles_ms([x for l in lats for x in l])
    out["saturation_qps"] = sum(c["ok"] for c in counts) / elapsed
    out["p50_ms"], out["p99_ms"] = pct[50], pct[99]
    out["load_errors"] = sum(c["err"] for c in counts)
    out["mean_batch"] = ((after["serve_replies"] - before["serve_replies"])
                         / max(1, after["serve_batches"] - before["serve_batches"]))

    # a hot swap under load, on the same warm server
    stop = threading.Event()
    swap_models = [[] for _ in range(SERVE_CLIENTS // 2)]
    swap_counts = [dict(ok=0, err=0) for _ in swap_models]
    threads = [threading.Thread(target=closed_loop, daemon=True,
                                args=(server.bound_port, 120.0, [], swap_counts[i],
                                      swap_models[i], stop))
               for i in range(len(swap_models))]
    for t in threads:
        t.start()
    time.sleep(1.0)
    admin = ServingClient("127.0.0.1", server.bound_port)
    t_swap = time.perf_counter()
    swap = admin.swap(2, params=p2)
    time.sleep(1.0)
    stop.set()
    join_all(threads)
    admin.close()
    events = sorted(e for l in swap_models for e in l)
    new_times = [t for t, m in events if m == 2]
    out["swap_warm_ms"] = swap["warm_ms"]
    out["swap_ttfr_ms"] = (new_times[0] - t_swap) * 1000.0 if new_times else None
    out["swap_dropped"] = sum(c["err"] for c in swap_counts)
    out["swap_flip_observed"] = {m for _, m in events} == {1, 2}
    out["server_errors"] = server.stats_record()["serve_errors"]
    server.shutdown()

    def open_loop(port, rate, dur, counters):
        """Paced offered load over several connections; callbacks sort the
        outcomes."""
        clients = [ServingClient("127.0.0.1", port) for _ in range(SERVE_CLIENTS // 2)]
        lock = threading.Lock()
        pending = [0]

        def cb(fut):
            try:
                fut.result()
                kind = "ok"
            except ServingError as exc:
                kind = "shed" if exc.kind in ("shed", "deadline") else "err"
            except Exception:
                kind = "err"
            with lock:
                counters[kind] = counters.get(kind, 0) + 1
                pending[0] -= 1

        start, sent = time.perf_counter(), 0
        try:
            while time.perf_counter() - start < dur:
                due = int((time.perf_counter() - start) * rate) - sent
                for _ in range(min(max(due, 0), 512)):
                    with lock:
                        pending[0] += 1
                    fut = clients[sent % len(clients)].submit(obs, slo_ms=SERVE_SLO_MS)
                    fut.add_done_callback(cb)
                    sent += 1
                time.sleep(0.002)
            counters["offered"] = sent
            deadline = time.perf_counter() + 60.0
            while time.perf_counter() < deadline:
                with lock:
                    if pending[0] == 0:
                        break
                time.sleep(0.005)
        finally:
            for client in clients:
                client.close()

    sat = max(out["saturation_qps"], 1.0)
    server = start_server(shed_policy="deadline", slo_ms=SERVE_SLO_MS)
    for tag, rate in (("low", 0.25 * sat), ("high", 2.0 * sat)):
        counters = {}
        open_loop(server.bound_port, rate, SERVE_LOOP_S / 2, counters)
        offered = max(counters.get("offered", 0), 1)
        out[f"offered_{tag}_qps"] = counters.get("offered", 0) / (SERVE_LOOP_S / 2)
        out[f"shed_rate_{tag}"] = counters.get("shed", 0) / offered
        out[f"errors_{tag}"] = counters.get("err", 0)
    server.shutdown()
    torch.cuda.empty_cache()
    return out


def geister_games(n, steps, seed):
    """``n`` sequences of ``steps`` observations of random Geister play,
    each the turn player's view."""
    from handyrl_tpu_torch.envs import make_env

    random.seed(seed)
    seqs = []
    for _ in range(n):
        env = make_env({"env": "Geister"})
        env.reset()
        seq = []
        for _ in range(steps):
            seq.append(env.observation(env.turn()))
            env.play(random.choice(env.legal_actions(env.turn())))
        seqs.append(seq)
    return seqs


def session_replay_check(tag, client, model, model_id, tol, seed):
    """13(c): CHECK_SESSIONS sessions through the server, CHECK_STEPS steps
    each, sent together so that they batch at one bucket; the same
    observations through ``model`` (an ``InferenceModel`` on the card) with
    an explicit hidden state, at that bucket.  Every output is held within
    ``tol`` of its scale.  Returns the sids, left open."""
    seqs = geister_games(CHECK_SESSIONS, CHECK_STEPS, seed)
    sids = [client.open_session() for _ in seqs]
    served = [session_step(client, seqs, sids, step, model=model_id)
              for step in range(CHECK_STEPS)]
    check(all(r["model"] == model_id for step in served for r in step),
          f"{tag}: a session step was not served by model {model_id}")
    worst = replay_error(tag, model, seqs, served)
    print(f"[serving] {tag}: {len(seqs)} sessions x {CHECK_STEPS} steps through the server "
          f"against the InferenceModel on the card with an explicit hidden state at bucket "
          f"{len(seqs)}: max_abs_err {worst:.3e} of the outputs' scale (tolerance {tol:.0e})")
    check(worst <= tol, f"{tag}: the served session outputs disagree with the replay")
    return sids


def session_step(client, seqs, sids, step, model=-1):
    """One step of every session, sent together so that they batch at one
    bucket; the replies in the sessions' order."""
    futs = [client.submit(seq[step], model=model, sid=sid) for seq, sid in zip(seqs, sids)]
    return [f.result(timeout=120) for f in futs]


def replay_error(tag, model, seqs, served):
    """The largest error, relative to max(1, the output's scale), of the
    served steps ``served[step][session]`` against the same observations
    through ``model`` on the card with an explicit hidden state, at the
    bucket of all the sessions."""
    import numpy as np
    import torch

    from handyrl_tpu_torch.models import fetch_outputs
    from handyrl_tpu_torch.utils import tree_stack

    worst = 0.0
    with torch.inference_mode():
        hidden = model.module.initial_state((len(seqs),), model.device)
        for step, replies in enumerate(served):
            out = model.inference_batch_async(tree_stack([seq[step] for seq in seqs]), hidden)
            hidden = out.pop("hidden")
            want = fetch_outputs(out)
            for i, reply in enumerate(replies):
                check(set(reply["out"]) == set(want), f"{tag}: output keys {sorted(reply['out'])}")
                for key, ref in want.items():
                    got = np.asarray(reply["out"][key])
                    check(got.shape == ref[i].shape and np.isfinite(got).all(),
                          f"{tag}: bad {key} {got.shape}")
                    err = float(np.abs(got - ref[i]).max())
                    worst = max(worst, err / max(1.0, float(np.abs(ref[i]).max())))
    return worst


class SessionPlayer:
    """One connection of 13(b): ``games`` Geister games at once, played by
    the served model against itself, each seat with a session of its own
    (2 x ``games`` sessions); the mover's session has the game's one
    request outstanding, and the action is sampled from the returned
    policy under the legal mask.  A finished game closes its sessions and
    opens new ones."""

    def __init__(self, port, games, seed):
        import queue

        import numpy as np

        from handyrl_tpu_torch.serving import ServingClient

        self.client = ServingClient("127.0.0.1", port)
        self.games = games
        self.rng = np.random.default_rng(seed)
        self.done = queue.Queue()
        self.latency, self.models = [], []
        self.steps = self.errors = self.finished = 0

    def _new_game(self):
        from handyrl_tpu_torch.envs import make_env

        env = make_env({"env": "Geister"})
        env.reset()
        return env, {p: self.client.open_session() for p in env.players()}

    def _close(self, game):
        for sid in game[1].values():
            self.client.close_session(sid)

    def _submit(self, i, game):
        env, sids = game
        turn = env.turn()
        t0 = time.perf_counter()
        self.client.submit(env.observation(turn), sid=sids[turn]).add_done_callback(
            lambda f, i=i, t0=t0: self.done.put((i, f, t0)))

    def run(self, end_t):
        """Play until ``end_t`` (perf_counter), which ``self.end_t`` may move
        while it runs."""
        import numpy as np

        from handyrl_tpu_torch.agents import masked_policy_logits, sample_logits

        self.end_t = end_t

        games = {i: self._new_game() for i in range(self.games)}
        for i, game in games.items():
            self._submit(i, game)
        outstanding = len(games)
        while outstanding:
            i, fut, t0 = self.done.get(timeout=120)
            outstanding -= 1
            env = games[i][0]
            try:
                reply = fut.result()
            except Exception:
                self.errors += 1
                self._close(games[i])
                continue
            self.latency.append((time.perf_counter() - t0) * 1000.0)
            self.models.append((time.perf_counter(), reply["model"]))
            turn = env.turn()
            logits = masked_policy_logits(np.reshape(reply["out"]["policy"], -1),
                                          env.legal_actions(turn))
            env.play(sample_logits(logits, 1.0, self.rng), turn)
            self.steps += 1
            if env.terminal() or time.perf_counter() >= self.end_t:
                self.finished += env.terminal()
                self._close(games[i])
                if time.perf_counter() >= self.end_t:
                    continue
                games[i] = self._new_game()
            self._submit(i, games[i])
            outstanding += 1
        self.client.close()


class CardMemory:
    """The card's used memory (nvidia-smi), sampled every half second on a
    thread until the block ends; ``peak_mib`` is the largest sample."""

    def __enter__(self):
        self.samples, self._stop = [], threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def _loop(self):
        while not self._stop.is_set():
            smi = subprocess.run(["nvidia-smi", "--query-gpu=memory.used",
                                  "--format=csv,noheader,nounits"],
                                 capture_output=True, text=True, timeout=60)
            if smi.returncode == 0:
                self.samples.append(float(smi.stdout.strip().splitlines()[0]))
            self._stop.wait(0.5)

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(60)
        self.peak_mib = max(self.samples, default=float("nan"))


def hidden_round_trip(model):
    """The hidden state's two copies per batch of max_batch sessions, as the
    server makes them: ``fetch_outputs`` brings the batch's next states to
    the host (D2H) and ``SessionCache.store`` copies each session's back to
    the card (H2D); then one whole batch (stack, forward, fetch) under the
    profiler."""
    import torch

    from handyrl_tpu_torch.fleet import SessionCache
    from handyrl_tpu_torch.models import fetch_outputs
    from handyrl_tpu_torch.serving import ContinuousBatcher
    from handyrl_tpu_torch.utils import tree_leaves, tree_map, tree_stack

    n = SESSION_SERVING["max_batch"]
    obs_list = [seq[0] for seq in geister_games(n, 1, SEED)]
    obs = tree_stack(obs_list)
    cache = SessionCache(capacity=n, spill_capacity=0, device=model.device)
    sids = [cache.open() for _ in range(n)]
    d2h, h2d = [], []
    with torch.inference_mode():
        hidden = model.module.initial_state((n,), model.device)
        for _ in range(5):
            hidden = model.inference_batch_async(obs, hidden)["hidden"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            host = fetch_outputs({"hidden": hidden})["hidden"]
            d2h.append((time.perf_counter() - t0) * 1e3)
            rows = [tree_map(lambda x: x[i, ...], host) for i in range(n)]
            t0 = time.perf_counter()
            for sid, row in zip(sids, rows):
                cache.store(sid, row)
            torch.cuda.synchronize()
            h2d.append((time.perf_counter() - t0) * 1e3)
    mb = sum(x.nbytes for x in tree_leaves(host)) / 1e6
    d2h_ms, h2d_ms = sorted(d2h)[2], sorted(h2d)[2]
    print(f"[serving] 13(b) the hidden state's round trip per batch of {n} sessions "
          f"({mb:.1f} MB): D2H (fetch_outputs) {d2h_ms:.2f} ms ({mb / d2h_ms:.2f} GB/s), H2D "
          f"(SessionCache.store, {n} sessions) {h2d_ms:.2f} ms ({mb / h2d_ms:.2f} GB/s); "
          "medians of 5")
    engine = ContinuousBatcher(model, [model.device], max_batch=n)
    hid_list = [cache.lookup(sid)[0] for sid in sids]
    with torch.inference_mode():
        engine._run(obs_list, hid_list, n)
        profile_call(f"one serving batch of {n} sessions (stack, forward, fetch)",
                     lambda: engine._run(obs_list, hid_list, n))


def wait_for_line(kids, tag, pattern, timeout):
    """The first match of ``pattern`` in a child's log, waiting for it."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        m = re.search(pattern, kids.output(tag))
        if m:
            return m
        if not kids.running(tag):
            break
        time.sleep(0.2)
    print(kids.output(tag)[-3000:])
    check(False, f"{tag}: no line matching {pattern!r}")


def serve_sessions(tmp):
    """13(b) and the transformer leg of 13(c): ``python -m
    handyrl_tpu_torch.main --serve`` on the training slice's transformer at
    full width, 512 sessions over 256 Geister games, a swap from disk and the
    SIGTERM drain."""
    import signal
    import zlib

    import torch

    from handyrl_tpu_torch.envs import make_env
    from handyrl_tpu_torch.models import build_inference_model, init_variables
    from handyrl_tpu_torch.runtime import checkpoint as ckpt
    from handyrl_tpu_torch.serving import ServingClient
    from handyrl_tpu_torch.serving.batcher import percentiles_ms

    env_args = {"env": "Geister", "net": "transformer", "net_args": NET_ARGS}
    config = {"env_args": env_args, "train_args": {
        "model_dir": "models", "metrics_path": "metrics.jsonl", "compute_dtype": "bfloat16",
        "drain_deadline_seconds": DRAIN_DEADLINE_S, "serving": SESSION_SERVING}}
    Path(tmp, "config.yaml").write_text(json.dumps(config))   # JSON is YAML
    model_dir = os.path.join(tmp, "models")
    t0 = time.perf_counter()
    module = make_env(env_args).net()
    params0 = {k: v.clone() for k, v in init_variables(module, SEED).state_dict().items()}
    ckpt.save_epoch_snapshot(model_dir, 1, params0, {"steps": 0}, 0)
    # seed 1 as 2.ckpt, written now and entered into the manifest mid-run
    blob = ckpt.to_bytes(init_variables(module, SEED + 1).state_dict())
    ckpt.atomic_write_bytes(ckpt.model_path(model_dir, 2), blob)
    digest = (zlib.crc32(blob), len(blob))
    del blob
    n_params = sum(p.numel() for p in module.parameters())
    print(f"[serving] 13(b) snapshots: seed {SEED} as epoch 1 (verified), seed {SEED + 1} "
          f"staged as 2.ckpt; {n_params} parameters, {digest[1] / 1e9:.2f} GB each, in "
          f"{time.perf_counter() - t0:.1f} s")
    replay = build_inference_model(module, params0)   # on the card
    del module, params0
    draining = threading.Event()
    with Children(tmp) as kids, CardMemory() as memory:
        t0 = time.perf_counter()
        proc = kids.start("serve", "--serve")
        port = int(wait_for_line(kids, "serve", r"serving: listening on port (\d+)", 600).group(1))
        check("(model 1," in kids.output("serve") and "device cuda" in kids.output("serve"),
              "13(b): the server did not publish snapshot 1 on the card")
        print(f"[serving] 13(b) --serve up in {time.perf_counter() - t0:.1f} s "
              "(import, snapshot load, engine build, 7 buckets warmed)")
        client = ServingClient("127.0.0.1", port, on_notice=lambda *_: draining.set())
        sids = session_replay_check("13(c) transformer", client, replay, 1,
                                    tolerance(torch.bfloat16), SEED)
        before = client.stats()
        players = [SessionPlayer(port, SESSION_GAMES, SEED + i) for i in range(SESSION_CONNS)]
        t0 = time.perf_counter()
        threads = [threading.Thread(target=p.run, args=(t0 + SESSION_RUN_S,), daemon=True)
                   for p in players]
        for t in threads:
            t.start()
        time.sleep(SESSION_RUN_S / 2)
        ckpt.record_snapshot(model_dir, 2, 0, {"2.ckpt": digest})   # the watcher's swap
        t_publish = time.perf_counter()
        for t in threads:
            t.join(SESSION_RUN_S + 300)
        check(not any(t.is_alive() for t in threads), "13(b): a session player did not end")
        window = time.perf_counter() - t0
        after = client.stats()
        steps = sum(p.steps for p in players)
        pct = percentiles_ms([x for p in players for x in p.latency])
        batches = after["serve_batches"] - before["serve_batches"]
        events = sorted(e for p in players for e in p.models)
        flipped = [t for t, m in events if m == 2]
        print(f"[serving] 13(b) {SESSION_CONNS} connections x {2 * SESSION_GAMES} sessions "
              f"({SESSION_CONNS * SESSION_GAMES} Geister games at once, both seats served, "
              f"{sum(p.finished for p in players)} finished) for {window:.1f} s: "
              f"{steps / window:.1f} session steps/s, p50 {pct[50]:.2f} ms, p99 {pct[99]:.2f} ms "
              f"(client), mean batch {(after['serve_replies'] - before['serve_replies']) / max(1, batches):.2f}; "
              f"session_restored {after['session_restored']}, evictions "
              f"{after['session_evictions']}, spill drops {after['session_spill_drops']}, "
              f"affinity misses {after['session_affinity_miss']}; errors "
              f"{sum(p.errors for p in players)} (server {after['serve_errors']})")
        check(sum(p.errors for p in players) == 0 and after["serve_errors"] == 0,
              "13(b): error replies under the session load")
        check(after["session_restored"] > 0 and after["session_evictions"] > 0,
              f"13(b): {2 * SESSION_CONNS * SESSION_GAMES} sessions over a capacity of "
              f"{SESSION_SERVING['session_capacity']} restored or evicted nothing")
        swap_line = wait_for_line(kids, "serve", r"hot-swapped to verified snapshot 2", 120)
        probe = geister_games(1, 1, SEED)[0][0]
        deadline = time.monotonic() + 120
        while client.infer(probe, timeout=120)["model"] != 2:
            check(time.monotonic() < deadline, "13(b): the replies never came from model 2")
            time.sleep(0.2)
        check(swap_line and "refresh failed" not in kids.output("serve"),
              "13(b): the watcher's refresh failed")
        print(f"[serving] 13(b) swap from disk: seed {SEED + 1} entered the manifest as epoch 2 "
              f"at {t_publish - t0:.1f} s; the watcher swapped it in, "
              + (f"the first reply from model 2 {(flipped[0] - t_publish) * 1e3:.0f} ms later, "
                 f"{len(flipped)} replies from it in the window"
                 if flipped else "after the window")
              + f"; hot swaps {client.stats()['serve_hot_swaps']}, errors 0")
        hidden_round_trip(replay)
        # the drain: only 13(c)'s sessions are still open
        t_term = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        check(draining.wait(30), "13(b): no draining notice after SIGTERM")
        exported = client.export_sessions(timeout=60)
        check(exported["count"] == len(sids) and set(sids) <= set(exported["sessions"]),
              f"13(b): the drain exported {exported['count']} sessions, not {len(sids)}")
        try:
            code = proc.wait(timeout=DRAIN_DEADLINE_S + 30)
        except subprocess.TimeoutExpired:
            code = None
        drain_s = time.perf_counter() - t_term
        client.close()
        log = kids.output("serve")
        check(code == 75 and "serving: SIGTERM — draining sessions" in log
              and "sessions handed off: True" in log,
              f"13(b): the SIGTERM drain exited {code}:\n{log[-2000:]}")
        check(drain_s <= DRAIN_DEADLINE_S, f"13(b): the drain took {drain_s:.1f} s")
        peak = re.search(r"serving: peak device memory .*", log)
        print(f"[serving] 13(b) SIGTERM: draining notice, {exported['count']} sessions exported "
              f"({sum(x.nbytes for h in exported['sessions'].values() for x in _leaves(h)) / 1e6:.1f} MB), "
              f"exit {code} {drain_s:.2f} s after the signal (deadline {DRAIN_DEADLINE_S} s); "
              f"{peak.group(0) if peak else 'no peak memory line'}")
    print(f"[serving] 13(b) card memory used (nvidia-smi), peak over the leg: "
          f"{memory.peak_mib:.0f} MiB, every process on the card included (other phases run beside this one)")
    del replay
    torch.cuda.empty_cache()


def drc_session_check(tmp):
    """13(c)'s DRC leg: the DRC ``GeisterNet`` at its defaults in fp32 (the
    session model of bench.py's fleet stage) served on the card by this
    process."""
    import torch

    from handyrl_tpu_torch.envs import make_env
    from handyrl_tpu_torch.models import build_inference_model, init_variables
    from handyrl_tpu_torch.serving import ModelRouter, ServingClient, ServingServer

    env = make_env({"env": "Geister"})
    env.reset()
    module = init_variables(env.net(), SEED)
    params = module.state_dict()
    # max_wait 50 ms: the four sessions of a step gather into one bucket
    cfg = dict(SESSION_SERVING, max_batch=CHECK_SESSIONS, warm_buckets=[1, CHECK_SESSIONS],
               max_wait_ms=50.0, watch_interval=0)
    router = ModelRouter(module, env.observation(0), cfg, model_dir=tmp)
    router.publish(1, params)
    server = ServingServer(router, cfg).run()
    client = ServingClient("127.0.0.1", server.bound_port)
    try:
        before = router.stats()["batches_served"]
        session_replay_check("13(c) DRC GeisterNet fp32", client,
                             build_inference_model(module, params), 1, DRC_SERVE_TOLERANCE,
                             SEED + 2)
        print(f"[serving] 13(c) DRC: {router.stats()['batches_served'] - before} batches for "
              f"{CHECK_STEPS} steps of {CHECK_SESSIONS} sessions")
    finally:
        client.close()
        server.shutdown()
    torch.cuda.empty_cache()


def phase_serving(results):
    """13: the inference serving plane: (a) bench.py's serving legs, (b)
    ``--serve`` with the transformer's KV-cache sessions at full width, (c)
    served sessions against a replay on the card.  No kernel on this path."""
    print(f"[serving] {card_line()}")
    times = [time.perf_counter()]
    with tempfile.TemporaryDirectory() as tmp:
        a = serve_bench(tmp)
        print(f"[serving] 13(a) TicTacToe SimpleConvNet, closed loop {SERVE_CLIENTS} connections "
              f"x {SERVE_WINDOW} outstanding for {SERVE_LOOP_S:.0f} s: "
              f"{a['saturation_qps']:.1f} req/s, p50 {a['p50_ms']:.2f} ms, p99 "
              f"{a['p99_ms']:.2f} ms (client), mean batch {a['mean_batch']:.2f}; errors "
              f"{a['load_errors']}")
        print(f"[serving] 13(a) hot swap under load: warm {a['swap_warm_ms']:.1f} ms, first reply "
              f"from the new model {a['swap_ttfr_ms'] or float('nan'):.1f} ms after the swap "
              f"call, dropped "
              f"{a['swap_dropped']}, flip observed {a['swap_flip_observed']}")
        print(f"[serving] 13(a) open loop against a {SERVE_SLO_MS:.0f} ms SLO: 0.25x "
              f"({a['offered_low_qps']:.1f} req/s offered) shed {a['shed_rate_low']:.4f}, 2x "
              f"({a['offered_high_qps']:.1f} req/s offered) shed {a['shed_rate_high']:.4f}; "
              f"errors {a['errors_low']} / {a['errors_high']}")
        check(a["swap_dropped"] == 0 and a["swap_flip_observed"], "13(a): the hot swap failed")
        check(a["shed_rate_low"] < a["shed_rate_high"], "13(a): shedding did not follow the load")
        check(a["load_errors"] == a["server_errors"] == a["errors_low"] == a["errors_high"] == 0,
              "13(a): error frames")
        times.append(time.perf_counter())
        serve_sessions(tmp)
        times.append(time.perf_counter())
        drc_session_check(tmp)
        times.append(time.perf_counter())
    parts = ", ".join(f"{tag} {t1 - t:.1f} s"
                      for tag, t, t1 in zip(("(a)", "(b)+(c) transformer", "(c) DRC"),
                                            times, times[1:]))
    print(f"[serving] phase 13 in {times[-1] - times[0]:.1f} s: {parts}")




FLEET_TURN_S = 2.0         # 14(a): each closed-loop turn, through the fleet or direct
FLEET_SESSION_GAMES = 16   # 14(b): SESSION_CONNS x 16 games x 2 seats = 256 sessions
FLEET_FAULT_REPLIES = 1500 # 14(b): the victim SIGTERMs itself after this many replies
FLEET_AFTER_S = 4.0        # 14(b): the load's seconds after the victim's exit
FLEET_DRAIN_S = 30         # 14(b): the replicas' drain_deadline_seconds
AUTOSCALE_OFFERED = 1.5    # 14(c): the open loop, in multiples of one replica's saturation
LEARNER_EPISODES = 8       # 14(d): minimum_episodes and update_episodes of config.yaml's learner
SIGTERM_STEP = 20          # 14(d): HANDYRL_FAULT_SIGTERM_AT_STEP
TRACE_TURNS = 2            # 14(d): turns of a run with tracing on and one off, the order
                           # alternating (on, off, off, on)


def closed_loop_load(port, obs, conns, window, dur, stop=None, slo_ms=None):
    """``conns`` connections, each keeping ``window`` requests outstanding
    on ``port`` for ``dur`` seconds (or until ``stop``), with the SLO
    ``slo_ms`` (the server's default if None): req/s, the client's p50/p99
    ms, the replies and errors, and each reply's (time, model)."""
    from handyrl_tpu_torch.serving import ServingClient
    from handyrl_tpu_torch.serving.batcher import percentiles_ms

    lock = threading.Lock()
    lats, events, counts = [], [], {"ok": 0, "err": 0}

    def settle(t0, fut):
        try:
            reply = fut.result(timeout=120)
        except Exception:
            with lock:
                counts["err"] += 1
            return
        t = time.perf_counter()
        with lock:
            counts["ok"] += 1
            lats.append((t - t0) * 1e3)
            events.append((t, reply["model"]))

    def one():
        client = ServingClient("127.0.0.1", port)
        inflight = []
        end = time.perf_counter() + dur
        try:
            while time.perf_counter() < end and not (stop and stop.is_set()):
                while len(inflight) < window:
                    inflight.append((time.perf_counter(), client.submit(obs, slo_ms=slo_ms)))
                settle(*inflight.pop(0))
            for item in inflight:
                settle(*item)
        finally:
            client.close()

    threads = [threading.Thread(target=one, daemon=True) for _ in range(conns)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(dur + 180)
    check(not any(t.is_alive() for t in threads), "a load thread did not end")
    elapsed = time.perf_counter() - t0
    pct = percentiles_ms(lats)
    return {"qps": counts["ok"] / elapsed, "p50": pct[50], "p99": pct[99], "ok": counts["ok"],
            "err": counts["err"], "events": events}


def open_loop_load(port, obs, rate_at, stop, events):
    """Paced offered load on ``port`` over SERVE_CLIENTS // 2 connections
    until ``stop``: ``rate_at(t)`` req/s at ``t`` seconds in, each request
    with the SLO SERVE_SLO_MS; each outcome goes to ``events`` as (time,
    'ok' | 'shed' | 'err')."""
    from handyrl_tpu_torch.serving import ServingClient, ServingError

    clients = [ServingClient("127.0.0.1", port) for _ in range(SERVE_CLIENTS // 2)]
    lock = threading.Lock()
    pending = [0]

    def done(fut):
        try:
            fut.result()
            kind = "ok"
        except ServingError as exc:
            kind = "shed" if exc.kind in ("shed", "deadline") else "err"
        except Exception:
            kind = "err"
        with lock:
            events.append((time.perf_counter(), kind))
            pending[0] -= 1

    start, sent, due_f = time.perf_counter(), 0, 0.0
    last = start
    try:
        while not stop.is_set():
            now = time.perf_counter()
            due_f += (now - last) * rate_at(now - start)
            last = now
            for _ in range(min(max(int(due_f) - sent, 0), 512)):
                with lock:
                    pending[0] += 1
                fut = clients[sent % len(clients)].submit(obs, slo_ms=SERVE_SLO_MS)
                fut.add_done_callback(done)
                sent += 1
            time.sleep(0.002)
        deadline = time.perf_counter() + 60.0
        while time.perf_counter() < deadline:
            with lock:
                if pending[0] == 0:
                    break
            time.sleep(0.005)
    finally:
        for client in clients:
            client.close()


def write_config(path, config):
    Path(path).mkdir(parents=True, exist_ok=True)
    Path(path, "config.yaml").write_text(json.dumps(config))   # JSON is YAML


def fleet_tictactoe(tmp):
    """14(a): ``python -m handyrl_tpu_torch.main --fleet`` over two
    ``--serve`` replica processes (TicTacToe ``SimpleConvNet`` on the card),
    13(a)'s load in turns through the fleet and direct to one replica, then
    a fleet-wide swap under load."""
    import signal

    from handyrl_tpu_torch.envs import make_env
    from handyrl_tpu_torch.models import init_variables
    from handyrl_tpu_torch.serving import ServingClient

    env = make_env({"env": "TicTacToe"})
    env.reset()
    obs = env.observation(0)
    serving = {"port": 0, "max_models": 4, "slo_ms": 1000.0, "shed_policy": "none",
               "max_batch": 64, "max_wait_ms": 1.0, "warm_buckets": SERVE_BUCKETS,
               "queue_bound": 8192, "watch_interval": 0, "stats_interval": 0}
    rep_dir, fleet_dir = os.path.join(tmp, "replicas"), os.path.join(tmp, "fleet")
    write_config(rep_dir, {"env_args": {"env": "TicTacToe"},
                           "train_args": {"seed": SEED, "model_dir": "models", "serving": serving}})
    out = {}
    with Children(tmp) as kids:
        for i in range(2):
            kids.start(f"rep{i}", "--serve", cwd=rep_dir)
        ports = [int(wait_for_line(kids, f"rep{i}", r"serving: listening on port (\d+)",
                                   300).group(1)) for i in range(2)]
        check(all("device cuda" in kids.output(f"rep{i}") for i in range(2)),
              "14(a): a replica is not on the card")
        write_config(fleet_dir, {"env_args": {"env": "TicTacToe"}, "train_args": {"fleet": {
            "port": 0, "stats_poll_s": 0.5, "stats_interval": 0,
            "replicas": [f"127.0.0.1:{p}" for p in ports]}}})
        fleet = kids.start("fleet", "--fleet", cwd=fleet_dir)
        fport = int(wait_for_line(kids, "fleet", r"fleet: entry port (\d+)", 120).group(1))
        turns = {"fleet": [], "direct": []}
        for tag in ("fleet", "direct", "fleet", "direct"):
            turn = closed_loop_load(fport if tag == "fleet" else ports[0], obs, SERVE_CLIENTS,
                                    SERVE_WINDOW, FLEET_TURN_S)
            turns[tag].append(turn)
            print(f"[fleet] 14(a) {tag:6s} closed loop {SERVE_CLIENTS} connections x "
                  f"{SERVE_WINDOW} outstanding for {FLEET_TURN_S:.0f} s: {turn['qps']:.1f} req/s, "
                  f"p50 {turn['p50']:.2f} ms, p99 {turn['p99']:.2f} ms (client); errors "
                  f"{turn['err']}")
        check(all(t["err"] == 0 for ts in turns.values() for t in ts), "14(a): error replies")
        # the fleet-wide swap under load: every replica warms and flips in turn
        p2 = {k: v.numpy() for k, v in init_variables(env.net(), SEED + 1).state_dict().items()}
        stop, loaded = threading.Event(), {}
        load = threading.Thread(target=lambda: loaded.update(closed_loop_load(
            fport, obs, SERVE_CLIENTS // 2, SERVE_WINDOW, 120.0, stop)), daemon=True)
        load.start()
        time.sleep(1.0)
        admin = ServingClient("127.0.0.1", fport)
        t_swap = time.perf_counter()
        swap = admin.swap(1, params=p2)
        swap_s = time.perf_counter() - t_swap
        time.sleep(1.0)
        stop.set()
        load.join(300)
        stats = admin.stats()
        admin.close()
        new = [t for t, m in loaded["events"] if m == 1]
        print(f"[fleet] 14(a) fleet-wide swap under load: {swap['replicas']} replicas flipped in "
              f"{swap_s * 1e3:.1f} ms (warm {swap['warm_ms']:.1f} ms summed), the first reply "
              f"from the new model {(new[0] - t_swap) * 1e3 if new else float('nan'):.1f} ms "
              f"after the swap call; dropped {loaded['err']}; fleet errors "
              f"{stats['fleet_errors']}, replica errors "
              f"{[r['serve_errors'] for r in stats['replicas'].values()]}")
        check(swap["replicas"] == 2 and {m for _, m in loaded["events"]} == {0, 1},
              "14(a): the fleet-wide swap did not flip both replicas")
        check(loaded["err"] == 0 and stats["fleet_errors"] == 0
              and all(r["serve_errors"] == 0 for r in stats["replicas"].values()),
              "14(a): error frames across the swap")
        fleet.send_signal(signal.SIGTERM)
        check(fleet.wait(60) == 0, f"14(a): --fleet exited {fleet.poll()} after SIGTERM")
        for i in range(2):
            proc = kids.procs[f"rep{i}"][0]
            proc.send_signal(signal.SIGTERM)
            check(proc.wait(60) == 75, f"14(a): replica {i} exited {proc.poll()} after SIGTERM")
    for tag in turns:
        qps = sorted(t["qps"] for t in turns[tag])
        out[tag] = {"qps": qps, "p50": [t["p50"] for t in turns[tag]],
                    "p99": [t["p99"] for t in turns[tag]]}
    f, d = out["fleet"], out["direct"]
    print(f"[fleet] 14(a) the router's cost (turns fleet/direct/fleet/direct): "
          f"{f['qps'][0]:.1f}-{f['qps'][1]:.1f} req/s through the fleet over 2 replicas against "
          f"{d['qps'][0]:.1f}-{d['qps'][1]:.1f} direct to one; p50 "
          f"{min(f['p50']):.2f}-{max(f['p50']):.2f} ms against "
          f"{min(d['p50']):.2f}-{max(d['p50']):.2f}, p99 {min(f['p99']):.2f}-{max(f['p99']):.2f} "
          f"ms against {min(d['p99']):.2f}-{max(d['p99']):.2f}")
    return out


def fleet_sessions(tmp):
    """14(b): the training slice's transformer at full width in two
    ``--serve`` replica processes behind the fleet, 256 sessions of Geister
    self-play; the victim, ``HANDYRL_FAULT_SIGTERM_REPLICA``, drains mid-load
    and its sessions migrate to the survivor."""
    import signal

    import torch

    from handyrl_tpu_torch.envs import make_env
    from handyrl_tpu_torch.fleet import FleetRouter
    from handyrl_tpu_torch.models import build_inference_model, init_variables
    from handyrl_tpu_torch.runtime import checkpoint as ckpt
    from handyrl_tpu_torch.serving import ServingClient

    env_args = {"env": "Geister", "net": "transformer", "net_args": NET_ARGS}
    model_dir = os.path.join(tmp, "fleet_models")
    module = make_env(env_args).net()
    params0 = {k: v.clone() for k, v in init_variables(module, SEED).state_dict().items()}
    ckpt.save_epoch_snapshot(model_dir, 1, params0, {"steps": 0}, 0)
    replay = build_inference_model(module, params0)   # on the card
    del module, params0
    rep_dir = os.path.join(tmp, "session_replicas")
    write_config(rep_dir, {"env_args": env_args, "train_args": {
        "model_dir": model_dir, "compute_dtype": "bfloat16",
        "drain_deadline_seconds": FLEET_DRAIN_S,
        "serving": dict(SESSION_SERVING, session_capacity=512, watch_interval=0)}})
    n_sessions = 2 * SESSION_CONNS * FLEET_SESSION_GAMES
    with Children(tmp) as kids, CardMemory() as memory:
        t0 = time.perf_counter()
        kids.start("victim", "--serve", cwd=rep_dir,
                   env={"HANDYRL_FAULT_SIGTERM_REPLICA": str(FLEET_FAULT_REPLIES)})
        kids.start("survivor", "--serve", cwd=rep_dir)
        ports = {tag: int(wait_for_line(kids, tag, r"serving: listening on port (\d+)",
                                        600).group(1)) for tag in ("victim", "survivor")}
        print(f"[fleet] 14(b) two --serve replicas of the transformer up in "
              f"{time.perf_counter() - t0:.1f} s")
        fleet = FleetRouter({
            "port": 0, "stats_poll_s": 0.5, "replica_stall_s": 120.0, "rejoin_backoff_s": 1.0,
            "rejoin_backoff_max_s": 5.0, "stats_interval": 0, "migrate_timeout_s": 60.0,
            "replicas": [f"127.0.0.1:{ports[t]}" for t in ("victim", "survivor")],
        }).run(connect_timeout=120)
        client = None
        try:
            vrep = next(r for r in fleet._reps() if r.spec.port == ports["victim"])
            export, moved = vrep.client.export_sessions, {}

            def measured_export(timeout=60.0):
                t = time.perf_counter()
                reply = export(timeout=timeout)
                moved.update(s=time.perf_counter() - t, count=len(reply["sessions"]),
                             bytes=sum(x.nbytes for h in reply["sessions"].values()
                                       for x in _leaves(h)))
                return reply

            vrep.client.export_sessions = measured_export
            client = ServingClient("127.0.0.1", fleet.bound_port)
            # CHECK_SESSIONS sessions on the victim: half their steps before
            # the load, half after the migration, each step at one bucket
            sids, others = [], []
            while len(sids) < CHECK_SESSIONS:
                sid = client.open_session()
                (sids if fleet._affinity[sid] is vrep else others).append(sid)
                check(len(others) < 64, "14(b): no session lands on the victim")
            for sid in others:
                client.close_session(sid)
            seqs = geister_games(CHECK_SESSIONS, CHECK_STEPS, SEED + 3)
            half = CHECK_STEPS // 2
            served = [session_step(client, seqs, sids, k) for k in range(half)]
            players = [SessionPlayer(fleet.bound_port, FLEET_SESSION_GAMES, SEED + 10 + i)
                       for i in range(SESSION_CONNS)]
            t_load = time.perf_counter()
            threads = [threading.Thread(target=p.run, args=(t_load + 600,), daemon=True)
                       for p in players]
            for t in threads:
                t.start()
            vproc = kids.procs["victim"][0]
            t_notice = None
            deadline = time.monotonic() + 300
            while vproc.poll() is None and time.monotonic() < deadline:
                if t_notice is None and fleet.preempt_drains:
                    t_notice = time.perf_counter()
                time.sleep(0.005)
            t_exit, code = time.perf_counter(), vproc.poll()
            check(code == 75 and t_notice is not None,
                  f"14(b): the victim exited {code}, draining notice seen: {t_notice is not None}"
                  f"\n{kids.output('victim')[-2000:]}")
            deadline = time.monotonic() + 60
            while not all(fleet._affinity.get(s) is not None
                          and fleet._affinity[s].spec.port == ports["survivor"] for s in sids):
                check(time.monotonic() < deadline, "14(b): affinity never flipped")
                time.sleep(0.01)
            t_end = time.perf_counter() + FLEET_AFTER_S
            for p in players:
                p.end_t = t_end
            for t in threads:
                t.join(300)
            check(not any(t.is_alive() for t in threads), "14(b): a session player did not end")
            served += [session_step(client, seqs, sids, k) for k in range(half, CHECK_STEPS)]
            stats = client.stats()
        finally:
            if client is not None:
                client.close()
            fleet.shutdown()
        survivor = stats["replicas"][f"127.0.0.1:{ports['survivor']}"]
        times = [t for p in players for t, _ in p.models]
        before = sum(1 for t in times if t < t_notice) / (t_notice - t_load)
        after = sum(1 for t in times if t > t_exit) / (t_end - t_exit)
        errors = sum(p.errors for p in players)
        print(f"[fleet] 14(b) {SESSION_CONNS} connections x {2 * FLEET_SESSION_GAMES} sessions "
              f"({n_sessions} at once) through the fleet: {before:.1f} session steps/s over 2 "
              f"replicas for {t_notice - t_load:.1f} s, {after:.1f} on the survivor for "
              f"{t_end - t_exit:.1f} s after the drain; errors {errors} (fleet "
              f"{stats['fleet_errors']}), survivor affinity misses "
              f"{survivor['session_affinity_miss']}, restores {survivor['session_restored']}")
        print(f"[fleet] 14(b) the victim's drain: {fleet.sessions_migrated} sessions "
              f"({moved.get('bytes', 0) / 1e6:.1f} MB) migrated in {fleet.last_migration_ms:.1f} "
              f"ms (the export's wire {moved.get('s', float('nan')) * 1e3:.1f} ms, "
              f"{moved.get('bytes', 0) / 1e6 / max(fleet.last_migration_ms / 1e3, 1e-9):.1f} MB/s "
              f"over the whole handoff); draining notice to exit {t_exit - t_notice:.2f} s "
              f"(deadline {FLEET_DRAIN_S} s), exit {code}")
        check(errors == 0 and stats["fleet_errors"] == 0, "14(b): error replies under the drain")
        check(survivor["session_affinity_miss"] == 0 and fleet.sessions_migrated > CHECK_SESSIONS
              and stats["fleet_preempt_drains"] == 1 and survivor["session_migrated_in"] > 0,
              "14(b): the victim's sessions did not migrate whole")
        sproc = kids.procs["survivor"][0]
        sproc.send_signal(signal.SIGTERM)
        check(sproc.wait(FLEET_DRAIN_S + 30) == 75, f"14(b): the survivor exited {sproc.poll()}")
        for tag in ("victim", "survivor"):
            peak = re.search(r"serving: peak device memory .*", kids.output(tag))
            print(f"[fleet] 14(b) {tag}: {peak.group(0) if peak else 'no peak memory line'}")
    worst = replay_error("14(b)", replay, seqs, served)
    tol = tolerance(torch.bfloat16)
    print(f"[fleet] 14(b) {CHECK_SESSIONS} migrated sessions x {CHECK_STEPS} steps ({half} on the "
          f"victim, {CHECK_STEPS - half} on the survivor from the migrated state) against the "
          f"InferenceModel on the card with an explicit hidden state: max_abs_err {worst:.3e} "
          f"of the outputs' scale (tolerance {tol:.0e}); card memory used (nvidia-smi), peak "
          f"{memory.peak_mib:.0f} MiB, every process on the card included (other phases run beside this one)")
    check(worst <= tol, "14(b): a migrated session disagrees with the replay")
    del replay
    torch.cuda.empty_cache()


def fleet_autoscale(tmp):
    """14(c): ``fleet.autoscale`` over ``ProcessReplicaFactory`` replicas
    (TicTacToe, max_batch 1) under an open loop above one replica's
    saturation: the scale-up's replica serves only once warm; calm then
    retires it through the migration."""
    from handyrl_tpu_torch.config import normalize_args
    from handyrl_tpu_torch.envs import make_env
    from handyrl_tpu_torch.fleet import FleetRouter, ProcessReplicaFactory
    from handyrl_tpu_torch.serving import ServingClient

    env = make_env({"env": "TicTacToe"})
    env.reset()
    obs = env.observation(0)
    args = normalize_args({"env_args": {"env": "TicTacToe"}, "train_args": {
        "seed": SEED, "model_dir": os.path.join(tmp, "autoscale_models"),
        "serving": {"port": 0, "max_batch": 1, "warm_buckets": [1], "max_wait_ms": 0.0,
                    "shed_policy": "deadline", "slo_ms": SERVE_SLO_MS, "queue_bound": 8192,
                    "stats_interval": 0},
        "fleet": {"port": 0, "stats_poll_s": 0.2, "stats_interval": 0, "autoscale": {
            "enabled": True, "min_replicas": 1, "max_replicas": 2, "interval_s": 0.2,
            "shed_slo": 0.01, "depth_high": 16.0, "depth_low": 1.0,
            # calm may start under the load (two replicas can outrun 1.5x a
            # saturation measured with other phases beside it): the window
            # outlasts the load's last 3 s and the session check after it
            "scale_down_after_s": 10.0, "cooldown_s": 1.0, "warm_timeout_s": 300.0}}}})
    factory = ProcessReplicaFactory(args)
    t0 = time.perf_counter()
    fleet = FleetRouter(args["train_args"]["fleet"], replica_factory=factory).run(
        connect_timeout=300)
    print(f"[fleet] 14(c) the floor's replica process spawned, warm and admitted in "
          f"{time.perf_counter() - t0:.1f} s")
    stamps, scale_up = {}, fleet.scale_up

    def stamped_scale_up(reason=""):
        stamps.setdefault("decision", time.perf_counter())
        return scale_up(reason)

    fleet.scale_up = stamped_scale_up
    client = None
    try:
        first = fleet._reps()[0]
        # no shed (a long SLO) and a depth under depth_high: no decision yet
        sat = closed_loop_load(first.spec.port, obs, SERVE_CLIENTS, 1, 2.0, slo_ms=10000.0)["qps"]
        stop, events = threading.Event(), []
        # the offered rate doubles every 10 s without a decision
        rate_at = (lambda t: AUTOSCALE_OFFERED * sat * (1 if "decision" in stamps
                                                        else 2 ** min(3, int(t // 10))))
        load = threading.Thread(target=open_loop_load,
                                args=(fleet.bound_port, obs, rate_at, stop, events), daemon=True)
        load.start()
        deadline = time.monotonic() + 240
        new = None
        while "first_request" not in stamps and time.monotonic() < deadline:
            reps = [r for r in fleet._reps() if r is not first]
            if reps:
                new = reps[0]
                if new.admitted:
                    stamps.setdefault("admitted", time.perf_counter())
                if new.picked:
                    stamps["first_request"] = time.perf_counter()
            time.sleep(0.002)
        check("first_request" in stamps and new is not None and new.admitted,
              f"14(c): no scale-up replica admitted and serving ({sorted(stamps)})")
        time.sleep(3.0)
        stop.set()
        load.join(120)

        def shed_rate(lo, hi):
            kinds = [k for t, k in events if lo <= t < hi]
            return sum(k == "shed" for k in kinds) / max(1, len(kinds)), len(kinds)

        before = shed_rate(0.0, stamps["decision"])
        after = shed_rate(stamps["first_request"] + 1.0, float("inf"))
        errs = sum(k == "err" for _, k in events)
        print(f"[fleet] 14(c) one replica's saturation {sat:.1f} req/s (max_batch 1, direct); "
              f"open loop through the fleet at {AUTOSCALE_OFFERED}x: shed rate {before[0]:.4f} "
              f"of {before[1]} before the decision, {after[0]:.4f} of {after[1]} from 1 s after "
              f"the new replica's first request; errors {errs}")
        print(f"[fleet] 14(c) scale-up: decision to admitted (warm) "
              f"{stamps['admitted'] - stamps['decision']:.2f} s, to its first request "
              f"{stamps['first_request'] - stamps['decision']:.2f} s; scale_ups "
              f"{fleet.scale_ups}")
        check(errs == 0 and stamps["admitted"] <= stamps["first_request"],
              "14(c): errors, or a request before admission")
        time.sleep(1.0)   # calm load scores polled: a new session goes to the least picked
        client = ServingClient("127.0.0.1", fleet.bound_port)
        sid = None
        for _ in range(64):
            s = client.open_session()
            if fleet._affinity[s] is new:
                sid = s
                break
        check(sid is not None, "14(c): no session landed on the new replica")
        client.infer(obs, sid=sid, timeout=60)
        misses = sum(r["session_affinity_miss"] for r in client.stats()["replicas"].values())
        t_calm = time.perf_counter()
        deadline = time.monotonic() + 120
        while not (fleet.scale_downs >= 1 and len(fleet._reps()) == 1):
            check(time.monotonic() < deadline, "14(c): calm never scaled the fleet down")
            time.sleep(0.05)
        check(client.infer(obs, sid=sid, timeout=60)["sid"] == sid, "14(c): the session is lost")
        stats = client.stats()
        lost = sum(r["session_affinity_miss"] for r in stats["replicas"].values()) - misses
        print(f"[fleet] 14(c) calm: scale-down {time.perf_counter() - t_calm:.1f} s after the "
              f"load, the new replica retired through the migration "
              f"({fleet.migrations} migration, {fleet.last_migration_ms:.1f} ms); sessions lost "
              f"{lost}; replicas left {stats['fleet_replicas']}")
        check(lost == 0 and stats["fleet_replicas"] == 1, "14(c): the scale-down lost a session")
    finally:
        if client is not None:
            client.close()
        fleet.shutdown()
        factory.close()


def fleet_learner_faults(tmp):
    """14(d): config.yaml's learner (episodes cut) through the CLI under
    HANDYRL_FAULT_NAN_AT_STEP (with trace.enabled and profile_dir) and
    HANDYRL_FAULT_SIGTERM_AT_STEP then a relaunch; updates/s with tracing on
    and off in turns, in this process."""
    import copy

    import yaml

    from handyrl_tpu_torch.config import normalize_args
    from handyrl_tpu_torch.runtime import checkpoint as ckpt
    from handyrl_tpu_torch.runtime.learner import Learner
    from handyrl_tpu_torch.utils.trace import read_trace

    base = yaml.safe_load((ROOT / "config.yaml").read_text())
    base["train_args"].update(epochs=3, minimum_episodes=LEARNER_EPISODES,
                              update_episodes=LEARNER_EPISODES)

    def config(path, **train):
        cfg = copy.deepcopy(base)
        cfg["train_args"].update(train)
        write_config(path, cfg)
        return cfg

    nan_dir = os.path.join(tmp, "nan")
    config(nan_dir, trace={"enabled": True}, profile_dir="profile")
    out, nan_s = run_cli(nan_dir, "--train", env={"HANDYRL_FAULT_NAN_AT_STEP": "1:1000000"})
    records = read_records(os.path.join(nan_dir, "metrics.jsonl"))
    last = records[-1]
    finite = all(math.isfinite(v) for r in records for v in (r.get("loss") or {}).values())
    print(f"[fleet] 14(d) NaN lr from step 1 on: {len(records)} epochs in {nan_s:.1f} s, "
          f"sentinel_skipped_steps {last.get('sentinel_skipped_steps')}, sentinel_rollbacks "
          f"{last.get('sentinel_rollbacks')}, losses finite {finite}")
    check(last.get("sentinel_skipped_steps", 0) > 0 and last.get("sentinel_rollbacks", 0) >= 1
          and finite, "14(d): the NaN run did not skip, roll back and finish finite")
    spans = read_trace(os.path.join(nan_dir, "trace.jsonl"))
    names = {r["name"] for r in spans}
    check({"train_step", "batch.wait", "checkpoint.save", "epoch.snapshot_wait"} <= names,
          f"14(d): trace spans {sorted(names)}")
    profiles = sorted(Path(nan_dir, "profile").glob("*.json"))
    check(len(profiles) == 1, f"14(d): profile_dir holds {len(profiles)} traces")
    events = json.loads(profiles[0].read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    print(f"[fleet] 14(d) trace.enabled: {len(spans) - 1} spans read back ({len(names) - 1} "
          f"names); profile_dir: {profiles[0].name}, {len(events)} events, {len(kernels)} CUDA "
          f"kernel events")
    check(kernels, "14(d): the profiler trace holds no CUDA kernel event")

    sig_dir = os.path.join(tmp, "sigterm")
    config(sig_dir, epochs=50)
    out, sig_s = run_cli(sig_dir, "--train", env={"HANDYRL_FAULT_SIGTERM_AT_STEP":
                                                  str(SIGTERM_STEP)}, code=75)
    models = os.path.join(sig_dir, "models")
    drain_epoch = ckpt.latest_verified_epoch(models)
    steps = ckpt.load_manifest(models)["epochs"][str(drain_epoch)]["steps"]
    check("drain checkpoint" in out and drain_epoch > 0 and ckpt.verify_state(models, drain_epoch),
          "14(d): no verified drain checkpoint")
    config(sig_dir, epochs=drain_epoch + 1, restart_epoch=-1)
    out, resume_s = run_cli(sig_dir, "--train")
    check(f"auto-resume (restart_epoch: -1): epoch {drain_epoch}" in out
          and ckpt.latest_verified_epoch(models) == drain_epoch + 1,
          "14(d): the relaunch did not resume at the drain checkpoint")
    print(f"[fleet] 14(d) SIGTERM at step {SIGTERM_STEP}: exit 75 after {sig_s:.1f} s, drain "
          f"checkpoint epoch {drain_epoch} at step {steps}; relaunch with restart_epoch: -1 "
          f"resumed there and finished epoch {drain_epoch + 1} in {resume_s:.1f} s")

    rates = {True: [], False: []}
    for turn in range(TRACE_TURNS):
        for on in ((True, False) if turn % 2 == 0 else (False, True)):
            run_dir = os.path.join(tmp, f"trace_{turn}_{int(on)}")
            cfg = config(run_dir, epochs=2, model_dir=os.path.join(run_dir, "models"),
                         metrics_path=os.path.join(run_dir, "metrics.jsonl"),
                         trace={"enabled": on, "path": os.path.join(run_dir, "trace.jsonl")})
            Learner(normalize_args(cfg)).run()
            rates[on].append(read_records(cfg["train_args"]["metrics_path"])[-1]["updates_per_sec"])
    order = ", ".join("on, off" if turn % 2 == 0 else "off, on" for turn in range(TRACE_TURNS))
    print(f"[fleet] 14(d) updates/s of the second epoch, {TRACE_TURNS} turns each, in the order "
          f"{order}: tracing on {', '.join(f'{r:.2f}' for r in rates[True])}; off "
          f"{', '.join(f'{r:.2f}' for r in rates[False])}")


def phase_fleet(results, parts="abcd"):
    """14: the fleet tier over serving replicas on the card, and the
    learner's fault machinery.  No kernel on these paths.  ``parts`` picks
    the legs."""
    legs = dict(zip("abcd", (fleet_tictactoe, fleet_sessions, fleet_autoscale,
                             fleet_learner_faults)))
    times = [time.perf_counter()]
    with tempfile.TemporaryDirectory() as tmp:
        for tag in parts:
            print(f"[fleet] {card_line()}")
            legs[tag](tmp)
            times.append(time.perf_counter())
    took = ", ".join(f"({tag}) {t1 - t:.1f} s" for tag, t, t1 in zip(parts, times, times[1:]))
    print(f"[fleet] phase 14 {''.join(f'({tag})' for tag in parts)} in "
          f"{times[-1] - times[0]:.1f} s: {took}")


INT8_SESSION_GAMES = 16   # 15(a): SESSION_CONNS x 16 games x 2 seats = 256 sessions, all resident
INT8_TURN_S = 1.0         # 15(a): each turn of the session load and of 13(a)'s load
INT8_SERVE_S = 2.0        # 15(a): the int8 --serve child's session load
INT8_SERVING = dict(SESSION_SERVING, session_capacity=512, weight_dtype="int8", watch_interval=0)
CALIB_BATCHES = 4         # 15(a): calibration batches of 64 replay observations
OBS8_EPISODES = 6         # 15(b)(i): Geister episodes of uniform play per plane
OBS8_STEPS = 3            # 15(b)(i): train steps on each plane
OBS8_EPISODES_7A = 32     # 15(b)(ii): minimum_episodes and update_episodes of config.yaml's learner
EXPORT_BATCHES = (1, 64)  # 15(c)(i): the batch sizes a reloaded artifact is checked at
EXPORT_TOLERANCE = 1e-5   # 15(c)(i): of the outputs' scale, strict fp32 on both devices
EDGE_TURN_S = 3.0         # 15(c)(ii): 13(a)'s load through the fleet over --serve and --edge
FLY_EPISODES = (48, 64)   # 15(d): minimum_episodes, update_episodes of the flywheel learner
# 15(d): a rollback signal read at boundary N is taken after N + 1, recorded at N + 2
FLY_EPOCHS = 6
FLY_POISON = 2            # 15(d): HANDYRL_FAULT_POISON_SNAPSHOT_AT_EPOCH
FLY_HARVESTERS = 3        # 15(d): client threads playing harvest games
FLY_JUDGES = 3            # 15(d): client threads playing judged games
CARD = "cuda"             # the device type phase 15 holds its tensors and processes to


_SEEDED = {}


def seeded_net(env_args, seed):
    """A copy of the env's net initialised from ``seed`` on the CPU; each
    (env, seed) is initialised once per phase (a full-width transformer
    takes seconds)."""
    import copy

    from handyrl_tpu_torch.envs import make_env
    from handyrl_tpu_torch.models import init_variables

    key = (json.dumps(env_args, sort_keys=True), seed)
    if key not in _SEEDED:
        _SEEDED[key] = init_variables(make_env(env_args).net(), seed)
    return copy.deepcopy(_SEEDED[key])


def worst_rel(got, want):
    """``tree_max_rel_err`` of two trees whose leaves agree in shape and are
    finite."""
    import numpy as np

    from handyrl_tpu_torch.utils import to_numpy, tree_leaves, tree_max_rel_err

    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        g, w = to_numpy(g), to_numpy(w)
        check(g.shape == w.shape and np.isfinite(g).all(), f"bad leaf {g.shape} vs {w.shape}")
    return tree_max_rel_err(got, want)


def int8_engines():
    """15(a), in this process: the full-width transformer's int8 engine on
    the card against the host quantize (codes bit for bit) and against an
    fp32 engine of the dequantized tree; param bytes, the dequantize's share
    of a batch of 64, a profiled batch, the calibration report."""
    import numpy as np
    import torch

    from handyrl_tpu_torch.models import build_inference_model, fetch_outputs
    from handyrl_tpu_torch.models import quantize as q
    from handyrl_tpu_torch.utils import tree_stack

    env_args = {"env": "Geister", "net": "transformer", "net_args": NET_ARGS}
    module = seeded_net(env_args, SEED)
    params = module.state_dict()
    host = q.quantize_params(params)
    t0 = time.perf_counter()
    engine = build_inference_model(module, params, "int8")      # on the card
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    resident = engine.module.state_dict()
    check(sorted(resident) == sorted(host)
          and all(t.device.type == CARD for t in resident.values()),
          "15(a): the int8 engine's state is not the quantized tree on the card")
    differ = [k for k, v in host.items() if resident[k].cpu().numpy().dtype != v.dtype
              or not np.array_equal(resident[k].cpu().numpy(), v)]
    check(not differ, f"15(a): codes on the card differ from the host quantize: {differ[:4]}")
    fp32 = build_inference_model(module, q.dequantize_params(host))
    b8, b32 = q.param_bytes(engine.module), q.param_bytes(fp32.module)
    n = SESSION_SERVING["max_batch"]
    obs = tree_stack([seq[0] for seq in geister_games(n, 1, SEED)])
    with torch.inference_mode():
        o8 = fetch_outputs(engine.inference_batch_async(obs, engine.init_hidden((n,))))
        of = fetch_outputs(fp32.inference_batch_async(obs, fp32.init_hidden((n,))))
    err = worst_rel(o8, of)
    print(f"[int8] 15(a) transformer d{NET_ARGS['d_model']} L{NET_ARGS['n_layers']}: int8 engine "
          f"built on the card in {build_s:.2f} s; {len(q.quantized_names(host))} kernels' codes "
          f"and scales on the card equal the host quantize bit for bit; param_bytes fp32 "
          f"{b32 / 1e9:.4f} GB, int8 {b8 / 1e9:.4f} GB ({b8 / b32:.4f}x); outputs and next "
          f"hidden at batch {n} against an fp32 engine of the dequantized tree: max_abs_err "
          f"{err:.3e} of scale (tolerance 1e-5)")
    check(err <= 1e-5, "15(a): the int8 engine disagrees with the fp32 engine of its weights")
    check(b8 < 0.3 * b32, "15(a): the int8 engine's params are not about a quarter of fp32's")
    layers = [m for m in engine.module.modules() if isinstance(m, (q.QuantLinear, q.QuantConv2d))]

    def dequantize_all():
        for m in layers:
            m.weight

    with torch.inference_mode():
        deq_ms = cuda_ms(dequantize_all)
        batch8 = cuda_ms(lambda: engine.inference_batch_async(obs, engine.init_hidden((n,))))
        batch32 = cuda_ms(lambda: fp32.inference_batch_async(obs, fp32.init_hidden((n,))))
        print(f"[int8] 15(a) one batch of {n} (forward, CUDA events, 20 calls): int8 "
              f"{batch8:.3f} ms, fp32 {batch32:.3f} ms; every kernel dequantized once "
              f"({len(layers)} layers) {deq_ms:.3f} ms = {deq_ms / batch8:.1%} of the int8 batch")
        profile_call(f"one int8 batch of {n} sessions (forward)",
                     lambda: engine.inference_batch_async(obs, engine.init_hidden((n,))))
    t0 = time.perf_counter()
    batches = [tree_stack(list(step)) for step in zip(*geister_games(n, CALIB_BATCHES, SEED + 5))]
    report = q.calibration_report(module, params, batches)
    print(f"[int8] 15(a) calibration_report over {len(batches)} batches of {n} replay "
          f"observations (random Geister play): calib_max_dev {report['calib_max_dev']}, "
          f"calib_mean_dev {report['calib_mean_dev']} ({time.perf_counter() - t0:.1f} s)")
    check(math.isfinite(report["calib_max_dev"]), "15(a): a non-finite calibration")
    del engine, fp32
    gc.collect()
    torch.cuda.empty_cache()
    return module, params


def session_turns(module, params):
    """15(a): 13(b)'s session load on an int8 and an fp32 server in this
    process, in turns, INT8_TURN_S each: session steps/s."""
    import torch

    from handyrl_tpu_torch.serving import ModelRouter, ServingServer

    obs = geister_games(1, 1, SEED)[0][0]
    servers = {}
    with tempfile.TemporaryDirectory() as tmp:
        for dtype in ("int8", "float32"):
            cfg = dict(INT8_SERVING, weight_dtype=dtype, warm_buckets=[1, 64])
            router = ModelRouter(module, obs, cfg, model_dir=tmp)
            router.publish(1, params)
            servers[dtype] = ServingServer(router, cfg).run()
        rates = {"int8": [], "float32": []}
        try:
            for dtype in ("int8", "float32", "float32", "int8"):
                players = [SessionPlayer(servers[dtype].bound_port, INT8_SESSION_GAMES, SEED + i)
                           for i in range(SESSION_CONNS)]
                t0 = time.perf_counter()
                threads = [threading.Thread(target=p.run, args=(t0 + INT8_TURN_S,), daemon=True)
                           for p in players]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(INT8_TURN_S + 300)
                check(not any(t.is_alive() for t in threads), "15(a): a session player hung")
                errors = sum(p.errors for p in players)
                check(errors == 0, f"15(a): {errors} error replies on the {dtype} server")
                rates[dtype].append(sum(p.steps for p in players) / (time.perf_counter() - t0))
        finally:
            for server in servers.values():
                server.shutdown()
    print(f"[int8] 15(a) {SESSION_CONNS} connections x {2 * INT8_SESSION_GAMES} sessions "
          f"(all resident), {INT8_TURN_S:.1f} s turns int8/fp32/fp32/int8: session steps/s int8 "
          + " / ".join(f"{r:.1f}" for r in rates["int8"]) + ", fp32 "
          + " / ".join(f"{r:.1f}" for r in rates["float32"]))
    gc.collect()
    torch.cuda.empty_cache()


def tictactoe_turns():
    """15(a): 13(a)'s closed loop on an int8 and an fp32 TicTacToe server in
    this process, in turns: req/s, p50/p99."""
    from handyrl_tpu_torch.envs import make_env
    from handyrl_tpu_torch.models import init_variables
    from handyrl_tpu_torch.serving import ModelRouter, ServingServer

    env = make_env({"env": "TicTacToe"})
    env.reset()
    obs = env.observation(0)
    module = init_variables(env.net(), SEED)
    servers, turns = {}, {"int8": [], "float32": []}
    with tempfile.TemporaryDirectory() as tmp:
        for dtype in ("int8", "float32"):
            cfg = {"port": 0, "slo_ms": 1000.0, "shed_policy": "none", "max_batch": 64,
                   "max_wait_ms": 1.0, "warm_buckets": SERVE_BUCKETS, "queue_bound": 8192,
                   "weight_dtype": dtype}
            router = ModelRouter(module, obs, cfg, model_dir=tmp)
            router.publish(1, module.state_dict())
            servers[dtype] = ServingServer(router, cfg).run()
        try:
            for dtype in ("int8", "float32", "float32", "int8"):
                turn = closed_loop_load(servers[dtype].bound_port, obs, SERVE_CLIENTS,
                                        SERVE_WINDOW, INT8_TURN_S)
                check(turn["err"] == 0, f"15(a): error replies on the {dtype} TicTacToe server")
                turns[dtype].append(turn)
        finally:
            for server in servers.values():
                server.shutdown()
    line = "; ".join(f"{d} " + " / ".join(f"{t['qps']:.1f} req/s (p50 {t['p50']:.2f}, p99 "
                                          f"{t['p99']:.2f} ms)" for t in ts)
                     for d, ts in turns.items())
    print(f"[int8] 15(a) 13(a)'s TicTacToe load ({SERVE_CLIENTS} x {SERVE_WINDOW}, "
          f"{INT8_TURN_S:.1f} s turns int8/fp32/fp32/int8): {line}")


def int8_serve_child(tmp, kids, module, params):
    """15(a): ``--serve`` with ``serving.weight_dtype: int8``, 256 resident
    sessions, a replay of the int8 engine on the card, a swap from disk
    (an int8 engine again), the SIGTERM drain with its peak memory."""
    import signal

    import torch

    from handyrl_tpu_torch.models import build_inference_model
    from handyrl_tpu_torch.serving import ServingClient

    proc = kids.procs["serve8"][0]
    port = int(wait_for_line(kids, "serve8", r"serving: listening on port (\d+)", 600).group(1))
    check("(model 1," in kids.output("serve8") and f"device {CARD}" in kids.output("serve8"),
          "15(a): the int8 server did not publish snapshot 1 on the card")
    draining = threading.Event()
    client = ServingClient("127.0.0.1", port, on_notice=lambda *_: draining.set())
    replay = build_inference_model(module, params, "int8")
    sids = session_replay_check("15(a) int8 --serve", client, replay, 1,
                                tolerance(torch.bfloat16), SEED)
    del replay
    before = client.stats()
    players = [SessionPlayer(port, INT8_SESSION_GAMES, SEED + i) for i in range(SESSION_CONNS)]
    t0 = time.perf_counter()
    threads = [threading.Thread(target=p.run, args=(t0 + INT8_SERVE_S,), daemon=True)
               for p in players]
    for t in threads:
        t.start()
    time.sleep(INT8_SERVE_S / 2)
    mid = client.stats()   # the sessions resident under the load
    for t in threads:
        t.join(INT8_SERVE_S + 300)
    check(not any(t.is_alive() for t in threads), "15(a): a session player did not end")
    window = time.perf_counter() - t0
    after = client.stats()
    errors = sum(p.errors for p in players)
    print(f"[int8] 15(a) --serve int8: {SESSION_CONNS} connections x {2 * INT8_SESSION_GAMES} "
          f"sessions for {window:.1f} s: {sum(p.steps for p in players) / window:.1f} session "
          f"steps/s, resident at mid-load {mid['session_resident']}, evictions "
          f"{after['session_evictions'] - before['session_evictions']}, errors {errors} (server "
          f"{after['serve_errors']}), lowprec_weight_dtype {after.get('lowprec_weight_dtype')}")
    check(errors == 0 and after["serve_errors"] == 0, "15(a): error frames on the int8 server")
    check(after.get("lowprec_weight_dtype") == "int8", "15(a): the server's engines are not int8")
    # a swap from disk: 2.ckpt, loaded and built by the server as an int8 engine
    params2 = seeded_net({"env": "Geister", "net": "transformer", "net_args": NET_ARGS},
                         SEED + 1).state_dict()
    t0 = time.perf_counter()
    swapped = client.swap(2, timeout=600)
    swap_s = time.perf_counter() - t0
    replay = build_inference_model(module, params2, "int8")
    session_replay_check("15(a) int8 after the swap from disk", client, replay, 2,
                         tolerance(torch.bfloat16), SEED + 3)
    del replay, params2
    stats = client.stats()
    check(stats["serve_hot_swaps"] >= 1 and stats.get("lowprec_weight_dtype") == "int8",
          "15(a): the swap from disk did not build an int8 engine")
    print(f"[int8] 15(a) swap from disk to epoch 2: {swap_s * 1e3:.1f} ms (warm "
          f"{swapped['warm_ms']:.1f} ms), replies from the int8 engine of 2.ckpt")
    proc.send_signal(signal.SIGTERM)
    check(draining.wait(30), "15(a): no draining notice after SIGTERM")
    client.export_sessions(timeout=120)
    code = proc.wait(timeout=DRAIN_DEADLINE_S + 60)
    client.close()
    log = kids.output("serve8")
    peak = re.search(r"serving: peak device memory .*", log)
    check(code == 75, f"15(a): the int8 server exited {code}")
    print(f"[int8] 15(a) --serve int8 {peak.group(0) if peak else 'no peak memory line'}; "
          f"{len(sids)} replayed sessions exported, exit {code}")


def int8_weights(tmp):
    """15(a): int8 weights on the serving path at full width."""
    import zlib

    import torch

    from handyrl_tpu_torch.runtime import checkpoint as ckpt

    env_args = {"env": "Geister", "net": "transformer", "net_args": NET_ARGS}
    serve_dir = os.path.join(tmp, "serve8")
    model_dir = os.path.join(serve_dir, "models")
    write_config(serve_dir, {"env_args": env_args, "train_args": {
        "model_dir": "models", "drain_deadline_seconds": DRAIN_DEADLINE_S,
        "serving": INT8_SERVING}})
    module = seeded_net(env_args, SEED)
    ckpt.save_epoch_snapshot(model_dir, 1, module.state_dict(), {"steps": 0}, 0)
    # seed 1 as 2.ckpt, entered into the manifest once the server is up: the
    # swap frame then loads it from disk, digest-verified
    blob = ckpt.to_bytes(seeded_net(env_args, SEED + 1).state_dict())
    ckpt.atomic_write_bytes(ckpt.model_path(model_dir, 2), blob)
    digest = (zlib.crc32(blob), len(blob))
    del blob, module
    with Children(tmp) as kids, CardMemory() as memory:
        kids.start("serve8", "--serve", cwd=serve_dir)
        module, params = int8_engines()
        wait_for_line(kids, "serve8", r"serving: listening on port (\d+)", 600)
        ckpt.record_snapshot(model_dir, 2, 0, {"2.ckpt": digest})
        session_turns(module, params)
        tictactoe_turns()
        int8_serve_child(tmp, kids, module, params)
    print(f"[int8] 15(a) card memory used (nvidia-smi), peak over the leg: "
          f"{memory.peak_mib:.0f} MiB, every process on the card included (other phases run beside this one)")
    del module, params
    gc.collect()
    torch.cuda.empty_cache()


def obs8_episodes(env_args, args, n, seed):
    """``n`` episodes of uniform play under ``args`` (its obs_int8 and
    compress_steps), seeded: the same trajectories for either obs_int8."""
    from handyrl_tpu_torch.envs import make_env
    from handyrl_tpu_torch.models import InferenceModel, RandomModel
    from handyrl_tpu_torch.runtime import Generator

    env = make_env(env_args)
    env.reset()
    # a zero-logit model shaped like the net's outputs (a narrow probe of
    # the same env: the width does not change the outputs' shapes)
    probe = make_env(dict(env_args, net_args={"d_model": 16, "n_heads": 2, "n_layers": 1,
                                              "memory_len": 4})
                     if env_args.get("net") == "transformer" else env_args)
    model = RandomModel.from_model(InferenceModel(probe.net(), device="cpu"),
                                   env.observation(env.players()[0]))
    gen = Generator(env, args)
    random.seed(seed)
    episodes = []
    while len(episodes) < n:
        ep = gen.generate({p: model for p in env.players()},
                          {"player": env.players(), "model_id": {p: 1 for p in env.players()}})
        if ep is not None:
            episodes.append(ep)
    return episodes


def obs8_transformer(results):
    """15(b)(i): the training slice's transformer (B16 x T512, bf16) on
    Geister episodes made with obs_int8 true and false from the same seed:
    the int8 windows dequantized on the card equal the fp32 windows bit for
    bit; OBS8_STEPS train steps through B1 on each plane, finite losses,
    the first ones within 2e-2, B1 launched n_layers times per update."""
    import copy

    import torch

    from handyrl_tpu_torch.config import normalize_args
    from handyrl_tpu_torch.envs import make_env
    from handyrl_tpu_torch.models.quantize import dequantize_obs_tree, obs_quant_spec
    from handyrl_tpu_torch.ops.flash_attention import MASKED_FLASH
    from handyrl_tpu_torch.parallel import TrainContext
    from handyrl_tpu_torch.runtime import codec
    from handyrl_tpu_torch.runtime.batch import make_batch
    from handyrl_tpu_torch.runtime.replay import EpisodeStore
    from handyrl_tpu_torch.utils import tree_leaves

    env_args = {"env": "Geister", "net": "transformer", "net_args": NET_ARGS}
    cfg = normalize_args({"env_args": env_args, "train_args": dict(TRAIN_ARGS, obs_int8=True)})
    args_q = dict(cfg["train_args"], env=env_args)
    args_f = dict(args_q, obs_int8=False)
    env = make_env(env_args)
    env.reset()
    args_q["_obs_quant"] = obs_quant_spec(env)
    planes = {"int8": args_q, "fp32": args_f}
    episodes = {k: obs8_episodes(env_args, a, OBS8_EPISODES, SEED) for k, a in planes.items()}
    enc = {k: sum(len(codec.dumps(ep)) for ep in eps) / len(eps) for k, eps in episodes.items()}
    module = seeded_net(env_args, SEED)
    ctxs = {"int8": TrainContext(module, args_q), "fp32": TrainContext(copy.deepcopy(module),
                                                                         args_f)}
    stores = {}
    for k, eps in episodes.items():
        stores[k] = EpisodeStore(64)
        stores[k].extend(eps)
    a = args_q

    def batch(k, seed):
        random.seed(seed)
        windows = [stores[k].sample_window(a["forward_steps"], a["burn_in_steps"],
                                           a["compress_steps"]) for _ in range(a["batch_size"])]
        random.seed(seed)
        return make_batch(windows, planes[k])

    host = {k: batch(k, 0) for k in planes}
    slot = {k: sum(x.nbytes for x in tree_leaves(b)) for k, b in host.items()}
    obs_bytes = {k: sum(x.nbytes for x in tree_leaves(b["observation"])) for k, b in host.items()}
    on_card = {k: ctxs[k].put_batch(b) for k, b in host.items()}
    check(all(x.dtype == torch.int8 for x in tree_leaves(on_card["int8"]["observation"])),
          "15(b)(i): the int8 batch did not reach the card as int8")
    widened = dequantize_obs_tree(on_card["int8"]["observation"], args_q["_obs_quant"])
    same = all(torch.equal(g, w) for g, w in zip(tree_leaves(widened),
                                                   tree_leaves(on_card["fp32"]["observation"])))
    check(same, "15(b)(i): the int8 windows dequantized on the card differ from the fp32 ones")
    losses = {k: [] for k in planes}
    launches = {}
    for k in planes:    # both planes are the path: the count runs on across them
        before = MASKED_FLASH.launches
        for step in range(OBS8_STEPS):
            m = ctxs[k].train_step(batch(k, step), 1e-5)
            losses[k].append(m["total"] / max(m["dcnt"], 1))
        torch.cuda.synchronize()
        launches[k] = MASKED_FLASH.launches - before
    per_step = launches_per_step(args_q)
    results.setdefault("masked_flash_attention", {"launches": 0})["launches"] += sum(
        launches.values())
    first = {k: v[0] for k, v in losses.items()}
    diff = abs(first["int8"] - first["fp32"])
    print(f"[obs8] 15(b)(i) transformer B{a['batch_size']} x T{a['forward_steps']} bf16 on "
          f"{OBS8_EPISODES} Geister episodes per plane (same seed): int8 windows dequantized on "
          f"the card equal the fp32 windows bit for bit; losses per sample int8 "
          f"{[round(x, 5) for x in losses['int8']]}, fp32 {[round(x, 5) for x in losses['fp32']]} "
          f"(first step |diff| {diff:.2e}, tolerance 2e-2 of scale); B1 launched "
          f"{launches['int8']} / {launches['fp32']} times in {OBS8_STEPS} updates ({per_step} per "
          f"update); encoded bytes per episode int8 {enc['int8']:.0f}, fp32 {enc['fp32']:.0f}; "
          f"a batch (a slot) int8 {slot['int8'] / 1e6:.2f} MB (observation "
          f"{obs_bytes['int8'] / 1e6:.2f}), fp32 {slot['fp32'] / 1e6:.2f} MB (observation "
          f"{obs_bytes['fp32'] / 1e6:.2f})")
    check(all(math.isfinite(x) for v in losses.values() for x in v), "15(b)(i): a non-finite loss")
    check(diff <= 2e-2 * max(1.0, abs(first["fp32"])), "15(b)(i): the first losses disagree")
    check(launches["int8"] == launches["fp32"] == per_step * OBS8_STEPS,
          f"15(b)(i): B1 launched {launches} times, expected {per_step * OBS8_STEPS} each")
    del ctxs, module, on_card
    gc.collect()
    torch.cuda.empty_cache()
    return sum(launches.values())


def obs8_rings():
    """15(b)(ii): the staged rings' bytes, int8 and fp32, for config.yaml's
    episodes (``DeviceEpisodeStage`` on the card)."""
    import yaml

    from handyrl_tpu_torch.config import normalize_args
    from handyrl_tpu_torch.envs import make_env
    from handyrl_tpu_torch.runtime import codec
    from handyrl_tpu_torch.runtime.batch import make_batch
    from handyrl_tpu_torch.runtime.device_replay import DeviceEpisodeStage
    from handyrl_tpu_torch.runtime.replay import EpisodeStore
    from handyrl_tpu_torch.utils import tree_leaves

    out = {}
    for dtype in ("int8", "fp32"):
        raw = yaml.safe_load((ROOT / "config.yaml").read_text())
        raw["train_args"].update(obs_int8=dtype == "int8", observation=True)
        cfg = normalize_args(raw)
        args = dict(cfg["train_args"], env=cfg["env_args"])
        eps = obs8_episodes(cfg["env_args"], args, 64, SEED)
        store = EpisodeStore(64)
        store.extend(eps)
        random.seed(SEED)
        slot = make_batch([store.sample_window(args["forward_steps"], args["burn_in_steps"],
                                               args["compress_steps"])
                           for _ in range(args["batch_size"])], args)
        stage = DeviceEpisodeStage(make_env(cfg["env_args"]).net(), args, n_lanes=4, slots=1024,
                                   chunk_steps=32)
        for ep in eps:
            stage.add_episode(ep)
        stage.flush()
        stage.drain()
        out[dtype] = (ring_bytes(stage.replay),
                      sum(len(codec.dumps(ep)) for ep in eps) / len(eps),
                      sum(x.nbytes for x in tree_leaves(slot)))
        del stage
    return out


def obs8_learners(tmp):
    """15(b)(ii): config.yaml's learner (7a, 2 epochs of 32 + 32 episodes)
    with obs_int8 true and false in turns, on the shm plane and on the
    device plane (observation: true there, which the device stage needs for
    turn-based training): finite losses, updates/s, input_wait_frac."""
    import torch
    import yaml

    from handyrl_tpu_torch.config import normalize_args
    from handyrl_tpu_torch.runtime.learner import Learner

    rows = []
    for pipeline, dtype in (("shm", "int8"), ("shm", "fp32"), ("device", "fp32"),
                            ("device", "int8")):
        run_dir = os.path.join(tmp, f"obs8_{pipeline}_{dtype}")
        raw = yaml.safe_load((ROOT / "config.yaml").read_text())
        raw["train_args"].update(
            epochs=2, seed=SEED, minimum_episodes=OBS8_EPISODES_7A,
            update_episodes=OBS8_EPISODES_7A, obs_int8=dtype == "int8", batch_pipeline=pipeline,
            model_dir=os.path.join(run_dir, "models"),
            metrics_path=os.path.join(run_dir, "metrics.jsonl"))
        if pipeline == "device":
            raw["train_args"].update(observation=True, device_stage_lanes=4,
                                     device_stage_chunk=16)
        cfg = normalize_args(raw)
        gc.collect()
        t0 = time.perf_counter()
        Learner(cfg).run()
        torch.cuda.synchronize()
        records = read_records(cfg["train_args"]["metrics_path"])
        last = records[-1]
        check(len(records) == 2 and "loss" in last and math.isfinite(last["loss"]["total"])
              and last.get("pipeline") == pipeline,
              f"15(b)(ii) {pipeline} {dtype}: records "
              f"{[(r['epoch'], r.get('pipeline')) for r in records]}")
        rows.append((pipeline, dtype, last["updates_per_sec"], last.get("input_wait_frac"),
                     time.perf_counter() - t0))
    print("[obs8] 15(b)(ii) config.yaml's learner, 2 epochs of "
          f"{OBS8_EPISODES_7A} + {OBS8_EPISODES_7A} episodes, in turns: "
          + "; ".join(f"{p} {d}: {u:.2f} updates/s, input_wait_frac {w}, {s:.1f} s"
                      for p, d, u, w, s in rows))
    rings = obs8_rings()
    print(f"[obs8] 15(b)(ii) config.yaml's episodes (64, observation: true): encoded bytes per "
          f"episode int8 {rings['int8'][1]:.0f}, fp32 {rings['fp32'][1]:.0f}; a batch (an shm "
          f"slot) int8 {rings['int8'][2] / 1e6:.3f} MB, fp32 {rings['fp32'][2] / 1e6:.3f} MB; "
          f"staged rings (4 lanes x 1024 slots) int8 {rings['int8'][0] / 1e6:.3f} MB, fp32 "
          f"{rings['fp32'][0] / 1e6:.3f} MB")


def int8_observations(tmp, results):
    """15(b): int8 observations on the training paths."""
    launches = obs8_transformer(results)
    obs8_learners(tmp)
    return launches


# the fresh process of 15(c)(i): load a .pt2 on a device, run the recorded
# inputs, report its error against the live module's recorded outputs
EXPORT_CHECK = r"""
import json, sys, time
import numpy as np, torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
from handyrl_tpu_torch.models.export import ExportedModel
from handyrl_tpu_torch.utils import tree_leaves, tree_map
path, ref, device = sys.argv[1:4]
t0 = time.perf_counter()
model = ExportedModel(path, device=device)
load_s = time.perf_counter() - t0
data = np.load(ref)
worst = 0.0
for n in [int(x) for x in data["batches"]]:
    it = iter(data[f"obs{n}_{i}"] for i in range(int(data["n_obs"])))
    obs = tree_map(lambda _: next(it), json.loads(str(data["obs_tree"])))
    hid = model.init_hidden((n,))
    if hid is not None:
        it = iter(data[f"hid{n}_{i}"] for i in range(int(data["n_hid"])))
        hid = tree_map(lambda _: next(it), hid)
    out = model.inference_batch(obs, hid)
    leaves = [out[k] for k in sorted(k for k in out if k != "hidden")]
    leaves += [x for x in tree_leaves(out.get("hidden")) if x is not None]
    for i, got in enumerate(leaves):
        want = data[f"out{n}_{i}"]
        worst = max(worst, float(np.abs(got - want).max()) / max(1.0, float(np.abs(want).max())))
print(json.dumps({"device": device, "load_s": load_s, "worst": worst}))
"""


def export_one(tmp, tag, env_args, module):
    """15(c)(i): one net exported to .pt2 on the card, its recorded inputs
    and the live module's outputs, and two fresh processes started to
    reload it on the card and on the CPU (``export_checked`` reads them)."""
    import numpy as np
    import torch

    from handyrl_tpu_torch.envs import make_env
    from handyrl_tpu_torch.models.export import export_model
    from handyrl_tpu_torch.utils import tree_leaves, tree_map

    env = make_env(env_args)
    env.reset()
    obs0 = env.observation(env.players()[0])
    path = os.path.join(tmp, f"{tag}.pt2")
    module = module.to(CARD).eval()
    t0 = time.perf_counter()
    export_model(module, obs0, path)
    export_s = time.perf_counter() - t0
    size_mb = os.path.getsize(path) / 1e6
    rng = np.random.default_rng(SEED)
    ref = {"batches": np.asarray(EXPORT_BATCHES), "n_obs": len(tree_leaves(obs0)),
           "obs_tree": json.dumps(tree_map(lambda _: 0, obs0))}
    with torch.inference_mode():
        for n in EXPORT_BATCHES:
            obs = tree_map(lambda x: (rng.random((n,) + np.shape(x)) < 0.3).astype(np.float32),
                           obs0)
            obs_t = tree_map(lambda x: torch.as_tensor(x, device=CARD), obs)
            hid = module.initial_state((n,), CARD)
            if hid is not None:   # a state one step in
                hid = module(obs_t, hid)["hidden"]
                ref["n_hid"] = len(tree_leaves(hid))
                for i, x in enumerate(tree_leaves(hid)):
                    ref[f"hid{n}_{i}"] = x.cpu().numpy()
            out = module(obs_t, hid)
            leaves = [out[k] for k in sorted(k for k, v in out.items()
                                             if k != "hidden" and v is not None)]
            leaves += [x for x in tree_leaves(out.get("hidden")) if x is not None]
            for i, x in enumerate(tree_leaves(obs)):
                ref[f"obs{n}_{i}"] = x
            for i, x in enumerate(leaves):
                ref[f"out{n}_{i}"] = x.cpu().numpy()
    ref_path = os.path.join(tmp, f"{tag}.ref.npz")
    np.savez(ref_path, **ref)
    procs = {dev: subprocess.Popen([sys.executable, "-c", EXPORT_CHECK, path, ref_path, dev],
                                   cwd=tmp, env=cli_env(), stdout=subprocess.PIPE,
                                   stderr=subprocess.PIPE, text=True)
             for dev in (CARD, "cpu")}
    return {"tag": tag, "path": path, "export_s": export_s, "size_mb": size_mb, "procs": procs}


def export_checked(job):
    """Wait for an export's reload processes and hold their errors to
    EXPORT_TOLERANCE."""
    tag, export_s, size_mb = job["tag"], job["export_s"], job["size_mb"]
    results = {}
    for dev, proc in job["procs"].items():
        out, err = proc.communicate(timeout=600)
        if proc.returncode != 0:
            print(err[-3000:])
        check(proc.returncode == 0, f"15(c)(i) {tag}: the {dev} reload exited {proc.returncode}")
        results[dev] = json.loads(out.strip().splitlines()[-1])
    print(f"[export] 15(c)(i) {tag}: exported on the card in {export_s:.2f} s, {size_mb:.1f} MB; "
          + "; ".join(f"reloaded in a fresh process on the {d} in {r['load_s']:.2f} s, outputs "
                      f"and next hidden at batch {'/'.join(map(str, EXPORT_BATCHES))} against the "
                      f"live module max_abs_err {r['worst']:.3e} of scale"
                      for d, r in results.items())
          + f" (tolerance {EXPORT_TOLERANCE:.0e}, strict fp32)")
    check(all(r["worst"] <= EXPORT_TOLERANCE for r in results.values()),
          f"15(c)(i) {tag}: a reloaded artifact disagrees with the live module")


def export_artifacts(tmp):
    """15(c)(i): the full-width transformer (step mode, KV-cache hidden) and
    GeeseNet to .pt2, their four reload processes at once, and ``--eval``
    of the GeeseNet artifact."""
    import torch

    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        tf_args = {"env": "Geister", "net": "transformer", "net_args": NET_ARGS}
        jobs = [export_one(tmp, "transformer", tf_args, seeded_net(tf_args, SEED))]
        gc.collect()
        torch.cuda.empty_cache()
        jobs.append(export_one(tmp, "geese", {"env": "HungryGeese"},
                               seeded_net({"env": "HungryGeese"}, SEED)))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    try:
        for job in jobs:
            export_checked(job)
    finally:
        for job in jobs:
            for proc in job["procs"].values():
                if proc.poll() is None:
                    proc.kill()
                proc.wait()
    eval_dir = os.path.join(tmp, "eval_pt2")
    write_config(eval_dir, {"env_args": {"env": "HungryGeese"}, "train_args": {}})
    out, secs = run_cli(eval_dir, "--eval", f"{jobs[1]['path']}:random", "20", "1")
    m = re.search(r"total = ([-\d.]+) \((\d+)\)", out)
    check(m is not None and int(m.group(2)) == 20,
          f"15(c)(i): --eval of the .pt2 did not play 20 games:\n{out[-1500:]}")
    print(f"[export] 15(c)(i) --eval geese.pt2:random 20 1 (HungryGeese, on the card): total "
          f"{m.group(1)} over {m.group(2)} games in {secs:.1f} s")


def edge_fleet(tmp, meanwhile=lambda: None):
    """15(c)(ii): ``--edge model.pt2`` (TicTacToe) tagged edge beside one
    ``--serve`` replica behind ``--fleet``, 13(a)'s load through the fleet:
    req/s served by each; sessions through the fleet never land on the edge;
    a sid or a swap sent straight to it is bad_request; its peak memory.
    ``meanwhile`` runs while the three processes start."""
    import signal

    from handyrl_tpu_torch.envs import make_env
    from handyrl_tpu_torch.models import init_variables
    from handyrl_tpu_torch.models.export import export_model
    from handyrl_tpu_torch.serving import ServingClient, ServingError

    env = make_env({"env": "TicTacToe"})
    env.reset()
    obs = env.observation(0)
    module = init_variables(env.net(), SEED)
    edge_dir, rep_dir, fleet_dir = (os.path.join(tmp, d) for d in ("edge", "rep", "fleetx"))
    Path(edge_dir).mkdir(parents=True, exist_ok=True)
    export_model(module, obs, os.path.join(edge_dir, "model.pt2"))
    write_config(edge_dir, {"env_args": {"env": "TicTacToe"},
                            "train_args": {"fleet": {"edge_port": 0, "edge_workers": 2}}})
    serving = {"port": 0, "slo_ms": 1000.0, "shed_policy": "none", "max_batch": 64,
               "max_wait_ms": 1.0, "warm_buckets": SERVE_BUCKETS, "queue_bound": 8192,
               "watch_interval": 0, "stats_interval": 0}
    write_config(rep_dir, {"env_args": {"env": "TicTacToe"},
                           "train_args": {"seed": SEED, "model_dir": "models", "serving": serving}})
    with Children(tmp) as kids:
        edge = kids.start("edge", "--edge", "model.pt2", cwd=edge_dir)
        rep = kids.start("rep", "--serve", cwd=rep_dir)
        meanwhile()
        eport = int(wait_for_line(kids, "edge", r"edge: serving model.pt2 on port (\d+)",
                                  300).group(1))
        rport = int(wait_for_line(kids, "rep", r"serving: listening on port (\d+)", 300).group(1))
        check(f"device {CARD}" in kids.output("edge"), "15(c)(ii): the edge is not on the card")
        write_config(fleet_dir, {"env_args": {"env": "TicTacToe"}, "train_args": {"fleet": {
            "port": 0, "stats_poll_s": 0.5, "stats_interval": 0,
            "replicas": [f"127.0.0.1:{rport}",
                         {"host": "127.0.0.1", "port": eport, "tags": ["edge"]}]}}})
        fleet = kids.start("fleet", "--fleet", cwd=fleet_dir)
        fport = int(wait_for_line(kids, "fleet", r"fleet: entry port (\d+)", 120).group(1))
        admin = ServingClient("127.0.0.1", fport)
        names = (f"127.0.0.1:{rport}", f"127.0.0.1:{eport}")
        deadline = time.monotonic() + 60
        while True:   # both replicas polled once before the load
            before = admin.stats()["replicas"]
            if all("serve_replies" in before.get(name, {}) for name in names):
                break
            check(time.monotonic() < deadline,
                  f"15(c)(ii): the fleet never polled {names}: {sorted(before)}\n"
                  + kids.output("edge")[-1500:] + kids.output("fleet")[-1500:])
            time.sleep(0.2)
        turn = closed_loop_load(fport, obs, SERVE_CLIENTS, SERVE_WINDOW, EDGE_TURN_S)
        time.sleep(1.0)   # one more poll after the load
        after = admin.stats()["replicas"]
        served = {name: after[name]["serve_replies"] - before[name]["serve_replies"]
                  for name in names}
        sids = [admin.open_session() for _ in range(8)]
        for sid in sids:
            admin.infer(obs, sid=sid)
        stats = admin.stats()["replicas"]
        edge_stats = stats[f"127.0.0.1:{eport}"]
        print(f"[edge] 15(c)(ii) 13(a)'s load through --fleet over --serve and --edge for "
              f"{EDGE_TURN_S:.0f} s: {turn['qps']:.1f} req/s, p50 {turn['p50']:.2f} ms, p99 "
              f"{turn['p99']:.2f} ms (client), errors {turn['err']}; served by the replica "
              f"{served[f'127.0.0.1:{rport}'] / EDGE_TURN_S:.1f} req/s, by the edge "
              f"{served[f'127.0.0.1:{eport}'] / EDGE_TURN_S:.1f} req/s; {len(sids)} sessions "
              f"through the fleet: the edge's session count "
              f"{edge_stats.get('session_opened', 0)}, its errors {edge_stats['serve_errors']}")
        check(turn["err"] == 0, "15(c)(ii): error replies through the fleet")
        check(edge_stats.get("session_opened", 0) == 0 and edge_stats["serve_errors"] == 0,
              "15(c)(ii): a session landed on the edge")
        admin.close()
        direct = ServingClient("127.0.0.1", eport)
        kinds = []
        for call in (lambda: direct.infer(obs, sid="s-1"), lambda: direct.swap(2)):
            try:
                call()
                kinds.append("served")
            except ServingError as exc:
                kinds.append(exc.kind)
        direct.close()
        print(f"[edge] 15(c)(ii) straight to the edge: a sid -> {kinds[0]}, a swap -> {kinds[1]}")
        check(kinds == ["bad_request", "bad_request"],
              "15(c)(ii): the edge served a stateful frame")
        fleet.send_signal(signal.SIGTERM)
        check(fleet.wait(60) == 0, f"15(c)(ii): --fleet exited {fleet.poll()}")
        edge.send_signal(signal.SIGTERM)
        check(edge.wait(60) == 0, f"15(c)(ii): --edge exited {edge.poll()}")
        rep.send_signal(signal.SIGTERM)
        check(rep.wait(60) == 75, f"15(c)(ii): the replica exited {rep.poll()}")
        peak = re.search(r"edge: peak device memory .*", kids.output("edge"))
        print(f"[edge] 15(c)(ii) {peak.group(0) if peak else 'no peak memory line'}")


def export_edge(tmp):
    """15(c): export and the edge (the edge's processes start first)."""
    edge_fleet(tmp, meanwhile=lambda: export_artifacts(tmp))


class FlywheelClients:
    """15(d)'s clients of the flywheel server: FLY_HARVESTERS threads play
    harvest games (a session per seat, ``harvest_open``, ``infer`` per move,
    ``harvest_step``, ``harvest_close``), FLY_JUDGES threads play judged
    games (the served model, greedy, against uniform play) and report each
    outcome against the epoch that served it.  The judges' outcomes are the
    game's, except for the poisoned epoch: its games are reported lost, as
    JAX bench.py's flywheel stage scripts its verdicts, because two epochs
    of TicTacToe training do not make a clean net and its negation play
    differently enough for a gate of a few games to tell."""

    def __init__(self, port):
        self.port = port
        self.stop = threading.Event()
        self.errors, self.kept, self.dropped, self.judged = [], 0, 0, {}
        self.threads = ([threading.Thread(target=self._harvest, args=(i,), daemon=True)
                         for i in range(FLY_HARVESTERS)]
                        + [threading.Thread(target=self._judge, args=(i,), daemon=True)
                           for i in range(FLY_JUDGES)])

    def start(self):
        for t in self.threads:
            t.start()
        return self

    def close(self):
        self.stop.set()
        for t in self.threads:
            t.join(60)
        check(not any(t.is_alive() for t in self.threads), "15(d): a client thread hung")

    def _loop(self, play, seed):
        from handyrl_tpu_torch.envs import make_env
        from handyrl_tpu_torch.serving import ServingClient, ServingError

        rng = random.Random(seed)
        env = make_env({"env": "TicTacToe"})
        client = ServingClient("127.0.0.1", self.port)
        try:
            while not self.stop.is_set():
                try:
                    play(client, env, rng)
                except ServingError as exc:
                    self.errors.append(f"{exc.kind}: {exc}")
        except Exception as exc:
            if not self.stop.is_set():
                self.errors.append(f"{type(exc).__name__}: {exc}")
        finally:
            client.close()

    def _harvest(self, i):
        def play(client, env, rng):
            kept = harvest_game(client, env, rng)
            self.kept += bool(kept)
            self.dropped += not kept
            time.sleep(0.02)   # paced: the learner's epochs outlast a gate verdict

        self._loop(play, SEED + 100 + i)

    def _judge(self, i):
        import numpy as np

        def play(client, env, rng):
            env.reset()
            seat, served = rng.randrange(2), None
            while not env.terminal():
                moves = {}
                for p in env.turns():
                    legal = list(env.legal_actions(p))
                    if p == seat:
                        reply = client.infer(env.observation(p))
                        served = reply["model"] if served is None else served
                        logits = np.asarray(reply["out"]["policy"]).reshape(-1)
                        moves[p] = max(legal, key=lambda a: (logits[a], rng.random()))
                    else:
                        moves[p] = rng.choice(legal)
                env.step(moves)
            if isinstance(served, int) and served > 0:
                outcome = -1.0 if served == FLY_POISON else float(env.outcome().get(seat, 0.0))
                client.report_outcome(served, outcome)
                self.judged[served] = self.judged.get(served, 0) + 1
            time.sleep(0.01)

        self._loop(play, SEED + 200 + i)


def harvest_game(client, env, rng, record=None):
    """One TicTacToe game through the harvest protocol, actions drawn as the
    Generator draws them (``rng.choices`` over the legal moves by the
    masked softmax); ``record`` collects each reply's outputs.  Returns
    whether the server kept the episode."""
    import numpy as np

    from handyrl_tpu_torch.utils import softmax

    players = env.players()
    sids = [client.open_session() for _ in players]
    hid = client.harvest_open(players, sids)
    env.reset()
    while not env.terminal():
        turn_players = env.turns()
        actions, legal_lists, moves = [None] * len(players), [None] * len(players), {}
        for p in turn_players:
            j = players.index(p)
            reply = client.infer(env.observation(p), sid=sids[j])
            if record is not None:
                record.append(reply["out"])
            logits = np.asarray(reply["out"]["policy"], np.float32).reshape(-1)
            legal = list(env.legal_actions(p))
            amask = np.full_like(logits, 1e32)
            amask[legal] = 0.0
            probs = softmax(logits - amask)
            action = rng.choices(legal, weights=probs[legal])[0]
            actions[j], legal_lists[j], moves[p] = int(action), legal, int(action)
        turn = turn_players[0] if turn_players else None
        env.step(moves)
        reward = env.reward()
        client.harvest_step(hid, actions, legal_lists, [reward.get(p) for p in players], turn)
    outcome = env.outcome()
    kept = client.harvest_close(hid, [float(outcome.get(p, 0.0)) for p in players])
    for sid in sids:
        client.close_session(sid)
    return kept


def harvest_parity(port):
    """15(d): one game through the harvest protocol, pulled back, against
    the Generator's encoding of the same trajectory (the served replies
    replayed as the model, the same random draws): byte for byte."""
    from handyrl_tpu_torch.config import normalize_args
    from handyrl_tpu_torch.envs import make_env
    from handyrl_tpu_torch.runtime import Generator
    from handyrl_tpu_torch.serving import ServingClient

    class Replayed:
        def __init__(self, outs):
            self.outs = list(outs)

        def init_hidden(self):
            return None

        def inference(self, obs, hidden=None):
            return dict(self.outs.pop(0), hidden=None)

    client = ServingClient("127.0.0.1", port)
    record = []
    check(harvest_game(client, make_env({"env": "TicTacToe"}), random.Random(SEED),
                       record=record), "15(d): the parity game was dropped")
    episodes, _ = client.harvest_pull(8)
    client.close()
    check(len(episodes) == 1, f"15(d): pulled {len(episodes)} episodes, not 1")
    env = make_env({"env": "TicTacToe"})
    targs = normalize_args({"env_args": {"env": "TicTacToe"}})["train_args"]
    gen = Generator(env, targs)
    # the Generator draws from the module's random: the client's stream
    state = random.getstate()
    random.seed(SEED)
    selfplay = gen.generate(dict.fromkeys(env.players(), Replayed(record)),
                            {"player": env.players(), "model_id": {p: 0 for p in env.players()}})
    random.setstate(state)
    ep = episodes[0]
    same = selfplay["blocks"] == ep["blocks"] and selfplay["steps"] == ep["steps"]
    print(f"[flywheel] 15(d) one harvested episode ({ep['steps']} steps, {len(ep['blocks'])} "
          f"blocks, served by epoch {ep['model_epoch']}) against the self-play encoding of its "
          f"trajectory: {'byte for byte equal' if same else 'DIFFERENT'}")
    check(same, "15(d): the harvested episode differs from the self-play encoding")


def flywheel_run(tmp):
    """15(d): ``--serve`` with the flywheel over TicTacToe, harvest and judge
    clients, and ``--train`` on harvested traffic only with epoch
    FLY_POISON's snapshot poisoned."""
    import signal

    from handyrl_tpu_torch.runtime import checkpoint as ckpt
    from handyrl_tpu_torch.serving import ServingClient

    run_dir = os.path.join(tmp, "flywheel")
    fly = {"enabled": True, "harvest_fraction": 1.0, "staleness_epochs": 8,
           "harvest_poll_s": 0.2, "harvest_max_pull": 32, "promote_winrate": 0.25,
           "promote_games": 8, "quality_window": 8, "demote_drop": 0.25, "shadow_fraction": 1.0}
    serving = {"port": 0, "slo_ms": 5000.0, "shed_policy": "none", "max_batch": 64,
               "max_wait_ms": 1.0, "warm_buckets": [1, 2, 4, 8], "watch_interval": 0.1,
               "stats_interval": 0}
    write_config(run_dir, {"env_args": {"env": "TicTacToe"}, "train_args": {
        "seed": SEED, "model_dir": "models", "metrics_path": "metrics.jsonl", "serving": serving,
        "flywheel": fly}})
    with Children(tmp) as kids:
        serve = kids.start("flyserve", "--serve", cwd=run_dir)
        port = int(wait_for_line(kids, "flyserve", r"serving: listening on port (\d+)",
                                 300).group(1))
        check("data flywheel on" in kids.output("flyserve"), "15(d): the flywheel is not on")
        harvest_parity(port)
        m, u = FLY_EPISODES
        write_config(run_dir, {"env_args": {"env": "TicTacToe"}, "train_args": {
            "seed": SEED, "model_dir": "models", "metrics_path": "metrics.jsonl",
            "epochs": FLY_EPOCHS, "minimum_episodes": m, "update_episodes": u,
            "keep_checkpoints": 2, "worker": {"num_parallel": 0}, "serving": serving,
            "flywheel": dict(fly, harvest_port=port)}})
        clients = FlywheelClients(port).start()
        monitor = ServingClient("127.0.0.1", port)
        events, stop = [], threading.Event()

        def watch():
            last = None
            while not stop.is_set():
                s = monitor.stats()
                cand = s.get("quality_candidate", 0)
                now = time.perf_counter()
                if cand != last:
                    events.append((now, cand, s.get("quality_promotions", 0),
                                   s.get("quality_gate_failures", 0),
                                   s.get("quality_demotions", 0), s.get("flywheel_episodes", 0)))
                    last = cand
                stop.wait(0.05)

        watcher = threading.Thread(target=watch, daemon=True)
        watcher.start()
        t0 = time.perf_counter()
        _, secs = run_cli(run_dir, "--train", timeout=900,
                            env={"HANDYRL_FAULT_POISON_SNAPSHOT_AT_EPOCH": str(FLY_POISON)})
        stop.set()
        watcher.join(30)
        stats = monitor.stats()
        monitor.close()
        clients.close()
        window = time.perf_counter() - t0
        serve.send_signal(signal.SIGTERM)
        code = serve.wait(60)
        log = kids.output("flyserve")
    records = read_records(os.path.join(run_dir, "metrics.jsonl"))
    check(code == 75, f"15(d): the flywheel server exited {code}")
    check(not clients.errors and stats["serve_errors"] == 0,
          f"15(d): error frames: clients {clients.errors[:3]}, server {stats['serve_errors']}")
    check(stats["flywheel_dropped_malformed"] == 0,
          f"15(d): {stats['flywheel_dropped_malformed']} malformed harvest episodes")
    staged = re.findall(r"staged candidate epoch (\d+)", log)
    failed = re.findall(r"gate failed for epoch (\d+)", log)
    demoted = re.findall(r"demoted epoch (\d+)", log)
    promoted = re.findall(r"promoted epoch (\d+)", log)
    print(f"[flywheel] 15(d) the server: staged {staged}, promoted {promoted}, gate failed "
          f"{failed}, demoted {demoted}; judged games per epoch {clients.judged}")
    check(str(FLY_POISON) in staged and (str(FLY_POISON) in failed or str(FLY_POISON) in demoted),
          "15(d): the poisoned snapshot was not staged and failed or demoted")
    spans = []
    for (t, cand, *_), nxt in zip(events, events[1:] + [None]):
        if cand and nxt is not None:
            spans.append((cand, nxt[0] - t))
    rollbacks = max(r.get("flywheel_rollbacks", 0) for r in records)
    rolled = max(r.get("sentinel_flywheel_rollbacks", 0) for r in records)
    check(rollbacks >= 1 and rolled >= 1,
          f"15(d): the learner did not roll back (flywheel_rollbacks {rollbacks}, the trainer's "
          f"sentinel_flywheel_rollbacks {rolled})")
    check(all(math.isfinite(r["loss"]["total"]) for r in records if r.get("loss")),
          "15(d): a non-finite loss")
    pins = sorted(int(e) for e in json.loads(Path(run_dir, "models", "SERVING.json").read_text()
                                              ).values() if isinstance(e, int) and e > 0)
    for epoch in pins:
        check(ckpt.verify_snapshot(os.path.join(run_dir, "models"), epoch) is not False
              and Path(run_dir, "models", f"{epoch}.ckpt").exists(),
              f"15(d): the served epoch {epoch} did not survive gc_snapshots")
    # harvest_fraction 1.0 sets no per-epoch budget, so no episode is held
    # over it and the ingestor has no over-budget count to print
    per_epoch = "; ".join(
        f"epoch {r['epoch']}: ingested {r.get('flywheel_ingested', 0)} (cumulative), stale "
        f"{r.get('flywheel_ingest_stale', 0)}, malformed {r.get('flywheel_ingest_malformed', 0)}, "
        f"{r['updates_per_sec']:.2f} updates/s" for r in records)
    print(f"[flywheel] 15(d) --train on harvested traffic only ({FLY_EPOCHS} epochs of "
          f"{m} + {u} episodes, epoch {FLY_POISON} poisoned) in {secs:.1f} s: "
          f"{stats['flywheel_episodes'] / window:.1f} harvested episodes/s over {window:.1f} s "
          f"({stats['flywheel_episodes']} kept, {clients.dropped} dropped by the clients' view, "
          f"malformed {stats['flywheel_dropped_malformed']}, truncated "
          f"{stats['flywheel_dropped_truncated']}); {per_epoch}; flywheel_rollbacks {rollbacks}")
    print(f"[flywheel] 15(d) seconds from staging to verdict: "
          + ", ".join(f"epoch {c} {s:.2f} s" for c, s in spans)
          + f"; the pinned epochs {pins} survived gc_snapshots (keep_checkpoints 2)")


def phase_quantize_edge_flywheel(results, parts="abcd"):
    """15: int8 weights on the serving path, int8 observations on the
    training paths, exported artifacts and the edge, the data flywheel.
    15(b)(i) runs B1; nothing else here does.  ``parts`` picks the legs."""
    legs = {"a": int8_weights, "b": lambda tmp: int8_observations(tmp, results),
            "c": export_edge, "d": flywheel_run}
    print(f"[phase15] {card_line()}")
    times = [time.perf_counter()]
    with tempfile.TemporaryDirectory() as tmp:
        for tag in parts:
            legs[tag](tmp)
            times.append(time.perf_counter())
    _SEEDED.clear()
    took = ", ".join(f"({tag}) {t1 - t:.1f} s" for tag, t, t1 in zip(parts, times, times[1:]))
    print(f"[phase15] phase 15 {''.join(f'({tag})' for tag in parts)} in "
          f"{times[-1] - times[0]:.1f} s: {took}")


# ---------------------------------------------------------------------------
# 16: the autovec twins, the host-sync sanitizer, the league
# ---------------------------------------------------------------------------

AUTOVEC_GAMES = 2048       # 16(a): games per self-play call (bench.py:2425's accelerator size)
AUTOVEC_VERIFY = 64        # 16(a): verify() games per lift on the card
AUTOVEC_CALLS = 2          # 16(a): timed generate calls per turn
AUTOVEC_TURNS = ("hand", "lift", "lift", "hand")
C4_CLI = {                 # 16(a): --train on ConnectFour with the lifted twin
    "epochs": 1, "minimum_episodes": 64, "update_episodes": 64, "batch_size": 64,
    "device_rollout_games": 128, "autovec_verify_games": 8, "worker": {"num_parallel": 2},
    "seed": SEED,
}
SANITIZER_STEPS = 4        # 16(b): batch() calls and train steps in the window
SANITIZER_EPISODES = 64    # 16(b): host-born episodes staged before the window
LEAGUE_CLI = {             # 16(c): tests/test_league.py:475-494's geometry
    "epochs": 8, "update_episodes": 24, "minimum_episodes": 16, "batch_size": 8,
    "forward_steps": 4, "maximum_episodes": 500, "eval_rate": 0.0,
    "worker": {"num_parallel": 2}, "keep_checkpoints": 2, "seed": SEED,
    "league": {"promote_winrate": 0.4, "promote_games": 3, "selfplay_rate": 0.15,
               "pfsp_weighting": "var"},
}
PROMOTED = re.compile(r"league: promotion gate PASSED .* frozen (main-\d+)")


def lift_equals_hand(V, n):
    """16(a): the lifted TicTacToe against the hand twin on the card, n
    games on the same random legal actions: observations, masks, terminal
    flags, states and outcomes bit for bit.  Returns the tensors compared."""
    import torch

    from handyrl_tpu_torch.envs.vector_tictactoe import VectorTicTacToe as H

    gen = card_generator()
    s_v, s_h = V.init(n, CARD), H.init(n, CARD)
    compared = 0
    for t in range(H.max_steps):
        legal = H.legal_mask(s_h)
        pairs = [(V.terminal(s_v, t), H.terminal(s_h, t)), (V.legal_mask(s_v), legal),
                 (V.observation(s_v, t), H.observation(s_h, t))]
        pairs += [(s_v[k], s_h[k]) for k in s_h]
        for got, want in pairs:
            check(got.device.type == CARD and got.dtype == want.dtype and torch.equal(got, want),
                  f"16(a): the lifted TicTacToe differs from the hand twin at step {t}")
        compared += len(pairs)
        scores = torch.rand(legal.shape, generator=gen, device=CARD)
        action = torch.where(legal, scores, -1.0).argmax(-1)
        s_v, s_h = V.apply(s_v, action, t), H.apply(s_h, action, t)
    check(torch.equal(V.outcome(s_v), H.outcome(s_h)), "16(a): outcomes differ")
    return compared + 1


def twin_turns(env_name, twins):
    """16(a): device self-play, AUTOVEC_GAMES games per call, the same net
    and seed for each twin, in ``AUTOVEC_TURNS``: env-steps/s per turn, and
    the launches per game step of one profiled call."""
    import torch

    from handyrl_tpu_torch.config import normalize_args
    from handyrl_tpu_torch.envs import make_env
    from handyrl_tpu_torch.models import init_variables
    from handyrl_tpu_torch.runtime.device_rollout import DeviceRollout

    cfg = normalize_args({"env_args": {"env": env_name}, "train_args": {"seed": SEED}})
    args = dict(cfg["train_args"], env=cfg["env_args"])
    module = init_variables(make_env(cfg["env_args"]).net(), SEED)
    rolls = {tag: DeviceRollout(venv, module, args, AUTOVEC_GAMES, device=CARD)
             for tag, venv in twins.items()}
    turns = AUTOVEC_TURNS if len(twins) > 1 else ("lift",)
    rates = {tag: [] for tag in twins}
    for tag in turns:
        roll = rolls[tag]
        gen = card_generator()
        roll.generate(None, gen)   # warm-up: the lift's vmap traces, the allocator grows
        steps = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(AUTOVEC_CALLS):
            steps += sum(ep["steps"] for ep in roll.generate(None, gen))
        rates[tag].append(steps / (time.perf_counter() - t0))
    launches = {}
    for tag, roll in rolls.items():
        wall, device_ms, n, _ = profile_launches(lambda: roll.generate(None, card_generator()))
        launches[tag] = n / roll.venv.max_steps
        check(n > 0, f"16(a) {env_name} {tag}: the profiler saw no launch")
        print(f"[autovec] {env_name} {tag} ({roll.venv.__name__}, "
              f"{type(roll.module).__name__}, {AUTOVEC_GAMES} games x {roll.venv.max_steps} "
              f"plies): env-steps/s by turn {', '.join(f'{r:.1f}' for r in rates[tag])}; one "
              f"generate under the profiler: wall {wall:.1f} ms, device {device_ms:.1f} ms "
              f"({device_ms / wall:.1%} busy), {n} launches, {launches[tag]:.1f} per game step")
    if len(twins) > 1:
        mean = {tag: sum(r) / len(r) for tag, r in rates.items()}
        print(f"[autovec] {env_name} lifted / hand: {mean['lift'] / mean['hand']:.3f}x env-steps/s "
              f"(turns {', '.join(AUTOVEC_TURNS)}), launches per game step {launches['lift']:.1f} "
              f"/ {launches['hand']:.1f} (not gated: no target for the card)")


def autovec_cli(tmp):
    """16(a): ``--train`` on ConnectFour with its lifted twin on the card and
    ``autovec_verify_games``, started; ``autovec_cli_check`` reads it."""
    run_dir = os.path.join(tmp, "c4")
    write_config(run_dir, {"env_args": {"env": "ConnectFour"}, "train_args": C4_CLI})
    return start_cli(run_dir, "--train")


def autovec_cli_check(job):
    """16(a): the learner's verified line, a finite loss, device episodes."""
    run_dir = job["cwd"]
    out, run_s = finish_cli(job)
    line = (f"autovec twin verified: AutoVecConnectFourRules parity over "
            f"{C4_CLI['autovec_verify_games']} random games")
    check(line in out, "16(a): the learner printed no autovec verified line")
    records = read_records(os.path.join(run_dir, "metrics.jsonl"))
    last = records[-1]
    check(len(records) == C4_CLI["epochs"] and "loss" in last
          and math.isfinite(last["loss"]["total"]) and last.get("plane") == "fused"
          and last.get("device_episodes", 0) > 0,
          f"16(a) ConnectFour --train: records {records}")
    check_shm("autovec cli", records, out)
    print(f"[autovec] ConnectFour --train, device_rollout_games {C4_CLI['device_rollout_games']}: "
          f"'{line}'; {last.get('device_episodes', 0)} device episodes, mean length "
          f"{last.get('device_mean_episode_len', 0):.1f}, loss {last['loss']['total']:.4f}, "
          f"{last['updates_per_sec']:.2f} updates/s; started beside (d), done {run_s:.1f} s "
          "after its start at the latest")


def autovec_card(tmp):
    """16(a): the lifts on the card: verify, the hand-twin gate, self-play
    hand against lift, ConnectFour's lift (its CLI runs beside (d))."""
    from handyrl_tpu_torch.envs.autovec import autovectorize
    from handyrl_tpu_torch.envs.connect_four import ConnectFourRules
    from handyrl_tpu_torch.envs.tictactoe import TicTacToeRules
    from handyrl_tpu_torch.envs.vector_tictactoe import VectorTicTacToe

    lifts = {}
    for rules in (TicTacToeRules, ConnectFourRules):
        t0 = time.perf_counter()
        lifts[rules] = V = autovectorize(rules)
        t1 = time.perf_counter()
        V.verify(AUTOVEC_VERIFY, SEED, device=CARD)
        print(f"[autovec] {V.__name__}: lifted in {t1 - t0:.2f} s (meta-device checks), "
              f"verify({AUTOVEC_VERIFY}) on the card passed in {time.perf_counter() - t1:.2f} s")
    compared = lift_equals_hand(lifts[TicTacToeRules], AUTOVEC_GAMES)
    print(f"[autovec gate] the lifted TicTacToe equals VectorTicTacToe bit for bit over "
          f"{AUTOVEC_GAMES} games on the card ({compared} tensors compared)")
    twin_turns("TicTacToe", {"hand": VectorTicTacToe, "lift": lifts[TicTacToeRules]})
    twin_turns("ConnectFour", {"lift": lifts[ConnectFourRules]})


def sanitizer_window():
    """16(b): HostSyncSanitizer and RecompileSentinel (and CUDA's own sync
    debug mode, a second witness) around a warm ``batch_pipeline: device``
    window on 7a's config: SANITIZER_STEPS batch() calls and train steps,
    no sync and no build; then a deliberate ``.cpu()`` named by this
    file's line."""
    import inspect
    import warnings

    import torch
    import yaml

    from handyrl_tpu_torch.config import normalize_args
    from handyrl_tpu_torch.envs import make_env
    from handyrl_tpu_torch.models import init_variables
    from handyrl_tpu_torch.parallel import TrainContext
    from handyrl_tpu_torch.runtime.device_batch import DeviceBatchPipeline
    from handyrl_tpu_torch.runtime.replay import EpisodeStore
    from handyrl_tpu_torch.utils.sanitizers import HostSyncSanitizer, RecompileSentinel

    raw = yaml.safe_load((ROOT / "config.yaml").read_text())
    # observation: true, which the device stage needs under turn-based
    # training; 4 lanes x 16 steps, as 15(b)(ii)
    raw["train_args"].update(batch_pipeline="device", observation=True, device_stage_lanes=4,
                             device_stage_chunk=16, seed=SEED)
    cfg = normalize_args(raw)
    args = dict(cfg["train_args"], env=cfg["env_args"])
    episodes = random_episodes(cfg["env_args"], {"observation": True}, SANITIZER_EPISODES, SEED)
    store = EpisodeStore(1000)
    ctx = TrainContext(init_variables(make_env(cfg["env_args"]).net(), SEED), args)
    stop = threading.Event()
    pipe = DeviceBatchPipeline(args, store, ctx, stop)
    store.extend(episodes)
    pipe.start()
    lr = 1e-5
    try:
        ctx.train_step(pipe.batch(), lr)   # warm-up: the first flush, sample and step
        # the feeder's flushes read the rings' counters on its thread (a
        # sync): it stages every episode before the window opens
        check(pipe.wait_idle(), "16(b): the feeder did not stage the episodes")
        torch.cuda.synchronize()
        metrics = []
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                with HostSyncSanitizer() as sync, RecompileSentinel() as sentinel:
                    t0 = time.perf_counter()
                    for _ in range(SANITIZER_STEPS):
                        metrics.append(ctx.train_step(pipe.batch(), lr))
                    host_ms = (time.perf_counter() - t0) * 1e3
            finally:
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        # the mode's own notice ("a prototype feature") is not a sync
        debug = [w for w in caught if "called a synchronizing" in str(w.message)]
        sites = sorted({f"{w.filename}:{w.lineno}: {str(w.message)[:120]}" for w in debug})
        print(f"[sanitizer] 16(b) {SANITIZER_STEPS} batch() calls and train steps on 7a's config "
              f"(batch_pipeline: device, B{args['batch_size']} x T{args['forward_steps']}), "
              f"{host_ms:.1f} ms on the host: {sync.report()}; {sentinel.report()}; CUDA sync "
              f"debug mode: {len(debug)} warnings{' at ' + '; '.join(sites) if sites else ''}")
        if debug:
            # where CUDA saw the sync: one more step with its debug mode raising
            torch.cuda.set_sync_debug_mode("error")
            try:
                ctx.train_step(pipe.batch(), lr)
            except RuntimeError:
                import traceback

                print("[sanitizer] 16(b) the sync CUDA saw, raised in its debug mode 'error':\n"
                      + "".join(traceback.format_exc().splitlines(True)[-12:]))
            finally:
                torch.cuda.set_sync_debug_mode(0)
        check(not sync.events, f"16(b): blocking host syncs in the device window: {sync.report()}")
        check(sentinel.count == 0, f"16(b): {sentinel.report()}")
        check(all(math.isfinite(m["total"]) and m["sentinel_bad"] == 0 for m in metrics),
              "16(b): a non-finite or skipped step in the window")
        with HostSyncSanitizer() as sync:
            batch = pipe.batch()
            leak = inspect.currentframe().f_lineno + 1
            batch["action"].cpu()   # the deliberate leak
        report = sync.report()
        check(f"chip_smoke.py:{leak}" in report,
              f"16(b): the deliberate leak at chip_smoke.py:{leak} is not named: {report}")
        print(f"[sanitizer] 16(b) the deliberate leak: {report.splitlines()[-1].strip()}")
    finally:
        stop.set()
        pipe.stop()


def league_cli(tmp):
    """16(c): ``--league`` on TicTacToe at tests/test_league.py's geometry,
    on the shm plane, started; ``league_cli_check`` reads it."""
    run_dir = os.path.join(tmp, "league")
    write_config(run_dir, {"env_args": {"env": "TicTacToe"}, "train_args": LEAGUE_CLI})
    return start_cli(run_dir, "--league")


def league_cli_check(job):
    """16(c): promotions by the gate, each frozen member's books covering the
    pool of its time, the registry reloaded, the league_* keys, frozen
    epochs kept by a GC of keep_checkpoints 2, no substitution."""
    from handyrl_tpu_torch.league import ANCHOR, League
    from handyrl_tpu_torch.runtime import checkpoint as ckpt

    run_dir = job["cwd"]
    out, run_s = finish_cli(job)
    promoted = PROMOTED.findall(out)
    check(len(promoted) >= 2, f"16(c): {len(promoted)} promotions by the gate, fewer than 2")
    model_dir = os.path.join(run_dir, "models")
    league = League(model_dir)
    frozen = sorted((m for m in league.members.values() if m.role == "frozen"),
                    key=lambda m: m.epoch)
    check([m.name for m in frozen] == promoted and league.promotions == len(promoted),
          f"16(c): LEAGUE.json holds {sorted(league.members)}, the gate froze {promoted}")
    for i, m in enumerate(frozen):
        pool = [ANCHOR] + [x.name for x in frozen[:i]]
        check(league.payoff.coverage(m.name, pool, 3) == 1.0,
              f"16(c): {m.name}'s books do not cover {pool} with 3 games each")
        check(ckpt.verify_snapshot(model_dir, m.epoch) is True,
              f"16(c): {m.name}'s snapshot did not survive GC")
    records = read_records(os.path.join(run_dir, "metrics.jsonl"))
    last = records[-1]
    check(len(records) == LEAGUE_CLI["epochs"], f"16(c): {len(records)} epoch records")
    check(all(k in last for k in ("league_population", "league_pool", "league_matches",
                                  "league_forfeits", "league_payoff_coverage",
                                  "league_candidate_wp", "league_elo_spread",
                                  "league_promotions")), f"16(c): league keys {sorted(last)}")
    check(last["league_population"] == len(league.members)
          and league.payoff.matches >= last["league_matches"] > 0,
          f"16(c): the last record {last['league_population']} members, "
          f"{last['league_matches']} matches; LEAGUE.json {len(league.members)}, "
          f"{league.payoff.matches}")
    check(not any("serve_snapshot_substituted" in r for r in records),
          "16(c): a frozen opponent was served by the latest model")
    check_shm("league", records, out)
    collected = [e for e in range(1, LEAGUE_CLI["epochs"] + 1)
                 if not os.path.exists(os.path.join(model_dir, f"{e}.ckpt"))]
    # the frozen epochs GC would have taken: older than the newest keep_checkpoints
    pinned = [m.epoch for m in frozen
              if m.epoch <= LEAGUE_CLI["epochs"] - LEAGUE_CLI["keep_checkpoints"]]
    check(pinned, "16(c): no frozen epoch was old enough for GC to take")
    elo = ", ".join(f"{r['league_elo_spread']}" for r in records)
    print(f"[league] 16(c) --league, {LEAGUE_CLI['epochs']} epochs of "
          f"{LEAGUE_CLI['minimum_episodes']} + {LEAGUE_CLI['update_episodes']} episodes: promoted "
          f"{', '.join(promoted)} by the gate; {league.payoff.matches} matches, coverage 1.0 for "
          f"each frozen member; keep_checkpoints {LEAGUE_CLI['keep_checkpoints']}: epochs "
          f"collected {collected}, frozen epochs {pinned} older than that kept; elo spread by "
          f"epoch {elo}; {last['updates_per_sec']:.2f} updates/s in the last epoch; started "
          f"beside (d), done {run_s:.1f} s after its start at the latest")


def league_transformer(results, tmp):
    """16(d): the slice's transformer through ``LeagueLearner(args).run()``:
    run 1 trains 2 epochs, its epoch 1 is frozen as main-1 by the gate's own
    action; run 2 resumes for one epoch, in which main-1's match jobs are
    served by the router's resident engine for epoch 1.  Launch counts from
    0 at each run."""
    import torch

    from handyrl_tpu_torch.config import normalize_args
    from handyrl_tpu_torch.league import CANDIDATE, League
    from handyrl_tpu_torch.league.learner import LeagueLearner
    from handyrl_tpu_torch.ops.flash_attention import MASKED_FLASH
    from handyrl_tpu_torch.runtime import checkpoint as ckpt
    from handyrl_tpu_torch.runtime.replay import decompress_block

    model_dir = os.path.join(tmp, "models")

    def config(epochs, **over):
        return normalize_args({
            "env_args": {"env": "Geister", "net": "transformer", "net_args": NET_ARGS},
            "train_args": dict(TRAIN_ARGS, minimum_episodes=TRANSFORMER_EPISODES,
                               update_episodes=TRANSFORMER_EPISODES, epochs=epochs,
                               worker={"num_parallel": 8}, seed=SEED, model_dir=model_dir,
                               metrics_path=os.path.join(tmp, "metrics.jsonl"),
                               # no self-play slice; the gate never passes here
                               # (16(c) and the CPU tests hold its decision)
                               league={"selfplay_rate": 0.0, "promote_games": 10 ** 6},
                               **over)})

    before = MASKED_FLASH.launches
    learner = LeagueLearner(config(2))
    t0 = time.perf_counter()
    check(learner.run() == 0, "16(d) run 1 did not end cleanly")
    run1_s = time.perf_counter() - t0
    steps = learner.trainer.steps
    per_step = launches_per_step(learner.args)
    del learner
    gc.collect()
    torch.cuda.empty_cache()
    league = League(model_dir)
    # what the gate does when it passes: epoch 1 into the population
    epoch1_steps = int(ckpt.load_manifest(model_dir)["epochs"]["1"]["steps"])
    member = league.freeze_candidate(1, epoch1_steps)
    check(member.name == "main-1", f"16(d): froze {member.name}")

    cfg = config(3, restart_epoch=-1, keep_checkpoints=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    learner = LeagueLearner(cfg)
    check(learner.model_epoch == 2, f"16(d): run 2 resumed at epoch {learner.model_epoch}")
    server = learner.model_server
    seen = {}
    stop = server.stop

    def stop_and_keep_stats():
        # the router forgets its engines when it stops: read them first
        router = server._router
        seen["engines"] = {mid: e.stats() for mid, e in router._engines.items()}
        seen["router"] = router.stats()
        seen["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        stop()

    server.stop = stop_and_keep_stats
    run2_before, steps0 = MASKED_FLASH.launches, learner.trainer.steps
    t0 = time.perf_counter()
    check(learner.run() == 0, "16(d) run 2 did not end cleanly")
    run2_s = time.perf_counter() - t0
    run2_launches = MASKED_FLASH.launches - run2_before
    run2_steps = learner.trainer.steps - steps0
    launches = MASKED_FLASH.launches - before
    steps += run2_steps

    check(launches == per_step * steps and run2_launches == per_step * run2_steps > 0,
          f"16(d): B1 launched {launches} times in {steps} updates ({run2_launches} in "
          f"{run2_steps} of run 2), expected {per_step} per update")
    frozen_engine = seen["engines"].get(1)
    check(frozen_engine is not None and frozen_engine["requests_served"] > 0,
          f"16(d): main-1 was not served by a resident router engine: {seen['engines']}")
    check(seen["router"]["substituted"] == 0 and server.substituted_snapshots == 0,
          f"16(d): substitutions {seen['router']['substituted']}")
    matches = masked = 0
    for ep in learner.trainer.store.snapshot():
        meta = ep["args"].get("league") or {}
        if meta.get("mode") != "match":
            continue
        matches += 1
        seats = [p for p, name in meta["seats"].items() if name != CANDIDATE]
        for blk in ep["blocks"]:
            cols = decompress_block(blk)
            for p in seats:
                col = ep["players"].index(p)
                check(not cols["tmask"][:, col].any() and not cols["omask"][:, col].any(),
                      f"16(d): a frozen seat's tmask/omask is not zero")
                masked += 1
    check(matches > 0, "16(d): no match episode was fed")
    payoff = learner.league.payoff
    games = payoff.games(CANDIDATE, "main-1")
    check(games > 0, "16(d): no candidate-vs-main-1 game in the books")
    check(ckpt.verify_snapshot(model_dir, 1) is True and not os.path.exists(
        os.path.join(model_dir, "2.ckpt")),
          "16(d): GC (keep_checkpoints 1) did not keep main-1's epoch 1 and collect epoch 2")
    records = read_records(cfg["train_args"]["metrics_path"])
    check(all(math.isfinite(r["loss"]["total"]) for r in records if "loss" in r)
          and "loss" in records[-1], "16(d): a non-finite or missing loss")
    check_shm("league transformer", records)
    boundary = [r["boundary_snapshot_s"] + r["boundary_save_s"] + r["boundary_publish_s"]
                for r in records]
    results["masked_flash_attention"]["launches"] += launches
    print(f"[league] 16(d) LeagueLearner, Geister d{NET_ARGS['d_model']} L{NET_ARGS['n_layers']} "
          f"B{TRAIN_ARGS['batch_size']} T{TRAIN_ARGS['forward_steps']} bf16, "
          f"{TRANSFORMER_EPISODES} episodes per epoch: run 1 (2 epochs) {run1_s:.1f} s, run 2 "
          f"(epoch 3, main-1 in the pool) {run2_s:.1f} s; main-1 served by the router's engine "
          f"for epoch 1: {frozen_engine['requests_served']} requests in "
          f"{frozen_engine['batches_served']} batches, {seen['router']['models']} router engines "
          f"resident, 0 substituted; {matches} match episodes fed, {masked} frozen-seat blocks "
          f"zero-masked; candidate vs main-1 {games} games (wp "
          f"{payoff.win_points(CANDIDATE, 'main-1'):.3f}); B1 {launches} launches in {steps} "
          f"updates ({per_step} per update); seconds per boundary "
          f"{', '.join(f'{b:.2f}' for b in boundary)}; run 2's peak memory {seen['peak_gb']:.2f} "
          "GB (learner, the actors' engine, the router's latest mirrors and main-1's engine "
          "resident)")


def phase_league_autovec(results):
    """16: the autovec twins on the card, the sanitizer on the device data
    plane, the league through the CLI and at full width.  16(d) runs B1;
    nothing else here does.  The CLI runs of (a) and (c) go on in
    processes of their own beside (d)."""
    print(f"[phase16] {card_line()}")
    results.setdefault("masked_flash_attention", {"launches": 0})
    times = [time.perf_counter()]
    with tempfile.TemporaryDirectory() as tmp:
        autovec_card(tmp)
        times.append(time.perf_counter())
        sanitizer_window()
        times.append(time.perf_counter())
        jobs = [autovec_cli(tmp), league_cli(tmp)]
        try:
            league_transformer(results, tmp)
            times.append(time.perf_counter())
            autovec_cli_check(jobs[0])
            league_cli_check(jobs[1])
        finally:
            for job in jobs:
                if job["proc"].poll() is None:
                    job["proc"].kill()
                job["proc"].wait()
        times.append(time.perf_counter())
    parts = ", ".join(f"{tag} {t1 - t:.1f} s" for tag, t, t1 in zip(
        ("(a) in this process", "(b)", "(d) with the CLIs of (a) and (c) beside it",
         "the CLIs' tail"), times, times[1:]))
    print(f"[phase16] phase 16 in {times[-1] - times[0]:.1f} s: {parts}")

DIST_HEARTBEAT = 1.0      # 17: the health plane's heartbeat interval, seconds
DIST_HEARTBEAT_TIMEOUT = 30.0
DIST_DRAIN_S = 60.0       # 17(b): the learners' drain_deadline_seconds (the default)
DIST_ACTOR_EPOCHS = 3     # 17(c): the gateway-fed learner's epochs
DIST_LOST_EPISODES = (24, 12)  # 17(b): minimum_episodes and update_episodes (config.yaml: 400, 200)
# intra-op threads of each rank and actor host, as torchrun sets them for
# several processes on one host (8 cores shared with the other streams)
DIST_THREADS = "2"
# a rank or an actor host as a user runs it, its kernels' launches written
# to CHIP_SMOKE_LAUNCHES when main() returns
RANK_CHILD = r"""
import json, os, sys
from handyrl_tpu_torch.main import main
from handyrl_tpu_torch.ops.flash_attention import FLASH, MASKED_FLASH
import torch
code = main(["--train"])
with open(os.environ["CHIP_SMOKE_LAUNCHES"], "w") as f:
    json.dump({"masked_flash_attention": MASKED_FLASH.launches,
               "flash_attention": FLASH.launches,
               "peak_bytes": torch.cuda.max_memory_allocated()}, f)
sys.exit(code)
"""
RANK_LINE = re.compile(r"distributed learner: process (\d+)/(\d+) \((\w+)\) on (\S+), backend (\w+)")
CRC_LINE = re.compile(r"distributed learner: process (\d+) params crc32 ([0-9a-f]{8}) at step (\d+)")
MODULE_LINE = re.compile(r"distributed learner: process (\d+) module hashes to ([0-9a-f]{8}) at step "
                         r"(\d+)")
POLL_LINE = re.compile(r"actor host \d+: params -> version (\d+) \((\d+) bytes in ([\d.]+) s, "
                       r"lag (\d+) updates\)")


def free_ports():
    """A port p with p + 1 (the health plane) and p + 2 (the gateway) free."""
    import socket

    for _ in range(100):
        port = free_port()
        if port > 65000:
            continue
        try:
            for p in (port + 1, port + 2):
                with socket.socket() as sock:
                    sock.bind(("", p))
            return port
        except OSError:
            continue
    check(False, "no three free ports in a row")


def start_rank(cwd, tag, rank=0, env=None, script=RANK_CHILD):
    """``script`` (``RANK_CHILD``) in ``cwd`` with ``PROCESS_ID=rank``, its
    output and its launch counts in files beside ``cwd``."""
    base = Path(str(cwd) + f".{tag}{rank}")
    out, err = open(f"{base}.out", "w"), open(f"{base}.err", "w")
    proc = subprocess.Popen([sys.executable, "-c", script], cwd=cwd, stdout=out, stderr=err,
                            env=dict(cli_env(), PROCESS_ID=str(rank), PYTHONUNBUFFERED="1",
                                     OMP_NUM_THREADS=DIST_THREADS,
                                     CHIP_SMOKE_LAUNCHES=f"{base}.json", **(env or {})))
    out.close()
    err.close()
    return {"proc": proc, "base": base, "rank": rank, "t0": time.perf_counter(), "end": None}


def finish_rank(job, timeout):
    """(exit code, stdout, stderr, launch counts or None) of a ``start_rank``
    child; killed at ``timeout``."""
    proc = job["proc"]
    try:
        proc.wait(timeout=max(1.0, timeout))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    if job["end"] is None:
        job["end"] = time.perf_counter()
    out, err = (Path(f"{job['base']}.{ext}").read_text(errors="replace") for ext in ("out", "err"))
    counts = Path(f"{job['base']}.json")
    return proc.returncode, out, err, json.loads(counts.read_text()) if counts.exists() else None


def wait_ranks(jobs, timeout):
    """Each job's ``finish_rank``, the end time of each taken as it exits."""
    deadline = time.perf_counter() + timeout
    while any(j["proc"].poll() is None for j in jobs) and time.perf_counter() < deadline:
        for j in jobs:
            if j["end"] is None and j["proc"].poll() is not None:
                j["end"] = time.perf_counter()
        time.sleep(0.2)
    return [finish_rank(j, deadline - time.perf_counter()) for j in jobs]


def tail(results):
    return "\n".join(f"--- exit {rc}\n{out[-2500:]}\n{err[-2500:]}" for rc, out, err, _ in results)


def dist_config(port, train, env_args=None, **dist):
    return {"env_args": env_args or {"env": "Geister", "net": "transformer", "net_args": NET_ARGS},
            "train_args": dict(train, distributed=dict({
                "coordinator_address": f"127.0.0.1:{port}", "heartbeat_interval": DIST_HEARTBEAT,
                "heartbeat_timeout": DIST_HEARTBEAT_TIMEOUT}, **dist))}


def dist_ranks(results, tmp, leg):
    """17(a): two ranks of the slice's transformer; ``leg`` 'gloo' shares
    the one card, 'nccl' puts one rank on each of two cards."""
    from handyrl_tpu_torch.parallel.distributed import params_crc32
    from handyrl_tpu_torch.runtime import checkpoint as ckpt

    cwd = Path(tmp, leg)
    train = dict(TRAIN_ARGS, minimum_episodes=TRANSFORMER_EPISODES,
                 update_episodes=TRANSFORMER_EPISODES, epochs=2, worker={"num_parallel": 8},
                 seed=SEED)
    write_config(cwd, dist_config(free_ports(), train, num_processes=2))
    t0 = time.perf_counter()
    done = wait_ranks([start_rank(cwd, leg, r) for r in (0, 1)], 900)
    run_s = time.perf_counter() - t0
    check([rc for rc, *_ in done] == [0, 0], f"17(a) {leg}: exits {[rc for rc, *_ in done]}\n"
          + tail(done))
    ranks = [RANK_LINE.findall(out) for _, out, _, _ in done]
    check(all(len(r) == 1 for r in ranks), f"17(a) {leg}: rank lines {ranks}")
    backends = {r[0][4] for r in ranks}
    devices = [r[0][3] for r in ranks]
    check(backends == {leg}, f"17(a): backend {backends} on {devices}, the placement gives {leg}")
    crcs = [CRC_LINE.findall(out) for _, out, _, _ in done]
    check(all(len(c) == 1 for c in crcs), f"17(a) {leg}: crc lines {crcs}")
    (_, crc0, steps0), (_, crc1, steps1) = crcs[0][0], crcs[1][0]
    saved = ckpt.load_params(str(cwd / "models" / "2.ckpt"))
    # each rank's module on the card against its host snapshot: tells a
    # divergence of the trained params from a host copy that changed later
    modules = [MODULE_LINE.findall(out) for _, out, _, _ in done]
    check(crc0 == crc1 == f"{params_crc32(saved):08x}" and steps0 == steps1
          and [m[0][1:] for m in modules if m] == [(crc0, steps0), (crc1, steps1)],
          f"17(a) {leg}: params crc32 {crc0} at step {steps0} / {crc1} at step {steps1}, the "
          f"saved epoch 2 {params_crc32(saved):08x}; the modules' {modules}\n" + tail(done))
    check(sorted(os.listdir(cwd)) == ["config.yaml", "metrics.jsonl", "models"],
          f"17(a) {leg}: the run's directory holds {sorted(os.listdir(cwd))}: only rank 0 writes")
    check_snapshots(str(cwd / "models"), [1, 2])
    records = read_records(cwd / "metrics.jsonl")
    check(len(records) == 2 and all(r.get("dist_backend") == leg for r in records),
          f"17(a) {leg}: records {[(r['epoch'], r.get('dist_backend')) for r in records]}")
    per_step = launches_per_step(TRAIN_ARGS)
    launches = [counts["masked_flash_attention"] for _, _, _, counts in done]
    check(all(n == per_step * int(steps0) for n in launches) and int(steps0) > 0,
          f"17(a) {leg}: B1 launched {launches} times by the ranks in {steps0} updates each, "
          f"expected {per_step} per update")
    results["masked_flash_attention"]["launches"] += sum(launches)
    print_epochs(f"dist {leg}", records)
    for r in records:
        if "dist_allreduce_ms" in r:
            print(f"[dist] 17(a) {leg} epoch {r['epoch']}: {r['updates_per_sec']:.3f} updates/s "
                  f"({r['train_steps_per_sec']:.3f} while training), gradient all-reduce "
                  f"{r['dist_allreduce_ms']:.2f} ms and {r['dist_allreduce_bytes'] / 1e6:.1f} MB "
                  f"per step over {r['dist_allreduce_calls']} steps, input wait "
                  f"{r['input_wait_frac']:.1%}, rank reports {r.get('rank_reports')}")
    print(f"[dist] 17(a) {leg}: 2 ranks on {devices}, backend {leg}, {steps0} updates each in "
          f"{run_s:.1f} s; params crc32 {crc0} on both ranks and in models/2.ckpt; B1 "
          f"{launches} ({per_step} per update per rank); only rank 0 wrote models/ and "
          "metrics.jsonl")


def dist_lost_rank(tmp):
    """17(b): 7a's config on two ranks, rank 1 killed at epoch 1; exit 75
    within heartbeat_timeout + the drain deadline; a relaunch resumes."""
    import yaml

    from handyrl_tpu_torch.runtime import checkpoint as ckpt

    base = yaml.safe_load((ROOT / "config.yaml").read_text())
    train = dict(base["train_args"], epochs=3, minimum_episodes=DIST_LOST_EPISODES[0],
                 update_episodes=DIST_LOST_EPISODES[1], drain_deadline_seconds=DIST_DRAIN_S)
    cwd = Path(tmp, "lost")
    write_config(cwd, dist_config(free_ports(), train, base["env_args"], num_processes=2))
    jobs = [start_rank(cwd, "kill", r, env={"HANDYRL_FAULT_KILL_PROCESS_AT_EPOCH": "1:1"})
            for r in (0, 1)]
    done = wait_ranks(jobs, 600)
    check([rc for rc, *_ in done] == [75, 1], f"17(b): exits {[rc for rc, *_ in done]}, "
          "expected 75 (the survivor) and 1 (the killed rank)\n" + tail(done))
    gap = jobs[0]["end"] - jobs[1]["end"]
    check(gap <= DIST_HEARTBEAT_TIMEOUT + DIST_DRAIN_S,
          f"17(b): the survivor exited {gap:.1f} s after the lost rank, over heartbeat_timeout "
          f"{DIST_HEARTBEAT_TIMEOUT:.0f} + drain {DIST_DRAIN_S:.0f} s")
    err0 = done[0][2]
    fault = [line for line in err0.splitlines() if "host fault" in line]
    drained = re.findall(r"drain checkpoint: epoch (\d+)", err0)
    check(fault and drained, "17(b): the coordinator announced no host fault or drain checkpoint")
    epoch = int(drained[0])
    check(ckpt.latest_verified_epoch(str(cwd / "models")) == epoch,
          f"17(b): the drained epoch {epoch} does not verify as the newest")
    cfg = json.loads((cwd / "config.yaml").read_text())
    cfg["train_args"].update(restart_epoch=-1)
    cfg["train_args"]["distributed"]["coordinator_address"] = f"127.0.0.1:{free_ports()}"
    write_config(cwd, cfg)
    t0 = time.perf_counter()
    again = wait_ranks([start_rank(cwd, "resume", r) for r in (0, 1)], 600)
    check([rc for rc, *_ in again] == [0, 0], f"17(b) relaunch: exits "
          f"{[rc for rc, *_ in again]}\n" + tail(again))
    resumed = [re.findall(r"auto-resume \(restart_epoch: -1\): epoch (\d+)", out)
               for _, out, _, _ in again]
    check(resumed == [[str(epoch)], [str(epoch)]], f"17(b): the ranks resumed {resumed}, "
          f"expected epoch {epoch} on both")
    crcs = {c for _, out, _, _ in again for c in CRC_LINE.findall(out)}
    check(len({c[1] for c in crcs}) == 1, f"17(b): the relaunched ranks ended apart: {crcs}")
    print(f"[dist] 17(b) rank 1 killed at epoch 1: the coordinator exited 75 {gap:.1f} s after "
          f"it ({fault[0][:160]}), drain checkpoint epoch {epoch} verified; the relaunch resumed "
          f"epoch {epoch} on both ranks and ended 0 in {time.perf_counter() - t0:.1f} s")


def dist_actor_host(results, tmp):
    """17(c): a gateway-fed learner of 12(c)'s transformer and one actor
    host on the same card; the host SIGKILLed mid-run."""
    import signal

    lanes, slots, finished = DATA_TRANSFORMER
    train = dict(TRAIN_ARGS, seq_attention="flash", minimum_episodes=finished,
                 update_episodes=finished, epochs=DIST_ACTOR_EPOCHS, seed=SEED,
                 device_rollout_games=lanes, device_replay=True, device_replay_slots=slots,
                 device_replay_k_steps=32, worker={"num_parallel": 1})
    port = free_ports()
    learner_dir, actor_dir = Path(tmp, "learner"), Path(tmp, "actor")
    write_config(learner_dir, dist_config(port, train, num_processes=1, actor_hosts=1))
    write_config(actor_dir, dist_config(port, train, num_processes=1, role="actor"))
    learner = start_rank(learner_dir, "learner")
    actor = start_rank(actor_dir, "actor")
    metrics = learner_dir / "metrics.jsonl"
    # the host is killed once it has polled a param version (the trainer
    # publishes every param_refresh_updates updates) and the learner has
    # written its first epoch's record (records already in the rings)
    deadline = time.perf_counter() + 600
    while time.perf_counter() < deadline and learner["proc"].poll() is None:
        if (POLL_LINE.search(Path(f"{actor['base']}.out").read_text(errors="replace"))
                and metrics.exists() and metrics.read_text().count("\n") >= 1):
            break
        time.sleep(0.5)
    check(actor["proc"].poll() is None, "17(c): the actor host ended before its SIGKILL\n"
          + tail([finish_rank(actor, 1)]))
    actor["proc"].send_signal(signal.SIGKILL)
    actor["proc"].wait()
    # the records written before the host was gone
    killed_at = len(read_records(metrics))
    done = wait_ranks([learner, actor], 900)
    (rc, out, err, counts), (arc, aout, aerr, acounts) = done
    check(rc == 0 and arc == -signal.SIGKILL, f"17(c): learner exit {rc}, actor host {arc}\n"
          + tail(done))
    records = read_records(metrics)
    check(killed_at >= 1 and records[killed_at - 1]["plane_record_batches"] > 0,
          f"17(c): no record batch reached the rings before the SIGKILL ({killed_at} records)")
    check(killed_at < len(records), f"17(c): the learner wrote no epoch record after the "
          f"SIGKILL ({killed_at} of {len(records)})")
    last = records[-1]
    check(last["dist_actor_host_losses"] >= 1 and last["dist_actor_hosts"] == 0,
          f"17(c): losses {last.get('dist_actor_host_losses')}, live {last.get('dist_actor_hosts')}")
    check(len(records) == DIST_ACTOR_EPOCHS and all("loss" in r for r in records[1:]),
          f"17(c): {len(records)} records")
    polls = POLL_LINE.findall(aout)
    versions = [int(v) for v, *_ in polls]
    check(polls and versions == sorted(set(versions)) and versions[0] > 0,
          f"17(c): the host's polled versions {versions} do not rise")
    per_step = launches_per_step(TRAIN_ARGS)
    # every update the trainer took, those after the last record included
    crc = CRC_LINE.findall(out)
    check(len(crc) == 1, f"17(c): the learner printed {len(crc)} crc lines")
    steps = int(crc[0][2])
    check(counts["masked_flash_attention"] == per_step * steps,
          f"17(c): the learner launched B1 {counts['masked_flash_attention']} times in {steps} "
          f"updates, expected {per_step} per update")
    results["masked_flash_attention"]["launches"] += counts["masked_flash_attention"]
    rate = last["plane_record_bytes"] / max(last["plane_record_span_s"], 1e-9)
    print_epochs("dist actor host", records)
    for v, nbytes, secs, lag in polls:
        print(f"[dist] 17(c) the host polled version {v}: {int(nbytes) / 1e6:.1f} MB in "
              f"{float(secs):.3f} s, lag {lag} updates")
    print(f"[dist] 17(c) learner (device_replay, {lanes} lanes) fed by one actor host at {lanes} "
          f"lanes: {last['plane_record_batches']} record batches, "
          f"{last['plane_record_bytes'] / 1e6:.1f} MB into the rings in "
          f"{last['plane_record_span_s']:.1f} s, {rate / 1e6:.2f} MB/s of records "
          f"({last['plane_record_batches'] / max(last['plane_record_span_s'], 1e-9):.2f} blocks/s); "
          f"host SIGKILLed after {killed_at} records, the "
          f"learner ended 0 with dist_actor_host_losses {last['dist_actor_host_losses']}; B1 "
          f"{counts['masked_flash_attention']} ({per_step} per update, {steps} updates), the "
          f"host's {acounts['masked_flash_attention'] if acounts else 'n/a (killed)'}")


def phase_distributed(results, parts="abc"):
    """17: the learner of several processes and the actor host (see the
    docstring's phase 17)."""
    import torch

    results.setdefault("masked_flash_attention", {"launches": 0})
    with tempfile.TemporaryDirectory() as tmp:
        # (b)'s processes run beside (a)'s: this process only starts and
        # waits for them, on a thread for (b)
        lost = {}
        if "b" in parts:
            def run_lost():
                try:
                    dist_lost_rank(tmp)
                except BaseException as exc:
                    lost["error"] = exc
            lost["thread"] = threading.Thread(target=run_lost, name="phase-17b")
            lost["thread"].start()
        try:
            if "a" in parts:
                dist_ranks(results, tmp, "gloo")
                if torch.cuda.device_count() >= 2:
                    dist_ranks(results, tmp, "nccl")
                else:
                    print(f"[dist] 17(a) nccl leg: not run ({torch.cuda.device_count()} card)")
        finally:
            if "thread" in lost:
                lost["thread"].join()
        if "error" in lost:
            raise lost["error"]
        if "c" in parts:
            dist_actor_host(results, tmp)


RING_SHAPE = (32, 512, 16, 96)   # 18(a): rows (B16 x 2 players), T, heads, head dim
RING_WINDOW = 32                 # memory_len of the slice's transformer
RING_SIZES = (2, 4)              # 18(a): the sp groups of the op
RING_REPEATS = 3                 # 18(a): timed forward+backward calls, after one warm-up
RING_SEED = 18
RING_LR = 1e-4                   # 18(b): the one step's lr
RING_TOLERANCE = 2e-2            # 18(a): bf16, of the reference's scale
# 18(b): the ring's step against the one-process flash step, both in bf16
# through 8 layers: the metrics within 6's kernel-against-einsum bound (the
# ring casts the probabilities to bf16 before V, as JAX does; B1 keeps them
# fp32), the data count exactly
RING_STEP_TOLERANCE = 5e-2
RING_RANK = r"""
import sys
import chip_smoke as cs
sys.exit(cs.ring_rank(*sys.argv[1:]))
"""


def ring_inputs():
    """18(a)'s q, k, v, key mask, slopes and output gradient, on the card,
    from ``RING_SEED``: the same in every process."""
    import torch

    rows, T, H, D = RING_SHAPE
    q, k, v, key_mask, slopes = attention_inputs(rows, T, H, D, torch.bfloat16, RING_SEED,
                                                 device=CARD)
    g = torch.Generator(device=CARD).manual_seed(RING_SEED + 1)
    dout = torch.randn(q.shape, device=CARD, generator=g).to(torch.bfloat16)
    return q, k, v, key_mask, slopes, dout


def ring_rank(mode, rank, nprocs, port, outdir):
    """One rank of 18(a)/(b) (``RING_RANK``, a process of its own): the
    masked ring op's forward and backward on its shard at the slice's
    shapes, and with ``mode`` 'step' one train step of ``seq_attention:
    ring`` on the group; results in ``outdir`` (tensors) and a JSON line."""
    import torch

    from handyrl_tpu_torch.ops.flash_attention import MASKED_FLASH
    from handyrl_tpu_torch.ops.ring_attention import masked_ring_attention_shard
    from handyrl_tpu_torch.parallel import distributed
    from handyrl_tpu_torch.parallel.mesh import make_mesh

    rank, nprocs = int(rank), int(nprocs)
    torch.set_num_threads(int(DIST_THREADS))
    _, device = distributed.init_distributed({
        "coordinator_address": f"127.0.0.1:{port}", "num_processes": nprocs,
        "process_id": rank, "initialization_timeout": 300.0})
    torch.cuda.set_device(device)
    mesh = make_mesh({"sp": nprocs})
    mesh.build_groups()
    sp = mesh.group("sp")
    report = {"rank": rank, "device": str(device), "backend": distributed.backend()}

    q, k, v, key_mask, slopes, dout = ring_inputs()
    counts = torch.cumsum(key_mask, dim=1)   # the global cumsum, sliced below
    T = RING_SHAPE[1]
    t = T // nprocs
    cut = slice(sp.index * t, (sp.index + 1) * t)
    qs, ks, vs = (x[:, cut].contiguous().requires_grad_() for x in (q, k, v))
    mask_s, counts_s, dout_s = (x[:, cut].contiguous() for x in (key_mask, counts, dout))

    def op():
        for x in (qs, ks, vs):
            x.grad = None
        out = masked_ring_attention_shard(qs, ks, vs, mask_s, counts_s, slopes, sp, RING_WINDOW)
        (out.float() * dout_s.float()).sum().backward()
        torch.cuda.synchronize()
        return out

    launches0 = MASKED_FLASH.launches
    out = op()   # warm-up
    before = sp.stats()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(RING_REPEATS):
        t0 = time.perf_counter()
        out = op()
        times.append((time.perf_counter() - t0) * 1e3)
    after = sp.stats()
    torch.save({"out": out.detach().cpu(), "dq": qs.grad.cpu(), "dk": ks.grad.cpu(),
                "dv": vs.grad.cpu()}, Path(outdir, f"op{nprocs}.rank{rank}.pt"))
    report["op"] = {"ms": sorted(times)[len(times) // 2], "all_ms": times,
                    "bytes": (after["bytes"] - before["bytes"]) / RING_REPEATS,
                    "shifts": (after["shifts"] - before["shifts"]) / RING_REPEATS,
                    "shift_ms": (after["seconds"] - before["seconds"]) / RING_REPEATS * 1e3,
                    "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                    "launches": MASKED_FLASH.launches - launches0}
    del q, k, v, qs, ks, vs, out
    if mode == "step":
        report["step"] = ring_train_rank(mesh, sp, rank, device, outdir)
    Path(outdir, f"{mode}{nprocs}.rank{rank}.json").write_text(json.dumps(report))
    distributed.shutdown_distributed()
    return 0


def ring_train_args(**extra):
    from handyrl_tpu_torch.config import normalize_args

    env_args = {"env": "Geister", "net": "transformer", "net_args": NET_ARGS}
    cfg = normalize_args({"env_args": env_args, "train_args": dict(TRAIN_ARGS, **extra)})
    return dict(cfg["train_args"], env=env_args)


def ring_train_rank(mesh, sp, rank, device, outdir):
    """18(b) on one rank: ``TrainContext(seq_attention='ring')`` on the
    group from the seed's weights, one step on the parent's batch."""
    import torch

    from handyrl_tpu_torch.envs import make_env
    from handyrl_tpu_torch.models import init_variables
    from handyrl_tpu_torch.ops.flash_attention import MASKED_FLASH
    from handyrl_tpu_torch.parallel import TrainContext
    from handyrl_tpu_torch.parallel.distributed import params_crc32

    args = ring_train_args(seq_attention="ring", mesh={"sp": sp.size})
    module = init_variables(make_env(args["env"]).net(), SEED)
    ctx = TrainContext(module, args, device, mesh=mesh)
    batch = torch.load(Path(outdir, "batch.pt"), weights_only=False)
    before = sp.stats()
    launches0 = MASKED_FLASH.launches
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    metrics = dict(ctx.train_step(batch, RING_LR).fetch())
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    after = sp.stats()
    if rank == 0:
        torch.save({n: p.detach().cpu() for n, p in module.named_parameters()},
                   Path(outdir, "ring_params.pt"))
    return {"metrics": metrics, "crc": f"{params_crc32(module.state_dict()):08x}",
            "step_s": step_s, "ring_bytes": after["bytes"] - before["bytes"],
            "ring_shifts": after["shifts"] - before["shifts"],
            "ring_ms": (after["seconds"] - before["seconds"]) * 1e3,
            "allreduce_ms": ctx.grad_reduce.stats()["seconds"] * 1e3,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": MASKED_FLASH.launches - launches0}


def start_ring_ranks(mode, nprocs, outdir):
    port = free_ports()
    jobs = []
    for r in range(nprocs):
        base = Path(outdir, f"{mode}{nprocs}.rank{r}")
        out, err = open(f"{base}.out", "w"), open(f"{base}.err", "w")
        proc = subprocess.Popen(
            [sys.executable, "-c", RING_RANK, mode, str(r), str(nprocs), str(port), str(outdir)],
            cwd=ROOT, stdout=out, stderr=err,
            env=dict(cli_env(), PYTHONUNBUFFERED="1", OMP_NUM_THREADS=DIST_THREADS))
        out.close()
        err.close()
        jobs.append({"proc": proc, "base": base, "rank": r, "t0": time.perf_counter(),
                     "end": None})
    return jobs


def finish_ring_ranks(tag, jobs, mode, nprocs, outdir, timeout):
    done = wait_ranks(jobs, timeout)
    check([rc for rc, *_ in done] == [0] * nprocs,
          f"{tag}: ranks exited {[rc for rc, *_ in done]}\n" + tail(done))
    return [json.loads(Path(outdir, f"{mode}{nprocs}.rank{r}.json").read_text())
            for r in range(nprocs)]


def ring_reference():
    """B1 and its recompute backward on the whole window, in this process:
    what every rank's shard is held against."""
    import torch

    from handyrl_tpu_torch.ops.flash_attention import masked_flash_attention

    q, k, v, key_mask, slopes, dout = ring_inputs()
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    out = masked_flash_attention(q, k, v, key_mask, slopes, RING_WINDOW)
    (out.float() * dout.float()).sum().backward()
    return {"out": out.detach(), "dq": q.grad, "dk": k.grad, "dv": v.grad}


def check_ring_op(nprocs, reports, ref, outdir):
    import torch

    T = RING_SHAPE[1]
    t = T // nprocs
    worst = {}
    for r in range(nprocs):
        got = torch.load(Path(outdir, f"op{nprocs}.rank{r}.pt"))
        for key, want in ref.items():
            part = want[:, r * t:(r + 1) * t].float()
            err = (got[key].to(part.device).float() - part).abs().max().item()
            scale = want.float().abs().max().item()
            worst[key] = max(worst.get(key, 0.0), err / scale)
            check(err <= RING_TOLERANCE * scale,
                  f"18(a) sp {nprocs} rank {r}: {key} max_abs_err {err:.3e} over "
                  f"{RING_TOLERANCE} x scale {scale:.3e}")
    for rep in reports:
        check(rep["op"]["launches"] == 0, f"18(a): rank {rep['rank']} launched a kernel")
    ms = [rep["op"]["ms"] for rep in reports]
    op = reports[0]["op"]
    print(f"[ring] 18(a) sp {nprocs} ({reports[0]['backend']} on {reports[0]['device']} for "
          f"every rank): the masked ring at {RING_SHAPE} bf16, window {RING_WINDOW}, within "
          f"{RING_TOLERANCE} of B1's scale on every shard (worst "
          + ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
          + f"); forward+backward {min(ms):.1f}-{max(ms):.1f} ms per rank (median of "
          f"{RING_REPEATS}), of it {op['shift_ms']:.1f} ms in {op['shifts']:.0f} shifts; ring "
          f"bytes per layer {op['bytes'] / 1e6:.1f} MB sent per rank; peak memory per rank "
          + ", ".join(f"{rep['op']['peak_gb']:.2f}" for rep in reports) + " GB; 0 launches")


def ring_batch(outdir):
    """18(b)'s batch: B16 x T512 windows of random-play Geister episodes,
    seeded, saved for the ranks."""
    import torch

    from handyrl_tpu_torch.runtime import EpisodeStore, make_batch

    args = ring_train_args(seq_attention="flash")
    store = EpisodeStore(64)
    store.extend(random_episodes(args["env"], {"observation": True}, EPISODES, RING_SEED))
    random.seed(RING_SEED)
    windows = [store.sample_window(args["forward_steps"], args["burn_in_steps"],
                                   args["compress_steps"]) for _ in range(args["batch_size"])]
    batch = make_batch(windows, args)
    torch.save(batch, Path(outdir, "batch.pt"))
    return batch


def ring_flash_step(results, batch):
    """18(b)'s one-process reference: the same weights and batch through
    ``TrainContext(seq_attention='flash')``, B1 on the path."""
    import torch

    from handyrl_tpu_torch.envs import make_env
    from handyrl_tpu_torch.models import init_variables
    from handyrl_tpu_torch.ops.flash_attention import MASKED_FLASH
    from handyrl_tpu_torch.parallel import TrainContext

    args = ring_train_args(seq_attention="flash")
    module = init_variables(make_env(args["env"]).net(), SEED)
    ctx = TrainContext(module, args)
    before = {n: p.detach().clone() for n, p in module.named_parameters()}
    launches0 = MASKED_FLASH.launches
    metrics = dict(ctx.train_step(batch, RING_LR).fetch())
    torch.cuda.synchronize()
    launches = MASKED_FLASH.launches - launches0
    check(launches == launches_per_step(args),
          f"18(b): the flash step launched B1 {launches} times, expected {launches_per_step(args)}")
    results["masked_flash_attention"]["launches"] += launches
    after = {n: p.detach() for n, p in module.named_parameters()}
    return metrics, before, after, launches


def check_ring_step(reports, flash, outdir):
    import torch

    metrics, before, after, launches = flash
    steps = [rep["step"] for rep in reports]
    check(steps[0]["crc"] == steps[1]["crc"], f"18(b): the ranks' params crc32 "
          f"{[s['crc'] for s in steps]} differ")
    check(steps[0]["metrics"] == steps[1]["metrics"], "18(b): the ranks' metrics differ")
    ring = steps[0]["metrics"]
    check(all(s["launches"] == 0 for s in steps), "18(b): a ring rank launched a kernel")
    check(ring["sentinel_bad"] == 0 and ring["dcnt"] == metrics["dcnt"],
          f"18(b): sentinel {ring['sentinel_bad']}, dcnt {ring['dcnt']} against {metrics['dcnt']}")
    for key in ("total", "p", "v"):
        err, scale = abs(ring[key] - metrics[key]), max(1.0, abs(metrics[key]))
        check(math.isfinite(ring[key]) and err <= RING_STEP_TOLERANCE * scale,
              f"18(b): {key} {ring[key]:.5f} against the flash step's {metrics[key]:.5f}")
    params = torch.load(Path(outdir, "ring_params.pt"))
    worst, agree, total = 0.0, 0, 0
    for n, p in params.items():
        d_ring = p.to(before[n].device) - before[n]
        d_flash = after[n] - before[n]
        diff = (d_ring - d_flash).abs()
        worst = max(worst, diff.max().item())
        agree += int((diff <= 0.1 * RING_LR).sum())
        total += diff.numel()
    # Adam's first step moves a weight by ~lr * sign(gradient): the steps
    # differ by at most a sign flip, where a gradient is near 0
    check(worst <= 2 * RING_LR * 1.01, f"18(b): the updates differ by {worst:.3e} > 2 lr")
    check(agree >= 0.9 * total, f"18(b): {agree / total:.2%} of the updates within 0.1 lr")
    s = steps[0]
    print(f"[ring] 18(b) one train step at 7b's width (B{TRAIN_ARGS['batch_size']} x "
          f"T{TRAIN_ARGS['forward_steps']} {TRAIN_ARGS['compute_dtype']}, "
          f"{NET_ARGS['n_layers']} layers) on sp 2 against the one-process flash step: total "
          f"{ring['total']:.5f} / {metrics['total']:.5f}, p {ring['p']:.5f} / {metrics['p']:.5f}, v "
          f"{ring['v']:.5f} / {metrics['v']:.5f}, dcnt {ring['dcnt']:.0f} (both); updates within "
          f"0.1 lr {agree / total:.2%}, worst {worst / RING_LR:.3f} lr; params crc32 {s['crc']} "
          f"on both ranks; ring step {s['step_s']:.2f} s ({s['ring_ms']:.0f} ms in "
          f"{s['ring_shifts']} shifts, {s['ring_bytes'] / 1e9:.3f} GB sent per rank), "
          f"all-reduce {s['allreduce_ms']:.0f} ms; peak memory per rank "
          + ", ".join(f"{st['peak_gb']:.2f}" for st in steps)
          + f" GB; B1 {launches} in the flash step, 0 on the ring ranks")


def ring_cli(tmp):
    """18(c)'s ranks: 7b's configuration through ``--train`` with
    ``seq_attention: ring`` on ``{'sp': 2}``, started."""
    cwd = Path(tmp, "ring_cli")
    train = dict(TRAIN_ARGS, seq_attention="ring", mesh={"sp": 2},
                 minimum_episodes=TRANSFORMER_EPISODES, update_episodes=TRANSFORMER_EPISODES,
                 epochs=2, worker={"num_parallel": 8}, seed=SEED)
    write_config(cwd, dist_config(free_ports(), train, num_processes=2))
    return cwd, [start_rank(cwd, "ring", r) for r in (0, 1)], time.perf_counter()


def check_ring_cli(cwd, jobs, t0):
    from handyrl_tpu_torch.parallel.distributed import params_crc32
    from handyrl_tpu_torch.runtime import checkpoint as ckpt

    done = wait_ranks(jobs, 900)
    run_s = time.perf_counter() - t0
    check([rc for rc, *_ in done] == [0, 0], f"18(c): exits {[rc for rc, *_ in done]}\n"
          + tail(done))
    ranks = [RANK_LINE.findall(out) for _, out, _, _ in done]
    check(all(len(r) == 1 for r in ranks), f"18(c): rank lines {ranks}")
    backends = {r[0][4] for r in ranks}
    check(len(backends) == 1, f"18(c): backends {backends}")
    crcs = [CRC_LINE.findall(out) for _, out, _, _ in done]
    check(all(len(c) == 1 for c in crcs), f"18(c): crc lines {crcs}")
    (_, crc0, steps0), (_, crc1, steps1) = crcs[0][0], crcs[1][0]
    saved = ckpt.load_params(str(cwd / "models" / "2.ckpt"))
    check(crc0 == crc1 == f"{params_crc32(saved):08x}" and steps0 == steps1 and int(steps0) > 0,
          f"18(c): params crc32 {crc0} at step {steps0} / {crc1} at step {steps1}, the saved "
          f"epoch 2 {params_crc32(saved):08x}")
    check(sorted(os.listdir(cwd)) == ["config.yaml", "metrics.jsonl", "models"],
          f"18(c): the run's directory holds {sorted(os.listdir(cwd))}: only rank 0 writes")
    check("a member: no actors" in done[1][1] and "its leader" in done[0][1],
          "18(c): the ranks did not report their sp roles")
    check_snapshots(str(cwd / "models"), [1, 2])
    records = read_records(cwd / "metrics.jsonl")
    check(len(records) == 2, f"18(c): {len(records)} records")
    launches = [counts["masked_flash_attention"] for _, _, _, counts in done]
    check(launches == [0, 0], f"18(c): the ring ranks launched B1 {launches} times")
    print_epochs("ring cli", records)
    for r in records:
        if "dist_ring_ms" in r:
            beside = f", 7b {RATES['7b']:.3f} in this call" if "7b" in RATES else ""
            print(f"[ring] 18(c) epoch {r['epoch']}: {r['train_steps_per_sec']:.3f} updates/s "
                  f"while training{beside}; ring {r['dist_ring_ms']:.1f} ms and "
                  f"{r['dist_ring_bytes'] / 1e9:.3f} GB sent in {r['dist_ring_shifts']} shifts per "
                  f"step, gradient all-reduce {r['dist_allreduce_ms']:.1f} ms per step, input "
                  f"wait {r['input_wait_frac']:.1%}")
    peaks = [counts.get("peak_bytes", 0) / 1e9 for _, _, _, counts in done]
    print(f"[ring] 18(c): 2 ranks ({backends.pop()}) of --train with seq_attention: ring, mesh "
          f"{{'sp': 2}}: {steps0} updates each in {run_s:.1f} s; params crc32 {crc0} on both "
          f"ranks and in models/2.ckpt; only rank 0 wrote; rank 1 ran no actor; B1 0 launches; "
          f"peak memory per rank {peaks[0]:.2f}, {peaks[1]:.2f} GB")


def phase_ring(results):
    """18: sequence-parallel training over ranks sharing the card (see the
    docstring's phase 18).  (c)'s ranks run beside (a) and (b)."""
    import torch

    results.setdefault("masked_flash_attention", {"launches": 0})
    with tempfile.TemporaryDirectory() as tmp:
        cwd, cli_jobs, cli_t0 = ring_cli(tmp)
        try:
            batch = ring_batch(tmp)
            ref = ring_reference()
            for nprocs in RING_SIZES:
                mode = "step" if nprocs == 2 else "op"
                jobs = start_ring_ranks(mode, nprocs, tmp)
                flash = ring_flash_step(results, batch) if mode == "step" else None
                reports = finish_ring_ranks(f"18(a) sp {nprocs}", jobs, mode, nprocs, tmp, 600)
                check_ring_op(nprocs, reports, ref, tmp)
                if flash is not None:
                    check_ring_step(reports, flash, tmp)
                del flash
                torch.cuda.empty_cache()
        except BaseException:
            for job in cli_jobs:   # a drain, then the kill at the bound
                job["proc"].terminate()
            wait_ranks(cli_jobs, 120)
            raise
        check_ring_cli(cwd, cli_jobs, cli_t0)
        print(f"[ring] NCCL leg: not run ({torch.cuda.device_count()} card)"
              if torch.cuda.device_count() < 2 else
              "[ring] NCCL leg: not run (the ranks of this phase share card 0)")


def leftovers(shm_before, stream=None):
    """Shared-memory segments and processes of the port alive now: segments
    made since ``shm_before``, this process's children, and CLI processes
    (a CLI learner's batchers carry its command line).  With ``stream``,
    only the processes of that stream (their environment names it) and no
    segment: the other streams' segments live beside this one's, and the
    whole script's check, made once every stream has ended, counts them."""
    import multiprocessing as mp

    segments = [] if stream else sorted(
        n for n in set(os.listdir("/dev/shm")) - shm_before if n.startswith("psm_"))
    procs = []
    for pid in os.listdir("/proc"):
        if not pid.isdigit() or int(pid) == os.getpid():
            continue
        try:
            cmdline = Path("/proc", pid, "cmdline").read_bytes().replace(b"\0", b" ").decode()
            if stream and f"{STREAM_ENV}={stream}".encode() not in \
                    Path("/proc", pid, "environ").read_bytes().split(b"\0"):
                continue
        except OSError:
            continue
        if "handyrl_tpu_torch.main" in cmdline:
            procs.append(f"{pid}: {cmdline.strip()}")
    procs += [f"{c.pid}: {c.name}" for c in mp.active_children()]
    return segments, procs


def profile_call(label, fn, top=12):
    """One more call of fn under torch.profiler: the device-busy share of
    its wall time and the kernels that took the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events are kernels and copies, plus the ranges of
    # record_function annotations (e.g. "Optimizer.step#Adam.step"), which
    # span kernels already counted
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and "#" not in e.key]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    if device_ms == 0:
        print("[profile] the profiler saw no device time: not measured")
        return
    print(f"[profile] {label}: wall {wall_ms:.1f} ms, kernels {device_ms:.1f} ms "
          f"({device_ms / wall_ms:.1%} busy), {sum(e.count for e in events)} kernel launches")
    ranked = sorted(events, key=lambda e: -e.self_device_time_total)
    # the top ones, and the port's own kernels wherever they rank
    for rank, e in enumerate(ranked, 1):
        if rank <= top or "wgmma_kernel" in e.key or "fma_kernel" in e.key:
            print(f"[profile] {e.self_device_time_total / 1e3:8.2f} ms {e.count:6d}x  "
                  f"#{rank} {e.key[:90]}")


def _phase_6(results):
    import torch

    env_args, module, episodes = phase_acting(results)
    phase_training(results, env_args, module, episodes)
    del module, episodes
    torch.cuda.empty_cache()


def _phase_8(results):
    from handyrl_tpu_torch.ops.flash_attention import FLASH, MASKED_FLASH

    phase_drc_learner(results)
    print(f"[drc] kernel launches in phase 8a: masked {MASKED_FLASH.launches}, "
          f"flash {FLASH.launches}")
    phase_geese_cli(results)   # in processes of its own


# 19: the split device plane (plane: split)
SPLIT_REFRESH = 2         # 19(a)'s param_refresh_updates
SPLIT_EPOCHS = 2          # 19(a)/(b)'s epochs (17(c)'s 3, cut to fit the time limit)
# 19's learners as a user runs them (main(["--train"]) in a directory holding
# config.yaml), their kernels' launches (by stream too), their trainer's
# updates, their wall seconds and their peak memory written to
# CHIP_SMOKE_LAUNCHES when main() returns
SPLIT_CHILD = r"""
import json, os, sys, time
import torch
from handyrl_tpu_torch.main import main
from handyrl_tpu_torch.ops.flash_attention import FLASH, MASKED_FLASH
from handyrl_tpu_torch.runtime import learner
steps = []
run = learner.Learner.run
def counted(self):
    try:
        return run(self)
    finally:
        steps.append(self.trainer.steps)
learner.Learner.run = counted
t0 = time.perf_counter()
code = main(["--train"])
with open(os.environ["CHIP_SMOKE_LAUNCHES"], "w") as f:
    json.dump({"masked_flash_attention": MASKED_FLASH.launches,
               "flash_attention": FLASH.launches,
               "stream_launches": {str(k): v for k, v in MASKED_FLASH.stream_launches.items()},
               "steps": steps[-1] if steps else None, "wall_s": time.perf_counter() - t0,
               "peak_bytes": torch.cuda.max_memory_allocated()}, f)
sys.exit(code)
"""
SPLIT_START = re.compile(r"device planes: split — learner \{.*?\} on (\S+) \(stream (0x[0-9a-f]+)"
                         r".*?actor \{'dp': (\d+)\} on \['(\S+) \(stream (0x[0-9a-f]+)")
SPLIT_END = re.compile(r"device planes: rollout launches by stream (\{.*?\}); param refreshes "
                       r"(\d+) of (\d+) bytes, ([\d.]+|n/a) ms per copy; records (\d+) bytes in "
                       r"(\d+) transfers")
# 19(c): tests/test_sentinel.py:525-560's learner (ParallelTicTacToe, its
# streaming twin, device replay) on one process, its rollout wedged; 3
# epochs (110 episodes) need more than the 2 blocks played before the wedge
# (8 lanes x 16 steps make at most ~43 games a block); a 10 s stall bound,
# as the other streams load the host (a 1 s bound tripped on the healthy
# fused plane after the degrade)
SPLIT_WEDGE = {
    "turn_based_training": False, "observation": False, "batch_size": 8, "forward_steps": 4,
    "burn_in_steps": 0, "device_rollout_games": 8, "device_replay": True,
    "device_replay_slots": 64, "device_replay_k_steps": 16, "minimum_episodes": 20,
    "update_episodes": 30, "maximum_episodes": 400, "epochs": 3, "eval_rate": 0.0,
    "worker": {"num_parallel": 1}, "plane": "split", "actor_chips": 1,
    "param_refresh_updates": 2, "plane_stall_timeout": 10.0, "plane_max_restarts": 0,
}


def split_config(plane):
    """17(c)'s learner (12(c)'s transformer from the rings, 2 epochs) under
    ``plane``, one actor member sharing the card on its own stream."""
    lanes, slots, finished = DATA_TRANSFORMER
    return {"env_args": {"env": "Geister", "net": "transformer", "net_args": NET_ARGS},
            "train_args": dict(TRAIN_ARGS, seq_attention="flash", minimum_episodes=finished,
                               update_episodes=finished, epochs=SPLIT_EPOCHS, seed=SEED,
                               device_rollout_games=lanes, device_replay=True,
                               device_replay_slots=slots, device_replay_k_steps=32,
                               worker={"num_parallel": 1}, plane=plane, actor_chips=1,
                               param_refresh_updates=SPLIT_REFRESH)}


def split_learner(results, tmp, plane):
    """One of 19(a)/(b): the learner's exit 0, one record per epoch, B1
    n_layers times per update; returns its records, output and counts."""
    cwd = Path(tmp, plane)
    write_config(cwd, split_config(plane))
    ((rc, out, err, counts),) = wait_ranks([start_rank(cwd, plane, script=SPLIT_CHILD)], 900)
    tag = "19(a)" if plane == "split" else "19(b)"
    check(rc == 0 and counts is not None and counts["steps"],
          f"{tag}: the learner exited {rc}\n" + tail([(rc, out, err, counts)]))
    records = read_records(cwd / "metrics.jsonl")
    check(len(records) == SPLIT_EPOCHS and all("loss" in r for r in records[1:]),
          f"{tag}: {len(records)} records")
    check(all(r["plane"] == plane for r in records),
          f"{tag}: the records' planes {[r['plane'] for r in records]}, expected {plane!r}")
    per_step = launches_per_step(TRAIN_ARGS)
    check(counts["masked_flash_attention"] == per_step * counts["steps"],
          f"{tag}: B1 launched {counts['masked_flash_attention']} times in {counts['steps']} "
          f"updates, expected {per_step} per update")
    results["masked_flash_attention"]["launches"] += counts["masked_flash_attention"]
    print_epochs(f"split {tag}", records)
    return records, out, counts


def split_streams(out, counts):
    """19(a): the rollout's launches all on the actor member's stream, B1's
    (the train step's) all on the learner member's, and the two apart;
    returns the end line's fields."""
    start, end = SPLIT_START.search(out), SPLIT_END.search(out)
    check(start and end, "19(a): the learner printed no device planes lines")
    learner_dev, learner_s, actors, actor_dev, actor_s = start.groups()
    learner_s, actor_s = int(learner_s, 16), int(actor_s, 16)
    rollout = {int(k, 16): n for k, n in json.loads(end.group(1).replace("'", '"')).items()}
    b1 = {int(k): n for k, n in counts["stream_launches"].items()}
    check(actors == "1" and learner_dev == actor_dev == "cuda:0" and learner_s != actor_s,
          f"19(a): members {start.groups()}: one actor member on the learner's card, on a "
          "stream of its own")
    check(set(rollout) == {actor_s} and sum(rollout.values()) > 0,
          f"19(a): rollout launches by stream {rollout}, expected all on {actor_s:#x}")
    check(set(b1) == {learner_s}, f"19(a): B1 launches by stream {b1}, expected all on the "
          f"learner's {learner_s:#x}")
    print(f"[split] 19(a) members on {learner_dev}: learner stream {learner_s:#x}, actor stream "
          f"{actor_s:#x}; rollout launches by stream {{{actor_s:#x}: {rollout[actor_s]}}}, B1 "
          f"(the train step) by stream {{{learner_s:#x}: {b1[learner_s]}}}")
    return end.groups()


def start_wedge(tmp):
    """19(c): a split run whose rollout wedges after two blocks, with no
    restart budget, started beside (a)."""
    cwd = Path(tmp, "wedge")
    write_config(cwd, {"env_args": {"env": "ParallelTicTacToe"}, "train_args": SPLIT_WEDGE})
    return cwd, start_rank(cwd, "wedge", script=SPLIT_CHILD,
                           env={"HANDYRL_FAULT_WEDGE_ROLLOUT": "2"})


def finish_wedge(cwd, job):
    """19(c): the run degraded to fused and ended 0."""
    ((rc, out, err, counts),) = wait_ranks([job], 600)
    check(rc == 0, f"19(c): the learner exited {rc}\n" + tail([(rc, out, err, counts)]))
    records = read_records(cwd / "metrics.jsonl")
    last = records[-1]
    keys = ("epoch", "steps", "episodes", "plane", "plane_watchdog_stalls",
            "plane_watchdog_restarts", "plane_watchdog_degraded")
    check(last["plane"] == "fused" and last["plane_watchdog_degraded"] == 1
          and last["plane_watchdog_stalls"] >= 1 and last["steps"] > 0,
          f"19(c): the records {[{k: r.get(k) for k in keys} for r in records]}\n{err[-3000:]}")
    check("degrading split -> fused" in err, "19(c): the watchdog never said it degraded")
    print(f"[split] 19(c) ParallelTicTacToe wedged after 2 blocks, plane_max_restarts 0: "
          f"degraded split -> fused (stalls {last['plane_watchdog_stalls']}), ended 0 after "
          f"{counts['wall_s']:.1f} s of main() at step {last['steps']}; the last record's plane "
          f"{last['plane']!r}, plane_watchdog_degraded {last['plane_watchdog_degraded']}")


def phase_split_plane(results):
    """19: the split device plane (see the docstring's phase 19): (a) split
    and (b) fused in turns, (c) beside (a)'s start."""
    results.setdefault("masked_flash_attention", {"launches": 0})
    with tempfile.TemporaryDirectory() as tmp:
        wedge = start_wedge(tmp)
        try:
            split, out, counts = split_learner(results, tmp, "split")
        except BaseException:
            wait_ranks([wedge[1]], 60)
            raise
        rollout, refreshes, nbytes, copy_ms, rec_bytes, transfers = split_streams(out, counts)
        check(any(r.get("plane_actor_busy_frac", 0) > 0 for r in split)
              and any(r.get("plane_xfer_bytes_per_sec", 0) > 0 for r in split),
              "19(a): no epoch with the actor member busy and bytes crossing the planes")
        check(split[-1].get("plane_param_refreshes", 0) > 1 and int(refreshes) > 1,
              f"19(a): {split[-1].get('plane_param_refreshes')} refreshes in the last record")
        fused, _, fcounts = split_learner(results, tmp, "fused")
        rates = {name: [r["train_steps_per_sec"] for r in rs if "loss" in r]
                 for name, rs in (("split", split), ("fused", fused))}
        lags = [r["plane_param_lag_mean"] for r in split if "plane_param_lag_mean" in r]
        print(f"[split] updates/s while training by epoch: 19(a) split "
              f"{', '.join(f'{x:.3f}' for x in rates['split'])}, 19(b) fused in turn "
              f"{', '.join(f'{x:.3f}' for x in rates['fused'])}; {counts['steps']} and "
              f"{fcounts['steps']} updates")
        print(f"[split] 19(a) {refreshes} param refreshes every {SPLIT_REFRESH} updates, "
              f"{int(nbytes) / 1e6:.1f} MB each, {copy_ms} ms per copy on the learner's stream; "
              f"records {int(rec_bytes) / 1e6:.1f} MB in {transfers} transfers "
              f"({int(rec_bytes) / max(int(transfers), 1) / 1e6:.3f} MB a block), "
              f"{int(rec_bytes) / counts['wall_s'] / 1e6:.3f} MB/s over the learner's "
              f"{counts['wall_s']:.1f} s; plane_xfer_bytes_per_sec by epoch "
              f"{[r.get('plane_xfer_bytes_per_sec') for r in split]}; plane_actor_busy_frac "
              f"{[r.get('plane_actor_busy_frac') for r in split]}; param lag mean {lags} "
              f"updates; peak memory {counts['peak_bytes'] / 2**30:.2f} GB split, "
              f"{fcounts['peak_bytes'] / 2**30:.2f} GB fused")
        finish_wedge(*wedge)


PHASES = {
    "4": phase_flash_op, "6": _phase_6, "7a": phase_learner_cli, "7b": phase_learner,
    "8": _phase_8, "9ac": lambda results: phase_remote(results, "ac"),
    "9b": lambda results: phase_remote(results, "b"), "10": phase_assembly,
    "11": phase_selfplay, "12": phase_device_data, "13": phase_serving,
    "14abc": lambda results: phase_fleet(results, "abc"),
    "14d": lambda results: phase_fleet(results, "d"),
    "15ab": lambda results: phase_quantize_edge_flywheel(results, "ab"),
    "15cd": lambda results: phase_quantize_edge_flywheel(results, "cd"),
    "16": phase_league_autovec,
    "17ab": lambda results: phase_distributed(results, "ab"),
    "17c": lambda results: phase_distributed(results, "c"),
    "18": phase_ring,
    "19": phase_split_plane,
}


def cpu_seconds():
    """User and system seconds of this process and of its children waited for."""
    t = os.times()
    return t.user + t.system + t.children_user + t.children_system


def run_phase(name, results, t0, stream):
    """One phase after 3, every launch count at 0 at its start and read at
    its end; a lap line with the seconds into the script and the CPU seconds
    its stream's processes spent on it."""
    from handyrl_tpu_torch.ops.flash_attention import FLASH, MASKED_FLASH

    FLASH.launches = MASKED_FLASH.launches = 0
    wall, cpu = time.time(), cpu_seconds()
    PHASES[name](results)
    print(f"[launches] kernel launches in phase {name}: masked {MASKED_FLASH.launches}, "
          f"flash {FLASH.launches}")
    print(f"[time] phase {name} ended {time.time() - t0:.1f} s into the script: "
          f"{time.time() - wall:.1f} s, cpu {cpu_seconds() - cpu:.1f} s, stream {stream}",
          flush=True)


def start_stream(name, t0, log_dir):
    """This script with ``--stream NAME`` in a session of its own, its output
    in a file; everything it starts carries the stream's name in its
    environment."""
    log = Path(log_dir, f"stream_{name}.log")
    with open(log, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--stream", name], cwd=ROOT,
            stdout=out, stderr=subprocess.STDOUT, start_new_session=True,
            env=dict(os.environ, PYTHONUNBUFFERED="1", **{
                STREAM_ENV: name, T0_ENV: repr(t0), RESULTS_ENV: str(log.with_suffix(".json"))}))
    return {"name": name, "proc": proc, "log": log, "shown": False}


def show_stream(stream):
    """A stream's output, once, framed by its phases and exit code."""
    if stream["shown"]:
        return
    stream["shown"] = True
    name, code = stream["name"], stream["proc"].returncode
    print(f"[stream {name}] phases {', '.join(STREAMS[name])}, run in a process of their own "
          f"beside the others: exit {code}; its output follows")
    print(stream["log"].read_text(errors="replace").rstrip())
    print(f"[stream {name}] end of its output", flush=True)


def poll_streams(streams):
    """Show each stream that has ended; fail on one that failed."""
    for stream in streams:
        code = stream["proc"].poll()
        if code is not None:
            show_stream(stream)
            check(code == 0, f"stream {stream['name']} (phases {', '.join(STREAMS[stream['name']])})"
                  f" exited {code}")


def finish_streams(streams, t0, results):
    """Wait for every stream until the deadline, poll them, and add their
    kernels' launches (12(c), 15(b)(i)) to this process's counts."""
    for stream in streams:
        try:
            stream["proc"].wait(timeout=max(1.0, t0 + STREAM_DEADLINE - time.time()))
        except subprocess.TimeoutExpired:
            stop_streams([stream])
            check(False, f"stream {stream['name']} still running {STREAM_DEADLINE} s into the "
                  "script; killed")
    poll_streams(streams)
    for stream in streams:
        counts = json.loads(stream["log"].with_suffix(".json").read_text())
        for name in KERNELS:
            results[name]["launches"] += counts[name]["launches"]


def stop_streams(streams):
    """Kill the session of each stream still running (its CLIs and workers
    with it) and show its output."""
    import signal

    for stream in streams:
        if stream["proc"].poll() is None:
            try:
                os.killpg(stream["proc"].pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            stream["proc"].wait()
        show_stream(stream)


def run_stream(name, results):
    """``--stream NAME``: the stream's phases in order, in this process."""
    t0 = float(os.environ.get(T0_ENV) or time.time())
    print(f"[stream {name}] {card_line()}")
    for phase in STREAMS[name]:
        run_phase(phase, results, t0, name)
    if os.environ.get(RESULTS_ENV):
        Path(os.environ[RESULTS_ENV]).write_text(json.dumps(
            {kernel: {"launches": results[kernel]["launches"]} for kernel in KERNELS}))


def main(argv):
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "handyrl_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: the handyrl_tpu_torch package is not beside this script", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    device_name = torch.cuda.get_device_name(0)
    results = {name: {"launches": 0} for name in KERNELS}
    if "--stream" in argv:
        try:
            run_stream(argv[argv.index("--stream") + 1], results)
        except SmokeError as exc:
            print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
            return 1
        return 0
    shm_before = set(os.listdir("/dev/shm"))
    t0 = time.time()
    streams = []
    try:
        phase_device(results)
        phase_kernel_check(results)
        phase_kernel_timing(results, device_name)
        print(f"[time] phase 3 ended {time.time() - t0:.1f} s into the script", flush=True)
        if "--parent" in argv:
            phase_parent(argv[argv.index("--parent") + 1], device_name)
        if "--kernels-only" not in argv:
            # the kernels are built and timed alone; from here on the streams
            # run at once, each phase's numbers taken with others beside it
            os.environ[STREAM_ENV] = "main"
            log_dir = tempfile.mkdtemp(prefix="chip_smoke_streams_")
            streams = [start_stream(name, t0, log_dir) for name in STREAMS if name != "main"]
            for phase in STREAMS["main"]:
                run_phase(phase, results, t0, "main")
                poll_streams(streams)
            finish_streams(streams, t0, results)
            segments, procs = leftovers(shm_before)
            check(not segments and not procs,
                  f"outlived their runs: segments {segments}, processes {procs}")
            print("[leftovers] no shared-memory segment and no process of the port outlived "
                  f"its run; the script took {time.time() - t0:.1f} s")
    except SmokeError as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    finally:
        stop_streams(streams)
    keys = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         **{key: results[name][key] for key in keys}}
        for name, (source, replaces) in KERNELS.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
