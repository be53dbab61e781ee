#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (handyrl_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                 # every phase, a few minutes on an H100
    python3 chip_smoke.py --kernels-only  # phases 1-3: build, check and time the kernels
    python3 chip_smoke.py --parent DIR    # also: DIR's kernels against these (see phase_parent)

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
   epochs cut to 3 through ``python -m handyrl_tpu_torch.main --train`` in a
   temp directory, its checkpoints verified against the manifest, and
   ``--eval models/latest.ckpt 100 4``; (b) the transformer above trained
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
   rule-based geese, then ``--eval models/latest.ckpt:rulebase 100 4``.
9. the remote actor plane and network battles, over loopback: (a) the
   repo's config.yaml with epochs cut to 3 through ``--train-server`` and
   ``--worker`` processes (8 remote actors on the card, a 1 s heartbeat),
   its checkpoints verified, episodes/s and updates/s per epoch; (b) the
   transformer above through ``Learner(args, remote=True)`` in this process
   with one ``--worker 8`` process on the same card: the masked kernel
   held to n_layers launches per learner step, each params blob the worker
   fetched held by CRC32 against the blob served and the snapshot saved,
   the blob's size and fetch seconds, remote moves/s, the boundaries'
   seconds, jobs_lost and heartbeat drops; (c) ``--eval-server 20`` with
   two ``--eval-client`` processes, (a)'s ``models/latest.ckpt`` on the
   card and random: 20 games, no forfeit.  Alone: ``python3 -c "import
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
   (b) gates: 64 episodes per env replayed through the port's host env
   (every action legal, every observation and outcome equal), one step of
   each streaming twin on the card equal to the CPU's from the same state
   and noise, ties taken first by argmax/argmin and the rule-based twin on
   the card, every rollout tensor on the card; (c) HungryGeese through
   ``--train`` with ``device_rollout_games: 256`` and ``device_eval_games:
   64`` against rulebase, 2 epochs (1000 + 2000 episodes): updates/s,
   the pipeline's stages, episodes/s from the device
   and from host workers, ``device_mean_episode_len``, the device-rulebase
   win rate, ``input_wait_frac``; every epoch on the fused plane with its
   device-rulebase win rate, no failed device evaluation, no watchdog
   stall, no batcher fallback; (d) Geister's DRC through
   ``Learner(args).run()`` with ``device_rollout_games: 128``, cut as 8a:
   finite losses, every epoch on the fused plane, no watchdog stall.  Alone:
   ``python3 -c "import chip_smoke as cs; cs.phase_selfplay({})"``.

Every learner phase (7a, 7b, 8a, 8b, 9a, 9b, 11c, 11d) runs on the port's default
``batch_pipeline: shm`` and fails unless every epoch's live pipeline mode
is ``shm``, the codec accelerator and the C fill are loaded, and no
batcher died or fell back; it prints the pipeline's stage seconds and the
put's ms per batch.  The script fails if a shared-memory segment or a
process of the port outlives it.

Phases 4, 5-6, 7b and 9b are the paths through the port's kernels: each
starts with every launch count at 0, and its kernel's count is read at its
end; phases 8a and 11 are read the same way and launch neither kernel (8b,
9a, 9c and 11c run in processes of their own).
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
DRC_EPISODES = 16        # minimum_episodes and update_episodes of phase 8a
GEESE_EPISODES = 100     # the same for phase 8b
REMOTE_HEARTBEAT = 1.0   # phase 9's heartbeat interval, seconds (the default is 10)
BATTLE_GAMES = 20        # phase 9c's games
# the card against the CPU on the RNN branch's outputs, absolute, times
# max(1, the outputs' scale): cuDNN's TF32 convolutions round their inputs
# to 10 bits of mantissa; in strict fp32 the two devices' conv algorithms
# sum in other orders, through 24 recurrent steps
DRC_TOLERANCE = {"tf32": 2e-2, "fp32": 1e-3}
HEAD_DIMS = (16, 32, 64, 96, 128)   # the kernels' instantiated head dims
TRAIN_STEPS = 4          # the first one is warm-up, left out of the rates
EPISODES = 4
SEED = 0

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


def attention_inputs(rows, T, H, D, dtype, seed, observed=0.7):
    """q, k, v ~ N(0, 1); key masks ~70% observed up to a per-row episode
    end, then unobserved padding — the shape of the training windows."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = qkv(rows, T, H, D, dtype, g)
    ends = torch.randint(T // 4, T + 1, (rows, 1), device="cuda", generator=g)
    t = torch.arange(T, device="cuda")[None]
    key_mask = ((torch.rand(rows, T, device="cuda", generator=g) < observed) & (t < ends)).float()
    slopes = torch.tensor([2.0 ** (-8.0 * (i + 1) / H) for i in range(H)], device="cuda")
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
    # einsum attention (no kernel), forward only
    batch = trainer.ctx.put_batch(trainer.sample_batch())
    with torch.no_grad():
        params = {n: p.to(torch.bfloat16) for n, p in module.named_parameters()}
        outs = [forward_prediction(module, params, batch, dict(args, seq_attention=mode))
                for mode in ("flash", "einsum")]
    # bf16 activations through 8 layers: the two attentions round at other
    # places (the kernel keeps probabilities in fp32, the einsum casts them
    # to bf16), so hold them to 5% of the outputs' scale
    acting = batch["turn_mask"][..., 0] > 0
    for key in ("value", "return", "policy"):
        a, b = outs[0][key], outs[1][key]
        if key == "policy":  # legal logits of acting steps (illegal ones are -1e32 on both)
            a, b = a[acting], b[acting]
            legal = b > -1e30
            a, b = a[legal], b[legal]
        err, scale = (a - b).abs().max().item(), max(1.0, b.abs().max().item())
        print(f"[training] kernel vs einsum path, one batch in bf16: {key} max_abs_err {err:.3e} "
              f"(tolerance {5e-2 * scale:.3e})")
        check(err <= 5e-2 * scale, f"training forward disagrees with the einsum path on {key}")


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


def run_cli(cwd, *argv, timeout=600):
    """``python -m handyrl_tpu_torch.main ARGV`` in ``cwd``, as a user runs
    it; fails the phase on a nonzero exit, printing the output's tail."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "handyrl_tpu_torch.main", *argv], cwd=cwd,
                          env=cli_env(), capture_output=True, text=True, timeout=timeout)
    elapsed = time.perf_counter() - t0
    if proc.returncode != 0:
        print(proc.stdout[-3000:] + proc.stderr[-3000:])
    check(proc.returncode == 0, f"main {' '.join(argv)} exited {proc.returncode}")
    return proc.stdout, elapsed


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
    3, through ``python -m handyrl_tpu_torch.main --train`` and then
    ``--eval models/latest.ckpt 100 4``, on the card."""
    with tempfile.TemporaryDirectory() as tmp:
        text, n = re.subn(r"(?m)^(\s+epochs:\s*)-?\d+", r"\g<1>3", (ROOT / "config.yaml").read_text())
        check(n == 1, "config.yaml has no single train_args.epochs line")
        Path(tmp, "config.yaml").write_text(text)
        train_out, train_s = run_cli(tmp, "--train")
        check_snapshots(os.path.join(tmp, "models"), [1, 2, 3])
        records = read_records(os.path.join(tmp, "metrics.jsonl"))
        check(len(records) == 3 and records[-1]["steps"] > 0,
              f"metrics.jsonl: {len(records)} records, expected 3 with steps > 0 on the last")
        print_epochs("cli", records)
        check_shm("cli", records, train_out)
        out, eval_s = run_cli(tmp, "--eval", "models/latest.ckpt", "100", "4")
        total = [line for line in out.splitlines() if line.startswith("total =")]
        check(len(total) == 1, "--eval printed no 'total =' line")
        print(f"[cli] --train 3 epochs in {train_s:.1f} s; --eval models/latest.ckpt 100 4 in "
              f"{eval_s:.1f} s: {total[0]} (win points vs random); final epoch's win rate "
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
            "train_args": dict(TRAIN_ARGS, minimum_episodes=8, update_episodes=8, epochs=2,
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
    100 4``, on the card."""
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
        out, eval_s = run_cli(tmp, "--eval", "models/latest.ckpt:rulebase", "100", "4")
        total = [line for line in out.splitlines() if line.startswith("total =")]
        check(len(total) == 1, "--eval printed no 'total =' line")
        print(f"[geese] --train 2 epochs ({GEESE_EPISODES} + 2 x {GEESE_EPISODES} episodes, B128 "
              f"T16, 6 actors) in {train_s:.1f} s; --eval models/latest.ckpt:rulebase 100 4 in "
              f"{eval_s:.1f} s: {total[0]} (win points of seat 0 vs 3 rule-based geese)")


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

    def start(self, tag, *argv):
        log = open(os.path.join(self.cwd, f"{tag}.log"), "w")
        proc = subprocess.Popen([sys.executable, "-m", "handyrl_tpu_torch.main", *argv],
                                cwd=self.cwd, env=cli_env(), stdout=log,
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
    """9a: the default config.yaml with epochs cut to 3 through ``python -m
    handyrl_tpu_torch.main --train-server`` and ``--worker`` (8 actors on
    the card) over loopback, a short heartbeat."""
    import yaml

    cfg = yaml.safe_load((ROOT / "config.yaml").read_text())
    entry_port = free_port()
    cfg["train_args"]["epochs"] = 3
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
            "train_args": dict(TRAIN_ARGS, minimum_episodes=8, update_episodes=8, epochs=2,
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


def phase_remote(results):
    """9: the remote actor plane and network battles; 9b's kernel counts
    start from 0."""
    with tempfile.TemporaryDirectory() as tmp:
        phase_remote_cli(tmp)
        phase_remote_learner(results)
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
KILL_EPISODES = 100      # minimum_episodes and update_episodes of 10(d)
# update_episodes of 10(c)'s runs (8a warms up on its 16; 7a on as many)
TURN_EPISODES = {"8a": 32, "7a": 100}


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


def turn_run(config, pipeline, tmp):
    """One learner of 10(c) in-process for 2 epochs under ``pipeline``: its
    second epoch's record (the first holds the trainer's warm-up: its first
    batch and the first step's one-off costs)."""
    import torch
    import yaml

    from handyrl_tpu_torch.config import normalize_args
    from handyrl_tpu_torch.runtime.learner import Learner

    run_dir = os.path.join(tmp, f"{config}_{pipeline}_{time.monotonic_ns()}")
    paths = dict(epochs=2, batch_pipeline=pipeline, seed=SEED,
                 model_dir=os.path.join(run_dir, "models"),
                 metrics_path=os.path.join(run_dir, "metrics.jsonl"))
    if config == "8a":
        cfg = normalize_args({"env_args": {"env": "Geister"}, "train_args": dict(
            DRC_TRAIN_ARGS, minimum_episodes=DRC_EPISODES, update_episodes=TURN_EPISODES["8a"],
            worker={"num_parallel": 8}, **paths)})
    else:  # 7a: config.yaml
        raw = yaml.safe_load((ROOT / "config.yaml").read_text())
        raw["train_args"].update(minimum_episodes=TURN_EPISODES["7a"],
                                 update_episodes=TURN_EPISODES["7a"], **paths)
        cfg = normalize_args(raw)
    gc.collect()
    t0 = time.perf_counter()
    learner = Learner(cfg)
    learner.run()
    torch.cuda.synchronize()
    records = read_records(cfg["train_args"]["metrics_path"])
    check(len(records) == 2 and "loss" in records[1] and records[1]["pipeline"] == pipeline,
          f"{config} {pipeline}: records {[(r['epoch'], r.get('pipeline')) for r in records]}")
    return records[1], time.perf_counter() - t0


def assembly_turns():
    """10(c): 8a's and 7a's learners under the threaded and the shm pipeline,
    in turns (thread, shm, shm, thread); the second epoch of each run."""
    with tempfile.TemporaryDirectory() as tmp:
        for config in ("8a", "7a"):
            runs = []
            for pipeline in ("thread", "shm", "shm", "thread"):
                r, run_s = turn_run(config, pipeline, tmp)
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
SELFPLAY_WINDOW = 3.0    # seconds of each rollout's timed window in 11(a)
REPLAY_EPISODES = 64     # episodes per env replayed through the host env in 11(b)
# 11(c): 8b's HungryGeese configuration with device self-play and evaluation
DEVICE_GEESE = {
    "turn_based_training": False, "observation": False, "epochs": 2,
    "minimum_episodes": 1000, "update_episodes": 2000,
    "device_rollout_games": 256, "device_eval_games": 64,
    "eval": {"opponent": ["rulebase"]}, "seed": SEED,
}


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
    """(wall ms, device ms, launches) of one call of fn under torch.profiler;
    launches are the device-side events (kernels and copies)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and "#" not in e.key]
    return (wall_ms, sum(e.self_device_time_total for e in events) / 1e3,
            sum(e.count for e in events))


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
        wall, device_ms, launches = profile_launches(lambda: roll.generate(None, gen))
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


def leftovers(shm_before):
    """Shared-memory segments and processes of the port alive now: segments
    made since ``shm_before``, this process's children, and CLI processes
    (a CLI learner's batchers carry its command line)."""
    import multiprocessing as mp

    segments = sorted(n for n in set(os.listdir("/dev/shm")) - shm_before if n.startswith("psm_"))
    procs = []
    for pid in os.listdir("/proc"):
        if not pid.isdigit() or int(pid) == os.getpid():
            continue
        try:
            cmdline = Path("/proc", pid, "cmdline").read_bytes().replace(b"\0", b" ").decode()
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


def main(argv):
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "handyrl_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: the handyrl_tpu_torch package is not beside this script", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from handyrl_tpu_torch.ops.flash_attention import FLASH, MASKED_FLASH

    def reset_launches():
        FLASH.launches = MASKED_FLASH.launches = 0

    device_name = torch.cuda.get_device_name(0)
    results = {name: {"launches": 0} for name in KERNELS}
    shm_before = set(os.listdir("/dev/shm"))
    t_script = time.perf_counter()
    try:
        phase_device(results)
        phase_kernel_check(results)
        phase_kernel_timing(results, device_name)
        if "--parent" in argv:
            phase_parent(argv[argv.index("--parent") + 1], device_name)
        if "--kernels-only" not in argv:
            # the two paths through the kernels, each counted from 0
            reset_launches()
            phase_flash_op(results)
            reset_launches()
            env_args, module, episodes = phase_acting(results)
            phase_training(results, env_args, module, episodes)
            del module, episodes
            torch.cuda.empty_cache()
            phase_learner_cli(results)
            reset_launches()
            phase_learner(results)
            # the recurrent and simultaneous-move paths: no kernel on either
            # (8b runs in processes of its own)
            reset_launches()
            phase_drc_learner(results)
            print(f"[drc] kernel launches in phase 8a: masked {MASKED_FLASH.launches}, "
                  f"flash {FLASH.launches}")
            phase_geese_cli(results)
            # the remote actor plane (9b runs the masked kernel) and battles
            phase_remote(results)
            # the batch-assembly plane under the learners (no kernel)
            phase_assembly(results)
            # on-device self-play and evaluation (no kernel on these paths)
            reset_launches()
            phase_selfplay(results)
            print(f"[selfplay] kernel launches in phase 11: masked {MASKED_FLASH.launches}, "
                  f"flash {FLASH.launches}")
            segments, procs = leftovers(shm_before)
            check(not segments and not procs,
                  f"outlived their runs: segments {segments}, processes {procs}")
            print("[leftovers] no shared-memory segment and no process of the port outlived "
                  f"its run; the script took {time.perf_counter() - t_script:.1f} s")
    except SmokeError as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
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
