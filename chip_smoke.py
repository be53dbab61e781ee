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
   engine, the threaded batch pipeline, 2 epochs), the kernel's launches
   held to n_layers per step, the checkpoints verified and reloaded bit
   for bit; then one train step's time and peak memory under remat 'none'
   and 'block'.

Phases 4, 5-6 and 7b are the paths through the port's kernels: each starts
with every launch count at 0, and its kernel's count is read at its end.
The last two lines are a JSON ``kernels`` record and the verdict
``{"ok": true, "device": {...}}``.  Nothing of JAX or of handyrl_tpu is
imported.  Weights are random, made from a seed.
"""

from __future__ import annotations

import json
import os
import random
import re
import subprocess
import sys
import tempfile
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


def phase_device(results):
    import torch

    from handyrl_tpu_torch.ops.flash_attention import FLASH, MASKED_FLASH

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    print(smi.stdout.strip().splitlines()[0])
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


def run_cli(cwd, *argv, timeout=600):
    """``python -m handyrl_tpu_torch.main ARGV`` in ``cwd``, as a user runs
    it; fails the phase on a nonzero exit, printing the output's tail."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(ROOT), os.environ.get("PYTHONPATH")) if p))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "handyrl_tpu_torch.main", *argv], cwd=cwd,
                          env=env, capture_output=True, text=True, timeout=timeout)
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


def print_epochs(tag, records):
    for r in records:
        win = (r.get("win_rate") or {}).get("total")
        print(f"[{tag}] epoch {r['epoch']}: steps {r['steps']}, episodes {r['episodes']}, "
              f"{r['episodes_per_sec']:.2f} episodes/s, {r['updates_per_sec']:.2f} updates/s, "
              f"win rate vs random {'n/a' if win is None else f'{win:.3f}'}; boundary: trainer "
              f"snapshot {r['boundary_snapshot_s']:.2f} s, save {r['boundary_save_s']:.2f} s, "
              f"publish {r['boundary_publish_s']:.2f} s")
        if "pipe_sample_s" in r:  # the batch pipeline's stage seconds over the epoch
            print(f"[{tag}] epoch {r['epoch']} pipeline: sample {r['pipe_sample_s']:.3f} s, "
                  f"assemble {r['pipe_assemble_s']:.3f} s, put {r['pipe_put_s']:.3f} s, host "
                  f"queue full {r['pipe_free_wait_s']:.3f} s, put thread starved "
                  f"{r['pipe_ready_wait_s']:.3f} s; trainer: {r['train_steps_per_sec']:.2f} "
                  f"steps/s while training, input wait {r['input_wait_frac']:.1%}")


def phase_learner_cli(results):
    """7a: the default config.yaml (TicTacToe, SimpleConvNet), epochs cut to
    3, through ``python -m handyrl_tpu_torch.main --train`` and then
    ``--eval models/latest.ckpt 100 4``, on the card."""
    with tempfile.TemporaryDirectory() as tmp:
        text, n = re.subn(r"(?m)^(\s+epochs:\s*)-?\d+", r"\g<1>3", (ROOT / "config.yaml").read_text())
        check(n == 1, "config.yaml has no single train_args.epochs line")
        Path(tmp, "config.yaml").write_text(text)
        _, train_s = run_cli(tmp, "--train")
        check_snapshots(os.path.join(tmp, "models"), [1, 2, 3])
        records = read_records(os.path.join(tmp, "metrics.jsonl"))
        check(len(records) == 3 and records[-1]["steps"] > 0,
              f"metrics.jsonl: {len(records)} records, expected 3 with steps > 0 on the last")
        print_epochs("cli", records)
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
