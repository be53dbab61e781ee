#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (handyrl_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                 # every phase, about a minute on an H100
    python3 chip_smoke.py --kernels-only  # phases 1-3: build, check and time the kernels

Phases, each of which fails the run when it fails:

1. device: the card's name and power limit; build every kernel with nvcc
   and print ptxas's registers / shared memory.
2. kernels vs their plain versions on the card, at the training shape and a
   small ragged one, fp32 and bf16.
3. kernel timing (CUDA events) beside its bound, the plain version and one
   PyTorch library call computing the same function.
4. acting: Geister self-play with the full-width memory transformer
   (d_model 1536, 16 heads, 8 layers, memory 32) in step mode on the card.
5. training: the Trainer at batch 16 x window 512 in bf16 on those episodes,
   through the masked flash kernel (launch count checked), its loss held
   against the einsum path on one batch.

The last two lines are a JSON ``kernels`` record and the verdict
``{"ok": true, "device": {...}}``.  Nothing of JAX or of handyrl_tpu is
imported.  Weights are random, made from a seed.
"""

from __future__ import annotations

import json
import random
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# the training configuration: the JAX package's long-window transformer
# point (bench.py TRANSFORMER_LONG_TPU at T512)
NET_ARGS = {"d_model": 1536, "n_heads": 16, "n_layers": 8, "memory_len": 32}
TRAIN_ARGS = {
    "batch_size": 16, "forward_steps": 512, "burn_in_steps": 0, "observation": True,
    "compute_dtype": "bfloat16", "seq_attention": "auto", "flash_min_t": 128,
}
TRAIN_STEPS = 4          # the first one is warm-up, left out of the rates
EPISODES = 4
SEED = 0

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


def attention_inputs(rows, T, H, D, dtype, seed, observed=0.7):
    """q, k, v ~ N(0, 1); key masks ~70% observed up to a per-row episode
    end, then unobserved padding — the shape of the training windows."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(rows, T, H, D, device="cuda", generator=g).to(dtype) for _ in range(3))
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

    from handyrl_tpu_torch.ops.flash_attention import MASKED_FLASH

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    print(smi.stdout.strip().splitlines()[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    MASKED_FLASH.build()
    print(f"[build] {MASKED_FLASH.source.name} in {time.perf_counter() - t0:.1f} s")
    for line in MASKED_FLASH.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("[ptxas]", line.strip())
    smem = MASKED_FLASH.library().masked_flash_smem_bytes
    print("[smem] dynamic shared memory per block, by head dim: "
          + ", ".join(f"D={d}: {smem(d)} B" for d in (16, 32, 64, 96, 128)))


def phase_kernel_check(results):
    import torch

    from handyrl_tpu_torch.ops.flash_attention import masked_attention_reference, masked_flash_kernel

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in full fp32
    # fp32: the kernel's FMA sums run in another order than the einsum's
    # (1e-4 absolute on O(1) outputs); bf16: inputs and output rounded to
    # bf16 (8 bits of mantissa) against the fp32 plain version of the same
    # rounded inputs
    tolerance = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
    worst = {}
    for shape in ((32, 512, 16, 96), (3, 100, 2, 16)):
        for window in (32, 1 << 30):
            for dtype in (torch.float32, torch.bfloat16):
                q, k, v, km, sl = attention_inputs(*shape, dtype, seed=len(worst) + 1)
                out = masked_flash_kernel(q, k, v, km, sl, window)
                ref = masked_attention_reference(q.float(), k.float(), v.float(), km, sl, window)
                torch.cuda.synchronize()
                check(torch.isfinite(out.float()).all().item(), f"non-finite kernel output {shape}")
                err = (out.float() - ref).abs().max().item()
                tag = f"{shape} window={window} {str(dtype)[6:]}"
                worst[tag] = err
                print(f"[kernel] {tag}: max_abs_err {err:.3e} (tolerance {tolerance[dtype]:g})")
                check(err <= tolerance[dtype], f"kernel disagrees with plain version at {tag}")
    results["max_abs_err"] = worst[f"{(32, 512, 16, 96)} window=32 bfloat16"]


def phase_kernel_timing(results, device_name):
    import torch
    import torch.nn.functional as F

    from handyrl_tpu_torch.ops.flash_attention import masked_attention_reference, masked_flash_kernel

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

    bw, bf16_peak, _ = peaks_for(device_name)
    nbytes = 4 * q.numel() * q.element_size() + km.numel() * 4 + sl.numel() * 4
    flops = 4 * D * H * int(valid.sum())   # q.k and p.v over the pairs the data lets through
    bytes_ms, ops_ms = nbytes / bw * 1e3, flops / bf16_peak * 1e3
    results.update(
        ms=ms, plain_ms=plain_ms, library_ms=library_ms,
        bound_ms=max(bytes_ms, ops_ms), bound_by="bytes" if bytes_ms >= ops_ms else "operations",
    )
    print(f"[timing] masked_flash_attention ({rows}, {T}, {H}, {D}) bf16 window {window}: "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms "
          f"(sdpa vs kernel max_abs_err {lib_err:.3e}); bound {results['bound_ms']:.4f} ms by "
          f"{results['bound_by']} ({nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP of valid pairs)")


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

    n_layers = NET_ARGS["n_layers"]
    check(launches == n_layers * TRAIN_STEPS,
          f"kernel launched {launches} times in {TRAIN_STEPS} steps, expected {n_layers * TRAIN_STEPS}")
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
          f"peak memory {peak_gb:.2f} GB; kernel launches {launches} (8 per step)")
    results["launches"] = launches
    profile_step(trainer)

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


def profile_step(trainer, top=12):
    """One more train step under torch.profiler: the device-busy share of
    the step's wall time and the kernels that took the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_epoch(1)
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
    print(f"[profile] one train step: wall {wall_ms:.1f} ms, kernels {device_ms:.1f} ms "
          f"({device_ms / wall_ms:.1%} busy), {sum(e.count for e in events)} kernel launches")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"[profile] {e.self_device_time_total / 1e3:8.2f} ms {e.count:6d}x  {e.key[:90]}")


def main(argv):
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "handyrl_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: the handyrl_tpu_torch package is not beside this script", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from handyrl_tpu_torch.ops.flash_attention import MASKED_FLASH

    device_name = torch.cuda.get_device_name(0)
    results = {}
    try:
        phase_device(results)
        phase_kernel_check(results)
        phase_kernel_timing(results, device_name)
        results.setdefault("launches", 0)
        if "--kernels-only" not in argv:
            # the main path, acting then training, counts every kernel launch
            MASKED_FLASH.launches = 0
            env_args, module, episodes = phase_acting(results)
            phase_training(results, env_args, module, episodes)
    except SmokeError as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    kernel = {
        "name": "masked_flash_attention",
        "route": "cuda",
        "source": "handyrl_tpu_torch/csrc/masked_flash_attention.cu",
        "replaces": "handyrl_tpu/ops/flash_attention.py:240",
        "launches": results["launches"],
        "max_abs_err": results["max_abs_err"],
        "ms": results["ms"],
        "plain_ms": results["plain_ms"],
        "bound_ms": results["bound_ms"],
        "bound_by": results["bound_by"],
        "library_ms": results["library_ms"],
    }
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
