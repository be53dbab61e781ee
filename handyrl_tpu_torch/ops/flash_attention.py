"""Masked flash attention: the transformer's seq-mode training attention.

Counterpart of ``masked_flash_attention`` in
``handyrl_tpu/ops/flash_attention.py``.  One semantics, two executions:

* ``masked_attention_reference`` — the plain PyTorch version, the exact
  counterpart of the JAX package's einsum reference: per-key observation
  masks, an ALiBi bias over observed-step ages, ring-window eviction (keys
  older than ``window`` observed steps are invisible) and self always
  visible.  The CPU path and the tests use it.
* the hand-written CUDA kernel ``csrc/masked_flash_attention.cu``, which
  computes the same function in O(T * tile) memory.  A CUDA tensor always
  goes to the kernel; only a CPU tensor takes the plain version.

The gradient is the JAX package's chunked-recompute backward
(``_masked_bwd``) in plain PyTorch, with the same chunk size: one query
chunk at a time, softmax-vjp over a (rows, H, chunk, T) slab.

Layout: (rows, T, H, D), like the rest of the ops layer.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_build import CudaKernel

NEG_INF = -1e30

MASKED_FLASH = CudaKernel(
    "masked_flash_attention.cu",
    "masked_flash_forward",
    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 3
    + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
)
_KERNEL_HEAD_DIMS = (16, 32, 64, 96, 128)
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _masked_scores(q_c, k, c_q, counts, key_mask, slopes, window, q0, scale):
    """(rows, H, C, T) biased + masked fp32 scores of a query chunk at global
    position ``q0`` against every key, and the (rows, C, T) validity."""
    C, T = q_c.shape[1], k.shape[1]
    # fp32 scores whatever the operand type, as the JAX einsum's
    # preferred_element_type=float32 gives
    s = torch.einsum("bqhd,bkhd->bhqk", q_c.float(), k.float()) * scale
    age = c_q[:, :, None] - counts[:, None, :]
    qpos = q0 + torch.arange(C, device=q_c.device)
    kpos = torch.arange(T, device=q_c.device)
    causal = qpos[:, None] >= kpos[None, :]
    valid = (key_mask[:, None, :] > 0) & causal[None] & (age >= 0) & (age < window)
    valid = valid | (qpos[:, None] == kpos[None, :])[None]
    s = s - slopes[None, :, None, None] * age[:, None]
    s = torch.where(valid[:, None], s, torch.full_like(s, NEG_INF))
    return s, valid


def masked_attention_reference(q, k, v, key_mask, slopes, window: int = 1 << 30):
    """Plain version of the kernel (JAX ``masked_attention_reference``).

    q/k/v: (rows, T, H, D); key_mask: (rows, T), 1.0 = observed; slopes: (H,).
    Scores and softmax are fp32; the probabilities are cast to q's dtype
    before the product with v."""
    D = q.shape[-1]
    counts = torch.cumsum(key_mask.float(), dim=1)
    s, valid = _masked_scores(
        q, k, counts, counts, key_mask, slopes.float(), window, 0, 1.0 / D ** 0.5
    )
    attn = (torch.softmax(s, dim=-1) * valid[:, None]).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", attn, v)


def _check_kernel_inputs(q, k, v, key_mask, slopes):
    if q.dim() != 4:
        raise ValueError(f"q must be (rows, T, H, D), got shape {tuple(q.shape)}")
    rows, T, H, D = q.shape
    for name, x in (("k", k), ("v", v)):
        if x.shape != q.shape or x.dtype != q.dtype:
            raise ValueError(f"{name} must match q's shape and dtype")
    if q.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"the kernel takes float32 or bfloat16, got {q.dtype}")
    if D not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"the kernel takes head dims {_KERNEL_HEAD_DIMS}, got {D}")
    if key_mask.shape != (rows, T) or key_mask.dtype != torch.float32:
        raise ValueError("key_mask must be (rows, T) float32")
    if slopes.shape != (H,) or slopes.dtype != torch.float32:
        raise ValueError("slopes must be (H,) float32")
    for name, x in (("q", q), ("k", k), ("v", v), ("key_mask", key_mask), ("slopes", slopes)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if rows * H >= 2 ** 31:
        raise ValueError("rows * H exceeds the kernel's grid")


def masked_flash_kernel(q, k, v, key_mask, slopes, window: int = 1 << 30):
    """Launch the CUDA kernel on CUDA tensors; raises on anything it does
    not take, and when the launch fails."""
    if q.device.type != "cuda":
        raise ValueError(f"the kernel runs on CUDA tensors, got {q.device}")
    _check_kernel_inputs(q, k, v, key_mask, slopes)
    rows, T, H, D = q.shape
    fn = MASKED_FLASH.fn()
    counts = torch.cumsum(key_mask, dim=1)
    out = torch.empty_like(q)
    s_row, s_t, s_h, _ = q.stride()
    rc = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), key_mask.data_ptr(), counts.data_ptr(),
        slopes.data_ptr(), out.data_ptr(), rows, T, H, D, s_row, s_t, s_h,
        float(window), 1.0 / D ** 0.5, _KERNEL_DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"masked_flash_forward launch failed with CUDA error {rc}")
    MASKED_FLASH.launches += 1
    return out


def _forward(q, k, v, key_mask, slopes, window):
    if q.device.type == "cpu":
        return masked_attention_reference(q, k, v, key_mask, slopes, window)
    return masked_flash_kernel(q, k, v, key_mask, slopes, window)


def _backward(q, k, v, key_mask, slopes, window, blk_q, g):
    """Chunked-recompute backward (JAX ``_masked_bwd``), fp32 throughout."""
    rows, T, H, D = q.shape
    scale = 1.0 / D ** 0.5
    C = min(blk_q, T)
    while T % C:
        C -= 1
    qf, kf, vf, gf = q.float(), k.float(), v.float(), g.float()
    counts = torch.cumsum(key_mask, dim=1)
    dq = torch.empty_like(qf)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    for q0 in range(0, T, C):
        q_c, g_c = qf[:, q0:q0 + C], gf[:, q0:q0 + C]
        s, valid = _masked_scores(
            q_c, kf, counts[:, q0:q0 + C], counts, key_mask, slopes, window, q0, scale
        )
        p = torch.softmax(s, dim=-1) * valid[:, None]
        dp = torch.einsum("bqhd,bkhd->bhqk", g_c, vf)
        ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
        dq[:, q0:q0 + C] = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
        dk += torch.einsum("bhqk,bqhd->bkhd", ds, q_c) * scale
        dv += torch.einsum("bhqk,bqhd->bkhd", p, g_c)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _MaskedFlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, key_mask, slopes, window, blk_q):
        ctx.save_for_backward(q, k, v, key_mask, slopes)
        ctx.window, ctx.blk_q = window, blk_q
        return _forward(q, k, v, key_mask, slopes, window)

    @staticmethod
    def backward(ctx, g):
        q, k, v, key_mask, slopes = ctx.saved_tensors
        dq, dk, dv = _backward(q, k, v, key_mask, slopes, ctx.window, ctx.blk_q, g)
        return dq, dk, dv, None, None, None, None


def masked_flash_attention(q, k, v, key_mask, slopes, window: int = 1 << 30, blk_q: int = 128):
    """Causal attention with per-key masks, observed-age ALiBi bias and
    window eviction — the transformer seq-mode semantics — through the CUDA
    kernel (the plain version for CPU tensors).

    q/k/v: (rows, T, H, D); key_mask: (rows, T) 1.0 = observed; slopes:
    (H,).  ``blk_q`` is the query chunk of the recompute backward."""
    key_mask = key_mask.float().contiguous()
    slopes = slopes.float().contiguous()
    return _MaskedFlashAttention.apply(q, k, v, key_mask, slopes, window, blk_q)
