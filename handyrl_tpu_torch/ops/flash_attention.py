"""Flash attention: the hand-written CUDA kernels of the ops layer.

Counterpart of ``handyrl_tpu/ops/flash_attention.py``, with its two entry
points, each one semantics with two executions:

* ``masked_flash_attention`` — the transformer's seq-mode training
  attention: per-key observation masks, an ALiBi bias over observed-step
  ages, ring-window eviction (keys older than ``window`` observed steps are
  invisible) and self always visible.  Plain version
  ``masked_attention_reference``, the exact counterpart of the JAX
  package's einsum reference; C entry ``masked_flash_forward``.
* ``flash_attention`` — plain causal or full attention over contiguous,
  fully observed sequences.  Plain version ``full_attention_reference``
  (``ops/ring_attention.py``); C entry ``flash_forward``.

Both kernels are instances of one template in ``csrc/flash_attention.cu``,
one library with two entry points, each with its own launch counter.

A CUDA tensor always goes to the kernel; only a CPU tensor takes the plain
version.  The kernels run O(T * tile) memory and take head dims up to 128:
the wrappers zero-pad q, k and v to the next instantiated head dim
(16/32/64/96/128), scale by the true D and drop the padded output columns,
which is exact.  bf16 and fp16 run on the tensor cores with fp32 sums, their
operands brought in by TMA, which needs a 16-byte aligned base: a view that
starts elsewhere reaches the kernel as an aligned copy (``kernel_operand``).
fp32 runs on FMA in full fp32.

The gradients are the JAX package's chunked-recompute backwards (``_bwd``
and ``_masked_bwd``) in plain PyTorch, with the same chunk sizes: one query
chunk at a time, softmax-vjp over a (B, H, chunk, T) slab.

Layout: (B, T, H, D), like the rest of the ops layer.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .cuda_build import CudaKernel
from .ring_attention import NEG_INF, full_attention_reference

MASKED_FLASH = CudaKernel(
    "flash_attention.cu",
    "masked_flash_forward",
    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 3
    + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
)
FLASH = CudaKernel(
    "flash_attention.cu",
    "flash_forward",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 3
    + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
)
_KERNEL_HEAD_DIMS = (16, 32, 64, 96, 128)
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def kernel_head_dim(D: int) -> int:
    """The head dim a kernel runs width-D heads at: the smallest
    instantiated one that holds D."""
    for d in _KERNEL_HEAD_DIMS:
        if D <= d:
            return d
    raise ValueError(f"the kernels take head dims up to {_KERNEL_HEAD_DIMS[-1]}, got {D}")


def pad_head_dim(x, Dp: int):
    """x zero-padded along its last dim to Dp.  Zero columns add nothing to
    q.k, and the output's padded columns are dropped, so padding is exact."""
    return x if x.shape[-1] == Dp else F.pad(x, (0, Dp - x.shape[-1]))


def kernel_operand(x, Dp: int):
    """x as the kernels read it: zero-padded along its last dim to Dp, and
    starting on a 16-byte boundary.  A contiguous view with a storage offset
    (``x[1:]``) may start anywhere; it is copied, never read misaligned.
    With Dp a multiple of 8, every stride of a contiguous x is a whole number
    of 16 bytes, as TMA needs."""
    x = pad_head_dim(x, Dp)
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _unpad(out, D: int):
    return out if out.shape[-1] == D else out[..., :D].contiguous()


def _masked_scores(q_c, k, c_q, counts, key_mask, slopes, window, q0, scale, k0=0):
    """(rows, H, C, T) biased + masked fp32 scores of a query chunk at global
    position ``q0`` against keys at global position ``k0``, and the (rows,
    C, T) validity: the one definition of the seq-mode semantics, shared by
    the plain version, the recompute backward and the masked ring shard."""
    C, T = q_c.shape[1], k.shape[1]
    # fp32 scores whatever the operand type, as the JAX einsum's
    # preferred_element_type=float32 gives
    s = torch.einsum("bqhd,bkhd->bhqk", q_c.float(), k.float()) * scale
    age = c_q[:, :, None] - counts[:, None, :]
    qpos = q0 + torch.arange(C, device=q_c.device)
    kpos = k0 + torch.arange(T, device=q_c.device)
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


def _check_placement(device, **tensors):
    for name, x in tensors.items():
        if x.device != device:
            raise ValueError(f"{name} is on {x.device}, q on {device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_qkv(q, k, v):
    if q.dim() != 4:
        raise ValueError(f"q must be (B, T, H, D), got shape {tuple(q.shape)}")
    B, T, H, D = q.shape
    for name, x in (("k", k), ("v", v)):
        if x.shape != q.shape or x.dtype != q.dtype:
            raise ValueError(f"{name} must match q's shape and dtype")
    if q.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"the kernels take float32, bfloat16 or float16, got {q.dtype}")
    kernel_head_dim(D)
    _check_placement(q.device, q=q, k=k, v=v)
    if B * H >= 2 ** 31:
        raise ValueError("B * H exceeds the kernel's grid")


def _check_kernel_inputs(q, k, v, key_mask, slopes):
    _check_qkv(q, k, v)
    rows, T, H, _ = q.shape
    if key_mask.shape != (rows, T) or key_mask.dtype != torch.float32:
        raise ValueError("key_mask must be (rows, T) float32")
    if slopes.shape != (H,) or slopes.dtype != torch.float32:
        raise ValueError("slopes must be (H,) float32")
    _check_placement(q.device, key_mask=key_mask, slopes=slopes)


def _need_cuda(q):
    if q.device.type != "cuda":
        raise ValueError(f"the kernel runs on CUDA tensors, got {q.device}")


def masked_flash_kernel(q, k, v, key_mask, slopes, window: int = 1 << 30):
    """Launch the masked CUDA kernel on CUDA tensors; raises on anything it
    does not take, and when the launch fails."""
    _need_cuda(q)
    _check_kernel_inputs(q, k, v, key_mask, slopes)
    rows, T, H, D = q.shape
    Dp = kernel_head_dim(D)
    q, k, v = (kernel_operand(x, Dp) for x in (q, k, v))
    fn = MASKED_FLASH.fn()
    counts = torch.cumsum(key_mask, dim=1)
    out = torch.empty_like(q)
    s_row, s_t, s_h, _ = q.stride()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), key_mask.data_ptr(), counts.data_ptr(),
        slopes.data_ptr(), out.data_ptr(), rows, T, H, Dp, s_row, s_t, s_h,
        float(window), 1.0 / D ** 0.5, _KERNEL_DTYPES[q.dtype], stream,
    )
    if rc != 0:
        raise RuntimeError(f"masked_flash_forward launch failed with CUDA error {rc}")
    MASKED_FLASH.count(stream)
    return _unpad(out, D)


def flash_kernel(q, k, v, causal: bool = True):
    """Launch the plain flash CUDA kernel on CUDA tensors; raises on
    anything it does not take, and when the launch fails."""
    _need_cuda(q)
    _check_qkv(q, k, v)
    B, T, H, D = q.shape
    Dp = kernel_head_dim(D)
    q, k, v = (kernel_operand(x, Dp) for x in (q, k, v))
    fn = FLASH.fn()
    out = torch.empty_like(q)
    s_b, s_t, s_h, _ = q.stride()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, T, H, Dp, s_b, s_t, s_h,
        1.0 / D ** 0.5, int(bool(causal)), _KERNEL_DTYPES[q.dtype], stream,
    )
    if rc != 0:
        raise RuntimeError(f"flash_forward launch failed with CUDA error {rc}")
    FLASH.count(stream)
    return _unpad(out, D)


def _recompute_backward(q, k, v, g, C, scores):
    """The chunked-recompute backward of both ops (JAX ``_bwd`` and
    ``_masked_bwd``), fp32 throughout: one query chunk of C rows at a time,
    softmax-vjp over its (B, H, C, T) score slab, dK/dV summed over chunks.
    ``scores(q_c, k, q0, scale)`` gives a chunk's fp32 scores and the
    validity that multiplies p, or None where p is not masked."""
    T = q.shape[1]
    scale = 1.0 / q.shape[-1] ** 0.5
    qf, kf, vf, gf = q.float(), k.float(), v.float(), g.float()
    dq = torch.empty_like(qf)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    for q0 in range(0, T, C):
        q_c, g_c = qf[:, q0:q0 + C], gf[:, q0:q0 + C]
        s, valid = scores(q_c, kf, q0, scale)
        p = torch.softmax(s, dim=-1)
        if valid is not None:
            p = p * valid[:, None]
        dp = torch.einsum("bqhd,bkhd->bhqk", g_c, vf)
        ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
        dq[:, q0:q0 + C] = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
        dk += torch.einsum("bhqk,bqhd->bkhd", ds, q_c) * scale
        dv += torch.einsum("bhqk,bqhd->bkhd", p, g_c)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _forward(q, k, v, key_mask, slopes, window):
    if q.device.type == "cpu":
        return masked_attention_reference(q, k, v, key_mask, slopes, window)
    return masked_flash_kernel(q, k, v, key_mask, slopes, window)


def _backward(q, k, v, key_mask, slopes, window, blk_q, g):
    """JAX ``_masked_bwd``: the chunk shrinks to a divisor of T."""
    T = q.shape[1]
    C = min(blk_q, T)
    while T % C:
        C -= 1
    counts = torch.cumsum(key_mask, dim=1)

    def scores(q_c, kf, q0, scale):
        c_q = counts[:, q0:q0 + q_c.shape[1]]
        return _masked_scores(q_c, kf, c_q, counts, key_mask, slopes, window, q0, scale)

    return _recompute_backward(q, k, v, g, C, scores)


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
    (H,), in any layout.  ``blk_q`` is the query chunk of the recompute
    backward."""
    q, k, v = (x.contiguous() for x in (q, k, v))
    key_mask = key_mask.float().contiguous()
    slopes = slopes.float().contiguous()
    return _MaskedFlashAttention.apply(q, k, v, key_mask, slopes, window, blk_q)


def _causal_scores(causal):
    """JAX ``_bwd``'s scores: plain, NEG_INF above the diagonal if causal;
    p is not masked."""

    def scores(q_c, kf, q0, scale):
        s = torch.einsum("bqhd,bkhd->bhqk", q_c, kf) * scale
        if causal:
            qpos = q0 + torch.arange(q_c.shape[1], device=q_c.device)
            kpos = torch.arange(kf.shape[1], device=kf.device)
            s = torch.where(qpos[:, None] >= kpos[None, :], s, NEG_INF)
        return s, None

    return scores


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, blk_q):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.blk_q = causal, blk_q
        if q.device.type == "cpu":
            return full_attention_reference(q, k, v, causal)
        return flash_kernel(q, k, v, causal)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = _recompute_backward(q, k, v, g, ctx.blk_q, _causal_scores(ctx.causal))
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal: bool = True, blk_q: int = 128, blk_k: int = 128):
    """Causal (or full) attention over (B, T, H, D) through the CUDA kernel
    (the plain version for CPU tensors); q, k, v in any layout.

    ``blk_q`` and ``blk_k`` are clamped to T and must divide it, as the JAX
    kernel's tiles must; the CUDA kernel tiles as it likes, and ``blk_q`` is
    the query chunk of the recompute backward."""
    T = q.shape[1]
    blk_q, blk_k = min(blk_q, T), min(blk_k, T)
    if T % blk_q or T % blk_k:
        raise ValueError(f"sequence length {T} must divide into tiles {blk_q}/{blk_k}")
    q, k, v = (x.contiguous() for x in (q, k, v))
    return _FlashAttention.apply(q, k, v, causal, blk_q)
