"""Ring attention: sequence-parallel exact attention over an ``sp`` group.

Counterpart of ``handyrl_tpu/ops/ring_attention.py``.  The time axis is
sharded over the ranks of an ``sp`` group (one process and one device per
rank, ``parallel/mesh.py``): rank ``i`` holds positions ``[i * T_loc, (i +
1) * T_loc)`` of q, k and v, and its K/V shard travels around the group by
point-to-point sends (``AxisGroup.shift``, parallel/distributed.py), so
that after n steps every query shard has seen every key shard.  The blocks
merge through a streaming softmax, as the JAX loop does: ring step 0 is the
query's own shard, where self-visibility (the causal diagonal, or the
masked semantics' "self always visible") makes the row max finite before
any all-masked block arrives; the probabilities are cast to v's dtype
before their product with v (JAX's ``p.astype(v.dtype)``); the last
rotation, which would only bring K/V home, is skipped.

The JAX package differentiates through ``ppermute``.  Here the backward is
written by hand (``_RingAttention``), a recompute in FlashAttention-2's
form: q, the own K/V shard, the output and the row log-sum-exp are saved;
D = rowsum(dO * O); the K/V shards rotate again with their dK/dV
accumulators beside them (fp32, so the sums lose nothing in transit), each
step recomputing p = exp(s - lse) from the same score function, adding into
dQ locally and into the visiting block's dK/dV; after n rotations each
accumulator is back with its owner.

The masked scores are ``flash_attention._masked_scores`` with a key offset
``k0``: the one definition of the transformer's seq-mode semantics.  Each
block's attention is plain PyTorch (an einsum, as in JAX): there is no TPU
kernel on this path.  Layout: (B, T, H, D).
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def _moved(x):
    """(B, H, T) row statistics as (B, T, H, 1), to scale (B, T, H, D)."""
    return x.transpose(1, 2)[..., None]


def _ring_forward(q, k, v, extras, group, scores):
    """(out, lse) of one query shard over every K/V shard of the ring.
    ``scores(qf, kf, extras, q0, k0)`` gives a block's (B, H, Tq, Tk) fp32
    scores, NEG_INF where a key is invisible."""
    n, idx = group.size, group.index
    B, T_loc, H, D = q.shape
    qf = q.float()
    o = torch.zeros((B, T_loc, H, D), dtype=torch.float32, device=q.device)
    m = torch.full((B, H, T_loc), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, T_loc), dtype=torch.float32, device=q.device)
    for i in range(n):
        k_idx = (idx - i) % n   # the owner of the K/V shard held at this step
        s = scores(qf, k.float(), extras, idx * T_loc, k_idx * T_loc)
        m_blk = s.amax(dim=-1)
        p = torch.exp(s - m_blk[..., None])
        l_blk = p.sum(dim=-1)
        o_blk = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)
        # an all-masked block has m_blk = NEG_INF and p = 1 garbage, but
        # step 0 made m finite, so its beta is exp(NEG_INF - m) = 0
        m_new = torch.maximum(m, m_blk)
        alpha = torch.exp(m - m_new)
        beta = torch.exp(m_blk - m_new)
        l = l * alpha + l_blk * beta
        o = o * _moved(alpha) + o_blk.float() * _moved(beta)
        m = m_new
        if i < n - 1:
            k, v, *extras = group.shift([k, v, *extras])
    l = l.clamp_min(1e-30)
    return (o / _moved(l)).to(q.dtype), m + torch.log(l)


def _ring_backward(q, k, v, extras, out, lse, g, group, scores):
    """(dq, dk, dv) of ``_ring_forward``: the shards rotate with their fp32
    dK/dV accumulators; the n-th rotation brings the accumulators home."""
    n, idx = group.size, group.index
    T_loc = q.shape[1]
    scale = 1.0 / q.shape[-1] ** 0.5
    qf, gf = q.float(), g.float()
    delta = (gf * out.float()).sum(dim=-1).transpose(1, 2)          # (B, H, Tq)
    dq = torch.zeros_like(qf)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    for i in range(n):
        k_idx = (idx - i) % n
        kf = k.float()
        s = scores(qf, kf, extras, idx * T_loc, k_idx * T_loc)
        p = torch.exp(s - lse[..., None])                             # 0 where invisible
        dp = torch.einsum("bqhd,bkhd->bhqk", gf, v.float())
        ds = p * (dp - delta[..., None])
        dq += torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
        dk += torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
        dv += torch.einsum("bhqk,bqhd->bkhd", p, gf)
        if i < n - 1:
            k, v, *extras, dk, dv = group.shift([k, v, *extras, dk, dv])
        else:
            dk, dv = group.shift([dk, dv])
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, extras, group, scores):
        out, lse = _ring_forward(q, k, v, extras, group, scores)
        ctx.save_for_backward(q, k, v, out, lse, *extras)
        ctx.group, ctx.scores = group, scores
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse, *extras = ctx.saved_tensors
        dq, dk, dv = _ring_backward(q, k, v, extras, out, lse, g.contiguous(), ctx.group,
                                    ctx.scores)
        return dq, dk, dv, None, None, None


def _need_group(group, name):
    if group is None:
        raise ValueError(f"{name} needs the sp group of its ranks (Mesh.group('sp')); "
                         "without one there is no ring to attend over")


def ring_attention_shard(q, k, v, group, causal: bool = True):
    """One rank's (plain causal or full) ring attention: q, k, v its
    (B, T_loc, H, D) shards, ``group`` its ``sp`` AxisGroup."""
    _need_group(group, "ring_attention_shard")
    scale = 1.0 / q.shape[-1] ** 0.5

    def scores(qf, kf, extras, q0, k0):
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
        if causal:
            qpos = q0 + torch.arange(qf.shape[1], device=qf.device)
            kpos = k0 + torch.arange(kf.shape[1], device=kf.device)
            s = torch.where(qpos[:, None] >= kpos[None, :], s, NEG_INF)
        return s

    return _RingAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(), (), group,
                                scores)


def masked_ring_attention_shard(q, k, v, key_mask, counts, slopes, group,
                                window: float = float(1 << 30)):
    """One rank's ring attention with the transformer's seq-mode semantics
    (per-key observation masks, ALiBi over observed-step ages, eviction of
    keys older than ``window`` observed steps, self always visible), scores
    by ``flash_attention._masked_scores``.

    q/k/v: this rank's (rows, T_loc, H, D) shards; key_mask, counts: its
    (rows, T_loc) shards, ``counts`` the GLOBAL observed-count cumsum (ages
    are differences of global counts: ``global_counts`` builds it from the
    group); slopes (H,).  key_mask and counts travel with their K/V shard."""
    from .flash_attention import _masked_scores   # that module imports this one

    _need_group(group, "masked_ring_attention_shard")
    scale = 1.0 / q.shape[-1] ** 0.5
    c_q = counts.float()
    slopes_f = slopes.float()

    def scores(qf, kf, extras, q0, k0):
        mask_k, c_k = extras
        return _masked_scores(qf, kf, c_q, c_k, mask_k, slopes_f, window, q0, scale, k0=k0)[0]

    return _RingAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                                (key_mask.float().contiguous(), c_q.contiguous()), group, scores)


def global_counts(key_mask, group):
    """The global observed-count cumsum of this rank's (rows, T_loc) shard
    of a key mask: the exclusive prefix, over the group, of each shard's
    observed count, plus the shard's own cumsum."""
    _need_group(group, "global_counts")
    local = key_mask.float()
    sums = group.all_gather(local.sum(dim=1))
    prefix = sum(sums[:group.index], torch.zeros_like(sums[0]))
    return prefix[:, None] + torch.cumsum(local, dim=1)


def _shard(mesh, x, seq_axis, batch_axis):
    """This rank's block of a (B, T, ...) tensor: rows by its ``batch_axis``
    position, time by its ``seq_axis`` position."""
    sp = mesh.group(seq_axis)
    t = x.shape[1] // sp.size
    x = x[:, sp.index * t:(sp.index + 1) * t]
    if batch_axis in mesh.shape and mesh.shape[batch_axis] > 1:
        dp = mesh.group(batch_axis)
        b = x.shape[0] // dp.size
        x = x[dp.index * b:(dp.index + 1) * b]
    return x.contiguous()


def _unshard(mesh, out, seq_axis, batch_axis):
    out = mesh.group(seq_axis).gather(out, dim=1)
    if batch_axis in mesh.shape and mesh.shape[batch_axis] > 1:
        out = mesh.group(batch_axis).gather(out, dim=0)
    return out


def ring_self_attention(q, k, v, mesh, causal: bool = True, seq_axis: str = "sp",
                        batch_axis: Optional[str] = "dp"):
    """Sequence-parallel attention over ``mesh`` (parallel/mesh.py): every
    rank passes the whole (B, T, H, D) q, k, v, computes its block (B over
    ``batch_axis``, T over ``seq_axis``) through the ring and returns the
    whole output, gathered.  A mesh without the sequence axis attends in
    one block, as the JAX package does."""
    if seq_axis not in mesh.shape or mesh.shape[seq_axis] == 1:
        return full_attention_reference(q, k, v, causal)
    out = ring_attention_shard(*(_shard(mesh, x, seq_axis, batch_axis) for x in (q, k, v)),
                               mesh.group(seq_axis), causal)
    return _unshard(mesh, out, seq_axis, batch_axis)


def masked_ring_self_attention(q, k, v, key_mask, slopes, mesh, window: int = 1 << 30,
                               seq_axis: str = "sp", batch_axis: Optional[str] = "dp"):
    """Sequence-parallel masked attention over ``mesh``: the transformer's
    training attention (``masked_attention_reference`` semantics) with T
    sharded over ``seq_axis``.  q/k/v (B, T, H, D), key_mask (B, T), slopes
    (H,), whole on every rank; the global observed-count cumsum is taken
    here, before sharding, as in JAX.  Without the sequence axis: the plain
    version."""
    from .flash_attention import masked_attention_reference

    if seq_axis not in mesh.shape or mesh.shape[seq_axis] == 1:
        return masked_attention_reference(q, k, v, key_mask, slopes, window)
    counts = torch.cumsum(key_mask.float(), dim=1)
    q, k, v, key_mask, counts = (_shard(mesh, x, seq_axis, batch_axis)
                                 for x in (q, k, v, key_mask, counts))
    out = masked_ring_attention_shard(q, k, v, key_mask, counts, slopes, mesh.group(seq_axis),
                                      float(window))
    return _unshard(mesh, out, seq_axis, batch_axis)


def full_attention_reference(q, k, v, causal: bool = True):
    """Naive O(T^2) attention over (B, T, H, D): fp32 scores and softmax,
    the causal mask a ``tril`` filled with ``NEG_INF``, the product with v in
    fp32, cast to q's dtype."""
    scale = 1.0 / q.shape[-1] ** 0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        T = q.shape[1]
        mask = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)
