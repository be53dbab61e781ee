"""The training step: forward, targets, loss, optimizer.

Counterpart of ``handyrl_tpu/parallel/train_step.py``:

    forward (a feed-forward net over the window's live prefix, the whole
             window through TransformerNet seq mode, or a recurrent net
             stepped over the window's T steps)
    -> output masking (turn / legal-action / observation)
    -> loss core (ops/losses.py)
    -> global-norm clip 4.0 -> L2 decay 1e-5 -> Adam, lr applied per step

``compute_dtype: bfloat16`` casts params and observations to bf16 copies
for the forward (fp32 master weights keep the optimizer state; gradients
flow back through the cast in fp32), as the JAX step does; outputs return
to fp32 before the masking, since the 1e32 action mask is not
bf16-representable; a recurrent state stays fp32.  On the card, convolutions
run in TF32 (PyTorch's default, ``torch.backends.cudnn.allow_tf32``) and
matmuls in fp32, so an fp32 conv net's step there is TF32 in its convs.

``seq_attention: ring`` trains sequence-parallel over the mesh's ``sp``
axis (one rank per shard, ``TrainContext`` builds the groups): every rank
of an ``sp`` group holds the group's whole batch, runs the net on its own
T/sp shard of the window through the masked ring (ops/ring_attention.py),
and gathers the heads' outputs along T, so that the targets and the loss
see the whole window; the gather's backward keeps this rank's slice.  The
bucket below then sums each rank's disjoint token part of the gradient,
and the step's metrics count each group once (its leader's).

Under a process group of several ranks (parallel/distributed.py) each rank
takes its shard of the global batch, and the step sums the ranks'
gradients and their losses/data-count vector in one flat bucket before the
clip: the JAX loss is a sum over the global batch, so the summed gradient
is the global batch's, the clip's global norm is taken on it, and the
sentinel's verdict is the same on every rank.

A step never waits on the card: the divergence sentinel's verdict stays on
the device (it is the fused Adam's ``found_inf``, which skips the update
there), and the metrics come back as ``StepMetrics``, copied to the host
at their first read, as the JAX step's metrics stay device arrays until
fetched.
"""

from __future__ import annotations

import math
from collections.abc import Mapping
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from ..ops import compute_loss_from_outputs
from ..utils import resolve_device, tree_leaves, tree_map

LOSS_KEYS = ("p", "v", "r", "ent", "total")


def make_optimizer(module) -> torch.optim.Adam:
    """optax's clip(4.0) -> add_decayed_weights(1e-5) -> scale_by_adam ->
    scale(-lr) is torch Adam with L2 weight decay (not AdamW), after
    ``clip_grad_norm_``; the lr is set on every step.  Fused, so that a
    step the sentinel rejects is skipped on the device (``found_inf``)."""
    return torch.optim.Adam(module.parameters(), lr=0.0, weight_decay=1e-5, fused=True)


class StepMetrics(Mapping):
    """The metrics (name -> float) of one step, or the sum of several, left
    on the device until the first read, which copies them all to the host
    at once and sums the steps there, in order."""

    def __init__(self, keys: Sequence[str], parts: List[torch.Tensor]):
        self._keys = tuple(keys)
        self._parts = parts     # one (len(keys),) fp32 vector per step, on its device
        self._host: Optional[Dict[str, float]] = None

    @classmethod
    def total(cls, metrics: Sequence["StepMetrics"]) -> "StepMetrics":
        """The sum of several steps' metrics, still on the device."""
        return cls(metrics[0]._keys, [part for m in metrics for part in m._parts])

    def fetch(self) -> Dict[str, float]:
        if self._host is None:
            rows = torch.stack(self._parts).tolist()
            self._host = dict(zip(self._keys, (sum(col) for col in zip(*rows))))
        return self._host

    def __getitem__(self, key: str) -> float:
        return self.fetch()[key]

    def __iter__(self):
        return iter(self._keys)

    def __len__(self) -> int:
        return len(self._keys)


def _compute_dtype(args: Dict[str, Any]) -> Optional[torch.dtype]:
    return torch.bfloat16 if args.get("compute_dtype") == "bfloat16" else None


def _cast_floats(tree, dtype):
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x, tree)


def resolve_seq_attention(args: Dict[str, Any], T: int) -> str:
    """'flash', 'einsum' or 'ring' for a window of length ``T``.

    ``auto`` picks the masked flash kernel at T >= ``flash_min_t`` and the
    exact einsum below it, on the card as on the CPU (where 'flash' runs
    the kernel's plain version).  Unlike the JAX package, a GPU does not
    fall back to einsum: the kernel is hand-written for it."""
    mode = args.get("seq_attention", "auto")
    if mode == "auto":
        return "flash" if T >= int(args.get("flash_min_t", 128)) else "einsum"
    if mode not in ("flash", "einsum", "ring"):
        raise ValueError(f"seq_attention={mode!r} not one of ('auto', 'flash', 'einsum', 'ring')")
    return mode


def resolve_seq_remat(args: Dict[str, Any]) -> str:
    """The seq path's rung of the remat ladder: 'none', 'attn' or 'block'.

    Named rungs pass through; booleans collapse to 'block' (True) and
    'none' (False); ``auto`` is 'none', as the JAX package resolves it on
    every backend but a TPU (where it depends on the window length).  Under
    ``seq_attention: ring`` it is always 'none', as in JAX: each rank holds
    only its shard's activations."""
    if args.get("seq_attention") == "ring":
        return "none"
    v = args.get("remat", "auto")
    if v in ("none", "attn", "block"):
        return v
    if isinstance(v, bool):
        return "block" if v else "none"
    return "none"


def resolve_rnn_remat(args: Dict[str, Any], device: torch.device) -> bool:
    """Whether the RNN branch checkpoints each time step, as the JAX
    package resolves it for its scan: the seq path's named rungs collapse
    to on ('attn', 'block') and off ('none'); ``auto`` is on for every
    device but the CPU."""
    v = args.get("remat", "auto")
    v = {"none": False, "attn": True, "block": True}.get(v, v)
    if v is None or v == "auto":
        return device.type != "cpu"
    return bool(v)


def _apply(module, params, inputs, kwargs=None):
    """``module(*inputs, **kwargs)``, with ``params`` in place of the
    module's own when given."""
    kwargs = kwargs or {}
    if params is None:
        return module(*inputs, **kwargs)
    return functional_call(module, params, inputs, kwargs)


def forward_prediction(module, params, batch: Dict[str, Any], args: Dict[str, Any]) -> Dict[str, Any]:
    """Run the net over a (B, T, P, ...) batch; returns post-burn-in outputs,
    turn/action/observation masked.  ``params``: a name -> tensor dict used
    in place of the module's own (bf16 copies), or None."""
    cdt = _compute_dtype(args)
    obs = batch["observation"]
    if any(x.dtype == torch.int8 for x in tree_leaves(obs)):
        # obs_int8: the planes arrive int8 (wire -> slots -> the card) and
        # widen here, on the card, under the spec the generator quantized
        # with (args['_obs_quant'], set by the learner; absent = unit scale)
        from ..models.quantize import dequantize_obs_tree

        obs = dequantize_obs_tree(obs, args.get("_obs_quant"))
    if cdt is not None:
        obs = _cast_floats(obs, cdt)
    B, T, P1 = batch["action"].shape[:3]
    burn_in = args["burn_in_steps"]

    if module.initial_state((B, P1)) is None:
        # feed-forward: put_batch may have cut the observation to the live
        # prefix [0, T_obs) of the window; every later step is padding whose
        # outputs the masks below zero, so the net runs on the prefix only
        # and its outputs are zero-padded back to T
        T_obs = tree_leaves(obs)[0].shape[1]
        flat = tree_map(lambda x: x.reshape((-1,) + tuple(x.shape[3:])), obs)
        outs = _apply(module, params, (flat, None))
        outputs = {}
        for k, v in outs.items():
            if k == "hidden" or v is None:
                continue
            v = v.reshape((B, T_obs, P1) + tuple(v.shape[1:]))
            if T_obs < T:
                v = F.pad(v, (0, 0) * (v.dim() - 2) + (0, T - T_obs))
            outputs[k] = v[:, burn_in:]
    elif getattr(module, "supports_seq", False) and args.get("seq_forward", True):
        omask = batch["observation_mask"]
        if omask.shape[2] != P1:
            raise ValueError(
                "recurrent training requires full-player batches (set observation: true)"
            )
        to_bp = lambda x: x.movedim(2, 1).reshape((B * P1, T) + tuple(x.shape[3:]))  # noqa: E731
        obs_bp = tree_map(to_bp, obs)                       # (B*P, T, ...)
        km = to_bp(omask)[..., 0]                           # (B*P, T)
        mode = resolve_seq_attention(args, T)
        kwargs = dict(
            seq=True, key_mask=km, burn_in=burn_in, use_flash=mode == "flash",
            blk_q=int(args.get("blk_q", 128)), remat=resolve_seq_remat(args),
        )
        if mode == "ring":
            outs = _seq_shard_forward(module, params, obs_bp, kwargs, args.get("_seq_group"))
        else:
            outs = _apply(module, params, (obs_bp, None), kwargs)
        outputs = {
            k: v.reshape((B, P1, T) + tuple(v.shape[2:])).movedim(1, 2)[:, burn_in:]
            for k, v in outs.items()
            if k != "hidden" and v is not None
        }
    else:
        outputs = _rnn_forward(module, params, obs, batch["observation_mask"], burn_in, args)

    tmask = batch["turn_mask"][:, burn_in:]
    omask = batch["observation_mask"][:, burn_in:]
    amask = batch["action_mask"][:, burn_in:]
    masked = {}
    for k, v in outputs.items():
        v = v.float()  # loss/target math stays fp32
        if k == "policy":
            v = v * tmask
            if v.shape[2] > 1 and P1 == 1:
                v = v.sum(dim=2, keepdim=True)  # gather the turn player's logits
            masked[k] = v - amask
        else:
            masked[k] = v * omask
    return masked


def _seq_shard_forward(module, params, obs_bp, kwargs, group):
    """The seq branch on this rank's T-shard of the (rows, T) window: the
    observations and the key mask sliced at the shard, the net run over the
    sp group's ring, the heads' outputs gathered back to the whole T in one
    collective (the backward keeps this rank's slice)."""
    if group is None:
        raise ValueError("seq_attention='ring' needs the sp group that TrainContext builds "
                         "(args['_seq_group']); there is none here")
    km = kwargs["key_mask"]
    t = km.shape[1] // group.size
    t0 = group.index * t
    shard = tree_map(lambda x: x[:, t0:t0 + t], obs_bp)
    outs = _apply(module, params, (shard, None),
                  dict(kwargs, key_mask=km[:, t0:t0 + t].contiguous(), ring=group))
    keys = [k for k, v in outs.items() if k != "hidden" and v is not None]
    widths = [outs[k].shape[-1] for k in keys]
    whole = group.gather(torch.cat([outs[k] for k in keys], dim=-1), dim=1)
    return dict(zip(keys, torch.split(whole, widths, dim=-1)))


def _rnn_forward(module, params, obs, omask, burn_in: int, args: Dict[str, Any]):
    """A recurrent net stepped over the window, time-major: the hidden
    state entering step t is masked by the step's observation mask, and
    the net's new state is committed only where the player observed.  The
    burn-in steps run without a graph (the JAX package's stop_gradient);
    with remat on, each later step is a checkpoint that its backward
    replays.  Returns post-burn-in outputs shaped (B, T', P, ...)."""
    B, T, P1 = omask.shape[:3]
    if P1 != tree_leaves(obs)[0].shape[2]:
        raise ValueError(
            "recurrent training requires full-player batches (set observation: true)"
        )

    def mask_like(m, h):
        return m.reshape(m.shape[:2] + (1,) * (h.dim() - 2))

    def step(hidden, obs_t, omask_t):
        h_in = tree_map(lambda h: h * mask_like(omask_t, h), hidden)
        h_flat = tree_map(lambda h: h.reshape((-1,) + tuple(h.shape[2:])), h_in)
        obs_flat = tree_map(lambda o: o.reshape((-1,) + tuple(o.shape[2:])), obs_t)
        # params is read here, from the closure, on the forward and on a
        # checkpoint's replay alike: the same bf16 copies both times
        out = _apply(module, params, (obs_flat, h_flat))
        new_hidden = tree_map(lambda h: h.reshape((B, P1) + tuple(h.shape[1:])), out["hidden"])
        hidden = tree_map(
            lambda h, nh: h * (1 - mask_like(omask_t, h)) + nh * mask_like(omask_t, nh),
            hidden, new_hidden)
        outs = {k: v.reshape((B, P1) + tuple(v.shape[1:]))
                for k, v in out.items() if k != "hidden" and v is not None}
        return hidden, outs

    hidden = module.initial_state((B, P1), omask.device)
    at = lambda t: tree_map(lambda x: x[:, t], obs)  # noqa: E731
    with torch.no_grad():
        for t in range(burn_in):
            hidden, _ = step(hidden, at(t), omask[:, t])
    remat = resolve_rnn_remat(args, omask.device) and torch.is_grad_enabled()
    steps = []
    for t in range(burn_in, T):
        if remat:
            hidden, outs = checkpoint(step, hidden, at(t), omask[:, t], use_reentrant=False)
        else:
            hidden, outs = step(hidden, at(t), omask[:, t])
        steps.append(outs)
    return {k: torch.stack([o[k] for o in steps], dim=1) for k in steps[0]}


def live_steps(batch: Dict[str, Any]) -> int:
    """One past the last step of the window with any turn or observation
    activity in any row (1 when there is none)."""
    act = np.asarray(batch["turn_mask"]) + np.asarray(batch["observation_mask"])
    live = act.any(axis=(0, 2, 3))
    return int(live.nonzero()[0][-1]) + 1 if live.any() else 1


def trim_burn_in(batch: Dict[str, Any], burn_in: int) -> Dict[str, Any]:
    """Drop burn-in steps from every time-major batch array."""
    if burn_in == 0:
        return batch
    out = {k: (v[:, burn_in:] if v.shape[1] > 1 else v) for k, v in batch.items() if k != "observation"}
    out["observation"] = tree_map(lambda x: x[:, burn_in:], batch["observation"])
    return out


class TrainContext:
    """Owns the module on its device, the optimizer and the train step.

    ``mesh`` (parallel/mesh.py; default: ``args['mesh']`` over the group's
    ranks) matters under ``seq_attention: ring``: the context checks it as
    the JAX package does and builds its process groups (a collective: every
    rank constructs its context at the same point), and the step runs on
    this rank's ``sp`` group (``seq_group``)."""

    def __init__(self, module, args: Dict[str, Any], device=None, mesh=None):
        self.device = resolve_device(device)
        self.module = module.to(self.device)
        self.args = args
        self.mesh = mesh
        self.seq_group = None
        if args.get("seq_attention") == "ring":
            self._setup_ring(args)
        recurrent = module.initial_state((1, 1)) is not None
        # a simultaneous-move batch holds its one target player's own
        # observations, so its hidden carry is well-defined without the flag
        if recurrent and args.get("turn_based_training", True) and not args.get("observation"):
            raise ValueError(
                "recurrent/memory models (RNN hidden or KV-cache transformer) under "
                "turn-based training require train_args.observation: true: their "
                "all-player training windows need every player's observation at every "
                "step (for a single-player env, turn_based_training: false also works)"
            )
        # feed-forward batches with no burn-in keep their live steps in a
        # prefix of the window: put_batch cuts the observation to it
        self.ff_compact = (not recurrent and args.get("burn_in_steps", 0) == 0
                           and args.get("compact_padding", True))
        self.compute_dtype = _compute_dtype(args)
        self.optimizer = make_optimizer(self.module)
        self.sentinel = bool(args.get("sentinel", True))
        # the gradient bucket's all-reduce under a group of several ranks
        from .distributed import BucketAllReduce, process_count

        self.grad_reduce = BucketAllReduce() if process_count() > 1 else None

    def _setup_ring(self, args: Dict[str, Any]) -> None:
        """JAX's construction-time checks of the ring, in its words, then
        the mesh's groups: ``seq_group`` is this rank's ``sp`` group."""
        from .mesh import make_mesh

        if self.mesh is None:
            self.mesh = make_mesh(args.get("mesh"))
        sp = self.mesh.shape.get("sp", 1)
        if sp < 2:
            raise ValueError(
                "seq_attention='ring' needs a mesh with an 'sp' axis of "
                f"size >= 2 (got {dict(self.mesh.shape)}); set train_args.mesh "
                "accordingly, e.g. {'dp': 2, 'sp': 4}"
            )
        T = args["burn_in_steps"] + args["forward_steps"]
        if T % sp:
            raise ValueError(
                f"seq_attention='ring': window length {T} (burn_in_steps "
                f"+ forward_steps) must be divisible by the 'sp' axis "
                f"size {sp}"
            )
        if args.get("remat") in ("attn", "block", True):
            raise ValueError(
                "remat ladder is unsupported with seq_attention='ring': "
                "the ring already partitions activation memory over "
                "'sp' — set remat: none/auto"
            )
        self.mesh.build_groups()
        self.seq_group = self.mesh.group("sp")
        self.args = dict(args, _seq_group=self.seq_group)

    def load_optimizer_state(self, state_dict: Dict[str, Any]) -> None:
        """Adam's saved state into this context's fused Adam; a state saved
        by an unfused one has its step counts moved to the params' device."""
        groups = [dict(g, fused=True, foreach=None, capturable=False)
                  for g in state_dict["param_groups"]]
        self.optimizer.load_state_dict(dict(state_dict, param_groups=groups))

    def put_batch(self, batch: Dict[str, Any], non_blocking: bool = False,
                  pinned: bool = False) -> Dict[str, Any]:
        """A host (numpy) batch on the device, its observation cut to the
        live prefix for feed-forward nets.  The result never shares memory
        with ``batch`` (a ring slot is refilled once its copy is done).

        ``non_blocking`` enqueues the copies without waiting for them (the
        caller orders their use, e.g. with an event), staging each array in
        freshly pinned memory first, unless ``pinned`` says the arrays
        already lie in page-locked memory (a registered ring slot): then
        they are copied from where they lie, the whole window, and the
        observation is cut on the device, since a host cut would be a
        strided view that PyTorch first copies into pageable memory."""
        (batch,), t_eff = self._compact([batch], pinned)
        out = tree_map(lambda x: self._put_array(x, non_blocking, pinned), batch)
        if t_eff is not None:
            out["observation"] = tree_map(lambda x: x[:, :t_eff], out["observation"])
        return out

    def put_batches(self, batches: List[Dict[str, Any]], non_blocking: bool = False,
                    pinned: bool = False) -> Dict[str, Any]:
        """k host batches as one (k, B, ...) device tree, for ``train_steps``;
        a feed-forward group is cut to the largest live prefix among its
        batches.  ``non_blocking``/``pinned`` as for ``put_batch``: each
        batch is copied into its slice of the stacked tensors, so a pinned
        group goes from its slots to the device with no host copy."""
        batches, t_eff = self._compact(batches, pinned)

        def stack(*xs):
            srcs = [self._host_tensor(x, non_blocking, pinned) for x in xs]
            out = torch.empty((len(srcs),) + tuple(srcs[0].shape), dtype=srcs[0].dtype,
                              device=self.device)
            for dst, src in zip(out, srcs):
                dst.copy_(src, non_blocking=non_blocking)
            return out

        out = tree_map(stack, *batches)
        if t_eff is not None:
            out["observation"] = tree_map(lambda x: x[:, :, :t_eff], out["observation"])
        return out

    def _compact(self, batches, pinned: bool):
        """(batches, t_eff): for a feed-forward net the group's largest live
        prefix is cut from the observations here, on the host, or, for
        page-locked batches bound for the card, returned as ``t_eff`` to be
        cut there (None: nothing left to cut)."""
        if not self.ff_compact:
            return batches, None
        t_eff = max(live_steps(b) for b in batches)
        if pinned and self.device.type == "cuda":
            return batches, t_eff
        return [dict(b, observation=tree_map(lambda x: x[:, :t_eff], b["observation"]))
                for b in batches], None

    def _host_tensor(self, x, non_blocking: bool, pinned: bool) -> torch.Tensor:
        """``x`` as a CPU tensor to copy from: pinned when the copy is to
        run asynchronously to the card and ``x`` is not page-locked yet."""
        t = torch.from_numpy(np.ascontiguousarray(x))
        if non_blocking and not pinned and self.device.type == "cuda":
            t = t.pin_memory()
        return t

    def _put_array(self, x, non_blocking: bool, pinned: bool) -> torch.Tensor:
        t = self._host_tensor(x, non_blocking, pinned)
        if self.device.type == "cpu":
            return t.clone()
        return t.to(self.device, non_blocking=non_blocking)

    def loss(self, batch: Dict[str, Any]):
        """(losses, data count) of one device batch, with the graph kept."""
        params = None
        if self.compute_dtype is not None:
            params = {n: p.to(self.compute_dtype) for n, p in self.module.named_parameters()}
        outputs = forward_prediction(self.module, params, batch, self.args)
        trimmed = trim_burn_in(batch, self.args["burn_in_steps"])
        return compute_loss_from_outputs(outputs, trimmed, self.args)

    def train_step(self, batch: Dict[str, Any], lr: float) -> StepMetrics:
        """One update from a device batch, or from a host (numpy) one, which
        goes through ``put_batch`` first; returns its metrics, still on the
        device: the step never waits on the card.

        With the sentinel on, a step whose loss, gradient norm or lr is not
        finite leaves params and Adam state untouched, contributes zeros to
        the metrics, and sets ``sentinel_bad``.  Under several ranks the
        metrics are the global batch's (summed over the ranks)."""
        if isinstance(batch["action"], np.ndarray):
            batch = self.put_batch(batch)
        self.optimizer.zero_grad(set_to_none=True)
        losses, dcnt = self.loss(batch)
        losses["total"].backward()
        zero = torch.zeros((), device=self.device)
        values = torch.stack([losses.get(k, zero).detach().float() for k in LOSS_KEYS]
                             + [dcnt.float()])
        if self.seq_group is not None and not self.seq_group.is_leader:
            # every rank of an sp group computed the same loss on the same
            # window: the bucket's sum counts it once, the leader's
            values = torch.zeros_like(values)
        if self.grad_reduce is not None:
            # the global batch's gradient and metrics: summed over the ranks
            # in one bucket, before the clip and the sentinel read them
            params = [p for p in self.module.parameters() if p.requires_grad]
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            self.grad_reduce([p.grad for p in params] + [values])
        gnorm = torch.nn.utils.clip_grad_norm_(self.module.parameters(), 4.0)
        keys = LOSS_KEYS + ("dcnt",)
        step = True
        if self.sentinel:
            # the verdict stays on the device: the fused Adam skips a rejected
            # update there (params, moments and step count untouched)
            ok = torch.isfinite(values[LOSS_KEYS.index("total")]) & torch.isfinite(gnorm)
            if not math.isfinite(lr):
                ok = torch.zeros_like(ok)
                step = False
            bad = (~ok).float()
            values = torch.cat([torch.where(ok, values, torch.zeros_like(values)), bad[None]])
            keys += ("sentinel_bad",)
            self.optimizer.found_inf = bad
        if step:
            for group in self.optimizer.param_groups:
                group["lr"] = lr
            self.optimizer.step()
        return StepMetrics(keys, [values])

    def train_steps(self, batches: Dict[str, Any], lr: float) -> StepMetrics:
        """k updates in a row from a stacked (k, B, ...) device tree (see
        ``put_batches``), at one lr; metrics summed over the k steps
        (``sentinel_bad`` counts the skipped ones).  The same as k calls of
        ``train_step`` on the k batches."""
        k = batches["action"].shape[0]
        return StepMetrics.total([self.train_step(tree_map(lambda x, i=i: x[i], batches), lr)
                                  for i in range(k)])
