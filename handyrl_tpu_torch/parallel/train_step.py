"""The training step: forward, targets, loss, optimizer.

Counterpart of ``handyrl_tpu/parallel/train_step.py`` for the seq-mode
transformer path:

    forward (whole window through TransformerNet seq mode)
    -> output masking (turn / legal-action / observation)
    -> loss core (ops/losses.py)
    -> global-norm clip 4.0 -> L2 decay 1e-5 -> Adam, lr applied per step

``compute_dtype: bfloat16`` casts params and observations to bf16 copies
for the forward (fp32 master weights keep the optimizer state; gradients
flow back through the cast in fp32), as the JAX step does; outputs return
to fp32 before the masking, since the 1e32 action mask is not
bf16-representable.  The feed-forward compaction branch, the RNN scan
branch and the ring-attention branch are not ported yet.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch.func import functional_call

from ..ops import compute_loss_from_outputs
from ..utils import resolve_device, tree_map

LOSS_KEYS = ("p", "v", "r", "ent", "total")


def _compute_dtype(args: Dict[str, Any]) -> Optional[torch.dtype]:
    return torch.bfloat16 if args.get("compute_dtype") == "bfloat16" else None


def _cast_floats(tree, dtype):
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x, tree)


def resolve_seq_attention(args: Dict[str, Any], T: int) -> str:
    """'flash' or 'einsum' for a window of length ``T``.

    ``auto`` picks the masked flash kernel at T >= ``flash_min_t`` and the
    exact einsum below it, on the card as on the CPU (where 'flash' runs
    the kernel's plain version).  Unlike the JAX package, a GPU does not
    fall back to einsum: the kernel is hand-written for it."""
    mode = args.get("seq_attention", "auto")
    if mode == "auto":
        return "flash" if T >= int(args.get("flash_min_t", 128)) else "einsum"
    if mode not in ("flash", "einsum"):
        raise ValueError(f"seq_attention={mode!r} is not ported yet")
    return mode


def forward_prediction(module, params, batch: Dict[str, Any], args: Dict[str, Any]) -> Dict[str, Any]:
    """Run the net over a (B, T, P, ...) batch; returns post-burn-in outputs,
    turn/action/observation masked.  ``params``: a name -> tensor dict used
    in place of the module's own (bf16 copies), or None."""
    cdt = _compute_dtype(args)
    obs = batch["observation"]
    if cdt is not None:
        obs = _cast_floats(obs, cdt)
    B, T, P1 = batch["action"].shape[:3]
    burn_in = args["burn_in_steps"]
    if not (getattr(module, "supports_seq", False) and args.get("seq_forward", True)):
        raise NotImplementedError("only the seq-mode transformer forward is ported")

    omask = batch["observation_mask"]
    if omask.shape[2] != P1:
        raise ValueError(
            "recurrent training requires full-player batches (set observation: true)"
        )
    to_bp = lambda x: x.movedim(2, 1).reshape((B * P1, T) + tuple(x.shape[3:]))  # noqa: E731
    obs_bp = tree_map(to_bp, obs)                       # (B*P, T, ...)
    km = to_bp(omask)[..., 0]                           # (B*P, T)
    kwargs = dict(
        seq=True, key_mask=km, burn_in=burn_in,
        use_flash=resolve_seq_attention(args, T) == "flash",
        blk_q=int(args.get("blk_q", 128)),
    )
    if params is None:
        outs = module(obs_bp, None, **kwargs)
    else:
        outs = functional_call(module, params, (obs_bp, None), kwargs)
    outputs = {
        k: v.reshape((B, P1, T) + tuple(v.shape[2:])).movedim(1, 2)[:, burn_in:]
        for k, v in outs.items()
        if k != "hidden" and v is not None
    }

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


def trim_burn_in(batch: Dict[str, Any], burn_in: int) -> Dict[str, Any]:
    """Drop burn-in steps from every time-major batch array."""
    if burn_in == 0:
        return batch
    out = {k: (v[:, burn_in:] if v.shape[1] > 1 else v) for k, v in batch.items() if k != "observation"}
    out["observation"] = tree_map(lambda x: x[:, burn_in:], batch["observation"])
    return out


class TrainContext:
    """Owns the module on its device, the optimizer and the train step."""

    def __init__(self, module, args: Dict[str, Any], device=None):
        self.device = resolve_device(device)
        self.module = module.to(self.device)
        self.args = args
        if args.get("turn_based_training", True) and not args.get("observation"):
            raise ValueError(
                "memory models (KV-cache transformer) under turn-based training "
                "require train_args.observation: true"
            )
        self.compute_dtype = _compute_dtype(args)
        # optax's clip(4.0) -> add_decayed_weights(1e-5) -> scale_by_adam ->
        # scale(-lr) is torch Adam with L2 weight decay (not AdamW), after
        # clip_grad_norm_; the lr is set on every step
        self.optimizer = torch.optim.Adam(self.module.parameters(), lr=0.0, weight_decay=1e-5)
        self.sentinel = bool(args.get("sentinel", True))

    def put_batch(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        return tree_map(lambda x: torch.as_tensor(np.asarray(x), device=self.device), batch)

    def loss(self, batch: Dict[str, Any]):
        """(losses, data count) of one device batch, with the graph kept."""
        params = None
        if self.compute_dtype is not None:
            params = {n: p.to(self.compute_dtype) for n, p in self.module.named_parameters()}
        outputs = forward_prediction(self.module, params, batch, self.args)
        trimmed = trim_burn_in(batch, self.args["burn_in_steps"])
        return compute_loss_from_outputs(outputs, trimmed, self.args)

    def train_step(self, batch: Dict[str, Any], lr: float) -> Dict[str, float]:
        """One update from a host (numpy) batch; returns metrics.

        With the sentinel on, a step whose loss, gradient norm or lr is not
        finite leaves params and Adam state untouched, contributes zeros to
        the metrics, and sets ``sentinel_bad``."""
        self.optimizer.zero_grad(set_to_none=True)
        losses, dcnt = self.loss(self.put_batch(batch))
        losses["total"].backward()
        gnorm = torch.nn.utils.clip_grad_norm_(self.module.parameters(), 4.0)
        zero = torch.zeros((), device=self.device)
        values = torch.stack([losses.get(k, zero).detach().float() for k in LOSS_KEYS] + [dcnt, gnorm])
        host = values.tolist()  # the step's one host sync
        metrics = dict(zip(LOSS_KEYS + ("dcnt",), host[:-1]))
        bad = self.sentinel and not (
            math.isfinite(metrics["total"]) and math.isfinite(host[-1]) and math.isfinite(lr)
        )
        if bad:
            metrics = {k: 0.0 for k in metrics}
        else:
            for group in self.optimizer.param_groups:
                group["lr"] = lr
            self.optimizer.step()
        if self.sentinel:
            metrics["sentinel_bad"] = float(bad)
        return metrics
