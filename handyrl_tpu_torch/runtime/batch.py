"""Fixed-shape training batch assembly from sampled episode windows.

Counterpart of ``make_batch`` in ``handyrl_tpu/runtime/batch.py`` (numpy
path; the C fill accelerator is not ported).  The same semantics:

* Shape (B, T, P, ...), T always exactly ``burn_in_steps + forward_steps``.
* In turn-based training without ``observation``, the actor-side arrays
  (observation / selected_prob / action / action_mask) carry only the turn
  player (P = 1); target-side arrays keep every player.
* Padding: before the window everything is zero; after episode end values
  become the final outcome, selected_prob 1, action_mask all-illegal
  (1e32), progress 1, episode_mask 0.
"""

from __future__ import annotations

import random
from typing import Any, Dict, List

import numpy as np

from ..utils import tree_concat, tree_leaves, tree_map
from .replay import decompress_block


def _concat_columns(blocks: List[Dict[str, Any]]) -> Dict[str, Any]:
    if len(blocks) == 1:
        return blocks[0]
    out = {key: np.concatenate([b[key] for b in blocks], axis=0) for key in blocks[0] if key != "obs"}
    out["obs"] = tree_concat([b["obs"] for b in blocks])
    return out


def _assemble_one(window: Dict[str, Any], args: Dict[str, Any]) -> Dict[str, Any]:
    cols = _concat_columns([decompress_block(b) for b in window["blocks"]])
    lo = window["start"] - window["base"]
    hi = window["end"] - window["base"]
    sl = slice(lo, hi)

    turn_based = args["turn_based_training"]
    num_players = cols["prob"].shape[1]
    if turn_based:
        target_players = list(range(num_players))
    else:
        target_players = [random.randrange(num_players)]

    obs = tree_map(lambda x: x[sl], cols["obs"])
    prob = cols["prob"][sl]
    action = cols["action"][sl]
    amask = cols["amask"][sl]

    if turn_based and not args["observation"]:
        # actor-side arrays: gather the turn player per step -> P dim 1
        turn = cols["turn"][sl]
        t_idx = np.arange(len(turn))
        obs = tree_map(lambda x: x[t_idx, turn][:, None], obs)
        prob = prob[t_idx, turn][:, None]
        action = action[t_idx, turn][:, None]
        amask = amask[t_idx, turn][:, None]
    else:
        obs = tree_map(lambda x: x[:, target_players], obs)
        prob = prob[:, target_players]
        action = action[:, target_players]
        amask = amask[:, target_players]

    steps = hi - lo
    pad_b = 0
    if steps < args["burn_in_steps"] + args["forward_steps"]:
        pad_b = args["burn_in_steps"] - (window["train_start"] - window["start"])

    return {
        "pad_b": pad_b,
        "steps": steps,
        "obs": obs,
        "prob": prob[..., None],
        "value": cols["value"][sl][:, target_players, None],
        "action": action[..., None].astype(np.int32),
        "outcome": np.asarray(window["outcome"], dtype=np.float32)[target_players].reshape(1, -1, 1),
        "reward": cols["reward"][sl][:, target_players, None],
        "ret": cols["ret"][sl][:, target_players, None],
        "tmask": cols["tmask"][sl][:, target_players, None].astype(np.float32),
        "omask": cols["omask"][sl][:, target_players, None].astype(np.float32),
        "amask": amask,
        "progress": (np.arange(window["start"], window["end"], dtype=np.float32) / window["total"])[:, None],
    }


# batch key -> (column key, padding value); the defaults ARE the padding
_COLUMN_FIELDS = (
    ("selected_prob", "prob", 1.0),
    ("value", "value", 0.0),
    ("action", "action", 0),
    ("reward", "reward", 0.0),
    ("return", "ret", 0.0),
    ("turn_mask", "tmask", 0.0),
    ("observation_mask", "omask", 0.0),
    ("action_mask", "amask", 1e32),
    ("progress", "progress", 1.0),
)


def make_batch(windows: List[Dict[str, Any]], args: Dict[str, Any]) -> Dict[str, Any]:
    """Assemble B sampled windows into one (B, T, P, ...) numpy batch."""
    B = len(windows)
    T = args["burn_in_steps"] + args["forward_steps"]
    cores = [_assemble_one(w, args) for w in windows]
    c0 = cores[0]

    def alloc(leaf, fill, dtype=np.float32):
        return np.full((B, T) + tuple(leaf.shape[1:]), fill, dtype)

    out = {"observation": tree_map(lambda x: alloc(x, 0, x.dtype), c0["obs"])}
    for out_key, core_key, fill in _COLUMN_FIELDS:
        out[out_key] = alloc(c0[core_key], fill, np.int32 if out_key == "action" else np.float32)
    out["outcome"] = np.zeros((B, 1) + tuple(c0["outcome"].shape[1:]), np.float32)
    out["episode_mask"] = np.zeros((B, T, 1, 1), np.float32)

    obs_dsts = tree_leaves(out["observation"])
    for b, c in enumerate(cores):
        lo, hi = c["pad_b"], c["pad_b"] + c["steps"]
        for dst, src in zip(obs_dsts, tree_leaves(c["obs"])):
            dst[b, lo:hi] = src
        for out_key, core_key, _ in _COLUMN_FIELDS:
            out[out_key][b, lo:hi] = c[core_key]
        out["outcome"][b] = c["outcome"]
        # value frozen at the outcome past episode end
        out["value"][b, hi:T] = c["outcome"][0]
        out["episode_mask"][b, lo:hi] = 1.0
    return out
