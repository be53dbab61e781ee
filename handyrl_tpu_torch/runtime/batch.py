"""Fixed-shape training batch assembly from sampled episode windows.

Counterpart of ``make_batch``/``fill_batch`` in
``handyrl_tpu/runtime/batch.py``.  The same semantics:

* Shape (B, T, P, ...), T always exactly ``burn_in_steps + forward_steps``.
* In turn-based training without ``observation``, the actor-side arrays
  (observation / selected_prob / action / action_mask) carry only the turn
  player (P = 1); target-side arrays keep every player.
* Padding: before the window everything is zero; after episode end values
  become the final outcome, selected_prob 1, action_mask all-illegal
  (1e32), progress 1, episode_mask 0.

Each window writes its unpadded slice into output arrays whose defaults are
the padding, one column (key) at a time, through the C fill of
``_codec_accel.c`` (``fill_column``/``fill_rows``) when the codec's
accelerator loaded, else through numpy; ``HANDYRL_NO_FILL_ACCEL=1`` forces
numpy, as in the JAX package.  ``fill_batch`` writes into preallocated
arrays, the views of a shared-memory ring slot (runtime/shm_batch.py).
"""

from __future__ import annotations

import os
import random
from typing import Any, Dict, List, Optional

import numpy as np

from ..utils import tree_concat, tree_leaves, tree_map
from . import codec
from .replay import decompress_block


def _fill_accel():
    """The C fill (``fill_rows``/``fill_column`` of the codec's
    accelerator), or None: off with ``HANDYRL_NO_FILL_ACCEL``, or when the
    accelerator did not load."""
    if os.environ.get("HANDYRL_NO_FILL_ACCEL", "").strip().lower() not in ("", "0", "false", "no"):
        return None
    acc = codec.get_accel()
    if acc is not None and all(hasattr(acc, sym) for sym in ("fill_rows", "fill_column")):
        return acc
    return None


def _broadcast_rows(acc, dst: np.ndarray, b: int, lo: int, hi: int, row: np.ndarray) -> None:
    """dst[b, lo:hi] = row (one row broadcast across hi - lo steps)."""
    if hi <= lo:
        return
    if (acc is not None and dst.dtype == row.dtype and row.shape == dst.shape[2:]
            and dst.flags.c_contiguous and row.flags.c_contiguous):
        acc.fill_rows(dst, b, lo, hi, row)
    else:
        dst[b, lo:hi] = row


def _fill_column(acc, dst: np.ndarray, los: List[int], srcs: List[np.ndarray]) -> None:
    """dst[b, los[b]:los[b] + len(srcs[b])] = srcs[b] for every window b.

    One C call per column: the destination buffer is acquired once, then a
    memcpy per window with the GIL released.  Only srcs[0] is pre-checked;
    the C side still validates every source's shape, dtype and bounds and
    raises, and then the numpy loop runs, which re-raises a real shape
    error."""
    if (acc is not None and srcs and dst.dtype == srcs[0].dtype
            and dst.flags.c_contiguous and srcs[0].flags.c_contiguous):
        try:
            acc.fill_column(dst, los, srcs)
            return
        except (ValueError, TypeError, BufferError):
            pass
    for b, (lo, src) in enumerate(zip(los, srcs)):
        dst[b, lo:lo + src.shape[0]] = src


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


# per-key padding values (every other key pads with 0): shared by the
# allocating path (make_batch) and the reset of a reused ring slot
_KEY_DEFAULTS = {"selected_prob": 1.0, "action_mask": 1e32, "progress": 1.0}

# batch key -> column key of _assemble_one's output
_COLUMN_FIELDS = (
    ("selected_prob", "prob"),
    ("value", "value"),
    ("action", "action"),
    ("reward", "reward"),
    ("return", "ret"),
    ("turn_mask", "tmask"),
    ("observation_mask", "omask"),
    ("action_mask", "amask"),
    ("progress", "progress"),
)


def _alloc_out(c0: Dict[str, Any], B: int, T: int) -> Dict[str, Any]:
    def alloc(leaf, fill=0.0, dtype=np.float32):
        shape = (B, T) + tuple(leaf.shape[1:])
        return np.zeros(shape, dtype) if fill == 0.0 else np.full(shape, fill, dtype)

    return {
        "observation": tree_map(lambda x: alloc(x, 0.0, x.dtype), c0["obs"]),
        "selected_prob": alloc(c0["prob"], _KEY_DEFAULTS["selected_prob"]),
        "value": alloc(c0["value"]),
        "action": alloc(c0["action"], 0, np.int32),
        "outcome": np.zeros((B, 1) + tuple(c0["outcome"].shape[1:]), np.float32),
        "reward": alloc(c0["reward"]),
        "return": alloc(c0["ret"]),
        "episode_mask": np.zeros((B, T, 1, 1), np.float32),
        "turn_mask": alloc(c0["tmask"]),
        "observation_mask": alloc(c0["omask"]),
        "action_mask": alloc(c0["amask"], _KEY_DEFAULTS["action_mask"]),
        "progress": alloc(c0["progress"], _KEY_DEFAULTS["progress"]),
    }


def reset_out(out: Dict[str, Any]) -> None:
    """Restore a reused output batch to the padding (what a fresh
    ``_alloc_out`` holds): needed before every fill of a recycled slot."""
    for key, arr in out.items():
        if key == "observation":
            for leaf in tree_leaves(arr):
                leaf.fill(0)
        else:
            arr.fill(_KEY_DEFAULTS.get(key, 0.0))


def _fill_out(acc, out: Dict[str, Any], cores: List[Dict[str, Any]], T: int) -> None:
    los = [c["pad_b"] for c in cores]
    obs_srcs = [tree_leaves(c["obs"]) for c in cores]
    for i, dst in enumerate(tree_leaves(out["observation"])):
        _fill_column(acc, dst, los, [leaves[i] for leaves in obs_srcs])
    for out_key, core_key in _COLUMN_FIELDS:
        _fill_column(acc, out[out_key], los, [c[core_key] for c in cores])
    _fill_column(acc, out["outcome"], [0] * len(cores), [c["outcome"] for c in cores])
    for b, c in enumerate(cores):
        lo, hi = los[b], los[b] + c["steps"]
        # value frozen at the outcome past episode end (after the column
        # fill above, which wrote the in-window values)
        _broadcast_rows(acc, out["value"], b, hi, T, c["outcome"][0])
        out["episode_mask"][b, lo:hi] = 1.0


def make_batch(windows: List[Dict[str, Any]], args: Dict[str, Any],
               out: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Assemble B sampled windows into one (B, T, P, ...) numpy batch.

    ``out``: a preallocated batch (the numpy views of a shared-memory ring
    slot) to fill in place instead of allocating; it is reset to the
    padding first, so a recycled slot keeps nothing of its last batch."""
    B = len(windows)
    T = args["burn_in_steps"] + args["forward_steps"]
    cores = [_assemble_one(w, args) for w in windows]
    if out is None:
        out = _alloc_out(cores[0], B, T)
    else:
        reset_out(out)
    _fill_out(_fill_accel(), out, cores, T)
    return out


def fill_batch(windows: List[Dict[str, Any]], args: Dict[str, Any],
               out: Dict[str, Any]) -> Dict[str, Any]:
    """``make_batch`` into a preallocated output (a ring slot's views)."""
    return make_batch(windows, args, out=out)
