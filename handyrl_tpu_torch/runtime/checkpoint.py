"""Checkpoints: epoch-indexed model snapshots and the full training state.

Counterpart of ``handyrl_tpu/runtime/checkpoint.py``, with torch payloads:
state dicts of CPU tensors written by ``torch.save`` and read with
``torch.load(weights_only=True)``, so a file can never run code.  The
layout and the durability contract are the JAX package's:

    models/{epoch}.ckpt    the epoch's params (a model state dict)
    models/latest.ckpt     a copy of the newest snapshot
    models/state.ckpt      params + optimizer state + step count + epoch
    models/MANIFEST.json   per-epoch CRC32 and size of each file above

Every write goes tmp file -> fsync -> atomic rename, so a crash mid-save
never corrupts an existing resume point.  ``restart_epoch: -1`` resumes
from the newest manifest entry whose snapshot verifies, falling back to
older ones, and an explicitly requested epoch refuses a file whose digest
no longer matches.  Flax msgpack checkpoints are not read here;
``models/convert.py`` is the bridge for weights.
"""

from __future__ import annotations

import io
import json
import os
import re
import tempfile
import zlib
from typing import Any, Dict, List, Optional, Tuple

import torch

MANIFEST_NAME = "MANIFEST.json"

_EPOCH_CKPT_RE = re.compile(r"^(\d+)\.ckpt$")


class CheckpointError(RuntimeError):
    """A checkpoint file failed digest verification or cannot be trusted."""


# -- atomic file plumbing ----------------------------------------------------


def _fsync_dir(path: str) -> None:
    """Durably record a rename in its directory (best-effort off Linux)."""
    try:
        fd = os.open(path or ".", os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_write_bytes(path: str, data: bytes) -> None:
    """tmp file in the target dir -> write -> fsync -> atomic rename: a
    reader sees the old complete file or the new one, never a torn one."""
    directory = os.path.dirname(path) or "."
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=os.path.basename(path) + ".tmp.", dir=directory)
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        _fsync_dir(directory)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def file_digest(path: str) -> Tuple[int, int]:
    """(crc32, size) of a file, streamed."""
    crc = size = 0
    with open(path, "rb") as f:
        while chunk := f.read(1 << 20):
            crc = zlib.crc32(chunk, crc)
            size += len(chunk)
    return crc, size


# -- serialization -----------------------------------------------------------


def to_bytes(payload: Any) -> bytes:
    """A payload of CPU tensors, numbers, strings and containers of them."""
    buf = io.BytesIO()
    torch.save(payload, buf)
    return buf.getvalue()


def from_bytes(blob: bytes) -> Any:
    return torch.load(io.BytesIO(blob), map_location="cpu", weights_only=True)


def load_params(path: str) -> Dict[str, torch.Tensor]:
    with open(path, "rb") as f:
        return from_bytes(f.read())


def load_train_state(path: str) -> Dict[str, Any]:
    return load_params(path)


def model_path(model_dir: str, epoch: int) -> str:
    return os.path.join(model_dir, f"{epoch}.ckpt")


def latest_model_path(model_dir: str) -> str:
    return os.path.join(model_dir, "latest.ckpt")


# -- manifest ----------------------------------------------------------------


def load_manifest(model_dir: str, strict: bool = False) -> Dict[str, Any]:
    """The digest manifest; a missing file is an empty manifest.  An
    unparseable one means corruption on this disk: ``strict`` (every
    verification path) raises, the save and GC paths start afresh."""
    path = os.path.join(model_dir, MANIFEST_NAME)
    try:
        with open(path) as f:
            manifest = json.load(f)
        if not isinstance(manifest, dict) or not isinstance(manifest.get("epochs"), dict):
            raise ValueError("manifest is not an object with an 'epochs' map")
    except OSError:
        return {"version": 1, "epochs": {}}
    except ValueError as exc:
        if strict:
            raise CheckpointError(
                f"{path} is corrupt ({exc}); digest verification is impossible — inspect the "
                "checkpoint dir (delete the manifest to accept an unverified resume)"
            )
        return {"version": 1, "epochs": {}}
    return manifest


def _write_manifest(model_dir: str, manifest: Dict[str, Any]) -> None:
    atomic_write_bytes(os.path.join(model_dir, MANIFEST_NAME),
                       json.dumps(manifest, indent=1, sort_keys=True).encode())


def _verify_file(path: str, meta: Dict[str, Any]) -> bool:
    try:
        crc, size = file_digest(path)
    except OSError:
        return False
    return crc == int(meta["crc32"]) and size == int(meta["size"])


def verify_snapshot(model_dir: str, epoch: int) -> Optional[bool]:
    """Does ``{epoch}.ckpt`` match its manifest digest?  None = no record."""
    entry = load_manifest(model_dir, strict=True)["epochs"].get(str(int(epoch)))
    meta = (entry or {}).get("files", {}).get(f"{int(epoch)}.ckpt")
    if meta is None:
        return None
    return _verify_file(model_path(model_dir, epoch), meta)


def verify_state(model_dir: str, epoch: int) -> Optional[bool]:
    """Does state.ckpt match the digest recorded at ``epoch``?  Only the
    newest entry can match a healthy file (it is overwritten each epoch).
    None = no record."""
    entry = load_manifest(model_dir, strict=True)["epochs"].get(str(int(epoch)))
    meta = (entry or {}).get("files", {}).get("state.ckpt")
    if meta is None:
        return None
    return _verify_file(os.path.join(model_dir, "state.ckpt"), meta)


def record_snapshot(model_dir: str, epoch: int, steps: int,
                    file_digests: Dict[str, Tuple[int, int]]) -> None:
    """Add one epoch's entry to the manifest (atomically rewritten)."""
    manifest = load_manifest(model_dir)
    manifest["epochs"][str(int(epoch))] = {
        "steps": int(steps),
        "files": {name: {"crc32": int(crc), "size": int(size)}
                  for name, (crc, size) in file_digests.items()},
    }
    _write_manifest(model_dir, manifest)


def save_epoch_snapshot(model_dir: str, epoch: int, params: Dict[str, torch.Tensor],
                        state_payload: Dict[str, Any], steps: int) -> None:
    """One epoch boundary's durable save: ``{epoch}.ckpt``, ``latest.ckpt``
    and ``state.ckpt``, each atomic, then the manifest entry with a CRC32
    per file, taken from the bytes in memory (no read-back)."""
    params_blob = to_bytes(params)
    state_blob = to_bytes(state_payload)
    atomic_write_bytes(model_path(model_dir, epoch), params_blob)
    atomic_write_bytes(latest_model_path(model_dir), params_blob)
    atomic_write_bytes(os.path.join(model_dir, "state.ckpt"), state_blob)
    params_digest = (zlib.crc32(params_blob), len(params_blob))
    record_snapshot(model_dir, epoch, steps, {
        f"{int(epoch)}.ckpt": params_digest,
        "latest.ckpt": params_digest,
        "state.ckpt": (zlib.crc32(state_blob), len(state_blob)),
    })


def latest_verified_epoch(model_dir: str) -> int:
    """Newest epoch whose snapshot verifies; 0 when none does.  Corrupt or
    missing snapshots are skipped for older verified ones; a directory
    from before the manifest falls back to its newest unrecorded
    ``{N}.ckpt``.  Recorded files that fail verification stay refused."""
    recorded = load_manifest(model_dir, strict=True)["epochs"]
    for key in sorted(recorded, key=int, reverse=True):
        meta = recorded[key].get("files", {}).get(f"{key}.ckpt")
        if meta is not None and _verify_file(model_path(model_dir, int(key)), meta):
            return int(key)
    try:
        names = os.listdir(model_dir)
    except OSError:
        return 0
    unrecorded = [int(m.group(1)) for name in names
                  if (m := _EPOCH_CKPT_RE.match(name)) and str(int(m.group(1))) not in recorded]
    return max(unrecorded, default=0)


def load_verified_params(model_dir: str, epoch: int,
                         pre_verified: bool = False) -> Dict[str, torch.Tensor]:
    """``load_params`` that refuses a digest-mismatched snapshot.  Files the
    manifest never recorded load as they are; ``pre_verified`` skips the
    digest scan when the caller just verified this epoch."""
    if not pre_verified and verify_snapshot(model_dir, epoch) is False:
        raise CheckpointError(
            f"{model_path(model_dir, epoch)} does not match its manifest digest (truncated "
            "or corrupt); refusing to load — use restart_epoch: -1 to fall back to the "
            "newest verified snapshot"
        )
    return load_params(model_path(model_dir, epoch))


def _newest_verified_recorded(model_dir: str) -> int:
    """Newest recorded epoch whose snapshot verifies (0 = none); a rotted
    manifest does not stop the save/GC path that calls this."""
    recorded = load_manifest(model_dir)["epochs"]
    for key in sorted(recorded, key=int, reverse=True):
        meta = recorded[key].get("files", {}).get(f"{key}.ckpt")
        if meta is not None and _verify_file(model_path(model_dir, int(key)), meta):
            return int(key)
    return 0


def gc_snapshots(model_dir: str, keep: int, pin=()) -> List[int]:
    """Delete epoch snapshots older than the newest ``keep`` (0 = keep all)
    and their manifest entries; returns the epochs removed.  The newest
    verified snapshot and the epochs in ``pin`` are never collected;
    latest.ckpt and state.ckpt are never touched."""
    if keep <= 0:
        return []
    try:
        names = os.listdir(model_dir)
    except OSError:
        return []
    epochs = sorted(int(m.group(1)) for name in names if (m := _EPOCH_CKPT_RE.match(name)))
    doomed = epochs[:-keep] if len(epochs) > keep else []
    if not doomed:
        return []
    pinned = {_newest_verified_recorded(model_dir)} | {int(e) for e in pin}
    doomed = [e for e in doomed if e not in pinned]
    if not doomed:
        return []
    for epoch in doomed:
        try:
            os.unlink(model_path(model_dir, epoch))
        except OSError:
            pass
    manifest = load_manifest(model_dir)
    pruned = {k: v for k, v in manifest["epochs"].items() if int(k) not in set(doomed)}
    if len(pruned) != len(manifest["epochs"]):
        manifest["epochs"] = pruned
        _write_manifest(model_dir, manifest)
    return doomed
