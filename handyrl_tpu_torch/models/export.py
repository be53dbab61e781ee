"""Deployment export: a ``torch.export`` program with the weights inside.

Counterpart of ``handyrl_tpu/models/export.py``.  The JAX package freezes a
net into serialized StableHLO (``.hlo``) with a symbolic batch dimension;
the port's artifact is a ``torch.export`` program (``.pt2``) with a dynamic
batch dimension on every observation and hidden leaf, its weights inside,
written by ``torch.export.save``.  The initial hidden state (batch 1) and
the output names ride in the artifact's extra files, as ``hidden0`` rides
in the JAX codec blob.

The program is traced on the device it is exported from (the card unless
the caller names another), its numerics are checked there against the live
module at two batch sizes, and it is saved with its weights moved to the
CPU, so one ``.pt2`` loads on the CPU and on the card: ``ExportedModel``
moves it to the device it runs on (``move_to_device_pass`` rewrites the
device of constants made inside the forward as well).

``export_onnx`` / ``OnnxModel`` are the JAX package's ONNX route; they need
the optional ``onnx`` (and ``onnxscript``) and ``onnxruntime`` packages and
name the missing one.  TF SavedModel (``.tf``) has no counterpart.

    python -m handyrl_tpu_torch.models.export CKPT [OUT]

exports a checkpoint of the env in ``./config.yaml`` (the counterpart of
``scripts/export_model.py``; ``OUT`` defaults to the checkpoint's path with
the suffix ``.pt2``; ``OUT`` ending in ``.onnx`` takes the ONNX route).
"""

from __future__ import annotations

import base64
import copy
import json
import sys
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from ..utils import (resolve_device, tree_leaves, tree_map, tree_max_rel_err, tree_to_numpy,
                     tree_unflatten)

# the trace batch: an unusual size, so no dimension of the net aliases it
_TRACE_BATCH = 5
# the batch sizes the numerics are checked at before the file is written
_CHECK_BATCHES = (1, 7)
_CHECK_TOL = 1e-5


def _require(*names: str) -> None:
    """Import each optional package or raise naming the missing one."""
    import importlib

    for name in names:
        try:
            importlib.import_module(name)
        except ImportError as exc:
            raise ImportError(
                f"the ONNX route needs the optional {name!r} package, which is not installed"
            ) from exc


class _Frozen(nn.Module):
    """The net as ``torch.export`` sees it: outputs without the None ones;
    a stateful net always takes its hidden state (no ``hidden is None``
    branch in the program)."""

    def __init__(self, net: nn.Module, stateful: bool):
        super().__init__()
        self.net = net
        self.stateful = stateful

    def forward(self, obs, hidden=None):
        out = self.net(obs, hidden if self.stateful else None)
        return {k: v for k, v in out.items() if v is not None}


def _batched(tree, n: int):
    return tree_map(lambda x: np.repeat(np.asarray(x)[None], n, axis=0), tree)


def export_model(module: nn.Module, sample_obs, path: str, device=None) -> Dict[str, Any]:
    """Freeze ``module`` into a ``.pt2`` program at ``path``.

    ``sample_obs`` is one unbatched observation tree (``env.observation(p)``);
    the program takes batch-leading trees of any batch size.  Returns what
    was written: the output names and the initial hidden state."""
    device = resolve_device(device)
    net = copy.deepcopy(module).to(device).eval()
    h1 = net.initial_state((1,), device)
    stateful = h1 is not None
    frozen = _Frozen(net, stateful).eval()
    batch = torch.export.Dim("batch", min=1, max=1 << 16)

    def inputs(n: int, rng=None):
        obs = _batched(sample_obs, n)
        if rng is not None:   # perturbed, so the check sees more than one input
            obs = tree_map(lambda x: (x + rng.normal(scale=0.5, size=x.shape)).astype(x.dtype)
                           if np.issubdtype(x.dtype, np.floating) else x, obs)
        obs = tree_map(lambda x: torch.as_tensor(x, device=device), obs)
        hidden = net.initial_state((n,), device) if stateful else None
        return obs, hidden

    obs_t, hidden_t = inputs(_TRACE_BATCH)
    dyn_obs = tree_map(lambda _: {0: batch}, sample_obs)
    if stateful:
        dyn = (dyn_obs, tree_map(lambda _: {0: batch}, hidden_t))
        args = (obs_t, hidden_t)
    else:
        dyn = (dyn_obs,)
        args = (obs_t,)
    with torch.no_grad():
        program = torch.export.export(frozen, args, dynamic_shapes=dyn, strict=False)
        # the program against the live module before anything is written
        runner = program.module()
        rng = np.random.default_rng(0)
        for n in _CHECK_BATCHES:
            obs_n, hid_n = inputs(n, rng)
            if stateful:   # a state one step in, not the zeros only
                hid_n = net(obs_n, hid_n)["hidden"]
            a = (obs_n, hid_n) if stateful else (obs_n,)
            want = tree_to_numpy(frozen(*a))
            got = tree_to_numpy(runner(*a))
            err = tree_max_rel_err(got, want)
            if not np.isfinite(err) or err > _CHECK_TOL:
                raise RuntimeError(f"export check failed at batch {n}: max error {err:.3g} of "
                                   f"scale against the live module (limit {_CHECK_TOL})")
    out_names = sorted(want)
    if device.type != "cpu":
        from torch.export.passes import move_to_device_pass

        program = move_to_device_pass(program, "cpu")
    from ..runtime import codec

    hidden0 = tree_to_numpy(h1) if stateful else None
    extra = {
        # extra files are text: the codec's bytes go in as base64
        "handyrl/hidden0": base64.b64encode(codec.dumps(hidden0)).decode(),
        "handyrl/meta.json": json.dumps({"outputs": out_names, "stateful": stateful}),
    }
    torch.export.save(program, path, extra_files=extra)
    return {"outputs": out_names, "hidden0": hidden0}


class _ArtifactModel:
    """What the artifacts share: the hidden state is stored with a leading
    batch axis of 1 (``self._hidden0``); ``init_hidden`` strips or
    broadcasts it."""

    _hidden0: Optional[Any] = None

    def init_hidden(self, batch_dims=()):
        if self._hidden0 is None:
            return None
        flat = tree_map(lambda x: np.asarray(x)[0], self._hidden0)
        if not batch_dims:
            return flat
        return tree_map(lambda x: np.broadcast_to(x, tuple(batch_dims) + x.shape).copy(), flat)

    def inference(self, obs, hidden=None) -> Dict[str, Any]:
        obs_b = tree_map(lambda x: np.asarray(x)[None], obs)
        hidden_b = (tree_map(lambda x: np.asarray(x)[None], hidden)
                    if hidden is not None else None)
        return tree_map(lambda x: x[0], self.inference_batch(obs_b, hidden_b))

    def _extract_hidden(self, out: Dict[str, Any]) -> Dict[str, Any]:
        """Fold flat next-state outputs (``hidden_N_out`` of an ONNX graph,
        or bare ``hidden_N``) back into an ``out['hidden']`` tree."""
        names = sorted((k for k in out if k.startswith("hidden_")),
                       key=lambda k: int(k[7:-4] if k.endswith("_out") else k[7:]))
        if names:
            out["hidden"] = tree_unflatten(self._hidden0, [out.pop(k) for k in names])
        return out


class ExportedModel(_ArtifactModel):
    """Inference over a ``.pt2`` artifact, with the ``InferenceModel``
    surface (numpy in, numpy out), on ``device`` (the card unless the caller
    names another).  A file that fails to load raises."""

    def __init__(self, path: str, device=None):
        from ..runtime import codec

        self.device = resolve_device(device)
        extra = {"handyrl/hidden0": "", "handyrl/meta.json": ""}
        program = torch.export.load(path, extra_files=extra)
        if not extra["handyrl/meta.json"]:
            raise ValueError(f"{path}: not a handyrl_tpu_torch export (no handyrl/meta.json)")
        meta = json.loads(extra["handyrl/meta.json"])
        self.output_names: List[str] = list(meta["outputs"])
        self._hidden0 = codec.loads(base64.b64decode(extra["handyrl/hidden0"]))
        if self.device.type != "cpu":
            from torch.export.passes import move_to_device_pass

            program = move_to_device_pass(program, self.device)
        self._program = program
        self._run = program.module()

    @torch.no_grad()
    def inference_batch(self, obs, hidden=None) -> Dict[str, Any]:
        obs_t = tree_map(lambda x: torch.as_tensor(np.asarray(x), device=self.device), obs)
        if self._hidden0 is None:
            out = self._run(obs_t)
        else:
            if hidden is None:
                hidden = self.init_hidden((tree_leaves(obs_t)[0].shape[0],))
            hid_t = tree_map(lambda x: x.to(self.device) if torch.is_tensor(x)
                             else torch.as_tensor(np.asarray(x), device=self.device), hidden)
            out = self._run(obs_t, hid_t)
        return tree_to_numpy(out)


# -- the ONNX route (optional packages) ---------------------------------------


def export_onnx(module: nn.Module, sample_obs, path: str, weight_dtype: str = "float32") -> None:
    """Freeze ``module`` into a ``.onnx`` file through ``torch.onnx``, with
    the JAX package's names: inputs ``input_N`` / ``hidden_N``, outputs by
    their keys with the next state as ``hidden_N_out``, the batch axis
    dynamic; a ``<path>.meta`` sidecar carries the input count and the
    initial hidden.  ``weight_dtype: int8`` exports the quantized module, its
    kernels dequantized inside the graph.  Needs ``onnx`` and
    ``onnxscript``."""
    _require("onnx", "onnxscript")
    from ..runtime import codec

    if weight_dtype == "int8":
        from .quantize import quantize_module, quantize_params

        params = quantize_params(module.state_dict())
        net = quantize_module(module).to_empty(device="cpu")
        net.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                             for k, v in params.items()})
    elif weight_dtype == "float32":
        net = copy.deepcopy(module).cpu()
    else:
        raise ValueError(f"unknown weight_dtype for ONNX export: {weight_dtype!r}")
    net.eval()
    h1 = net.initial_state((1,), "cpu")
    obs_leaves = tree_leaves(sample_obs)
    hid_leaves = tree_leaves(h1) if h1 is not None else []

    class _Flat(nn.Module):
        def __init__(self):
            super().__init__()
            self.net = net

        def forward(self, *leaves):
            obs = tree_unflatten(sample_obs, leaves[: len(obs_leaves)])
            hidden = tree_unflatten(h1, leaves[len(obs_leaves):]) if hid_leaves else None
            out = self.net(obs, hidden)
            flat = {k: v for k, v in out.items() if k != "hidden" and v is not None}
            for i, leaf in enumerate(tree_leaves(out.get("hidden"))):
                flat[f"hidden_{i}"] = leaf
            return tuple(flat[k] for k in sorted(flat))

    leaves = ([torch.as_tensor(np.repeat(np.asarray(x)[None], _TRACE_BATCH, 0))
               for x in obs_leaves]
              + [x.repeat((_TRACE_BATCH,) + (1,) * (x.dim() - 1)) for x in hid_leaves])
    with torch.no_grad():
        probe = net(tree_unflatten(sample_obs, leaves[: len(obs_leaves)]),
                    tree_unflatten(h1, leaves[len(obs_leaves):]) if hid_leaves else None)
    keys = sorted([k for k, v in probe.items() if k != "hidden" and v is not None]
                  + [f"hidden_{i}" for i in range(len(hid_leaves))])
    in_names = ([f"input_{i}" for i in range(len(obs_leaves))]
                + [f"hidden_{i}" for i in range(len(hid_leaves))])
    out_names = [k + "_out" if k.startswith("hidden_") else k for k in keys]
    torch.onnx.export(_Flat(), tuple(leaves), path, input_names=in_names,
                      output_names=out_names,
                      dynamic_axes={n: {0: "batch"} for n in in_names + out_names})
    meta = {"n_obs": len(obs_leaves), "hidden0": tree_to_numpy(h1) if h1 is not None else None}
    with open(path + ".meta", "wb") as f:
        f.write(codec.dumps(meta))


class OnnxModel(_ArtifactModel):
    """Inference over a ``.onnx`` artifact through onnxruntime on ``device``
    (the card unless the caller names another): the CUDA execution provider
    on the card, which must be installed (``onnxruntime-gpu``), the CPU one
    on the CPU.  Hidden state is found by the ``hidden_N`` input names.
    Needs ``onnxruntime``."""

    def __init__(self, path: str, device=None):
        _require("onnxruntime")
        import onnxruntime

        from ..runtime import codec

        self.device = resolve_device(device)
        if self.device.type == "cuda":
            if "CUDAExecutionProvider" not in onnxruntime.get_available_providers():
                raise RuntimeError(
                    f"{path!r}: running an ONNX artifact on the card needs onnxruntime's "
                    "CUDAExecutionProvider, which this onnxruntime lacks (install "
                    "onnxruntime-gpu), or pass device='cpu'")
            index = self.device.index if self.device.index is not None else 0
            providers = [("CUDAExecutionProvider", {"device_id": index})]
        elif self.device.type == "cpu":
            providers = ["CPUExecutionProvider"]
        else:
            raise ValueError(f"no onnxruntime provider for device {self.device}")
        self._sess = onnxruntime.InferenceSession(path, providers=providers)
        with open(path + ".meta", "rb") as f:
            meta = codec.loads(f.read())
        self._n_obs = int(meta["n_obs"])
        self._hidden0 = meta["hidden0"]
        self._input_names = [i.name for i in self._sess.get_inputs()]

    def inference_batch(self, obs, hidden=None) -> Dict[str, Any]:
        obs_leaves = [np.asarray(x) for x in tree_leaves(obs)]
        if len(obs_leaves) != self._n_obs:
            raise ValueError(f"observation tree has {len(obs_leaves)} leaves; the artifact was "
                             f"exported for {self._n_obs}")
        if self._hidden0 is not None and hidden is None:
            hidden = self.init_hidden((obs_leaves[0].shape[0],))
        hid_leaves = [np.asarray(x) for x in tree_leaves(hidden)] if hidden is not None else []
        feeds = dict(zip(self._input_names, obs_leaves + hid_leaves))
        names = [o.name for o in self._sess.get_outputs()]
        out = dict(zip(names, (np.asarray(v) for v in self._sess.run(names, feeds))))
        return self._extract_hidden(out)


def load_artifact(path: str, device=None):
    """An exported model by its suffix: ``.pt2`` -> ``ExportedModel``,
    ``.onnx`` -> ``OnnxModel``; the JAX package's ``.hlo`` and ``.tf`` are
    refused by name."""
    if path.endswith(".pt2"):
        return ExportedModel(path, device=device)
    if path.endswith(".onnx"):
        return OnnxModel(path, device=device)
    if path.endswith(".hlo"):
        raise ValueError(f"{path!r}: .hlo is the JAX package's StableHLO artifact and needs JAX; "
                         "export a .pt2 with handyrl_tpu_torch.models.export")
    if path.endswith(".tf"):
        raise ValueError(f"{path!r}: .tf is the JAX package's TF SavedModel artifact and needs "
                         "TensorFlow; export a .pt2 with handyrl_tpu_torch.models.export")
    raise ValueError(f"{path!r}: not an exported artifact (.pt2 or .onnx)")


def main(argv: Optional[List[str]] = None, device=None) -> int:
    """``python -m handyrl_tpu_torch.models.export CKPT [OUT]``."""
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv:
        print("usage: python -m handyrl_tpu_torch.models.export CKPT [OUT]")
        return 1
    import time

    from ..envs import make_env, prepare_env
    from ..main import load_args
    from ..runtime.checkpoint import load_params

    ckpt = argv[0]
    out = argv[1] if len(argv) > 1 else ckpt.rsplit(".", 1)[0] + ".pt2"
    args = load_args()
    prepare_env(args["env_args"])
    env = make_env(args["env_args"])
    module = env.net()
    module.load_state_dict(load_params(ckpt))
    env.reset()
    obs = env.observation(env.players()[0])
    t0 = time.perf_counter()
    if out.endswith(".onnx"):
        dtype = "int8" if out.endswith(".int8.onnx") else "float32"
        export_onnx(module, obs, out, weight_dtype=dtype)
    else:
        export_model(module, obs, out, device=device)
    print(f"exported {ckpt} -> {out} in {time.perf_counter() - t0:.2f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
