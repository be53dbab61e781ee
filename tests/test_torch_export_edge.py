"""The port's exported artifacts (``models/export.py``), their loaders and the
edge replica (``fleet/edge.py``, ``--edge``) on the CPU.

* A ``.pt2`` export of each of the four nets round-trips at batch 1 and 7:
  outputs and the next hidden state against the live module within 1e-6,
  and against the JAX package's ``apply`` on the weights ``convert.py``
  carried over within 1e-5 (fp32, another summation order).  The artifact
  holds its weights on the CPU and names its outputs and initial hidden.
* ``load_model`` dispatches on the suffix; the JAX package's ``.hlo`` and
  ``.tf`` are refused by name; the ONNX route names its missing packages
  and, where they are installed, runs (``importorskip``).
* The edge replica serves the wire protocol (its replies equal the
  artifact's), refuses a ``sid``, a wire ``hidden``, a ``swap`` and an
  ``open_session`` as ``bad_request``, and reports ``serve_*`` stats; behind
  a ``FleetRouter`` sessions and shipped state never land on it.
* ``python -m handyrl_tpu_torch.models.export`` and ``--edge`` from a
  config.yaml directory, as the command line runs them.
"""

import importlib.util
import signal
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from handyrl_tpu.envs import make_env as jax_make_env
from handyrl_tpu.models import init_variables as jax_init_variables
from handyrl_tpu_torch.envs import make_env
from handyrl_tpu_torch.fleet import EdgeReplica, FleetRouter
from handyrl_tpu_torch.models import InferenceModel, flax_to_state_dict
from handyrl_tpu_torch.models.export import ExportedModel, export_model, load_artifact
from handyrl_tpu_torch.runtime import checkpoint as ckpt
from handyrl_tpu_torch.runtime.evaluation import load_model
from handyrl_tpu_torch.serving import ModelRouter, ServingClient, ServingError, ServingServer
from handyrl_tpu_torch.utils import tree_leaves, tree_map

ROOT = Path(__file__).resolve().parent.parent
TRANSFORMER = {"env": "Geister", "net": "transformer",
               "net_args": {"d_model": 32, "n_heads": 2, "n_layers": 2, "memory_len": 4}}
NETS = {"SimpleConvNet": {"env": "TicTacToe"}, "GeeseNet": {"env": "HungryGeese"},
        "GeisterNet": {"env": "Geister"}, "transformer": TRANSFORMER}
TIMEOUT = 60


def _jax_and_port(env_args, seed=3):
    jenv = jax_make_env(env_args)
    jmodule = jenv.net()
    variables = jax_init_variables(jmodule, jenv, seed=seed)
    module = make_env(env_args).net()
    module.load_state_dict(flax_to_state_dict(jax.tree.map(np.asarray, variables["params"])))
    env = make_env(env_args)
    env.reset()
    return jmodule, variables, module.eval(), env.observation(env.players()[0])


def _jax_hidden(name, h):
    """The port's hidden state in the JAX layout (the DRC's (C, H, W) last)."""
    if name == "GeisterNet":
        return tuple(np.moveaxis(np.asarray(x), -3, -1) for x in h)
    return h


@pytest.fixture(scope="module", params=sorted(NETS))
def exported(request, tmp_path_factory):
    name = request.param
    jmodule, variables, module, obs = _jax_and_port(NETS[name])
    path = str(tmp_path_factory.mktemp("export") / f"{name}.pt2")
    info = export_model(module, obs, path, device="cpu")
    return name, jmodule, variables, module, obs, path, info


@pytest.mark.parametrize("n", [1, 7])
def test_pt2_round_trip_matches_the_module_and_jax(exported, n):
    name, jmodule, variables, module, obs, path, info = exported
    model = ExportedModel(path, device="cpu")
    assert model.output_names == info["outputs"]
    rng = np.random.default_rng(n)
    batch = tree_map(lambda x: (rng.random((n,) + np.shape(x)) < 0.3).astype(np.float32), obs)
    hidden = model.init_hidden((n,))
    stateful = hidden is not None
    for step in range(2):
        got = model.inference_batch(batch, hidden)
        with torch.no_grad():
            want = module(tree_map(torch.from_numpy, batch),
                          tree_map(torch.from_numpy, hidden) if stateful else None)
        jh = _jax_hidden(name, hidden) if stateful else None
        jwant = jmodule.apply(variables, batch, jh)
        for key in ("policy", "value"):
            np.testing.assert_allclose(got[key], want[key].numpy(), rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(got[key], np.asarray(jwant[key]), rtol=1e-5, atol=1e-5)
        if stateful:
            for g, w in zip(tree_leaves(got["hidden"]), tree_leaves(want["hidden"])):
                np.testing.assert_allclose(g, w.numpy(), rtol=1e-6, atol=1e-6)
            for g, w in zip(tree_leaves(_jax_hidden(name, got["hidden"])),
                            tree_leaves(jwant["hidden"])):
                np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5, atol=1e-5)
            hidden = got["hidden"]
        else:
            assert "hidden" not in got
            break


def test_artifact_holds_cpu_weights_and_names_its_outputs(exported):
    name, _, _, module, obs, path, info = exported
    program = torch.export.load(path)
    assert all(t.device.type == "cpu" for t in program.state_dict.values())
    assert info["outputs"] == sorted(k for k, v in module(
        tree_map(lambda x: torch.as_tensor(np.asarray(x)[None]), obs),
        module.initial_state((1,))).items() if v is not None)
    model = load_model(path, make_env(NETS[name]), device="cpu")
    assert isinstance(model, ExportedModel)
    single = model.inference(obs, model.init_hidden())
    assert single["policy"].ndim == 1


def test_exported_entry_points_refuse_without_a_card(exported, monkeypatch):
    path = exported[5]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ExportedModel(path)


def test_jax_artifacts_are_refused_by_name(tmp_path):
    env = make_env({"env": "TicTacToe"})
    for suffix, words in ((".hlo", "StableHLO"), (".tf", "SavedModel")):
        with pytest.raises(ValueError, match=words):
            load_model(str(tmp_path / f"m{suffix}"), env, device="cpu")
    with pytest.raises(ValueError, match="not an exported artifact"):
        load_artifact(str(tmp_path / "m.bin"), device="cpu")
    bad = tmp_path / "broken.pt2"
    bad.write_bytes(b"not a program")
    with pytest.raises(Exception):
        ExportedModel(str(bad), device="cpu")   # a broken artifact raises, never falls back


def test_export_check_error_is_nan_for_a_non_finite_output():
    """The export's numerics check reads ``tree_max_rel_err``: a NaN leaf
    must make it NaN (refused), not vanish in a running max."""
    from handyrl_tpu_torch.utils import tree_max_rel_err

    want = {"policy": np.ones((2, 3), np.float32), "value": np.full((2, 1), 4.0, np.float32)}
    got = {"policy": np.ones((2, 3), np.float32) + 0.5,
           "value": torch.full((2, 1), 4.2)}
    assert tree_max_rel_err(got, want) == pytest.approx(0.5, rel=1e-6)
    got["value"][0, 0] = float("nan")
    assert np.isnan(tree_max_rel_err(got, want))
    assert np.isnan(tree_max_rel_err({"value": want["value"]}, {"value": got["value"]}))


def test_onnx_route_names_its_missing_packages(tmp_path):
    from handyrl_tpu_torch.models.export import OnnxModel, export_onnx

    _, _, module, obs = _jax_and_port({"env": "TicTacToe"})
    missing = [p for p in ("onnx", "onnxscript") if importlib.util.find_spec(p) is None]
    if missing:
        with pytest.raises(ImportError, match=missing[0]):
            export_onnx(module, obs, str(tmp_path / "m.onnx"))
    if importlib.util.find_spec("onnxruntime") is None:
        with pytest.raises(ImportError, match="onnxruntime"):
            OnnxModel(str(tmp_path / "m.onnx"))


def _stand_in_onnxruntime(monkeypatch, providers):
    """A module named ``onnxruntime`` offering ``providers``, whose sessions
    record the providers they were opened with."""
    import types

    opened = []

    class Session:
        def __init__(self, path, providers):
            opened.append(providers)

        def get_inputs(self):
            return []

    ort = types.ModuleType("onnxruntime")
    ort.get_available_providers = lambda: list(providers)
    ort.InferenceSession = Session
    monkeypatch.setitem(sys.modules, "onnxruntime", ort)
    return opened


def test_onnx_artifact_runs_on_the_card_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    """An ``.onnx`` artifact takes the device of every entry point: the CPU
    provider only for device='cpu'; the card otherwise, where a missing CUDA
    provider (or a missing card) raises instead of running on the CPU."""
    from handyrl_tpu_torch.models import export
    from handyrl_tpu_torch.runtime import codec

    path = str(tmp_path / "m.onnx")
    with open(path + ".meta", "wb") as f:
        f.write(codec.dumps({"n_obs": 1, "hidden0": None}))
    opened = _stand_in_onnxruntime(monkeypatch, ["CPUExecutionProvider"])
    model = export.load_artifact(path, device="cpu")
    assert model.device == torch.device("cpu") and opened == [["CPUExecutionProvider"]]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            export.load_artifact(path)          # the default is the card, never the CPU
    monkeypatch.setattr(export, "resolve_device", lambda d: torch.device("cuda" if d is None else d))
    with pytest.raises(RuntimeError, match="CUDAExecutionProvider"):
        export.load_artifact(path)
    assert len(opened) == 1
    opened = _stand_in_onnxruntime(monkeypatch, ["CUDAExecutionProvider", "CPUExecutionProvider"])
    assert export.load_artifact(path, device="cuda:1").device == torch.device("cuda:1")
    assert opened == [[("CUDAExecutionProvider", {"device_id": 1})]]


@pytest.mark.parametrize("weight_dtype", ["float32", "int8"])
def test_onnx_round_trip_where_installed(tmp_path, weight_dtype):
    pytest.importorskip("onnx")
    pytest.importorskip("onnxscript")
    pytest.importorskip("onnxruntime")
    from handyrl_tpu_torch.models.export import OnnxModel, export_onnx

    _, _, module, obs = _jax_and_port({"env": "TicTacToe"})
    path = str(tmp_path / "m.onnx")
    export_onnx(module, obs, path, weight_dtype=weight_dtype)
    batch = tree_map(lambda x: np.repeat(np.asarray(x)[None], 3, 0), obs)
    got = OnnxModel(path, device="cpu").inference_batch(batch)
    want = InferenceModel(module, device="cpu").inference_batch(batch)
    tol = 1e-5 if weight_dtype == "float32" else 5e-2
    np.testing.assert_allclose(got["policy"], want["policy"].numpy(), rtol=tol, atol=tol)


# -- the edge replica ---------------------------------------------------------


def test_edge_replica_serves_the_wire_protocol(tmp_path):
    _, _, module, obs = _jax_and_port({"env": "TicTacToe"})
    path = str(tmp_path / "m.pt2")
    export_model(module, obs, path, device="cpu")
    model = ExportedModel(path, device="cpu")
    edge = EdgeReplica(model, port=0, workers=2).run()
    client = ServingClient("127.0.0.1", edge.bound_port)
    try:
        reply = client.infer(obs, timeout=TIMEOUT)
        assert reply["model"] == 0
        np.testing.assert_allclose(reply["out"]["policy"], model.inference(obs)["policy"],
                                   rtol=1e-6, atol=1e-6)
        assert client.stats(timeout=TIMEOUT)["serve_replies"] == 1
        for call in (lambda: client.infer(obs, sid="s-x", timeout=TIMEOUT),
                     lambda: client.infer(obs, hidden={"h": np.zeros(2, np.float32)},
                                          timeout=TIMEOUT),
                     lambda: client.swap(2, params={"w": np.zeros(1, np.float32)},
                                         timeout=TIMEOUT),
                     lambda: client.open_session(timeout=TIMEOUT)):
            with pytest.raises(ServingError) as err:
                call()
            assert err.value.kind == "bad_request"
        stats = client.stats(timeout=TIMEOUT)
        assert stats["serve_errors"] == 4 and stats["serve_replies"] == 1
    finally:
        client.close()
        edge.shutdown()
    assert not any(t.is_alive() for t in edge._threads)   # a stop joins its threads


def test_fleet_keeps_stateful_routes_off_a_pt2_edge(tmp_path):
    """A full replica and an edge replica over the same DRC weights' export
    behind a FleetRouter: sessions and shipped hidden state land on the full
    one, stateless requests may use the edge, and the edge never opens a
    session."""
    _, _, module, obs = _jax_and_port({"env": "TicTacToe"})
    path = str(tmp_path / "m.pt2")
    export_model(module, obs, path, device="cpu")
    cfg = {"port": 0, "max_models": 3, "slo_ms": 2000.0, "shed_policy": "none", "max_batch": 8,
           "warm_buckets": [1, 4], "session_capacity": 64}
    router = ModelRouter(module, obs, cfg, model_dir=str(tmp_path), devices=["cpu"])
    router.publish(1, module.state_dict())
    full = ServingServer(router, cfg).run()
    edge = EdgeReplica(ExportedModel(path, device="cpu"), port=0).run()
    fleet = FleetRouter({"port": 0, "stats_poll_s": 0.2, "replica_stall_s": 5.0,
                         "rejoin_backoff_s": 0.2, "stats_interval": 0.0,
                         "replicas": [f"127.0.0.1:{full.bound_port}",
                                      {"host": "127.0.0.1", "port": edge.bound_port,
                                       "tags": ["edge"]}]}).run(connect_timeout=10.0)
    client = ServingClient("127.0.0.1", fleet.bound_port)
    try:
        sids = [client.open_session(timeout=TIMEOUT) for _ in range(4)]
        assert all(not fleet._affinity[s].is_edge for s in sids)
        for sid in sids:
            assert client.infer(obs, sid=sid, timeout=TIMEOUT)["sid"] == sid
        for _ in range(16):
            client.infer(obs, timeout=TIMEOUT)
        stats = client.stats(timeout=TIMEOUT)["replicas"]
        edge_stats = stats[f"127.0.0.1:{edge.bound_port}"]
        assert edge_stats["serve_errors"] == 0 and "session_opened" not in edge_stats
    finally:
        client.close()
        fleet.shutdown()
        edge.shutdown()
        full.shutdown()


def test_cli_exports_and_serves_an_edge(tmp_path):
    """``python -m handyrl_tpu_torch.models.export`` writes the artifact from
    a checkpoint; ``main(["--edge", path])`` loads it (a sitecustomize keeps
    the CLI children on the CPU)."""
    module = make_env({"env": "TicTacToe"}).net()
    ckpt.atomic_write_bytes(str(tmp_path / "1.ckpt"), ckpt.to_bytes(module.state_dict()))
    (tmp_path / "config.yaml").write_text("env_args: {env: TicTacToe}\n"
                                         "train_args: {fleet: {edge_port: 0}}\n")
    code = ("import sys, handyrl_tpu_torch.models.export as e;"
            "sys.exit(e.main(sys.argv[1:], device='cpu'))")
    out = subprocess.run([sys.executable, "-c", code, "1.ckpt"], cwd=tmp_path,
                         env={"PYTHONPATH": str(ROOT), "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "exported 1.ckpt -> 1.pt2" in out.stdout
    model = ExportedModel(str(tmp_path / "1.pt2"), device="cpu")
    env = make_env({"env": "TicTacToe"})
    env.reset()
    with torch.no_grad():
        want = module(tree_map(lambda x: torch.as_tensor(np.asarray(x)[None]),
                               env.observation(0)))
    np.testing.assert_allclose(model.inference(env.observation(0))["policy"],
                               want["policy"][0].numpy(), rtol=1e-6, atol=1e-6)
    code = ("import sys\nfrom handyrl_tpu_torch.main import main\n"
            "sys.exit(main(['--edge', '1.pt2'], device='cpu'))\n")
    proc = subprocess.Popen([sys.executable, "-u", "-c", code], cwd=tmp_path,
                            env={"PYTHONPATH": str(ROOT), "PATH": "/usr/bin:/bin"},
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("edge: serving 1.pt2 on port"), line + proc.stderr.read()[-2000:]
        port = int(line.split("on port ")[1].split()[0])
        client = ServingClient("127.0.0.1", port)
        assert client.infer(env.observation(0), timeout=TIMEOUT)["model"] == 0
        client.close()
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
        assert "SIGTERM" in proc.stdout.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
