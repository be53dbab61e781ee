"""The port's int8 rung (``handyrl_tpu_torch/models/quantize.py`` and its
seams) against the JAX package's ``models/quantize.py`` on the CPU.

Weights are the JAX package's, carried over with ``convert.py``; inputs come
from seeded numpy.  Tolerances:

* codes, scales, ``param_bytes``, quantized observations and episode blocks:
  bit for bit;
* int8 engines against JAX ``QuantizedInferenceModel`` (the DRC with its
  hidden state, the transformer in step mode with its KV cache): 1e-5 (fp32,
  another summation order), the next hidden state included;
* the int8 engine against an fp32 engine of the dequantized tree: 1e-6 (the
  same weights, the same ops);
* ``calibration_report`` against JAX: 1e-5 on the deviations (their inputs
  differ by the 1e-5 above);
* ``forward_prediction`` on int8 windows against JAX on the same windows:
  1e-5; against the port's own fp32 windows: exactly;
* the staged int8 rings' sampled windows against ``make_batch`` of the
  same episodes: exactly (0/1 planes, unit scale).
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from handyrl_tpu.config import normalize_args as jax_normalize_args
from handyrl_tpu.envs import make_env as jax_make_env
from handyrl_tpu.models import init_variables as jax_init_variables
from handyrl_tpu.models import quantize as jq
from handyrl_tpu.parallel.train_step import forward_prediction as jax_forward
from handyrl_tpu.runtime.generation import Generator as JaxGenerator
from handyrl_tpu_torch.config import normalize_args
from handyrl_tpu_torch.envs import make_env
from handyrl_tpu_torch.models import build_inference_model, flax_to_state_dict
from handyrl_tpu_torch.models import quantize as pq
from handyrl_tpu_torch.parallel import forward_prediction
from handyrl_tpu_torch.runtime import device_replay
from handyrl_tpu_torch.runtime.batch import make_batch
from handyrl_tpu_torch.runtime.device_replay import DeviceEpisodeStage
from handyrl_tpu_torch.runtime.generation import Generator
from handyrl_tpu_torch.runtime.replay import EpisodeStore, decompress_block
from handyrl_tpu_torch.utils import tree_leaves, tree_map

TRANSFORMER = {"env": "Geister", "net": "transformer",
               "net_args": {"d_model": 32, "n_heads": 2, "n_layers": 2, "memory_len": 4}}
NETS = {
    "SimpleConvNet": {"env": "TicTacToe"},
    "GeeseNet": {"env": "HungryGeese"},
    "GeisterNet": {"env": "Geister"},
    "transformer": TRANSFORMER,
}


def _jax_net(env_args, seed=3):
    jenv = jax_make_env(env_args)
    jmodule = jenv.net()
    return jenv, jmodule, jax_init_variables(jmodule, jenv, seed=seed)["params"]


def _fp32_state(params):
    return flax_to_state_dict(jax.tree.map(np.asarray, params))


@pytest.fixture(scope="module", params=sorted(NETS))
def net(request):
    env_args = NETS[request.param]
    jenv, jmodule, params = _jax_net(env_args)
    return request.param, env_args, jmodule, params, make_env(env_args).net()


def test_codes_are_the_jax_codes_bit_for_bit(net):
    """JAX quantize_params then convert == the port's quantize of the
    converted fp32 state dict, codes and scales alike."""
    name, _, _, params, module = net
    want = _fp32_state(jax.tree.map(np.asarray, jq.quantize_params(jax.tree.map(np.asarray,
                                                                                 params))))
    got = pq.quantize_params(_fp32_state(params))
    assert sorted(got) == sorted(want)
    assert sorted(got) == sorted(pq.quantize_module(module).state_dict())
    for key, value in got.items():
        assert value.dtype == want[key].numpy().dtype, key
        np.testing.assert_array_equal(value, want[key].numpy(), err_msg=key)
    assert pq.quantize_params(got).keys() == got.keys()   # idempotent
    assert pq.param_bytes(got) == jq.param_bytes(jq.quantize_params(jax.tree.map(np.asarray,
                                                                                 params)))
    assert pq.param_bytes(_fp32_state(params)) == jq.param_bytes(params)
    if name == "GeeseNet":   # the zero-initialised value head: scale 1.0, codes 0
        assert np.all(got["Dense_1.weight.int8_scale"] == 1.0)
        assert not got["Dense_1.weight.int8_q"].any()


def test_leaf_quantize_is_per_output_channel_on_dim_0():
    rng = np.random.default_rng(0)
    w = rng.normal(size=(5, 3, 2, 2)).astype(np.float32)
    w[2] = 0.0
    node = pq.quantize_leaf(w)
    jnode = jq.quantize_leaf(w.transpose(2, 3, 1, 0))      # OIHW -> HWIO
    np.testing.assert_array_equal(node["int8_q"], jnode["int8_q"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(node["int8_scale"], jnode["int8_scale"])
    assert node["int8_scale"][2] == 1.0
    back = pq.dequantize_leaf(node)
    assert np.abs(back - w).max() <= node["int8_scale"].max() / 2 + 1e-7
    np.testing.assert_array_equal(back, jq.dequantize_leaf(jnode).transpose(3, 2, 0, 1))


def _obs_batch(env_args, n, seed):
    env = make_env(env_args)
    env.reset()
    obs = env.observation(env.players()[0])
    rng = np.random.default_rng(seed)
    return tree_map(lambda x: (rng.random((n,) + np.shape(x)) < 0.3).astype(np.float32), obs)


@pytest.mark.parametrize("name", ["GeisterNet", "transformer"])
def test_int8_engine_matches_jax_quantized_engine(name):
    """The DRC with its hidden state and the transformer in step mode with
    its KV cache: two steps, outputs and the next hidden within 1e-5."""
    env_args = NETS[name]
    _, jmodule, params = _jax_net(env_args, seed=5)
    module = make_env(env_args).net()
    jengine = jq.QuantizedInferenceModel(jmodule, {"params": params})
    engine = build_inference_model(module, pq.quantize_params(_fp32_state(params)), "int8",
                                   device="cpu")
    fp32 = build_inference_model(module, pq.dequantize_params(pq.quantize_params(
        _fp32_state(params))), device="cpu")
    assert isinstance(engine, pq.QuantizedInferenceModel)
    assert {t.dtype for k, t in engine.module.state_dict().items()
            if k.endswith("int8_q")} == {torch.int8}
    B = 3
    jh, h, hf = jengine.init_hidden((B,)), engine.init_hidden((B,)), fp32.init_hidden((B,))
    to_port = (lambda x: torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(x), -1, -3)))
               ) if name == "GeisterNet" else (lambda x: torch.from_numpy(np.asarray(x)))
    for step in range(2):
        obs = _obs_batch(env_args, B, step)
        jout = jengine.inference_batch(obs, jh)
        with torch.no_grad():
            out = engine.inference_batch(obs, h)
            outf = fp32.inference_batch(obs, hf)
        for key in ("policy", "value"):
            np.testing.assert_allclose(out[key].numpy(), np.asarray(jout[key]), rtol=1e-5,
                                       atol=1e-5, err_msg=key)
            np.testing.assert_allclose(out[key].numpy(), outf[key].numpy(), rtol=1e-6,
                                       atol=1e-6, err_msg=key)
        for got, want in zip(tree_leaves(out["hidden"]), tree_leaves(jout["hidden"])):
            np.testing.assert_allclose(got.numpy(), to_port(want).numpy(), rtol=1e-5, atol=1e-5)
        jh, h, hf = jout["hidden"], out["hidden"], outf["hidden"]


def test_no_forward_materialises_the_whole_fp32_tree():
    """Each quantized layer dequantizes only its own kernel: the engine's
    resident state holds int8 codes, and the fp32 kernels exist one at a
    time, inside their layer's forward."""
    module = make_env(TRANSFORMER).net()
    engine = build_inference_model(module, module.state_dict(), "int8", device="cpu")
    kernels = [m for m in engine.module.modules() if isinstance(m, (pq.QuantLinear,
                                                                    pq.QuantConv2d))]
    assert kernels and not any(isinstance(m, torch.nn.Linear) for m in engine.module.modules())
    live, peak = [0], [0]
    sizes = {}

    def pre(mod, _args):
        sizes[id(mod)] = mod.int8_q.numel()
        live[0] += sizes[id(mod)]
        peak[0] = max(peak[0], live[0])

    def post(mod, _args, _out):
        live[0] -= sizes[id(mod)]

    for m in kernels:
        m.register_forward_pre_hook(pre)
        m.register_forward_hook(post)
    engine.inference_batch(_obs_batch(TRANSFORMER, 2, 0), engine.init_hidden((2,)))
    assert peak[0] == max(m.int8_q.numel() for m in kernels)
    fp32_bytes = pq.param_bytes(module.state_dict())
    assert pq.param_bytes(engine.module) < 0.3 * fp32_bytes


def test_calibration_report_matches_jax():
    env_args = NETS["SimpleConvNet"]
    _, jmodule, params = _jax_net(env_args, seed=7)
    module = make_env(env_args).net()
    batches = [_obs_batch(env_args, 8, s) for s in (1, 2)]
    want = jq.calibration_report(jmodule, params, batches)
    got = pq.calibration_report(module, _fp32_state(params), batches, device="cpu")
    assert got["calib_batches"] == want["calib_batches"] == 2.0
    for key in ("calib_max_dev", "calib_mean_dev"):
        assert abs(got[key] - want[key]) <= 1e-5, (key, got, want)
    assert 0.0 < got["calib_mean_dev"] <= got["calib_max_dev"]


def test_obs_trees_quantize_and_dequantize_as_jax():
    rng = np.random.default_rng(0)
    planes = {"board": (rng.random((4, 7, 6, 6)) < 0.3).astype(np.float32),
              "scalar": (rng.random((4, 18)) < 0.5).astype(np.float32)}
    ramp = {"p": np.linspace(-1.0, 1.0, 32, dtype=np.float32).reshape(4, 8),
            "q": np.linspace(-3.0, 5.0, 32, dtype=np.float32).reshape(4, 8)}
    for tree, spec in ((planes, None), (planes, [(1.0, 0.0), (1.0, 0.0)]),
                       (ramp, [(2.0 / 254.0, 0.0), (0.05, -20.0)])):
        got, want = pq.quantize_obs_tree(tree, spec), jq.quantize_obs_tree(tree, spec)
        assert pq.obs_tree_is_int8(got) and jq.obs_tree_is_int8(want)
        for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
            assert g.dtype == np.int8
            np.testing.assert_array_equal(g, w)
        deq = pq.dequantize_obs_tree(tree_map(torch.from_numpy, got), spec)
        jdeq = jq.dequantize_obs_tree(tree_map(jnp.asarray, want), spec)
        for g, w in zip(tree_leaves(deq), jax.tree.leaves(jdeq)):
            assert g.dtype == torch.float32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        host = pq.dequantize_obs_tree(got, spec)      # numpy in, numpy out
        for g, w in zip(tree_leaves(host), jax.tree.leaves(jdeq)):
            np.testing.assert_array_equal(g, np.asarray(w))
    # 0/1 planes round-trip exactly under the default spec; fp32 passes through
    for g, w in zip(tree_leaves(pq.dequantize_obs_tree(pq.quantize_obs_tree(planes))),
                    tree_leaves(planes)):
        np.testing.assert_array_equal(g, w)
    assert pq.dequantize_obs_tree(planes) == planes

    class _BadEnv:
        def obs_int8_spec(self):
            return [(0.0, 0.0)]

    for quant in (pq, jq):
        with pytest.raises(ValueError, match="scale"):
            quant.obs_quant_spec(_BadEnv())
    env = make_env({"env": "Geister"})
    assert pq.obs_quant_spec(env) == jq.obs_quant_spec(jax_make_env({"env": "Geister"}))


class _DetModel:
    """A fixed-weight policy/value head over any observation tree."""

    def __init__(self, n_in, n_actions, seed=7):
        self.W = np.random.RandomState(seed).randn(n_in, n_actions).astype(np.float32)

    def inference(self, obs, hidden=None):
        flat = np.concatenate([np.asarray(x, np.float32).reshape(-1) for x in tree_leaves(obs)])
        return {"policy": np.tanh(flat @ self.W).astype(np.float32),
                "value": np.asarray([np.tanh(float(flat.sum()) / 50)], np.float32),
                "hidden": None}

    def init_hidden(self):
        return None


def _targs(env_name, normalize=normalize_args, **over):
    cfg = normalize({"env_args": {"env": env_name}, "train_args": dict(over, mesh={"dp": 1})})
    return dict(cfg["train_args"], env=cfg["env_args"])


def _episodes(gen_cls, mk_env, env_name, n_in, n_actions, targs, n, seed):
    random.seed(seed)
    env = mk_env({"env": env_name})
    model = _DetModel(n_in, n_actions)
    players = env.players()
    gen = gen_cls(env, targs)
    out = []
    while len(out) < n:
        ep = gen.generate({p: model for p in players},
                          {"player": players, "model_id": {p: 1 for p in players}})
        if ep is not None:
            out.append(ep)
    return out


@pytest.mark.parametrize("env_name,n_in,n_actions", [("TicTacToe", 27, 9),
                                                     ("HungryGeese", 17 * 77, 4)])
def test_finalize_with_obs_int8_writes_the_jax_blocks(env_name, n_in, n_actions):
    over = {"obs_int8": True, "turn_based_training": env_name == "TicTacToe",
            "observation": env_name != "TicTacToe"}
    eps = _episodes(Generator, make_env, env_name, n_in, n_actions, _targs(env_name, **over),
                    3, 17)
    jeps = _episodes(JaxGenerator, jax_make_env, env_name, n_in, n_actions,
                     _targs(env_name, jax_normalize_args, **over), 3, 17)
    feps = _episodes(Generator, make_env, env_name, n_in, n_actions,
                     _targs(env_name, **dict(over, obs_int8=False)), 3, 17)
    for ep, jep, fep in zip(eps, jeps, feps):
        assert ep["blocks"] == jep["blocks"]
        np.testing.assert_array_equal(ep["obs_scale"], jep["obs_scale"])
        np.testing.assert_array_equal(ep["obs_zero"], jep["obs_zero"])
        for b, fb in zip(ep["blocks"], fep["blocks"]):
            obs, fobs = decompress_block(b)["obs"], decompress_block(fb)["obs"]
            assert pq.obs_tree_is_int8(obs) and not pq.obs_tree_is_int8(fobs)
            for g, w in zip(tree_leaves(pq.dequantize_obs_tree(obs)), tree_leaves(fobs)):
                np.testing.assert_array_equal(g, w)
    # the calibration feed from a store dequantizes back to fp32 planes
    store = EpisodeStore(10)
    store.extend(eps)
    batches = pq.calibration_batches_from_store(store, 2)
    assert len(batches) == 2 and not any(pq.obs_tree_is_int8(b) for b in batches)


FORWARD = {
    "ff-SimpleConvNet": ({"env": "TicTacToe"}, dict(turn_based_training=True)),
    "rnn-GeisterNet": ({"env": "Geister"}, dict(observation=True, burn_in_steps=2)),
    "seq-transformer": (TRANSFORMER, dict(observation=True, burn_in_steps=2)),
}


@pytest.mark.parametrize("case", sorted(FORWARD))
def test_forward_prediction_on_int8_windows_matches_jax(case):
    """The feed-forward, RNN and seq branches: int8 observation windows
    widen inside forward_prediction, equal to the fp32 windows exactly and
    to JAX's forward on the same int8 windows within 1e-5."""
    env_args, over = FORWARD[case]
    targs = _targs(env_args["env"], forward_steps=4, batch_size=2, obs_int8=True, **over)
    targs["env"] = env_args
    jtargs = _targs(env_args["env"], jax_normalize_args, forward_steps=4, batch_size=2,
                    obs_int8=True, **over)
    _, jmodule, params = _jax_net(env_args, seed=11)
    module = make_env(env_args).net()
    module.load_state_dict(_fp32_state(params))
    env = make_env(env_args)
    env.reset()
    obs0 = env.observation(env.players()[0])
    B, T, P = 2, targs["burn_in_steps"] + targs["forward_steps"], 2
    rng = np.random.default_rng(3)
    obs = tree_map(lambda x: (rng.random((B, T, P) + np.shape(x)) < 0.3).astype(np.int8), obs0)
    A = 9 if env_args["env"] == "TicTacToe" else 214
    turn = np.zeros((B, T, P, 1), np.float32)
    turn[:, np.arange(T), np.arange(T) % P] = 1.0   # the players move in turn
    batch = {
        "observation": obs,
        "observation_mask": np.ones((B, T, P, 1), np.float32),
        "turn_mask": turn,
        "action_mask": np.where(rng.random((B, T, P, A)) < 0.5, 1e32, 0.0).astype(np.float32),
        "action": np.zeros((B, T, P, 1), np.int32),
    }
    targs["_obs_quant"] = pq.obs_quant_spec(env, obs=obs0)
    jtargs["_obs_quant"] = jq.obs_quant_spec(jax_make_env(env_args))
    with torch.no_grad():
        out = forward_prediction(module, None, tree_map(torch.from_numpy, batch), targs)
        fbatch = dict(batch, observation=tree_map(lambda x: x.astype(np.float32), obs))
        fout = forward_prediction(module, None, tree_map(torch.from_numpy, fbatch), targs)
    jout = jax_forward(jmodule, params, tree_map(jnp.asarray, batch), jtargs)
    assert sorted(out) == sorted(k for k, v in jout.items() if v is not None)
    for key in out:
        np.testing.assert_array_equal(out[key].numpy(), fout[key].numpy(), err_msg=key)
        np.testing.assert_allclose(out[key].numpy(), np.asarray(jout[key]), rtol=1e-5, atol=1e-5,
                                   err_msg=key)


def _host_window(ep, train_start, args):
    fwd, cs = args["forward_steps"], args["compress_steps"]
    start = max(0, train_start - args["burn_in_steps"])
    end = min(train_start + fwd, ep["steps"])
    first_block, last_block = start // cs, (end - 1) // cs + 1
    return {"args": ep["args"],
            "outcome": np.asarray([ep["outcome"][p] for p in ep["players"]], np.float32),
            "players": ep["players"], "blocks": ep["blocks"][first_block:last_block],
            "base": first_block * cs, "start": start, "end": end, "train_start": train_start,
            "total": ep["steps"]}


def test_staged_int8_rings_sample_what_make_batch_assembles(monkeypatch):
    """JAX test_lowprec's ring parity on the port: int8 rings, and every
    sampled window (dequantized on sample) equals make_batch's (whose int8
    planes are dequantized on the host) exactly."""
    targs = _targs("HungryGeese", batch_size=8, forward_steps=8, turn_based_training=False,
                   observation=False, obs_int8=True)
    eps = _episodes(Generator, make_env, "HungryGeese", 17 * 77, 4, targs, 24, 23)
    stage = DeviceEpisodeStage(make_env({"env": "HungryGeese"}).net(), targs, n_lanes=4,
                               slots=256, chunk_steps=8, track_episodes=True, device="cpu")
    for ep in eps:
        stage.add_episode(ep)
    stage.flush()
    stage.drain()
    rec = stage.replay.rings["rec"]
    obs_keys = [k for k in rec if k.startswith("obs") and k[3:].isdigit()]
    assert obs_keys and all(rec[k].dtype == torch.int8 for k in obs_keys)
    S, G = stage.slots, stage.replay.rings["g"]
    n = 16
    batch, info = stage.replay.sample(torch.Generator().manual_seed(3), n, with_info=True)
    assert all(x.dtype == torch.float32 for x in tree_leaves(batch["observation"]))
    for i in range(n):
        lane, slot, player = (int(info[k][i]) for k in ("lane", "slot", "player"))
        gs0 = G - 1 - ((G - 1 - slot) % S)
        g0, _, ep = [s for s in stage.spans[lane] if s[0] <= gs0 <= s[1]][0]
        if player >= 0:
            monkeypatch.setattr("handyrl_tpu_torch.runtime.batch.random.randrange",
                                lambda _n, p=player: p)
        host = make_batch([_host_window(ep, gs0 - g0, targs)], targs)
        assert pq.obs_tree_is_int8(host["observation"])   # int8 on the host path
        host["observation"] = pq.dequantize_obs_tree(host["observation"],
                                                     pq.episode_obs_spec(ep))
        for key in host:
            for h, g in zip(tree_leaves(host[key]), tree_leaves(batch[key])):
                np.testing.assert_array_equal(g.numpy()[i:i + 1], h, err_msg=f"{key} row {i}")
    assert device_replay is not None


def test_router_publishes_int8_and_calibrates(tmp_path):
    from handyrl_tpu_torch.serving import ModelRouter

    env = make_env({"env": "TicTacToe"})
    env.reset()
    obs = env.observation(0)
    module = env.net()
    cfg = {"max_models": 3, "slo_ms": 2000.0, "shed_policy": "none", "max_batch": 8,
           "warm_buckets": [1, 4], "weight_dtype": "int8", "calibration_batches": 2}
    router = ModelRouter(module, obs, cfg, model_dir=str(tmp_path), devices=["cpu"])
    batch = tree_map(lambda x: np.repeat(np.asarray(x)[None], 4, axis=0), obs)
    router.calibration_source = lambda: [batch, batch, batch]
    try:
        router.publish(1, module.state_dict())
        mid, engine = router.resolve(1)
        assert mid == 1 and isinstance(engine.model, pq.QuantizedInferenceModel)
        assert any(isinstance(m, pq.QuantLinear) for m in engine.model.module.modules())
        assert router.last_calibration["calib_batches"] == 2.0
        assert 0.0 <= router.last_calibration["calib_max_dev"] <= 0.05
        out = engine.submit(obs).result(timeout=60)
        assert np.isfinite(out["policy"]).all()
    finally:
        router.stop()
