"""The recurrent path of the port against the JAX package on the CPU: the
ConvLSTM cell, the DRC, Geister's ``GeisterNet``, the RNN branch of
``forward_prediction`` and the loss through it, the engine with a DRC
hidden state, and a Learner epoch with the DRC.

Weights are the JAX package's, carried over with ``convert.py``; inputs
come from seeded numpy.  The JAX hidden state is (..., L, H, W, C), the
port's (..., L, C, H, W): the tests permute between them.  Tolerances:
modules 1e-5 (fp32, another summation order); the RNN forward_prediction
1e-5; losses and gradients 1e-4 (gradients: relative, and 1e-5 absolute
where they cross zero; sums over the batch); remat on against off
exactly equal (the same ops, replayed); bf16 against the JAX bf16 run 5e-2
of the outputs' scale (the JAX cells promote to fp32 against their fp32
state, the port's run in bf16: the runs are not bit-comparable).
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from handyrl_tpu.envs import make_env as jax_make_env
from handyrl_tpu.models import RandomModel as JaxRandomModel
from handyrl_tpu.models.layers import DRC as JaxDRC
from handyrl_tpu.models.layers import ConvLSTMCell as JaxConvLSTMCell
from handyrl_tpu.models.nets import GeisterNet as JaxGeisterNet
from handyrl_tpu.ops import compute_loss_from_outputs as jax_loss
from handyrl_tpu.parallel.train_step import forward_prediction as jax_forward
from handyrl_tpu.parallel.train_step import trim_burn_in as jax_trim_burn_in
from handyrl_tpu.runtime import Generator as JaxGenerator
from handyrl_tpu.runtime import make_batch as jax_make_batch
from handyrl_tpu_torch.config import normalize_args
from handyrl_tpu_torch.envs import make_env
from handyrl_tpu_torch.models import GeisterNet, InferenceModel, flax_to_state_dict, init_variables
from handyrl_tpu_torch.models.layers import DRC, ConvLSTMCell
from handyrl_tpu_torch.parallel import TrainContext, forward_prediction, resolve_rnn_remat
from handyrl_tpu_torch.runtime import BatchedInferenceEngine
from handyrl_tpu_torch.runtime import checkpoint as ckpt
from handyrl_tpu_torch.runtime.learner import Learner

GEISTER = {"env": "Geister"}
LOSS_KEYS = ("p", "v", "r", "ent", "total")


def _to_port(h):
    """JAX (..., H, W, C) -> port (..., C, H, W)."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(h), -1, -3)))


def _to_jax(h):
    return np.moveaxis(h.detach().numpy(), -3, -1)


def _state_dict(params):
    return flax_to_state_dict(jax.tree.map(np.asarray, params))


def _close(got, want, tol=1e-5, msg=""):
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol, err_msg=msg)


def _asymmetric(rng, shape):
    """Inputs with no symmetry a wrong layout could hide behind: a ramp
    along every axis plus noise."""
    x = rng.normal(size=shape).astype(np.float32)
    for axis, n in enumerate(shape):
        ramp = np.linspace(-1, 1, n, dtype=np.float32)
        x += ramp.reshape((1,) * axis + (n,) + (1,) * (len(shape) - axis - 1)) * (axis + 1) / 4
    return x


def test_conv_lstm_cell_matches_jax():
    rng = np.random.default_rng(0)
    x, h, c = (_asymmetric(rng, (3, 5, 6, 8)) for _ in range(3))  # NHWC, width != height
    jcell = JaxConvLSTMCell(8)
    variables = jcell.init(jax.random.PRNGKey(1), x, (h, c))
    jout, (jh, jc) = jcell.apply(variables, x, (h, c))
    cell = ConvLSTMCell(8, 8)
    cell.load_state_dict(_state_dict(variables["params"]))
    with torch.no_grad():
        out, (ph, pc) = cell(_to_port(x), (_to_port(h), _to_port(c)))
    _close(_to_jax(out), jout, msg="out")
    _close(_to_jax(ph), jh, msg="h")
    _close(_to_jax(pc), jc, msg="c")


def test_drc_matches_jax():
    rng = np.random.default_rng(1)
    x = _asymmetric(rng, (2, 6, 5, 8))
    hidden = tuple(_asymmetric(rng, (2, 3, 6, 5, 8)) for _ in range(2))
    jdrc = JaxDRC(3, 8, 2)
    variables = jdrc.init(jax.random.PRNGKey(2), x, hidden)
    jout, jhidden = jdrc.apply(variables, x, hidden)
    drc = DRC(8, 3, 8, 2)
    drc.load_state_dict(_state_dict(variables["params"]))
    with torch.no_grad():
        out, new = drc(_to_port(x), tuple(_to_port(h) for h in hidden))
    _close(_to_jax(out), jout)
    for got, want in zip(new, jhidden):
        _close(_to_jax(got), want)
    zeros = drc.initial_state((4, 2), (6, 5))
    assert [tuple(z.shape) for z in zeros] == [(4, 2, 3, 8, 6, 5)] * 2
    assert all(z.dtype == torch.float32 and not z.any() for z in zeros)


@pytest.fixture(scope="module")
def geister_nets():
    """The JAX GeisterNet at its defaults and the port's with its weights."""
    jenv = jax_make_env(GEISTER)
    jmodule = jenv.net()
    assert isinstance(jmodule, JaxGeisterNet)
    from handyrl_tpu.models import init_variables as jax_init_variables

    variables = jax_init_variables(jmodule, jenv, seed=4)
    module = make_env(GEISTER).net()
    module.load_state_dict(_state_dict(variables["params"]), strict=True)
    return jmodule, variables, module


def test_geister_default_net_is_the_drc_geister_net(geister_nets):
    jmodule, variables, module = geister_nets
    assert isinstance(module, GeisterNet)
    assert sum(x.size for x in jax.tree.leaves(variables["params"])) == sum(
        p.numel() for p in module.parameters())
    h, c = module.initial_state((2,))
    assert h.shape == c.shape == (2, 3, 32, 6, 6) and h.dtype == torch.float32
    jh, _ = jmodule.initial_state((2,))
    assert tuple(np.moveaxis(np.asarray(jh), -1, -3).shape) == tuple(h.shape)


def test_geister_net_matches_jax(geister_nets):
    jmodule, variables, module = geister_nets
    rng = np.random.default_rng(2)
    obs = {"board": (rng.random((4, 7, 6, 6)) < 0.3).astype(np.float32),
           "scalar": _asymmetric(rng, (4, 18))}
    obs["board"] += _asymmetric(rng, (4, 7, 6, 6)) * 0.5
    hidden = tuple(_asymmetric(rng, (4, 3, 6, 6, 32)) for _ in range(2))
    for jh, ph in ((hidden, tuple(_to_port(h) for h in hidden)), (None, None)):
        want = jmodule.apply(variables, obs, jh)
        with torch.no_grad():
            got = module({k: torch.from_numpy(v) for k, v in obs.items()}, ph)
        assert sorted(got) == sorted(want) == ["hidden", "policy", "return", "value"]
        assert got["policy"].shape == (4, 214)
        for k in ("policy", "value", "return"):
            _close(got[k].numpy(), want[k], msg=k)
        for g, w in zip(got["hidden"], want["hidden"]):
            _close(_to_jax(g), w, msg="hidden")


def _window_at(ep, train_start, forward_steps, burn_in_steps, compress_steps):
    """The store's window at a chosen ``train_start`` (sample_window's
    arithmetic), to place windows over an episode's end."""
    steps = ep["steps"]
    start = max(0, train_start - burn_in_steps)
    end = min(train_start + forward_steps, steps)
    first, last = start // compress_steps, (end - 1) // compress_steps + 1
    return {"args": ep["args"], "players": ep["players"],
            "outcome": np.asarray([ep["outcome"][p] for p in ep["players"]], np.float32),
            "blocks": ep["blocks"][first:last], "base": first * compress_steps,
            "start": start, "end": end, "train_start": train_start, "total": steps}


def _rnn_args(**extra):
    train = dict(batch_size=2, burn_in_steps=2, forward_steps=4, observation=True,
                 policy_target="UPGO", value_target="UPGO")
    cfg = normalize_args({"env_args": GEISTER, "train_args": dict(train, **extra)})
    return dict(cfg["train_args"], env=cfg["env_args"])


@pytest.fixture(scope="module")
def rnn_setup():
    """B=2, burn-in 2, forward 4, P=2, filters 8: one window in the middle
    of an episode, one over its end (padding after it), and observer steps
    with their observation masked out."""
    args = _rnn_args()
    jenv = jax_make_env(GEISTER)
    gen = JaxGenerator(jenv, args)
    model = JaxRandomModel({"policy": ((214,), np.float32), "value": ((1,), np.float32),
                            "return": ((1,), np.float32)})
    random.seed(3)
    ep = None
    while ep is None or ep["steps"] < 12:
        ep = gen.generate({0: model, 1: model}, {"player": [0, 1]})
    windows = [_window_at(ep, 5, 4, 2, 4), _window_at(ep, ep["steps"] - 2, 4, 2, 4)]
    batch = jax_make_batch(windows, args)
    assert batch["episode_mask"][1, -1].sum() == 0 and batch["episode_mask"][1, 2].sum() == 1
    # partial observation: some observer steps unobserved
    rng = np.random.default_rng(5)
    drop = (batch["turn_mask"] == 0) & (rng.random(batch["turn_mask"].shape) < 0.5)
    batch["observation_mask"] = np.where(drop, 0.0, batch["observation_mask"]).astype(np.float32)
    assert 0 < (batch["observation_mask"] == 0).sum() and drop.any()

    jmodule = JaxGeisterNet(filters=8)
    obs0 = jax.tree.map(lambda x: jnp.asarray(x[0, 0]), batch["observation"])
    variables = jmodule.init(jax.random.PRNGKey(6), obs0, jmodule.initial_state((2,)))
    return args, jmodule, variables, batch


def _port_net(setup):
    _, _, variables, _ = setup
    module = GeisterNet(filters=8)
    module.load_state_dict(_state_dict(variables["params"]), strict=True)
    return module


def test_rnn_forward_prediction_matches_jax(rnn_setup):
    args, jmodule, variables, batch = rnn_setup
    want = jax_forward(jmodule, variables["params"], batch, args)
    module = _port_net(rnn_setup)
    ctx = TrainContext(module, args, device="cpu")
    with torch.no_grad():
        got = forward_prediction(module, None, ctx.put_batch(batch), args)
    assert sorted(got) == sorted(want) == ["policy", "return", "value"]
    for k in want:
        assert got[k].shape == tuple(want[k].shape) and got[k].shape[:3] == (2, 4, 2), k
        _close(got[k].numpy(), want[k], msg=k)


def _port_loss_and_grads(setup, **extra):
    args = dict(setup[0], **extra)
    module = _port_net(setup)
    ctx = TrainContext(module, args, device="cpu")
    losses, dcnt = ctx.loss(ctx.put_batch(setup[3]))
    losses["total"].backward()
    return losses, dcnt, {n: p.grad for n, p in module.named_parameters()}


def test_rnn_loss_and_gradients_match_jax(rnn_setup):
    args, jmodule, variables, batch = rnn_setup

    def jtotal(params):
        losses, dcnt = jax_loss(jax_forward(jmodule, params, batch, args),
                                jax_trim_burn_in(batch, args["burn_in_steps"]), args)
        return losses["total"], (losses, dcnt)

    (_, (jlosses, jdcnt)), jgrads = jax.value_and_grad(jtotal, has_aux=True)(variables["params"])
    jgrads = _state_dict(jgrads)
    losses, dcnt, grads = _port_loss_and_grads(rnn_setup)
    assert dcnt.item() == float(jdcnt)
    for k in LOSS_KEYS:
        _close(losses[k].item(), float(jlosses[k]), tol=1e-4, msg=k)
    assert sorted(grads) == sorted(jgrads)
    for n, g in grads.items():
        np.testing.assert_allclose(g.numpy(), jgrads[n].numpy(), rtol=1e-4, atol=1e-5, err_msg=n)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_rnn_remat_on_and_off_give_identical_gradients(rnn_setup, monkeypatch, compute_dtype):
    """The checkpoint's replay computes with the forward's weights: under
    bf16 the same bf16 copies, read from the step's closure."""
    import handyrl_tpu_torch.parallel.train_step as ts

    calls = []
    real = ts.checkpoint
    monkeypatch.setattr(ts, "checkpoint", lambda *a, **k: calls.append(1) or real(*a, **k))
    off = _port_loss_and_grads(rnn_setup, remat=False, compute_dtype=compute_dtype)
    assert not calls
    on = _port_loss_and_grads(rnn_setup, remat=True, compute_dtype=compute_dtype)
    assert len(calls) == 4  # one checkpoint per post-burn-in step
    for k in LOSS_KEYS:
        assert on[0][k].item() == off[0][k].item(), k
    for n, g in off[2].items():
        assert torch.equal(on[2][n], g), n


def test_rnn_bf16_matches_jax_bf16(rnn_setup):
    args, jmodule, variables, batch = rnn_setup
    args = dict(args, compute_dtype="bfloat16")
    bf16 = jax.tree.map(lambda x: x.astype(jnp.bfloat16), variables["params"])
    want = jax_forward(jmodule, bf16, batch, args)
    module = _port_net(rnn_setup)
    ctx = TrainContext(module, args, device="cpu")
    with torch.no_grad():
        params = {n: p.to(torch.bfloat16) for n, p in module.named_parameters()}
        got = forward_prediction(module, params, ctx.put_batch(batch), args)
    acting = batch["turn_mask"][:, 2:, :, 0] > 0
    for k in want:
        g, w = got[k].numpy(), np.asarray(want[k])
        assert got[k].dtype == torch.float32
        if k == "policy":  # the legal logits of acting steps (illegal ones are -1e32 on both)
            g, w = g[acting], w[acting]
            legal = w > -1e30
            g, w = g[legal], w[legal]
        scale = max(1.0, np.abs(w).max())
        assert np.abs(g - w).max() <= 5e-2 * scale, k
    losses, _ = ctx.loss(ctx.put_batch(batch))
    assert all(np.isfinite(losses[k].item()) for k in LOSS_KEYS)


def test_rnn_train_step_updates_and_stays_finite(rnn_setup):
    args, _, _, batch = rnn_setup
    module = _port_net(rnn_setup)
    before = [p.detach().clone() for p in module.parameters()]
    metrics = TrainContext(module, args, device="cpu").train_step(batch, 1e-3)
    assert metrics["sentinel_bad"] == 0.0 and np.isfinite(metrics["total"])
    assert any(not torch.equal(a, b) for a, b in zip(before, module.parameters()))


def test_recurrent_net_needs_observation_under_turn_based_training():
    module = GeisterNet(filters=8)
    with pytest.raises(ValueError, match="RNN hidden or KV-cache transformer"):
        TrainContext(module, _rnn_args(observation=False), device="cpu")
    TrainContext(module, _rnn_args(observation=False, turn_based_training=False), device="cpu")


@pytest.mark.parametrize("value,device,on", [
    ("auto", "cpu", False), ("auto", "cuda", True), ("auto", "meta", True),
    (True, "cpu", True), (False, "cuda", False), ("none", "cuda", False),
    ("attn", "cpu", True), ("block", "cpu", True), (None, "cuda", True),
])
def test_resolve_rnn_remat(value, device, on):
    assert resolve_rnn_remat({"remat": value}, torch.device(device)) is on


@pytest.mark.parametrize("value,ok", [("auto", True), (True, True), (False, True), (None, True),
                                      ("yes", False), (1, False)])
def test_unroll_is_accepted_and_checked(value, ok):
    raw = {"env_args": GEISTER, "train_args": {"unroll": value}}
    if ok:
        assert normalize_args(raw)["train_args"]["unroll"] == value
    else:
        with pytest.raises(ValueError, match="unroll"):
            normalize_args(raw)


def test_inference_engine_stacks_drc_hidden():
    """Rows at different steps of their games and fresh ones share a batch;
    outputs and both hidden tensors equal per-request calls."""
    model = InferenceModel(init_variables(GeisterNet(filters=8), 1), device="cpu")
    rng = np.random.default_rng(7)

    def obs():
        return {"board": (rng.random((7, 6, 6)) < 0.3).astype(np.float32),
                "scalar": (rng.random(18) < 0.5).astype(np.float32)}

    requests = []
    for i in range(10):
        hidden = None
        for _ in range(i % 4):
            hidden = model.inference(obs(), hidden if hidden is not None else model.init_hidden())["hidden"]
        requests.append((obs(), hidden))
    engine = BatchedInferenceEngine(model, max_batch=4).start()
    futures = [engine.submit(*r) for r in requests]
    results = [f.result(timeout=60) for f in futures]
    engine.stop()
    assert engine.batches_served < len(requests)
    for (o, h), r in zip(requests, results):
        direct = model.inference(o, h if h is not None else model.init_hidden())
        for k in ("policy", "value", "return"):
            np.testing.assert_allclose(r[k], direct[k], rtol=2e-4, atol=2e-5)
        for a, b in zip(r["hidden"], direct["hidden"]):
            assert a.shape == (3, 8, 6, 6)
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4, atol=2e-5)


def test_geister_drc_learner_trains_one_epoch(tmp_path, monkeypatch):
    """Self-play with the DRC's hidden state through the engine, burn-in
    windows, UPGO targets, one epoch and its snapshot, on the CPU."""
    monkeypatch.chdir(tmp_path)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        args = normalize_args({"env_args": GEISTER, "train_args": {
            "batch_size": 2, "burn_in_steps": 2, "forward_steps": 4, "observation": True,
            "policy_target": "UPGO", "value_target": "UPGO", "minimum_episodes": 2,
            "update_episodes": 2, "epochs": 1, "num_batchers": 1, "eval_rate": 0.0,
            "worker": {"num_parallel": 2}}})
        learner = Learner(args, net=GeisterNet(filters=8, drc_layers=1, drc_repeats=1),
                          device="cpu")
        assert learner.run() == 0
    finally:
        torch.set_num_threads(threads)
    assert learner.trainer.steps > 0 and learner.trainer.sentinel_skipped_steps == 0
    assert np.isfinite(learner.trainer.last_loss["total"])
    assert ckpt.verify_snapshot("models", 1)
    saved = ckpt.load_params("models/1.ckpt")
    assert saved["drc.cell0.Conv_0.weight"].shape == (32, 16, 3, 3)
