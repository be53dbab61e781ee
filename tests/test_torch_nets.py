"""The default config's env and net, the feed-forward train path and the
remat ladder of the port, against the JAX package on the CPU.

Weights are the JAX package's, carried over with ``convert.py``; games and
observations come from seeded numpy / ``random``.  Tolerances: the net
1e-5 (fp32, another summation order and GroupNorm variance formula); the
forward prediction and the loss 1e-4 (sums over a batch); remat rungs
against each other 1e-6 (the same ops, replayed); the port's 'block' rung
against the JAX package's 1e-4.
"""

import importlib
import random

import jax
import numpy as np
import pytest
import torch

from handyrl_tpu.envs import make_env as jax_make_env
from handyrl_tpu.models import RandomModel as JaxRandomModel
from handyrl_tpu.models import init_variables as jax_init_variables
from handyrl_tpu.ops import compute_loss_from_outputs as jax_loss
from handyrl_tpu.parallel.train_step import forward_prediction as jax_forward
from handyrl_tpu.runtime import EpisodeStore as JaxEpisodeStore
from handyrl_tpu.runtime import Generator as JaxGenerator
from handyrl_tpu.runtime import make_batch as jax_make_batch
from handyrl_tpu_torch.config import normalize_args
from handyrl_tpu_torch.envs import make_env
from handyrl_tpu_torch.models import SimpleConvNet, flax_to_state_dict, init_variables
from handyrl_tpu_torch.parallel import TrainContext, forward_prediction, live_steps

fa = importlib.import_module("handyrl_tpu_torch.ops.flash_attention")

TTT = {"env": "TicTacToe"}


def _args(env_args, **train):
    cfg = normalize_args({"env_args": env_args, "train_args": train})
    return dict(cfg["train_args"], env=cfg["env_args"])


@pytest.mark.parametrize("seed", range(4))
def test_tictactoe_matches_jax_env(seed):
    """Seeded random games in lock step: turns, legal actions, every
    player's observation, strings, replica deltas and outcomes."""
    rng = random.Random(seed)
    env, jenv = make_env(TTT), jax_make_env(TTT)
    for _ in range(10):
        env.reset(), jenv.reset()
        while not jenv.terminal():
            assert not env.terminal()
            assert env.turn() == jenv.turn() and env.turns() == jenv.turns()
            assert env.legal_actions() == jenv.legal_actions()
            for p in (0, 1, None):
                np.testing.assert_array_equal(env.observation(p), jenv.observation(p))
            a = rng.choice(jenv.legal_actions())
            assert env.action2str(a) == jenv.action2str(a)
            assert env.str2action(jenv.action2str(a)) == a
            env.play(a), jenv.play(a)
            assert env.diff_info() == jenv.diff_info()
        assert env.terminal() and env.outcome() == jenv.outcome()
        assert str(env) == str(jenv)


@pytest.fixture(scope="module")
def conv_nets():
    jenv = jax_make_env(TTT)
    jmodule = jenv.net()
    variables = jax_init_variables(jmodule, jenv, seed=5)
    module = make_env(TTT).net()
    module.load_state_dict(flax_to_state_dict(jax.tree.map(np.asarray, variables["params"])))
    return jmodule, variables, module


def test_simple_conv_net_matches_jax(conv_nets):
    jmodule, variables, module = conv_nets
    assert isinstance(module, SimpleConvNet)
    assert sum(x.size for x in jax.tree.leaves(variables["params"])) == sum(
        p.numel() for p in module.parameters())
    rng = np.random.default_rng(0)
    # board planes, and dense inputs that make GroupNorm's statistics matter
    obs = np.concatenate([(rng.random((6, 3, 3, 3)) < 0.4).astype(np.float32),
                          rng.normal(size=(6, 3, 3, 3)).astype(np.float32)])
    want = jmodule.apply(variables, obs, None)
    with torch.no_grad():
        got = module(torch.from_numpy(obs), None)
    assert sorted(got) == sorted(want) == ["policy", "value"]
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5, atol=1e-5,
                                   err_msg=k)


def test_init_variables_covers_conv_and_group_norm():
    module = init_variables(SimpleConvNet(), seed=1)
    block = module.ConvBlock_0
    assert block.Conv_0.bias is None and torch.equal(block.GroupNorm_0.weight, torch.ones(32))
    assert block.GroupNorm_0.eps == 1e-6 and block.GroupNorm_0.num_groups == 8
    assert module.DenseHead_0.Conv_0.bias.abs().sum() == 0
    w = module.Conv_0.weight  # fan-in 3 * 3 * 3
    assert abs(w.std().item() - (1 / 27) ** 0.5) < 0.05
    assert w.abs().max() <= 2 * (1 / 27) ** 0.5 / 0.87962566103423978 + 1e-6
    assert module.DenseHead_1.Dense_0.bias is None


@pytest.fixture(scope="module")
def ff_batch():
    """TicTacToe windows longer than a game (forward_steps 16 > 9 moves),
    so every window ends in padding and the live prefix is shorter than T."""
    jargs = _args(TTT, batch_size=8, forward_steps=16)
    jenv = jax_make_env(TTT)
    gen = JaxGenerator(jenv, jargs)
    model = JaxRandomModel({"policy": ((9,), np.float32), "value": ((1,), np.float32)})
    random.seed(7)
    store = JaxEpisodeStore(32)
    store.extend([gen.generate({0: model, 1: model}, {"player": [0, 1]}) for _ in range(12)])
    windows = [store.sample_window(16, 0, 4) for _ in range(8)]
    return jargs, jax_make_batch(windows, jargs)


def test_feed_forward_prediction_and_loss_match_jax(conv_nets, ff_batch):
    jmodule, variables, module = conv_nets
    args, batch = ff_batch
    assert live_steps(batch) < 16
    joutputs = jax_forward(jmodule, variables["params"], batch, args)
    jlosses, jdcnt = jax_loss(joutputs, batch, args)

    results = {}
    for compact in (True, False):
        ctx = TrainContext(module, dict(args, compact_padding=compact), device="cpu")
        device_batch = ctx.put_batch(batch)
        T_obs = device_batch["observation"].shape[1]
        assert (T_obs < 16) == compact
        outputs = forward_prediction(module, None, device_batch, ctx.args)
        losses, dcnt = ctx.loss(device_batch)
        results[compact] = outputs, losses
        for k in joutputs:
            np.testing.assert_allclose(outputs[k].detach().numpy(), np.asarray(joutputs[k]),
                                       rtol=1e-4, atol=1e-4, err_msg=k)
        for k in jlosses:
            np.testing.assert_allclose(losses[k].item(), float(jlosses[k]), rtol=1e-4, atol=1e-4,
                                       err_msg=k)
        assert dcnt.item() == float(jdcnt)
    (on, lon), (off, loff) = results[True], results[False]
    for k in on:
        assert torch.equal(on[k], off[k]), k
    for k in lon:
        assert torch.equal(lon[k], loff[k]), k


def test_feed_forward_model_trains_without_observation_flag(conv_nets, ff_batch):
    """The observation-flag rule is for memory models only: the conv net
    trains on turn-player batches."""
    _, _, module = conv_nets
    args, batch = ff_batch
    assert not args["observation"]
    ctx = TrainContext(_copy(module), args, device="cpu")
    metrics = ctx.train_step(batch, 1e-3)
    assert metrics["sentinel_bad"] == 0.0 and np.isfinite(metrics["total"])


def _copy(module):
    clone = SimpleConvNet()
    clone.load_state_dict(module.state_dict())
    return clone


SEQ_ENV = {"env": "Geister", "net": "transformer",
           "net_args": {"d_model": 32, "n_heads": 2, "n_layers": 2, "memory_len": 8}}


@pytest.fixture(scope="module")
def seq_setup():
    jargs = _args(SEQ_ENV, batch_size=2, forward_steps=24, observation=True,
                  seq_attention="flash")
    jenv = jax_make_env(SEQ_ENV)
    jmodule = jenv.net()
    variables = jax_init_variables(jmodule, jenv, seed=9)
    gen = JaxGenerator(jenv, jargs)
    model = JaxRandomModel({"policy": ((214,), np.float32), "value": ((1,), np.float32),
                            "return": ((1,), np.float32)})
    random.seed(11)
    store = JaxEpisodeStore(8)
    store.extend([gen.generate({0: model, 1: model}, {"player": [0, 1]}) for _ in range(2)])
    batch = jax_make_batch([store.sample_window(24, 0, 4) for _ in range(2)], jargs)
    sd = flax_to_state_dict(jax.tree.map(np.asarray, variables["params"]))
    return jargs, jmodule, variables, batch, sd


def _rung_loss_and_grads(setup, remat):
    args, _, _, batch, sd = setup
    module = make_env(SEQ_ENV).net()
    module.load_state_dict(sd)
    ctx = TrainContext(module, dict(args, remat=remat), device="cpu")
    losses, _ = ctx.loss(ctx.put_batch(batch))
    losses["total"].backward()
    return losses, {n: p.grad for n, p in module.named_parameters()}


def test_remat_rungs_give_the_same_outputs_and_gradients(seq_setup, monkeypatch):
    calls = []
    forward = fa._forward
    monkeypatch.setattr(fa, "_forward", lambda *a: calls.append(1) or forward(*a))
    results = {}
    for remat in ("none", "attn", "block"):
        calls.clear()
        results[remat] = _rung_loss_and_grads(seq_setup, remat)
        # the checkpointed rungs replay the attention forward once per layer
        assert len(calls) == 2 * (1 if remat == "none" else 2), remat
    base_losses, base_grads = results["none"]
    for remat in ("attn", "block"):
        losses, grads = results[remat]
        for k in base_losses:
            np.testing.assert_allclose(losses[k].item(), base_losses[k].item(), rtol=1e-6, atol=1e-6)
        for n, g in base_grads.items():
            np.testing.assert_allclose(grads[n].numpy(), g.numpy(), rtol=1e-6, atol=1e-6,
                                       err_msg=f"{remat} {n}")


def test_block_rung_matches_jax_block(seq_setup):
    args, jmodule, variables, batch, _ = seq_setup
    jargs = dict(args, remat="block")

    def jtotal(params):
        losses, _ = jax_loss(jax_forward(jmodule, params, batch, jargs), batch, jargs)
        return losses["total"], losses

    (_, jlosses), jgrads = jax.value_and_grad(jtotal, has_aux=True)(variables["params"])
    jgrads = flax_to_state_dict(jax.tree.map(np.asarray, jgrads))
    losses, grads = _rung_loss_and_grads(seq_setup, "block")
    for k in ("p", "v", "r", "ent", "total"):
        np.testing.assert_allclose(losses[k].item(), float(jlosses[k]), rtol=1e-4, err_msg=k)
    for n, g in grads.items():
        np.testing.assert_allclose(g.numpy(), jgrads[n].numpy(), rtol=1e-4, atol=1e-6, err_msg=n)


@pytest.mark.parametrize("value,rung", [("auto", "none"), (True, "block"), (False, "none"),
                                        ("attn", "attn"), ("block", "block"), ("none", "none")])
def test_resolve_seq_remat(value, rung):
    from handyrl_tpu_torch.parallel import resolve_seq_remat

    assert resolve_seq_remat({"remat": value}) == rung
