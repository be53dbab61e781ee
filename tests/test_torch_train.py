"""The slice end to end on the CPU: one Geister train step of the port
against the JAX package's, from identical params and an identical batch,
with ``seq_attention: flash`` (the JAX Pallas kernel in interpret mode,
the port's kernel function on its plain version).

Tolerances: losses rtol 1e-4 (fp32 sums over the batch); gradients rtol
1e-3 / atol 1e-6 (backprop through 2 layers and the chunked attention
backward); params after the Adam step within 1e-2 * lr of the JAX step,
except where |grad| < 1e-6: Adam's first step g / (|g| + eps) is sign-like
there and rounding may flip it, so only |delta| <= lr holds.
"""

import random

import jax
import numpy as np
import pytest
import torch

from handyrl_tpu.config import normalize_args as jax_normalize_args
from handyrl_tpu.envs import make_env as jax_make_env
from handyrl_tpu.models import RandomModel as JaxRandomModel
from handyrl_tpu.models import init_variables as jax_init_variables
from handyrl_tpu.ops import compute_loss_from_outputs as jax_loss
from handyrl_tpu.parallel import TrainContext as JaxTrainContext
from handyrl_tpu.parallel import make_mesh
from handyrl_tpu.parallel.train_step import forward_prediction as jax_forward
from handyrl_tpu.parallel.train_step import trim_burn_in as jax_trim
from handyrl_tpu.runtime import EpisodeStore as JaxEpisodeStore
from handyrl_tpu.runtime import Generator as JaxGenerator
from handyrl_tpu.runtime import make_batch as jax_make_batch
from handyrl_tpu.runtime.trainer import Trainer as JaxTrainer
from handyrl_tpu_torch.config import normalize_args
from handyrl_tpu_torch.envs import make_env
from handyrl_tpu_torch.models import flax_to_state_dict
from handyrl_tpu_torch.parallel import TrainContext
from handyrl_tpu_torch.runtime import Trainer

RAW = {
    "env_args": {"env": "Geister", "net": "transformer",
                 "net_args": {"d_model": 32, "n_heads": 2, "n_layers": 2, "memory_len": 8}},
    "train_args": {"batch_size": 4, "forward_steps": 48, "burn_in_steps": 0, "compress_steps": 4,
                   "observation": True, "seq_attention": "flash", "batch_pipeline": "thread",
                   "mesh": {"dp": 1}},
}


def _args(normalize):
    cfg = normalize(RAW)
    return dict(cfg["train_args"], env=cfg["env_args"])


@pytest.fixture(scope="module")
def setup():
    jargs, args = _args(jax_normalize_args), _args(normalize_args)
    jenv = jax_make_env(jargs["env"])
    jmodule = jenv.net()
    variables = jax_init_variables(jmodule, jenv, seed=1)
    gen = JaxGenerator(jenv, jargs)
    model = JaxRandomModel({"policy": ((214,), np.float32), "value": ((1,), np.float32),
                            "return": ((1,), np.float32)})
    random.seed(2)
    store = JaxEpisodeStore(16)
    store.extend([gen.generate({0: model, 1: model}, {"player": [0, 1]}) for _ in range(3)])
    windows = [store.sample_window(48, 0, 4) for _ in range(4)]
    batch = jax_make_batch(windows, jargs)
    params_np = jax.tree.map(np.asarray, variables["params"])
    return jargs, args, jmodule, variables, batch, params_np


def _port_module(params_np, args):
    module = make_env(args["env"]).net()
    module.load_state_dict(flax_to_state_dict(params_np))
    return module


def test_one_train_step_matches_jax(setup):
    jargs, args, jmodule, variables, batch, params_np = setup

    def jtotal(params):
        outputs = jax_forward(jmodule, params, batch, jargs)
        losses, _ = jax_loss(outputs, jax_trim(batch, 0), jargs)
        return losses["total"], losses

    (_, jlosses), jgrads = jax.value_and_grad(jtotal, has_aux=True)(variables["params"])
    jgrads = flax_to_state_dict(jax.tree.map(np.asarray, jgrads))

    module = _port_module(params_np, args)
    ctx = TrainContext(module, args, device="cpu")
    losses, _ = ctx.loss(ctx.put_batch(batch))
    for k in ("p", "v", "r", "ent", "total"):
        np.testing.assert_allclose(losses[k].item(), float(jlosses[k]), rtol=1e-4, err_msg=k)
    losses["total"].backward()
    grads = {n: p.grad.clone() for n, p in module.named_parameters()}
    assert sorted(grads) == sorted(jgrads)
    for n, g in grads.items():
        np.testing.assert_allclose(g.numpy(), jgrads[n].numpy(), rtol=1e-3, atol=1e-6, err_msg=n)

    lr = 1e-3
    jctx = JaxTrainContext(jmodule, jargs, make_mesh({"dp": 1}))
    jstate, jmetrics = jctx.train_step(jctx.init_state(variables["params"]), jctx.put_batch(batch), lr)
    jnew = flax_to_state_dict(jax.tree.map(np.asarray, jax.device_get(jstate["params"])))
    before = {n: p.detach().clone() for n, p in module.named_parameters()}
    metrics = ctx.train_step(batch, lr)
    assert metrics["sentinel_bad"] == 0.0 and float(jmetrics["sentinel_bad"]) == 0.0
    np.testing.assert_allclose(metrics["total"], float(jmetrics["total"]), rtol=1e-4)
    assert metrics["dcnt"] == float(jmetrics["dcnt"])
    for n, p in module.named_parameters():
        delta = (p.detach() - before[n]).numpy()
        jdelta = jnew[n].numpy() - before[n].numpy()
        small = np.abs(grads[n].numpy()) < 1e-6
        assert np.all(np.abs(delta[~small] - jdelta[~small]) <= 1e-2 * lr), n
        assert np.all(np.abs(delta[small]) <= lr * (1 + 1e-3)), n


def test_sentinel_skips_a_non_finite_step(setup):
    _, args, _, _, batch, params_np = setup
    module = _port_module(params_np, args)
    ctx = TrainContext(module, args, device="cpu")
    before = [p.detach().clone() for p in module.parameters()]
    metrics = ctx.train_step(batch, float("nan"))
    assert metrics["sentinel_bad"] == 1.0 and metrics["total"] == 0.0
    assert all(torch.equal(a, b) for a, b in zip(before, module.parameters()))
    assert not ctx.optimizer.state  # the Adam moments were never created
    metrics = ctx.train_step(batch, 1e-3)
    assert metrics["sentinel_bad"] == 0.0
    assert any(not torch.equal(a, b) for a, b in zip(before, module.parameters()))


def test_trainer_lr_schedule_matches_jax(setup):
    jargs, args, jmodule, variables, batch, params_np = setup
    jtrainer = JaxTrainer(jargs, jmodule, variables["params"], make_mesh({"dp": 1}))
    trainer = Trainer(args, _port_module(params_np, args), device="cpu")
    assert trainer.lr == jtrainer.lr
    for t in (trainer, jtrainer):
        t.steps, t.data_cnt_ema = 1234, 98.5
    assert trainer.lr == jtrainer.lr


def test_trainer_takes_steps_from_its_store(setup):
    jargs, args, _, _, _, params_np = setup
    trainer = Trainer(args, _port_module(params_np, args), device="cpu")
    with pytest.raises(RuntimeError):
        trainer.sample_batch()
    gen_env = make_env(args["env"])
    from handyrl_tpu_torch.models import RandomModel
    from handyrl_tpu_torch.runtime import Generator

    model = RandomModel({"policy": ((214,), np.float32), "value": ((1,), np.float32)})
    random.seed(4)
    trainer.store.extend([Generator(gen_env, args).generate({0: model, 1: model}, {"player": [0, 1]})
                          for _ in range(2)])
    ema0 = trainer.data_cnt_ema
    history = trainer.train_epoch(2)
    assert len(history) == 2 and trainer.steps == 2
    assert all(np.isfinite(m["total"]) for m in history)
    dcnt = sum(m["dcnt"] for m in history)
    assert trainer.data_cnt_ema == pytest.approx(ema0 * 0.8 + dcnt / (1e-2 + 2) * 0.2)


def test_config_subset_keeps_the_jax_defaults_and_refuses_what_is_not_ported():
    from handyrl_tpu.config import DEFAULT_TRAIN_ARGS as JAX_DEFAULTS
    from handyrl_tpu_torch.config import DEFAULT_TRAIN_ARGS

    for key, value in DEFAULT_TRAIN_ARGS.items():
        if isinstance(value, dict):  # a subset of the JAX package's section
            assert {k: JAX_DEFAULTS[key][k] for k in value} == value, key
        else:
            assert JAX_DEFAULTS[key] == value, key
    env = {"env": "Geister"}
    assert normalize_args({"env_args": env, "train_args": {"attn_mode": "einsum"}})[
        "train_args"]["seq_attention"] == "einsum"
    for rung in ("attn", "block", True, False):
        assert normalize_args({"env_args": env, "train_args": {"remat": rung}})[
            "train_args"]["remat"] == rung
    for bad in ({"seq_attention": "ring"}, {"remat": "full"}, {"remat": 1}, {"blk_q": 12},
                {"compute_dtype": "float16"}, {"value_target": "XX"}, {"batch_size": 0},
                {"restart_epoch": -2}, {"eval_rate": 1.5}, {"update_episodes": 0}):
        with pytest.raises(ValueError):
            normalize_args({"env_args": env, "train_args": bad})
    # the JAX package's default pipeline and the batcher knobs, with its defaults
    assert DEFAULT_TRAIN_ARGS["batch_pipeline"] == JAX_DEFAULTS["batch_pipeline"] == "shm"
    for key in ("shm_slots", "batcher_max_restarts", "batcher_stall_timeout", "fused_steps"):
        assert DEFAULT_TRAIN_ARGS[key] == JAX_DEFAULTS[key], key
    for mode in ("shm", "thread", "device"):
        assert normalize_args({"env_args": env, "train_args": {"batch_pipeline": mode}})[
            "train_args"]["batch_pipeline"] == mode
    with pytest.raises(ValueError, match="redundant under device_replay"):
        normalize_args({"env_args": env, "train_args": {
            "batch_pipeline": "device", "device_replay": True, "device_rollout_games": 8}})
    with pytest.raises(ValueError, match="not one of"):
        normalize_args({"env_args": env, "train_args": {"batch_pipeline": "bogus"}})
    with pytest.raises(ValueError):
        normalize_args({"train_args": {}})
