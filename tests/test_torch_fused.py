"""``fused_steps`` in the port, on the CPU: ``put_batches`` and
``train_steps`` against k single steps and against the JAX package's
``train_steps`` on a {dp: 1} mesh, and the Trainer taking k updates per
pull of the shared-memory pipeline.

Tolerances: k fused steps equal k single steps bit for bit when the
batches are put alike (the same code runs); with the feed-forward group
cut to its longest live prefix, within 1e-6 (the convolutions see more
padding rows, which may change their summation blocking).  Against JAX:
summed losses rtol 1e-4 (fp32 sums over the batch), the data count
exactly, and params after k Adam steps within k * 1e-2 * lr of the JAX
step where the first gradient is >= 1e-6 and within k * lr elsewhere
(Adam's g / (|g| + eps) is sign-like there, and rounding may flip it).
"""

import random

import jax
import numpy as np
import pytest
import torch

from handyrl_tpu.envs import make_env as jax_make_env
from handyrl_tpu.models import RandomModel as JaxRandomModel
from handyrl_tpu.models import init_variables as jax_init_variables
from handyrl_tpu.parallel import TrainContext as JaxTrainContext
from handyrl_tpu.parallel import make_mesh
from handyrl_tpu.runtime import EpisodeStore as JaxEpisodeStore
from handyrl_tpu.runtime import Generator as JaxGenerator
from handyrl_tpu.runtime import make_batch as jax_make_batch
from handyrl_tpu_torch.config import normalize_args
from handyrl_tpu_torch.envs import make_env
from handyrl_tpu_torch.models import flax_to_state_dict
from handyrl_tpu_torch.parallel import TrainContext, live_steps
from handyrl_tpu_torch.runtime import Trainer

TTT = {"env": "TicTacToe"}
K = 3
LR = 1e-3


def _args(**train):
    cfg = normalize_args({"env_args": TTT, "train_args": dict(train, mesh={"dp": 1})})
    return dict(cfg["train_args"], env=cfg["env_args"])


@pytest.fixture(scope="module")
def setup():
    """Params from the JAX initialiser, and K TicTacToe batches whose
    windows outrun their games (forward_steps 16), with unequal live
    prefixes."""
    args = _args(batch_size=8, forward_steps=16)
    jenv = jax_make_env(TTT)
    jmodule = jenv.net()
    variables = jax_init_variables(jmodule, jenv, seed=3)
    gen = JaxGenerator(jenv, args)
    model = JaxRandomModel({"policy": ((9,), np.float32), "value": ((1,), np.float32)})
    random.seed(11)
    store = JaxEpisodeStore(64)
    store.extend([gen.generate({0: model, 1: model}, {"player": [0, 1]}) for _ in range(24)])
    batches = [jax_make_batch([store.sample_window(16, 0, 4) for _ in range(8)], args)
               for _ in range(K)]
    assert len({live_steps(b) for b in batches}) > 1 or live_steps(batches[0]) < 16
    params_np = jax.tree.map(np.asarray, variables["params"])
    return args, jmodule, variables, batches, params_np


def _module(params_np):
    module = make_env(TTT).net()
    module.load_state_dict(flax_to_state_dict(params_np))
    return module


@pytest.mark.parametrize("compact", [False, True])
def test_train_steps_equal_k_train_steps(setup, compact):
    args, _, _, batches, params_np = setup
    args = dict(args, compact_padding=compact)
    fused = TrainContext(_module(params_np), args, device="cpu")
    single = TrainContext(_module(params_np), args, device="cpu")
    stacked = fused.put_batches(batches)
    assert stacked["action"].shape[:2] == (K, 8)
    if compact:  # the group is cut to its longest live prefix
        assert stacked["observation"].shape[2] == max(live_steps(b) for b in batches)
    got = fused.train_steps(stacked, LR)
    want = {}
    for b in batches:
        for key, value in single.train_step(b, LR).items():
            want[key] = want.get(key, 0.0) + value
    assert sorted(got) == sorted(want) and got["sentinel_bad"] == 0.0
    assert got["dcnt"] == want["dcnt"]
    tol = 1e-6 if compact else 0.0
    for key in want:
        assert abs(got[key] - want[key]) <= tol * max(1.0, abs(want[key])), key
    for (n, p), q in zip(fused.module.named_parameters(), single.module.parameters()):
        assert torch.allclose(p, q, rtol=0, atol=tol) if tol else torch.equal(p, q), n
    assert fused.optimizer.state_dict()["state"][0]["step"] == K


def test_train_steps_match_jax(setup):
    args, jmodule, variables, batches, params_np = setup
    jctx = JaxTrainContext(jmodule, args, make_mesh({"dp": 1}))
    jstate, jmetrics = jctx.train_steps(jctx.init_state(variables["params"]),
                                        jctx.put_batches(batches), LR)
    jnew = flax_to_state_dict(jax.tree.map(np.asarray, jax.device_get(jstate["params"])))
    assert int(jstate["steps"]) == K

    ctx = TrainContext(_module(params_np), args, device="cpu")
    before = {n: p.detach().clone() for n, p in ctx.module.named_parameters()}
    losses, _ = ctx.loss(ctx.put_batch(batches[0]))
    losses["total"].backward()
    small = {n: p.grad.abs() < 1e-6 for n, p in ctx.module.named_parameters()}
    ctx.optimizer.zero_grad(set_to_none=True)
    metrics = ctx.train_steps(ctx.put_batches(batches), LR)
    assert metrics["sentinel_bad"] == 0.0 == float(jmetrics["sentinel_bad"])
    assert metrics["dcnt"] == float(jmetrics["dcnt"])
    for key in ("p", "v", "ent", "total"):
        np.testing.assert_allclose(metrics[key], float(jmetrics[key]), rtol=1e-4, err_msg=key)
    for n, p in ctx.module.named_parameters():
        delta = (p.detach() - before[n]).numpy()
        jdelta = jnew[n].numpy() - before[n].numpy()
        s = small[n].numpy()
        assert np.all(np.abs(delta[~s] - jdelta[~s]) <= K * 1e-2 * LR), n
        assert np.all(np.abs(delta[s] - jdelta[s]) <= K * LR * (1 + 1e-3)), n


def test_trainer_takes_k_updates_per_pull_of_the_shm_pipeline(setup):
    """``fused_steps: 4``: one pull of the shm pipeline brings a stacked
    group of 4, the trainer counts 4 steps and moves the data-count EMA
    by 4 applied updates, as the JAX trainer does."""
    from handyrl_tpu_torch.models import RandomModel
    from handyrl_tpu_torch.runtime import Generator
    from handyrl_tpu_torch.runtime.shm_batch import ShmBatchPipeline

    _, _, _, _, params_np = setup
    args = _args(batch_size=8, forward_steps=8, fused_steps=4, num_batchers=1)
    trainer = Trainer(args, _module(params_np), device="cpu")
    assert isinstance(trainer.batcher, ShmBatchPipeline) and trainer.fused == 4
    env = make_env(TTT)
    model = RandomModel({"policy": ((9,), np.float32), "value": ((1,), np.float32)})
    random.seed(5)
    trainer.store.extend([Generator(env, args).generate({0: model, 1: model}, {"player": [0, 1]})
                          for _ in range(12)])
    ema0 = trainer.data_cnt_ema
    trainer.batcher.start()
    try:
        trainer.update_flag = True  # end the epoch after its first pull
        history = trainer.train_epoch()
    finally:
        trainer.stop()
    assert len(history) == 1 and trainer.steps == 4
    assert history[0]["sentinel_bad"] == 0.0 and np.isfinite(history[0]["total"])
    assert trainer.stats["pipe_batcher_deaths"] == trainer.stats["pipe_batcher_fallback"] == 0
    assert trainer.batcher.stats()["batches"] >= 4
    assert trainer.data_cnt_ema == pytest.approx(
        ema0 * 0.8 + history[0]["dcnt"] / (1e-2 + 4) * 0.2)
