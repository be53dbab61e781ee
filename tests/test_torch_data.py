"""The port's data path against the JAX package's, on the CPU: episodes from
the same seed, the codec's bytes, sampled windows and ``make_batch``.
All compared exactly: the arithmetic is numpy on both sides."""

import random

import numpy as np
import pytest

from handyrl_tpu.envs import make_env as jax_make_env
from handyrl_tpu.models import RandomModel as JaxRandomModel
from handyrl_tpu.runtime import EpisodeStore as JaxEpisodeStore
from handyrl_tpu.runtime import Generator as JaxGenerator
from handyrl_tpu.runtime import make_batch as jax_make_batch
from handyrl_tpu.runtime.codec import py_dumps as jax_py_dumps
from handyrl_tpu.runtime.replay import compress_block as jax_compress_block
from handyrl_tpu_torch.envs import make_env
from handyrl_tpu_torch.models import RandomModel
from handyrl_tpu_torch.runtime import EpisodeStore, Generator, compress_block, make_batch
from handyrl_tpu_torch.runtime.codec import CodecError, py_dumps, py_loads
from handyrl_tpu_torch.utils import tree_leaves

SPEC = {"policy": ((214,), np.float32), "value": ((1,), np.float32), "return": ((1,), np.float32)}
GEN_ARGS = {"observation": True, "gamma": 0.8, "compress_steps": 4}


def _episodes(pkg, seed, n=3):
    env_mod, gen_cls, model_cls = pkg
    env = env_mod({"env": "Geister"})
    gen = gen_cls(env, GEN_ARGS)
    model = model_cls(SPEC)
    random.seed(seed)
    return [gen.generate({0: model, 1: model}, {"player": [0, 1]}) for _ in range(n)]


JAX = (jax_make_env, JaxGenerator, JaxRandomModel)
PORT = (make_env, Generator, RandomModel)


@pytest.fixture(scope="module")
def episodes():
    return _episodes(JAX, 11), _episodes(PORT, 11)


def test_generated_episodes_are_byte_equal(episodes):
    for je, pe in zip(*episodes):
        assert pe["steps"] == je["steps"] and pe["outcome"] == je["outcome"]
        assert pe["players"] == je["players"]
        assert pe["blocks"] == je["blocks"]


def test_codec_bytes_equal_and_round_trip():
    rng = np.random.default_rng(0)
    obj = {
        "a": rng.standard_normal((3, 4)).astype(np.float32),
        "b": [1, -2, 3.5, None, True, False, "geister", b"\x00\x01"],
        "c": (np.int32(7), np.arange(6, dtype=np.int64).reshape(2, 3), np.float32(0.25)),
        3: {"nested": np.zeros((0, 2), np.uint8)},
    }
    raw = py_dumps(obj)
    assert raw == jax_py_dumps(obj)
    back = py_loads(raw)
    np.testing.assert_array_equal(back["a"], obj["a"])
    assert back["b"] == obj["b"] and back[3]["nested"].shape == (0, 2)
    cols = {"obs": {"board": rng.random((4, 2, 7, 6, 6)).astype(np.float32)},
            "prob": np.ones((4, 2), np.float32)}
    assert compress_block(cols) == jax_compress_block(cols)
    with pytest.raises(CodecError):
        py_loads(raw + b"N")
    with pytest.raises(CodecError):
        py_dumps({"x": object()})


@pytest.mark.parametrize(
    "observation,burn_in,forward_steps,turn_based",
    [(True, 0, 16, True), (False, 2, 8, True), (True, 4, 64, True), (True, 0, 8, False)],
)
def test_make_batch_equals_jax(episodes, observation, burn_in, forward_steps, turn_based):
    args = {"observation": observation, "burn_in_steps": burn_in, "forward_steps": forward_steps,
            "turn_based_training": turn_based, "compress_steps": 4}
    batches = []
    for store_cls, batch_fn, eps in ((JaxEpisodeStore, jax_make_batch, episodes[0]),
                                     (EpisodeStore, make_batch, episodes[1])):
        store = store_cls(16)
        store.extend(eps)
        random.seed(5)
        windows = [store.sample_window(forward_steps, burn_in, 4) for _ in range(6)]
        batches.append(batch_fn(windows, args))
    want, got = batches
    assert sorted(got) == sorted(want)
    for key in want:
        if key == "observation":
            assert sorted(got[key]) == sorted(want[key])
            for g, w in zip(tree_leaves(got[key]), tree_leaves(want[key])):
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)
        else:
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
