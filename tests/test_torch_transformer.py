"""The port's TransformerNet against the JAX package's, on the CPU.

The JAX net is initialised by the JAX package; ``convert.py`` carries its
params into the port.  Observations and key masks are made with numpy from
a seed.  Tolerance 1e-5 (fp32; the same arithmetic, in another summation
order and LayerNorm variance formula).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from handyrl_tpu.envs import make_env as jax_make_env
from handyrl_tpu.models import init_variables as jax_init_variables
from handyrl_tpu_torch.envs import make_env
from handyrl_tpu_torch.models import (
    InferenceModel,
    RandomModel,
    TransformerNet,
    flax_to_state_dict,
    init_variables,
)

ENV_ARGS = {
    "env": "Geister", "net": "transformer",
    "net_args": {"d_model": 32, "n_heads": 2, "n_layers": 2, "memory_len": 8},
}
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def nets():
    jenv = jax_make_env(ENV_ARGS)
    jmodule = jenv.net()
    variables = jax_init_variables(jmodule, jenv, seed=3)
    module = make_env(ENV_ARGS).net()
    module.load_state_dict(flax_to_state_dict(jax.tree.map(np.asarray, variables["params"])))
    return jmodule, variables, module


def _obs(rng, lead):
    return {
        "board": (rng.random(lead + (7, 6, 6)) < 0.3).astype(np.float32),
        "scalar": (rng.random(lead + (18,)) < 0.5).astype(np.float32),
    }


def test_state_dict_names_and_sizes(nets):
    _, variables, module = nets
    assert isinstance(module, TransformerNet)
    assert module.enc1.in_features == 270  # board 7*6*6 before scalar 18
    n_jax = sum(x.size for x in jax.tree.leaves(variables["params"]))
    assert n_jax == sum(p.numel() for p in module.parameters())


def test_step_mode_matches_jax_over_ring_wraparound(nets):
    """12 decode steps over a memory of 8: the ring wraps, and outputs,
    caches and the step counter stay equal."""
    jmodule, variables, module = nets
    rng = np.random.default_rng(0)
    B = 3
    jhidden = jmodule.initial_state((B,))
    hidden = module.initial_state((B,))
    apply = jax.jit(jmodule.apply)
    for _ in range(12):
        obs = _obs(rng, (B,))
        jout = apply(variables, obs, jhidden)
        with torch.no_grad():
            out = module({k: torch.from_numpy(v) for k, v in obs.items()}, hidden)
        for key in ("policy", "value", "return"):
            np.testing.assert_allclose(out[key].numpy(), np.asarray(jout[key]), **TOL)
        jhidden, hidden = jout["hidden"], out["hidden"]
        for jl, tl in zip(jhidden["layers"], hidden["layers"]):
            for kv in ("k", "v"):
                np.testing.assert_allclose(tl[kv].numpy(), np.asarray(jl[kv]), **TOL)
        np.testing.assert_array_equal(hidden["pos"].numpy(), np.asarray(jhidden["pos"]))


@pytest.mark.parametrize("use_flash", [False, True])
def test_seq_mode_matches_jax(nets, use_flash):
    jmodule, variables, module = nets
    rng = np.random.default_rng(1)
    rows, T = 4, 40
    obs = _obs(rng, (rows, T))
    key_mask = (rng.random((rows, T)) < 0.6).astype(np.float32)
    key_mask[1, 25:] = 0.0  # an episode that ended inside the window
    jout = jmodule.apply(variables, obs, None, seq=True, key_mask=jnp.asarray(key_mask), use_flash=use_flash)
    with torch.no_grad():
        out = module({k: torch.from_numpy(v) for k, v in obs.items()}, None, seq=True,
                     key_mask=torch.from_numpy(key_mask), use_flash=use_flash)
    assert "hidden" not in out
    for key in ("policy", "value", "return"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(jout[key]), **TOL)


def test_seq_mode_equals_step_mode(nets):
    """The window semantics reproduce the KV ring: a fully observed window
    in seq mode gives the step-by-step outputs."""
    _, _, module = nets
    rng = np.random.default_rng(2)
    rows, T = 2, 20
    obs = {k: torch.from_numpy(v) for k, v in _obs(rng, (rows, T)).items()}
    with torch.no_grad():
        seq = module(obs, None, seq=True)
        hidden = module.initial_state((rows,))
        for t in range(T):
            step = module({k: v[:, t] for k, v in obs.items()}, hidden)
            hidden = step["hidden"]
            torch.testing.assert_close(step["policy"], seq["policy"][:, t], rtol=1e-5, atol=1e-5)


def test_inference_model_keeps_hidden_on_device():
    module = init_variables(make_env(ENV_ARGS).net(), seed=0)
    model = InferenceModel(module, device="cpu")
    env = make_env(ENV_ARGS)
    obs = env.observation(0)
    hidden = model.init_hidden()
    out = model.inference(obs, hidden)
    assert isinstance(out["policy"], np.ndarray) and out["policy"].shape == (214,)
    assert out["value"].shape == (1,) and -1.0 <= float(out["value"][0]) <= 1.0
    assert isinstance(out["hidden"]["pos"], torch.Tensor) and float(out["hidden"]["pos"]) == 1.0
    assert out["hidden"]["layers"][0]["k"].shape == (8, 2, 16)
    random_out = RandomModel.from_model(model, obs).inference(obs)
    assert sorted(random_out) == ["policy", "return", "value"]
    assert random_out["policy"].shape == (214,) and not random_out["policy"].any()


def test_init_variables_is_seeded_and_flax_scaled():
    a = init_variables(make_env(ENV_ARGS).net(), seed=5)
    b = init_variables(make_env(ENV_ARGS).net(), seed=5)
    for pa, pb in zip(a.parameters(), b.parameters()):
        assert torch.equal(pa, pb)
    w = a.mlp_up0.weight
    std = (1.0 / w.shape[1]) ** 0.5
    assert abs(w.std().item() / std - 1.0) < 0.1       # lecun normal after the truncation fix
    assert w.abs().max().item() <= 2 * std / 0.87962566103423978 + 1e-6
    assert torch.count_nonzero(a.mlp_up0.bias) == 0
