"""The port's device twins (handyrl_tpu_torch/envs/vector_*.py) against the
JAX package's on the CPU, leaf for leaf.

Each twin is driven from random play, N lanes for M steps, through both
packages.  The JAX twin draws from its keys; the port's twin draws through
its module-level helpers (``_uniform``, ``_gumbel``, ``_bernoulli``), which
the tests replace with the JAX draws of the same key splits, so ``init``,
``step``, ``reset_done`` and ``rule_based_action_all`` must agree bit for
bit.  Tolerance: none.  Every state leaf, ``observation``, the legal masks,
``record``, ``outcome_scores``, ``rule_based_action_all``, ``view_obs`` and
the numpy ``episode_obs`` are compared exactly, dtypes included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from handyrl_tpu.envs.vector_geister import VectorGeister as JaxGeister
from handyrl_tpu.envs.vector_hungry_geese import VectorHungryGeese as JaxGeese
from handyrl_tpu.envs.vector_parallel_tictactoe import VectorParallelTicTacToe as JaxPTTT
from handyrl_tpu.envs.vector_tictactoe import VectorTicTacToe as JaxTTT
from handyrl_tpu_torch.envs import make_env
from handyrl_tpu_torch.envs import vector_hungry_geese as port_geese_mod
from handyrl_tpu_torch.envs import vector_parallel_tictactoe as port_pttt_mod
from handyrl_tpu_torch.envs.vector_common import gumbel, reset_where_done
from handyrl_tpu_torch.envs.vector_geister import VectorGeister
from handyrl_tpu_torch.envs.vector_hungry_geese import MAXLEN, VectorHungryGeese
from handyrl_tpu_torch.envs.vector_parallel_tictactoe import VectorParallelTicTacToe
from handyrl_tpu_torch.envs.vector_tictactoe import VectorTicTacToe

GEN = torch.Generator().manual_seed(0)  # never drawn from where draws are injected


class Draws:
    """Stands in for a twin's draw helper: hands out the JAX draws queued
    for it, in order, and checks each request's shape."""

    def __init__(self):
        self.queue = []

    def push(self, array):
        self.queue.append(np.asarray(array))

    def __call__(self, gen, shape, device, *args):
        want = self.queue.pop(0)
        assert tuple(shape) == want.shape, (tuple(shape), want.shape)
        return torch.from_numpy(want.copy()).to(device)


def assert_tree_equal(port, jax_tree, ctx=""):
    """Exact equality of every leaf, dtype included."""
    if isinstance(jax_tree, dict):
        assert sorted(port) == sorted(jax_tree), ctx
        for key in jax_tree:
            assert_tree_equal(port[key], jax_tree[key], f"{ctx}/{key}")
        return
    got = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    want = np.asarray(jax_tree)
    assert got.dtype == want.dtype, (ctx, got.dtype, want.dtype)
    assert got.shape == want.shape, (ctx, got.shape, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=ctx)


def _to_torch(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


# -- TicTacToe (episodic) ----------------------------------------------------


@pytest.mark.parametrize("seed", range(2))
def test_tictactoe_twin_matches_jax(seed):
    B = 24
    rng = np.random.default_rng(seed)
    jstate = JaxTTT.init(B)
    state = VectorTicTacToe.init(B)
    assert_tree_equal(state, jstate, "init")
    for t in range(VectorTicTacToe.max_steps + 1):
        assert_tree_equal(VectorTicTacToe.terminal(state, t), JaxTTT.terminal(jstate, t), f"terminal {t}")
        assert_tree_equal(VectorTicTacToe.observation(state, t), JaxTTT.observation(jstate, t),
                          f"obs {t}")
        legal = VectorTicTacToe.legal_mask(state)
        assert_tree_equal(legal, JaxTTT.legal_mask(jstate), f"legal {t}")
        # a legal cell where there is one; finished games get any cell
        scores = rng.random((B, 9)) + legal.numpy()
        actions = scores.argmax(axis=1).astype(np.int32)
        jstate = JaxTTT.apply(jstate, jnp.asarray(actions), t)
        state = VectorTicTacToe.apply(state, torch.from_numpy(actions).long(), t)
        assert_tree_equal(state, jstate, f"apply {t}")
    assert_tree_equal(VectorTicTacToe.outcome(state), JaxTTT.outcome(jstate), "outcome")
    assert (state["winner"] != 0).any()


# -- ParallelTicTacToe (streaming) ------------------------------------------


def test_parallel_tictactoe_twin_matches_jax(monkeypatch):
    B, M = 32, 24
    bern = Draws()
    monkeypatch.setattr(port_pttt_mod, "_bernoulli", bern)
    rng = np.random.default_rng(1)
    key = jax.random.PRNGKey(1)
    key, k0 = jax.random.split(key)
    jstate = JaxPTTT.init(B, k0)
    state = VectorParallelTicTacToe.init(B, GEN)
    assert_tree_equal(state, jstate, "init")
    cells_log, active_log = [], []
    for t in range(M):
        key, kr, kf = jax.random.split(key, 3)
        jstate = JaxPTTT.reset_done(jstate, kr)
        state = VectorParallelTicTacToe.reset_done(state, GEN)
        assert_tree_equal(state, jstate, f"reset {t}")
        assert_tree_equal(VectorParallelTicTacToe.observation(state), JaxPTTT.observation(jstate), f"obs {t}")
        legal = VectorParallelTicTacToe.legal_mask_all(state)
        assert_tree_equal(legal, JaxPTTT.legal_mask_all(jstate), f"legal {t}")
        rec = VectorParallelTicTacToe.record(state)
        assert_tree_equal(rec, JaxPTTT.record(jstate), f"record {t}")
        cells_log.append(rec["cells"].numpy().copy())
        active_log.append(state["active"].numpy().astype(np.float32))
        actions = (rng.random((B, 2, 9)) + legal.numpy()).argmax(axis=2).astype(np.int32)
        bern.push(jax.random.bernoulli(kf, 0.5, (B,)))
        jstate = JaxPTTT.step(jstate, jnp.asarray(actions), kf)
        state = VectorParallelTicTacToe.step(state, torch.from_numpy(actions), GEN)
        assert_tree_equal(state, jstate, f"step {t}")
        assert_tree_equal(VectorParallelTicTacToe.outcome_scores(state),
                          JaxPTTT.outcome_scores(jstate), f"outcome {t}")
    assert not bern.queue and state["done"].any()
    # the numpy rebuild of a lane's observations, and the device replay's view
    compact = {"cells": np.stack(cells_log)[:, 3]}
    active = np.stack(active_log)[:, 3]
    np.testing.assert_array_equal(VectorParallelTicTacToe.episode_obs(compact, active),
                                  JaxPTTT.episode_obs(compact, active))
    windows = {"cells": np.stack(cells_log).transpose(1, 0, 2)[:6]}      # (N, T, 9)
    player = np.arange(6, dtype=np.int32) % 2
    assert_tree_equal(
        VectorParallelTicTacToe.view_obs(_to_torch(windows), torch.from_numpy(player)),
        JaxPTTT.view_obs({"cells": jnp.asarray(windows["cells"])}, jnp.asarray(player)), "view_obs")


# -- HungryGeese ---------------------------------------------------------------


def _geese_drive(monkeypatch, B, M, seed, greedy_share):
    """Both twins through M steps of a policy mixing the rule-based twin's
    choice (so games live past the hunger step) with uniform moves (so
    geese reverse and collide); every leaf compared at every step."""
    uni, gum = Draws(), Draws()
    monkeypatch.setattr(port_geese_mod, "_uniform", uni)
    monkeypatch.setattr(port_geese_mod, "_gumbel", gum)
    jstep = jax.jit(JaxGeese.step)
    jrule = jax.jit(JaxGeese.rule_based_action_all)
    jreset = jax.jit(JaxGeese.reset_done)
    jobs = jax.jit(JaxGeese.observation)
    rng = np.random.default_rng(seed)
    key = jax.random.PRNGKey(seed)
    key, k0 = jax.random.split(key)
    uni.push(jax.random.uniform(k0, (B, port_geese_mod.NUM_CELLS)))
    jstate = JaxGeese.init(B, k0)
    state = VectorHungryGeese.init(B, GEN)
    assert_tree_equal(state, jstate, "init")
    log = {"records": [], "active": []}
    for t in range(M):
        key, kr, kg, kf = jax.random.split(key, 4)
        uni.push(jax.random.uniform(kr, (B, port_geese_mod.NUM_CELLS)))
        jstate = jreset(jstate, kr)
        state = VectorHungryGeese.reset_done(state, GEN)
        assert_tree_equal(state, jstate, f"reset {t}")
        if t % 5 == 0:
            assert_tree_equal(VectorHungryGeese.observation(state), jobs(jstate), f"obs {t}")
        assert_tree_equal(VectorHungryGeese.legal_mask_all(state),
                          JaxGeese.legal_mask_all(jstate), f"legal {t}")
        rec = VectorHungryGeese.record(state)
        assert_tree_equal(rec, JaxGeese.record(jstate), f"record {t}")
        log["records"].append({k: v.numpy().copy() for k, v in rec.items()})
        log["active"].append(state["active"].numpy().astype(np.float32))
        gum.push(jax.random.gumbel(kg, (B, 4, 4)))
        rule = VectorHungryGeese.rule_based_action_all(state, GEN)
        assert_tree_equal(rule, jrule(jstate, kg), f"rule {t}")
        actions = np.where(rng.random((B, 4)) < greedy_share, rule.numpy(),
                           rng.integers(0, 4, (B, 4))).astype(np.int32)
        k1, k2 = jax.random.split(kf)
        gum.push(jax.random.gumbel(k1, (B, port_geese_mod.NUM_CELLS)))
        gum.push(jax.random.gumbel(k2, (B, port_geese_mod.NUM_CELLS)))
        jstate = jstep(jstate, jnp.asarray(actions), kf)
        state = VectorHungryGeese.step(state, torch.from_numpy(actions), GEN)
        assert_tree_equal(state, jstate, f"step {t}")
        assert_tree_equal(VectorHungryGeese.outcome_scores(state), JaxGeese.outcome_scores(jstate),
                          f"outcome {t}")
    assert not uni.queue and not gum.queue
    return state, log


@pytest.mark.parametrize("seed,greedy_share", [(0, 0.3), (1, 0.97)])
def test_hungry_geese_twin_matches_jax(monkeypatch, seed, greedy_share):
    B, M = 24, 56 if greedy_share > 0.5 else 30
    state, log = _geese_drive(monkeypatch, B, M, seed, greedy_share)
    if greedy_share > 0.5:
        assert int(state["step"].max()) > 40  # the hunger step was crossed
    records = {k: np.stack([r[k] for r in log["records"]]) for k in log["records"][0]}
    active = np.stack(log["active"])
    lane = int(np.argmax(active.sum(axis=(0, 2))))
    compact = {k: v[:, lane] for k, v in records.items()}
    np.testing.assert_array_equal(VectorHungryGeese.episode_obs(compact, active[:, lane]),
                                  JaxGeese.episode_obs(compact, active[:, lane]))
    windows = {k: np.ascontiguousarray(np.swapaxes(v, 0, 1)[:8]) for k, v in records.items()}
    player = np.arange(8, dtype=np.int32) % 4
    assert_tree_equal(
        VectorHungryGeese.view_obs(_to_torch(windows), torch.from_numpy(player)),
        JaxGeese.view_obs({k: jnp.asarray(v) for k, v in windows.items()}, jnp.asarray(player)),
        "view_obs")


def _single_goose_state(B=2):
    """One lane's hand-made state: goose 0 of length 1 at the centre, the
    others dead, food placed by the caller."""
    state = VectorHungryGeese.init(B, torch.Generator().manual_seed(0))
    state["cells"][:] = 0
    state["cells"][:, 0, 0] = 3 * 11 + 5
    state["length"][:] = 0
    state["length"][:, 0] = 1
    state["occ"][:] = 0
    state["occ"][:, 0, 3 * 11 + 5] = 1
    state["active"][:] = False
    state["active"][:, 0] = True
    state["food"][:] = 0
    return state


def test_rule_based_ties_go_to_the_first_direction():
    """Planted ties: food at equal distance in two or four directions.  The
    twin, the JAX twin and the host agent pick the first direction."""
    centre = 3 * 11 + 5
    cases = {  # food cells -> the first tied direction (N, S, W, E = 0..3)
        (centre - 2 * 11, centre + 2 * 11): 0,          # north and south, 2 away
        (centre - 2, centre + 2): 2,                    # west and east
        (centre + 2 * 11, centre + 2): 1,               # south and east
        (centre - 11 - 1, centre + 11 + 1): 0,          # diagonal: N, W tie first
    }
    host = make_env({"env": "HungryGeese"})
    for food, first in cases.items():
        state = _single_goose_state()
        for cell in food:
            state["food"][:, cell] = 1
        got = VectorHungryGeese.rule_based_action_all(state, torch.Generator().manual_seed(0))
        jstate = {k: jnp.asarray(v.numpy()) for k, v in state.items()}
        want = JaxGeese.rule_based_action_all(jstate, jax.random.PRNGKey(0))
        host.geese = [[centre], [], [], []]
        host.food = list(food)
        host.last_actions = {}
        assert int(got[0, 0]) == int(want[0, 0]) == host.rule_based_action(0) == first, food


def test_gumbel_food_respawn_ties_go_to_the_first_cell(monkeypatch):
    """Planted ties in the respawn's Gumbel-max: every free cell draws the
    same value, so argmax takes the first free cell, in both packages."""
    state = _single_goose_state(B=1)
    state["food"][:, 0] = 1                        # one food left: one respawn
    jstate = {k: jnp.asarray(v.numpy()) for k, v in state.items()}
    flat = np.zeros((1, port_geese_mod.NUM_CELLS), np.float32)
    gum = Draws()
    gum.push(flat)
    gum.push(flat)
    monkeypatch.setattr(port_geese_mod, "_gumbel", gum)
    monkeypatch.setattr(jax.random, "gumbel", lambda key, shape: jnp.zeros(shape))
    actions = np.zeros((1, 4), np.int32)
    got = VectorHungryGeese.step(state, torch.from_numpy(actions), GEN)
    want = JaxGeese.step(jstate, jnp.asarray(actions), jax.random.PRNGKey(0))
    assert_tree_equal(got, want, "tied respawn")
    assert np.flatnonzero(got["food"][0].numpy()).tolist() == [0, 1]


def test_gathers_stay_in_range_for_empty_geese():
    """Dead geese (length 0) have cell -1 wherever a gather reads a cell:
    the twin clips before indexing, as the JAX twin relies on clamping, and
    the one-hot of -1 is a zero row."""
    state = _single_goose_state()
    assert VectorHungryGeese.head_cell(state)[0].tolist() == [38, -1, -1, -1]
    assert VectorHungryGeese.tail_cell(state)[0].tolist() == [38, -1, -1, -1]
    obs = VectorHungryGeese.observation(state)
    assert obs[0, 0, 1].sum() == 0 and obs[0, 0, 0].sum() == 1
    out = VectorHungryGeese.step(state, torch.full((2, 4), 3, dtype=torch.int32), GEN)
    assert out["length"][0].tolist() == [1, 0, 0, 0]


def test_body_list_and_reset_where_done():
    state = VectorHungryGeese.init(3, torch.Generator().manual_seed(2))
    head = int(state["cells"][1, 2, 0])
    assert VectorHungryGeese.body_list(state, 1, 2) == [head]
    assert MAXLEN == 77
    fresh = {k: torch.zeros_like(v) for k, v in state.items()}
    state["done"] = torch.tensor([True, False, True])
    out = reset_where_done(fresh, state)
    assert not out["length"][0].any() and out["length"][1].all() and not out["length"][2].any()


def test_gumbel_helper_clamps_at_zero(monkeypatch):
    monkeypatch.setattr(torch, "rand", lambda *a, **k: torch.zeros(4))
    g = gumbel(None, (4,), "cpu")
    assert torch.isfinite(g).all()
    # jax.random.gumbel draws its uniforms from [tiny, 1): u = tiny gives this
    np.testing.assert_allclose(g.numpy(), -np.log(-np.log(np.finfo(np.float32).tiny)))


# -- Geister -------------------------------------------------------------------


def test_geister_twin_matches_jax():
    B, M = 16, 205       # past the 200-ply draw: every lane ends at least once
    jstep = jax.jit(JaxGeister.step)
    jlegal = jax.jit(JaxGeister.legal_mask_all)
    jobs = jax.jit(JaxGeister.observation)
    key = jax.random.PRNGKey(5)
    jstate = JaxGeister.init(B, key)
    state = VectorGeister.init(B, GEN)
    assert_tree_equal(state, jstate, "init")
    rng = np.random.default_rng(5)
    log = {"records": [], "observing": []}
    ended, wins = 0, set()
    for t in range(M):
        jstate = JaxGeister.reset_done(jstate, key)
        state = VectorGeister.reset_done(state, GEN)
        assert_tree_equal(state, jstate, f"reset {t}")
        legal = VectorGeister.legal_mask_all(state)
        assert_tree_equal(legal, jlegal(jstate), f"legal {t}")
        if t % 3 == 0:
            assert_tree_equal(VectorGeister.observation(state), jobs(jstate), f"obs {t}")
        assert_tree_equal(VectorGeister.observe_mask(state), JaxGeister.observe_mask(jstate), f"omask {t}")
        rec = VectorGeister.record(state)
        assert_tree_equal(rec, JaxGeister.record(jstate), f"record {t}")
        log["records"].append({k: v.numpy().copy() for k, v in rec.items()})
        log["observing"].append(VectorGeister.observe_mask(state).numpy().astype(np.float32))
        actions = (rng.random((B, 2, 214)) + legal.numpy()).argmax(axis=2).astype(np.int32)
        jstate = jstep(jstate, jnp.asarray(actions), key)
        state = VectorGeister.step(state, torch.from_numpy(actions), GEN)
        assert_tree_equal(state, jstate, f"step {t}")
        assert_tree_equal(VectorGeister.outcome_scores(state), JaxGeister.outcome_scores(jstate),
                          f"outcome {t}")
        wins.update(state["win"][state["done"]].tolist())
        ended += int(state["done"].sum())
    assert ended >= B and {0, 1, 2} <= wins  # wins of both colours and draws
    records = {k: np.stack([r[k] for r in log["records"]]) for k in log["records"][0]}
    observing = np.stack(log["observing"])
    for lane in (0, 7):
        compact = {k: v[:, lane] for k, v in records.items()}
        assert_tree_equal(VectorGeister.episode_obs(compact, observing[:, lane]),
                          JaxGeister.episode_obs(compact, observing[:, lane]), f"episode_obs {lane}")


def test_geister_twin_plays_host_games_legally():
    """Lock step against the port's host env: the legal set of the turn
    player, both players' observations and the board after every ply."""
    B = 8
    hosts = [make_env({"env": "Geister"}) for _ in range(B)]
    state = VectorGeister.init(B)
    rng = np.random.RandomState(3)
    finished = 0
    for t in range(170):
        legal = VectorGeister.legal_mask_all(state).numpy()
        obs = VectorGeister.observation(state)
        done = state["done"].numpy().copy()
        ply = state["ply"].numpy()
        actions = np.zeros((B, 2), np.int64)
        for b, host in enumerate(hosts):
            if done[b]:
                continue
            c = int(ply[b]) % 2
            assert host.ply == ply[b] and host.turn() == c
            assert set(np.flatnonzero(legal[b, c]).tolist()) == set(host.legal_actions())
            for p in range(2):
                want = host.observation(p)
                np.testing.assert_array_equal(obs["scalar"][b, p].numpy(), want["scalar"])
                np.testing.assert_array_equal(obs["board"][b, p].numpy(), want["board"])
            actions[b, c] = rng.choice(np.flatnonzero(legal[b, c]))
        state = VectorGeister.step(state, torch.from_numpy(actions))
        for b, host in enumerate(hosts):
            if done[b]:
                continue
            host.play(int(actions[b, int(ply[b]) % 2]))
            assert (state["board"][b].numpy().reshape(6, 6) == host.board).all()
            win = int(state["win"][b])
            assert win == (-1 if host.win_color is None else host.win_color)
            finished += host.terminal()
    assert finished >= 1
