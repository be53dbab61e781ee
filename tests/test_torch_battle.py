"""The port's network battle mode (handyrl_tpu_torch/runtime/battle.py) and
its payoff ledger (league/matchmaker.py ``PayoffMatrix``), on the CPU.

* tests/test_battle_books.py's eight cases, on the port: scripted peers
  speak the client protocol over replica envs, sever on cue, and the
  ledger books draws, placements and forfeits as the JAX package's does.
* A network match over loopback sockets, clients holding replica envs,
  gives the outcome ``exec_match`` gives on one env with the same seeded
  agents, in every env with a replica protocol.
* Across packages: a JAX ``NetworkAgentClient`` plays a game to its end
  against the port's server, beside a port client.
* ``--eval-server`` and two ``--eval-client`` through ``main``: every game
  played, no forfeit.

Outcomes are compared exactly.  Sockets bind port 0 (the CLI case takes a
port that was free) and every join has a deadline.
"""

import random
import socket
import threading
import time

import numpy as np
import pytest
import yaml

from handyrl_tpu.agents import RandomAgent as JaxRandomAgent
from handyrl_tpu.envs import make_env as jax_make_env
from handyrl_tpu.league.matchmaker import PayoffMatrix as JaxPayoffMatrix
from handyrl_tpu.runtime.battle import NetworkAgentClient as JaxNetworkAgentClient
from handyrl_tpu.runtime.connection import FramedConnection as JaxFramedConnection
from handyrl_tpu_torch.agents import Agent, RandomAgent
from handyrl_tpu_torch.envs import make_env
from handyrl_tpu_torch.league import PayoffMatrix
from handyrl_tpu_torch.models import InferenceModel, init_variables
from handyrl_tpu_torch.runtime.battle import (
    NetworkAgent,
    NetworkAgentClient,
    PeerSevered,
    exec_recorded_match,
    forfeit_outcome,
)
from handyrl_tpu_torch.runtime.connection import FramedConnection
from handyrl_tpu_torch.runtime.evaluation import exec_match, exec_network_match

TIMEOUT = 30.0


class ScriptedPeer:
    """A NetworkAgent-shaped peer: a replica env synced by deltas, moves
    from a script, severing at move k or during the outcome round."""

    def __init__(self, env_name, player, moves, sever_at=None, sever_on_outcome=False):
        self.env = make_env({"env": env_name})
        self.player = player
        self.moves = list(moves)
        self.sever_at = sever_at
        self.sever_on_outcome = sever_on_outcome
        self.final_outcome = None
        self._move_i = 0

    def update(self, info, reset):
        self._maybe_sever()
        self.env.update(info, reset)

    def action(self, player):
        self._maybe_sever()
        a = self.moves[self._move_i]
        self._move_i += 1
        return self.env.action2str(a, player)

    def observe(self, player):
        return None

    def outcome(self, outcome):
        if self.sever_on_outcome:
            raise PeerSevered(self.player)
        self.final_outcome = outcome

    def _maybe_sever(self):
        if self.sever_at is not None and self._move_i >= self.sever_at:
            raise PeerSevered(self.player)


DRAW_X, DRAW_O = [0, 1, 5, 6, 8], [2, 3, 4, 7]   # no line of three: a draw
WIN_X, WIN_O = [0, 1, 2], [3, 4]                 # X takes the top row


def _play(moves_x, moves_o, payoff=None, names=None, sever_x_at=None):
    env = make_env({"env": "TicTacToe"})
    agents = {0: ScriptedPeer("TicTacToe", 0, moves_x, sever_at=sever_x_at),
              1: ScriptedPeer("TicTacToe", 1, moves_o)}
    outcome, severed = exec_recorded_match(env, agents, names, payoff)
    return env, agents, outcome, severed


@pytest.mark.parametrize("moves,want,wp", [((WIN_X, WIN_O), {0: 1, 1: -1}, (1.0, 0.0)),
                                           ((DRAW_X, DRAW_O), {0: 0, 1: 0}, (0.5, 0.5))],
                         ids=["decisive", "draw"])
def test_finished_game_records_pairwise(moves, want, wp):
    p = PayoffMatrix()
    _, agents, outcome, severed = _play(*moves, p, names={0: "alice", 1: "bob"})
    assert severed is None and outcome == want
    assert (p.win_points("alice", "bob"), p.win_points("bob", "alice")) == wp
    assert p.matches == 1 and p.forfeits == 0
    # both replicas saw the delta-synced game and its final outcome
    assert [agents[i].final_outcome for i in (0, 1)] == [want[0], want[1]]
    assert agents[0].env.terminal() and agents[1].env.terminal()


def test_severed_peer_forfeits_with_books():
    p = PayoffMatrix()
    _, _, outcome, severed = _play(WIN_X, WIN_O, p, {0: "alice", 1: "bob"}, sever_x_at=2)
    assert severed == 0 and outcome == {0: -1.0, 1: 1.0}
    assert p.win_points("bob", "alice") == 1.0 and p.win_points("alice", "bob") == 0.0
    assert p.matches == 1 and p.forfeits == 1


def test_sever_during_outcome_delivery_keeps_real_result():
    p = PayoffMatrix()
    env = make_env({"env": "TicTacToe"})
    agents = {0: ScriptedPeer("TicTacToe", 0, WIN_X, sever_on_outcome=True),
              1: ScriptedPeer("TicTacToe", 1, WIN_O)}
    outcome, severed = exec_recorded_match(env, agents, {0: "alice", 1: "bob"}, p)
    assert severed is None and outcome == {0: 1, 1: -1}
    assert p.win_points("alice", "bob") == 1.0 and p.forfeits == 0 and p.matches == 1


def test_default_names_are_seats():
    p = PayoffMatrix()
    _play(WIN_X, WIN_O, p)
    assert p.win_points("seat0", "seat1") == 1.0


def test_no_ledger_still_plays():
    _, _, outcome, severed = _play(WIN_X, WIN_O, payoff=None)
    assert outcome == {0: 1, 1: -1} and severed is None


def test_forfeit_outcome_multiplayer_shape():
    assert forfeit_outcome([0, 1, 2, 3], 2) == {0: 1.0, 1: 1.0, 2: -1.0, 3: 1.0}


def test_multiplayer_match_placements_via_ledger():
    """A 4-player placement decomposes into pairwise entries, as the JAX
    ledger books it (and its Elo and persistence agree)."""
    names = {0: "a", 1: "b", 2: "c", 3: "d"}
    outcome = {0: 1.0, 1: 1 / 3, 2: -1 / 3, 3: -1.0}
    p, jp = PayoffMatrix(), JaxPayoffMatrix()
    p.record_outcome(names, outcome)
    jp.record_outcome(names, outcome)
    got = np.array([[np.nan if a == b else p.win_points(a, b) for b in "abcd"] for a in "abcd"])
    want = np.array([[np.nan, 1.0, 1.0, 1.0], [0.0, np.nan, 1.0, 1.0],
                     [0.0, 0.0, np.nan, 1.0], [0.0, 0.0, 0.0, np.nan]])
    np.testing.assert_array_equal(got, want)
    assert p.elo(list("abcd"), anchor="a") == jp.elo(list("abcd"), anchor="a")
    assert p.to_dict() == jp.to_dict()
    assert PayoffMatrix.from_dict(p.to_dict()).to_dict() == p.to_dict()


def _socket_match(env_name, client_agents, clients=None):
    """One network match over loopback: the port's server side on a master
    env, one client per seat on threads (a port ``NetworkAgentClient``
    unless ``clients`` gives another factory for that seat)."""
    env = make_env({"env": env_name})
    pairs = [socket.socketpair() for _ in env.players()]
    clients = clients or {}
    threads = []
    for p, (_, theirs) in zip(env.players(), pairs):
        make_client = clients.get(p, lambda sock, agent: NetworkAgentClient(
            agent, make_env({"env": env_name}), FramedConnection(sock, timeout=TIMEOUT)))
        client = make_client(theirs, client_agents[p])
        threads.append(threading.Thread(target=client.run, daemon=True))
        threads[-1].start()
    agents = {p: NetworkAgent(FramedConnection(ours, timeout=TIMEOUT), p)
              for p, (ours, _) in zip(env.players(), pairs)}
    try:
        outcome, severed = exec_recorded_match(env, agents)
        for agent in agents.values():
            agent.conn.send(("quit", None))
        for t in threads:
            t.join(TIMEOUT)
        assert not any(t.is_alive() for t in threads)
    finally:
        for ours, theirs in pairs:
            ours.close()
            theirs.close()
    return outcome, severed


class LocalPeer:
    """The client protocol in-process: a replica env and an agent."""

    def __init__(self, env_name, agent):
        self.env, self.agent = make_env({"env": env_name}), agent

    def update(self, info, reset):
        self.env.update(info, reset)

    def action(self, player):
        return self.env.action2str(self.agent.action(self.env, player), player)

    def observe(self, player):
        return self.agent.observe(self.env, player)

    def outcome(self, outcome):
        pass


@pytest.mark.parametrize("env_name", ["TicTacToe", "ConnectFour", "Geister",
                                      "ParallelTicTacToe", "HungryGeese"])
@pytest.mark.parametrize("seed", [0, 1])
def test_network_match_equals_exec_match(env_name, seed):
    """Over sockets as in one process.  Each request waits for its reply,
    so the envs draw from Python's random (HungryGeese's food, and its
    replicas' resets) in one order either way; where only the agents
    draw, the outcome is also exec_match's on a single env."""
    players = make_env({"env": env_name}).players()

    def agents():
        return {p: RandomAgent(seed=seed * 10 + p) for p in players}

    random.seed(seed)
    outcome, severed = _socket_match(env_name, agents())
    random.seed(seed)
    master = make_env({"env": env_name})
    peers = {p: LocalPeer(env_name, agent) for p, agent in agents().items()}
    assert severed is None and outcome == exec_network_match(master, peers)
    if env_name != "HungryGeese":
        assert outcome == exec_match(make_env({"env": env_name}), agents())


def test_network_match_of_a_model_agent_equals_exec_match():
    """A greedy net on the CPU in seat 0, random in seat 1."""
    env = make_env({"env": "ConnectFour"})
    model = InferenceModel(init_variables(env.net(), 3), "cpu")
    outcome, severed = _socket_match("ConnectFour", {0: Agent(model), 1: RandomAgent(seed=5)})
    want = exec_match(make_env({"env": "ConnectFour"}), {0: Agent(model), 1: RandomAgent(seed=5)})
    assert severed is None and outcome == want


def test_jax_client_plays_a_port_server_game_to_its_end():
    """Seat 0 is the JAX package's client (its env, agent and connection),
    seat 1 the port's; both random with the seeds exec_match gets."""
    def jax_client(sock, agent):
        return JaxNetworkAgentClient(agent, jax_make_env({"env": "TicTacToe"}),
                                     JaxFramedConnection(sock, timeout=TIMEOUT))

    for seed in range(3):
        outcome, severed = _socket_match(
            "TicTacToe", {0: JaxRandomAgent(seed=seed), 1: RandomAgent(seed=seed + 100)},
            clients={0: jax_client})
        want = exec_match(make_env({"env": "TicTacToe"}),
                          {0: RandomAgent(seed=seed), 1: RandomAgent(seed=seed + 100)})
        assert severed is None and outcome == want


def test_exec_network_match_matches_the_jax_one():
    """Scripted peers through both packages' ``exec_network_match``."""
    from handyrl_tpu.runtime.evaluation import exec_network_match as jax_exec_network_match

    for moves in ((WIN_X, WIN_O), (DRAW_X, DRAW_O)):
        ours = exec_network_match(make_env({"env": "TicTacToe"}),
                                  {i: ScriptedPeer("TicTacToe", i, m) for i, m in enumerate(moves)})
        theirs = jax_exec_network_match(
            jax_make_env({"env": "TicTacToe"}),
            {i: ScriptedPeer("TicTacToe", i, m) for i, m in enumerate(moves)})
        assert ours == theirs


def _free_port():
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def test_eval_server_and_clients_through_main(tmp_path, monkeypatch, capsys):
    from handyrl_tpu_torch.main import main

    monkeypatch.chdir(tmp_path)
    (tmp_path / "config.yaml").write_text(yaml.safe_dump({
        "env_args": {"env": "TicTacToe"}, "train_args": {"battle_port": _free_port()}}))
    codes = []
    runs = [["--eval-server", "4"], ["--eval-client", "random", "127.0.0.1"],
            ["--eval-client", "random", "127.0.0.1"]]
    threads = [threading.Thread(target=lambda a=a: codes.append(main(a, device="cpu")),
                                daemon=True) for a in runs]
    for t in threads:
        t.start()
        time.sleep(0.1)  # the server listens before the clients try
    deadline = time.monotonic() + TIMEOUT
    for t in threads:
        t.join(max(0.0, deadline - time.monotonic()))
    assert not any(t.is_alive() for t in threads) and codes == [0, 0, 0]
    out = capsys.readouterr().out
    total = [line for line in out.splitlines() if line.startswith("total =")]
    assert len(total) == 1 and total[0].endswith("(4)")
    assert "over 4 match(es), 0 forfeit(s)" in out
