"""Network battle mode: agents on different machines play one game.

Counterpart of ``handyrl_tpu/runtime/battle.py``.  The server owns the
master env and runs ``exec_network_match`` over one socket proxy per seat
(``NetworkAgent``); each client owns a replica env, kept in step only by
``diff_info``/``update`` deltas, and a local agent (``NetworkAgentClient``).
``eval_server_main`` and ``eval_client_main`` are ``--eval-server`` and
``--eval-client``; the default port is 9876 (``train_args.battle_port``).

The wire carries the codec's frames (runtime/connection.py), the JAX
package's, so a client of either package plays against a server of the
other: env deltas, action strings, outcomes and value lists, never a
tensor.  A client's model runs on the card unless the caller says otherwise.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

import numpy as np

from ..envs import make_env, prepare_env
from ..utils import resolve_device
from .connection import (
    FramedConnection,
    accept_socket_connections,
    connect_socket_connection,
    open_socket_connection,
    send_recv,
)
from .evaluation import build_agent, exec_network_match, load_model_agent, wp_func

BATTLE_PORT = 9876


class PeerSevered(RuntimeError):
    """A remote peer's connection died mid-match; carries the seat, so the
    match is scored as that seat's forfeit."""

    def __init__(self, player):
        super().__init__(f"peer for player {player} severed mid-match")
        self.player = player


def forfeit_outcome(players, severed_player):
    """The severed seat scores -1, every surviving seat +1."""
    return {p: (-1.0 if p == severed_player else 1.0) for p in players}


def exec_recorded_match(env, network_agents, names=None, payoff=None, game_args=None):
    """``exec_network_match`` with the payoff ledger's accounting: a
    finished game records pairwise, a severed peer records a forfeit, an
    env error records nothing.  Returns ``(outcome, severed_player)``;
    ``names`` maps seats to ledger names (default ``seat{p}``), ``payoff``
    is a ``PayoffMatrix``-shaped ledger or None."""
    names = names or {p: f"seat{p}" for p in env.players()}
    try:
        outcome = exec_network_match(env, network_agents, game_args=game_args)
    except PeerSevered as exc:
        if env.terminal():
            # the game finished and the peer died during the outcome round
            # (a client leaving after its last move): the master env holds
            # the real result, and a forfeit would book a winner's loss
            outcome = env.outcome()
            if payoff is not None:
                payoff.record_outcome(names, outcome)
            return outcome, None
        if payoff is not None:
            payoff.record_forfeit(names, exc.player)
        return forfeit_outcome(env.players(), exc.player), exc.player
    if outcome is not None and payoff is not None:
        payoff.record_outcome(names, outcome)
    return outcome, None


class NetworkAgentClient:
    """The client's command loop: a local agent on a replica env."""

    def __init__(self, agent, env, conn: FramedConnection):
        self.agent = agent
        self.env = env
        self.conn = conn

    def run(self) -> None:
        while True:
            try:
                command, args = self.conn.recv()
            except (OSError, EOFError):
                break
            if command == "quit":
                break
            elif command == "outcome":
                print("outcome = %f" % args)
                self.conn.send(None)
            elif hasattr(self.agent, command):
                if command == "action":
                    player = args
                    ret = self.env.action2str(self.agent.action(self.env, player), player)
                else:  # reset / observe
                    ret = getattr(self.agent, command)(self.env, args)
                    if ret is not None:
                        ret = [float(x) for x in np.reshape(np.asarray(ret), (-1,))]
                self.conn.send(ret)
            elif command == "update":
                info, reset = args
                self.env.update(info, reset)
                self.conn.send(None)
            else:
                self.conn.send(None)


class NetworkAgent:
    """The server's proxy of a remote client in seat ``player``: a dead or
    stalled connection raises ``PeerSevered`` for that seat."""

    def __init__(self, conn: FramedConnection, player=None):
        self.conn = conn
        self.player = player

    def _rpc(self, payload):
        try:
            return send_recv(self.conn, payload)
        except (OSError, EOFError) as exc:
            raise PeerSevered(self.player) from exc

    def update(self, data, reset: bool):
        return self._rpc(("update", (data, reset)))

    def outcome(self, outcome):
        return self._rpc(("outcome", float(outcome)))

    def action(self, player: int):
        return self._rpc(("action", player))

    def observe(self, player: int):
        return self._rpc(("observe", player))


def network_match_acception(n_games: int, env_args: Dict[str, Any], num_agents: int, port: int):
    """Yield a group of ``num_agents`` client connections per game, as soon
    as it fills, so matches start while later clients join and a client
    can reconnect between games."""
    waiting_conns: List[FramedConnection] = []
    games = 0
    sock = open_socket_connection(port)
    try:
        for conn in accept_socket_connections(sock=sock):
            if conn is None:
                continue
            conn.send(env_args)  # every client learns the env on joining
            waiting_conns.append(conn)
            if len(waiting_conns) == num_agents:
                group, waiting_conns = waiting_conns, []
                yield group
                games += 1
            if games >= n_games:
                return
    finally:
        # refuse further joins and release a half-filled group, so clients
        # hear that the server is gone instead of waiting forever
        sock.close()
        for conn in waiting_conns:
            conn.close()


class _Locked:
    """Serialises one ledger's record_* calls across match threads."""

    def __init__(self, payoff, lock):
        self._payoff = payoff
        self._lock = lock

    def record_outcome(self, names, outcome):
        with self._lock:
            self._payoff.record_outcome(names, outcome)

    def record_forfeit(self, names, severed_seat):
        with self._lock:
            self._payoff.record_forfeit(names, severed_seat)


def eval_server_main(args: Dict[str, Any], argv: List[str], port: Optional[int] = None) -> None:
    """``--eval-server [NUM_GAMES]``: serve NUM_GAMES (default 100) games to
    clients as they join, each game in a thread of its own, and print the
    win points of the first seat and the session's payoff ledger."""
    from ..league.matchmaker import PayoffMatrix

    env_args = args["env_args"]
    prepare_env(env_args)
    master_env = make_env(env_args)
    num_games = int(argv[0]) if argv else 100
    port = port or int(args["train_args"].get("battle_port", BATTLE_PORT))

    print("network match server mode")
    total: Dict[Any, int] = {}
    # one ledger per session, seats named by join order
    payoff = PayoffMatrix()
    lock = threading.Lock()
    threads: List[threading.Thread] = []

    def run_match(game: int, conns: List[FramedConnection]) -> None:
        env = make_env(env_args)
        agents = {p: NetworkAgent(conn, p) for p, conn in zip(env.players(), conns)}
        names = {p: f"seat{p}" for p in env.players()}
        outcome, severed = exec_recorded_match(env, agents, names, _Locked(payoff, lock))
        if severed is not None:
            print("game %d: seat %s severed — forfeit, outcome = %s" % (game, severed, outcome))
        if outcome is not None:
            o = outcome[env.players()[0]]
            with lock:
                total[o] = total.get(o, 0) + 1
            if severed is None:
                print("game %d: outcome = %s" % (game, outcome))
        for conn in conns:
            try:
                conn.send(("quit", None))
            except OSError:
                pass
            conn.close()

    groups = network_match_acception(num_games, env_args, len(master_env.players()), port)
    for game, conns in enumerate(groups):
        t = threading.Thread(target=run_match, args=(game, conns))
        t.start()
        threads.append(t)
    for t in threads:
        t.join()
    print("total = %.3f (%d)" % (wp_func(total), sum(total.values())))
    seats = [f"seat{p}" for p in master_env.players()]
    wp0 = payoff.aggregate_win_points(seats[0], seats[1:])
    if wp0 is not None:
        print("payoff: %s wp vs field = %.3f over %d match(es), %d forfeit(s)"
              % (seats[0], wp0, payoff.matches, payoff.forfeits))


def eval_client_main(args: Dict[str, Any], argv: List[str], port: Optional[int] = None,
                     device=None) -> None:
    """``--eval-client AGENT [HOST] [N_GAMES]``: play AGENT ('random',
    'rulebase[-key]' or a checkpoint path) game after game against HOST
    (default localhost) until the server is gone, or N_GAMES ('once' = 1)
    games.  A checkpoint's model runs on the card unless ``device`` says
    otherwise."""
    device = resolve_device(device)
    print("network match client mode")
    host = argv[1] if len(argv) >= 2 else "localhost"
    port = port or int(args["train_args"].get("battle_port", BATTLE_PORT))
    max_games = None
    if len(argv) >= 3:
        max_games = 1 if argv[2] == "once" else int(argv[2])
    games_played = 0
    connected_once = False
    while True:
        try:
            # retry while the server boots; after the first contact a
            # refused connection means the server finished and went away
            conn = connect_socket_connection(
                host, port, retry_seconds=0.0 if connected_once else 60.0)
            connected_once = True
        except OSError:
            print("server is gone")
            return
        try:
            env_args = conn.recv()
        except (OSError, EOFError):
            conn.close()
            print("server is gone")
            return

        prepare_env(env_args)
        env = make_env(env_args)
        agent = build_agent(argv[0] if argv else "random", env)
        if agent is None:
            agent = load_model_agent(argv[0], env, device)
        NetworkAgentClient(agent, env, conn).run()
        conn.close()
        games_played += 1
        if max_games is not None and games_played >= max_games:
            return
