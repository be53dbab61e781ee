"""Match execution and evaluation.

Counterpart of ``handyrl_tpu/runtime/evaluation.py``:

* ``exec_match`` — one match on a shared env;
* ``exec_network_match`` — one match whose agents each hold a replica env
  synchronised by ``diff_info``/``update`` deltas (the battle server's,
  runtime/battle.py);
* ``Evaluator`` — the worker-side model-vs-opponent job;
* ``evaluate_mp`` — standalone evaluation over a thread pool, balancing
  first and second seats, with a win-point report per seat pattern;
* ``eval_main`` — ``python -m handyrl_tpu_torch.main --eval MODELS
  NUM_GAMES NUM_WORKERS``.

Threads share one model on the card; with several of them, each distinct
model is served through one batched inference engine, so concurrent games
share its forwards.
"""

from __future__ import annotations

import copy
import random
import threading
from typing import Any, Dict, List, Optional

from ..agents import Agent, EnsembleAgent, RandomAgent, RuleBasedAgent
from ..envs import make_env, prepare_env
from ..models import InferenceModel
from ..utils import resolve_device
from .checkpoint import load_params
from .inference_engine import BatchedInferenceEngine


def view(env, player: Optional[int] = None) -> None:
    if hasattr(env, "view"):
        env.view(player=player)
    else:
        print(env)


def exec_match(env, agents: Dict[int, Any], critic=None, show: bool = False, game_args=None):
    """Run one match on a shared env; returns the outcome dict, or None on
    an env error."""
    if env.reset(game_args or {}):
        return None
    for agent in agents.values():
        agent.reset(env, show=show)
    while not env.terminal():
        if show:
            view(env)
        turn_players = env.turns()
        observers = env.observers()
        actions = {}
        for p, agent in agents.items():
            if p in turn_players:
                actions[p] = agent.action(env, p, show=show)
            elif p in observers:
                agent.observe(env, p, show=show)
        if env.step(actions):
            return None
        if show and critic is not None:
            print("cv = ", critic.observe(env, None, show=False)[0])
    if show:
        view(env)
        print("final outcome = %s" % env.outcome())
    return env.outcome()


def exec_network_match(env, network_agents: Dict[int, Any], show: bool = False, game_args=None):
    """A match on the master ``env`` whose agents hold replica envs, kept in
    step by the master's deltas; returns the outcome dict, or None on an
    env error."""
    if env.reset(game_args or {}):
        return None
    for p, agent in network_agents.items():
        agent.update(env.diff_info(p), True)
    while not env.terminal():
        if show:
            view(env)
        turn_players = env.turns()
        observers = env.observers()
        actions = {}
        for p, agent in network_agents.items():
            if p in turn_players:
                actions[p] = env.str2action(agent.action(p), p)
            elif p in observers:
                agent.observe(p)
        if env.step(actions):
            return None
        for p, agent in network_agents.items():
            agent.update(env.diff_info(p), False)
    outcome = env.outcome()
    for p, agent in network_agents.items():
        agent.outcome(outcome[p])
    return outcome


def build_agent(raw: Any, env=None) -> Optional[Any]:
    """'random' / 'rulebase[-key]' -> a scripted agent; anything else None."""
    if raw == "random":
        return RandomAgent()
    if isinstance(raw, str) and raw.startswith("rulebase"):
        key = raw.split("-")[1] if "-" in raw else None
        return RuleBasedAgent(key)
    return None


def load_model(model_path: str, env, device=None) -> InferenceModel:
    """A ``.ckpt`` state dict -> the env's net on ``device``."""
    if not model_path.endswith(".ckpt"):
        raise ValueError(
            f"{model_path!r}: the port loads .ckpt checkpoints only; exported models "
            "(.hlo, .tf, .onnx) wait for the export port (ROADMAP A10)"
        )
    module = env.net()
    module.load_state_dict(load_params(model_path))
    return InferenceModel(module, device)


def load_model_agent(model_path: str, env, device=None) -> Agent:
    """A checkpoint path -> a greedy Agent."""
    return Agent(load_model(model_path, env, device))


class Evaluator:
    """The worker-side evaluation job: the model in ``args['player']``'s
    seats, an opponent from ``eval.opponent`` in the others."""

    def __init__(self, env, args: Dict[str, Any]):
        self.env = env
        self.args = args
        self.opponent = args.get("eval", {}).get("opponent", ["random"])
        if not isinstance(self.opponent, list):
            self.opponent = [self.opponent]

    def execute(self, models: Dict[int, Any], args: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        opponents = [o for o in self.opponent if build_agent(o, self.env) is not None] or ["random"]
        opponent = random.choice(opponents)
        agents = {}
        for p in self.env.players():
            if p in args["player"]:
                agents[p] = Agent(models[p], observation=self.args.get("observation", False))
            else:
                agents[p] = build_agent(opponent, self.env)
        outcome = exec_match(self.env, agents)
        if outcome is None:
            print("None episode in evaluation!")
            return None
        return {"args": args, "result": outcome, "opponent": opponent}


def wp_func(results: Dict[Any, int]) -> float:
    """Win points: 1 per win, 0.5 per draw, over finished games."""
    games = sum(results.values())
    win = sum(v for k, v in results.items() if k is not None and k > 0)
    draw = sum(v for k, v in results.items() if k == 0)
    return (win + draw / 2) / max(games, 1e-6)


def evaluate_mp(env_args: Dict[str, Any], agents: Dict[int, Any], num_games: int,
                num_workers: int = 4, seed: int = 0):
    """``num_games`` games over ``num_workers`` threads, seats balanced for
    two-player games; returns {pattern: {outcome: count}} from agent 0's
    side and prints the win points of each pattern and in total."""
    players = make_env(env_args).players()
    patterns: List[List[int]] = [[0, 1], [1, 0]] if len(players) == 2 else [list(players)]
    jobs = iter([patterns[i % len(patterns)] for i in range(num_games)])
    results: Dict[str, Dict[Any, int]] = {str(p): {} for p in patterns}
    lock = threading.Lock()

    def run():
        env = make_env(env_args)
        # shallow copies per thread: models are shared, an agent's hidden
        # state is per game
        local_agents = {k: copy.copy(a) for k, a in agents.items()}
        while True:
            with lock:
                pat = next(jobs, None)
            if pat is None:
                return
            seat_agents = {seat: local_agents[pat[idx]] for idx, seat in enumerate(env.players())}
            try:
                outcome = exec_match(env, seat_agents)
            except Exception as exc:  # a broken agent must not zero the report
                print(f"match failed: {type(exc).__name__}: {exc}")
                continue
            if outcome is None:
                continue
            o = outcome[env.players()[pat.index(0)]]
            with lock:
                results[str(pat)][o] = results[str(pat)].get(o, 0) + 1

    threads = [threading.Thread(target=run) for _ in range(max(1, num_workers))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()

    total: Dict[Any, int] = {}
    for pat, res in results.items():
        print("%s = %.3f (%d)" % (pat, wp_func(res), sum(res.values())))
        for k, v in res.items():
            total[k] = total.get(k, 0) + v
    print("total = %.3f (%d)" % (wp_func(total), sum(total.values())))
    return results


def eval_vs_baseline(env_args: Dict[str, Any], agent0, opponent: str, num_games: int,
                     num_workers: int = 4):
    """(win points, mean outcome) of ``agent0`` with every other seat
    played by ``opponent`` (a spec for ``build_agent``)."""
    env = make_env(env_args)
    agents: Dict[int, Any] = {0: agent0}
    for k in env.players()[1:]:
        opp = build_agent(opponent)
        if opp is None:
            raise ValueError(f"unknown baseline opponent spec {opponent!r}")
        agents[k] = opp
    results = evaluate_mp(env_args, agents, num_games, num_workers)
    total: Dict[Any, int] = {}
    for res in results.values():
        for k, v in res.items():
            total[k] = total.get(k, 0) + v
    scored = {k: v for k, v in total.items() if k is not None}
    mean_outcome = sum(k * v for k, v in scored.items()) / max(sum(scored.values()), 1)
    return wp_func(total), mean_outcome


def parse_eval_spec(raw: str) -> Dict[str, Any]:
    """``A[:B]`` -> {"main": A, "opponent": B or 'random'}; '+' inside a
    side joins checkpoint paths into an ensemble."""
    parts = raw.split(":")
    if len(parts) > 2:
        raise ValueError(
            f"eval spec {raw!r} has more than one ':'; use A:B (opponent) and '+' to join "
            "ensemble members"
        )
    return {"main": parts[0], "opponent": parts[1] if len(parts) > 1 else "random"}


def eval_main(args: Dict[str, Any], argv: List[str], device=None) -> None:
    """``--eval MODELS NUM_GAMES NUM_WORKERS``: MODELS is ``A[:B]``; A is
    evaluated, B (default 'random') fills every other seat.  Each side is
    'random', 'rulebase[-key]', a checkpoint path or a '+'-joined ensemble
    of checkpoint paths.  Models run on the card unless ``device`` says
    otherwise."""
    device = resolve_device(device)
    env_args = args["env_args"]
    prepare_env(env_args)
    env = make_env(env_args)
    raw = argv[0] if argv else "models/latest.ckpt"
    num_games = int(argv[1]) if len(argv) >= 2 else 100
    num_workers = int(argv[2]) if len(argv) >= 3 else 4

    engines: List[BatchedInferenceEngine] = []

    def share(model):
        if num_workers <= 1:
            return model
        engine = BatchedInferenceEngine(model, max_batch=max(8, num_workers)).start()
        engines.append(engine)
        return engine.client()

    def resolve(spec: str):
        agent = build_agent(spec, env)
        if agent is not None:
            return agent
        paths = spec.split("+")
        models = [share(load_model(p, env, device)) for p in paths]
        return EnsembleAgent(models) if len(models) > 1 else Agent(models[0])

    spec = parse_eval_spec(raw)
    agents = {0: resolve(spec["main"])}
    if len(env.players()) > 1:
        opponent = resolve(spec["opponent"])
        for i in range(1, len(env.players())):
            agents[i] = opponent
    try:
        evaluate_mp(env_args, agents, num_games, num_workers)
    finally:
        for engine in engines:
            engine.stop()
