"""League training: the population plane over the learner and its actors.

Counterpart of ``handyrl_tpu/league/learner.py``.  ``LeagueLearner``
subclasses the Learner and changes three seams:

* model serving: ``LeagueModelServer`` keeps the shared engine for the
  latest (candidate) model, and serves frozen opponents through a
  ``ModelRouter`` (serving/router.py): each frozen snapshot gets a resident
  ``ContinuousBatcher`` engine, loaded once from the verified store, in
  place of a disk load per job;
* role assignment: a ``selfplay_rate`` slice of generation jobs stays
  latest-vs-latest; the rest are league matches: the candidate takes one
  (rotating) seat, a PFSP-sampled frozen member the others, and only the
  candidate's columns train (the frozen seats' tmask/omask are zeroed
  when the episode is fed);
* the epoch boundary: match outcomes recorded per ordered pair in the
  payoff ledger feed the promotion gate: once the candidate has
  ``promote_games`` against every active member and its pooled win points
  reach ``promote_winrate``, the just-saved snapshot is frozen into the
  population (``League.freeze_candidate``) and its checkpoint is pinned
  against GC.  ``league_*`` keys land in metrics.jsonl.

Run it with ``python -m handyrl_tpu_torch.main --league``.  The router's
engines live on the learner's device, or under ``plane: split`` on the
actor members (their streams and locks), beside the self-play and never
contending with the learner member, as the JAX league places them on the
actor mesh.
"""

from __future__ import annotations

import random
from typing import Any, Dict

import numpy as np

from ..envs import make_env
from ..models.inference import as_host_array
from ..runtime.inference_engine import EngineStopped
from ..runtime.learner import Learner
from ..runtime.replay import compress_block, decompress_block
from ..runtime.worker import LocalModelServer
from ..serving.router import ModelRouter, RouteError
from ..utils import tree_map
from .league import ANCHOR, CANDIDATE, League
from .matchmaker import Matchmaker

__all__ = ["LeagueLearner", "LeagueModelServer", "RouterOpponent", "league_main"]


class RouterOpponent:
    """A frozen member's model handle for actor threads: its requests go
    through the router to that snapshot's resident engine, which batches
    across every acting thread as the latest model's shared engine does."""

    def __init__(self, server: "LeagueModelServer", model_id: int):
        self._server = server
        self._mid = int(model_id)

    def init_hidden(self, batch_dims=()):
        # numpy, as the router's engines take and return it
        hidden = self._server.module.initial_state(tuple(batch_dims))
        return None if hidden is None else tree_map(as_host_array, hidden)

    def submit(self, obs, hidden=None):
        return self._server.route_submit(self._mid, obs, hidden)

    def inference(self, obs, hidden=None) -> Dict[str, Any]:
        return self.submit(obs, hidden).result(timeout=600.0)


class LeagueModelServer(LocalModelServer):
    """LocalModelServer plus a ModelRouter for the frozen opponents'
    engines.  Latest-model requests keep the shared engine; concrete old
    epochs route to resident router engines.  A missing or corrupt
    snapshot is served by the latest engine, counted: the router's
    substitutions fold into ``substituted_snapshots``."""

    def __init__(self, module, env, args: Dict[str, Any], device=None, opponent_devices=None):
        super().__init__(module, env, args, device)
        serving_cfg = dict(args.get("serving", {}) or {})
        # rollout jobs are throughput work: never shed, no SLO; a match
        # finishes or fails loudly
        serving_cfg["shed_policy"] = "none"
        # every active pool member stays resident (+1 for the latest): a
        # smaller max_models would evict and cold-reload inside the actors'
        # generation loop
        serving_cfg["max_models"] = max(
            int(serving_cfg.get("max_models", 4)),
            int((args.get("league", {}) or {}).get("max_population", 16)) + 1,
        )
        env.reset()
        template_obs = env.observation(env.players()[0])
        # the frozen opponents' engines: on the learner's device, or on the
        # split plane's actor members
        self._router = ModelRouter(module, template_obs, serving_cfg,
                                   model_dir=self.model_dir,
                                   devices=list(opponent_devices or [self.device]))

    @property
    def module(self):
        """The served module (the shared engine's copy)."""
        return self._model.module

    # the base __init__ sets the counter before the router exists; reads
    # fold the router's substitutions in
    @property
    def substituted_snapshots(self) -> int:
        router = getattr(self, "_router", None)
        return self._substituted_base + (router.substituted if router else 0)

    @substituted_snapshots.setter
    def substituted_snapshots(self, value: int) -> None:
        self._substituted_base = int(value)

    def publish(self, model_id: int, state_dict) -> None:
        super().publish(model_id, state_dict)
        try:
            # the router's latest mirrors the served latest: the counted
            # substitute when a member's snapshot is gone
            self._router.publish(int(model_id), state_dict)
        except RouteError:
            pass  # the router has stopped (a shutdown race): nothing to serve

    def get(self, model_id: int):
        if model_id == 0:
            return self._random
        with self._lock:
            current = self.model_id
        if model_id < 0 or model_id >= current:
            return self.engine.client()
        return RouterOpponent(self, int(model_id))

    def route_submit(self, mid: int, obs, hidden=None):
        try:
            _, route = self._router.resolve(mid)
        except RouteError as exc:
            # stopped, or nothing published: actor threads drain as when the
            # shared engine goes away
            raise EngineStopped(str(exc)) from exc
        return route.submit(obs, hidden)

    def router_stats(self) -> Dict[str, Any]:
        return self._router.stats()

    def stop(self) -> None:
        """Stop the shared engine and the router; the router joins its
        engines' serve threads, so none is left inside torch."""
        super().stop()
        self._router.stop()


class LeagueLearner(Learner):
    """A learner whose generation plane plays the league."""

    def __init__(self, args: Dict[str, Any], net=None, device=None, remote: bool = False):
        super().__init__(args, net, device, remote)
        cfg = dict(self.args.get("league", {}) or {})
        self.league_args = cfg
        self.league = League(self.model_dir, cfg)
        stale = sorted(m.name for m in self.league.members.values() if m.epoch > self.model_epoch)
        if stale:
            self.model_server.stop()
            self.trainer.stop()
            raise ValueError(
                f"league members {stale} reference snapshots newer than the "
                f"resumed model epoch {self.model_epoch}; resume the run "
                "with restart_epoch: -1 (or clear models/LEAGUE.json to "
                "start a fresh league)"
            )
        self.matchmaker = Matchmaker(self.league.payoff, cfg.get("pfsp_weighting", "var"),
                                     seed=int(self.args["seed"]))
        self.selfplay_rate = float(cfg.get("selfplay_rate", 0.2))
        self._league_seat = 0
        self._league_rng = random.Random(int(self.args["seed"]) ^ 0x5EA6)
        pool = self.league.opponent_pool()
        print("league: %d member(s), pool %s, pfsp=%s selfplay_rate=%.2f "
              "promote wp>=%.2f over >=%d games/pair"
              % (len(self.league.members), [m.name for m in pool],
                 cfg.get("pfsp_weighting", "var"), self.selfplay_rate,
                 float(cfg.get("promote_winrate", 0.55)), int(cfg.get("promote_games", 8))))

    # -- the seams into the learner ----------------------------------------------

    def _make_model_server(self, args: Dict[str, Any]):
        # plane: split: the opponents' engines go on the actor members,
        # beside the self-play and off the learner member
        return LeagueModelServer(self.module, make_env(args["env_args"]), self.args, self.device,
                                 opponent_devices=self._actor_members)

    def _gc_pinned(self):
        return self.league.frozen_epochs()

    def _assign_role(self) -> Dict[str, Any]:
        args = super()._assign_role()
        if args["role"] != "g":
            return args
        pool = self.league.opponent_pool()
        if not pool or self._league_rng.random() < self.selfplay_rate:
            args["league"] = {"mode": "selfplay"}
            return args
        players = self.env.players()
        me = players[self._league_seat % len(players)]   # seat balance
        self._league_seat += 1
        opponent = self.matchmaker.sample_opponent(
            CANDIDATE, [m.name for m in pool],
            min_games=int(self.league_args.get("promote_games", 8)))
        epoch = {m.name: m.epoch for m in pool}[opponent]
        args["player"] = [me]
        args["model_id"] = {p: (self.model_epoch if p == me else epoch) for p in players}
        args["league"] = {
            "mode": "match",
            "seats": {p: (CANDIDATE if p == me else opponent) for p in players},
        }
        return args

    def feed_episodes(self, episodes) -> None:
        for episode in episodes:
            if episode is None:
                continue
            meta = (episode.get("args") or {}).get("league")
            if not meta or meta.get("mode") != "match":
                continue
            seats = meta["seats"]
            self.league.payoff.record_outcome(seats, episode["outcome"])
            self._mask_non_candidate(
                episode, [p for p, name in seats.items() if name == CANDIDATE])
        super().feed_episodes(episodes)

    @staticmethod
    def _mask_non_candidate(episode: Dict[str, Any], candidate_players) -> None:
        """Zero the frozen seats' tmask/omask columns, so only the
        candidate's steps carry loss: the opponent's (old-policy) actions
        are context, not targets."""
        players = episode["players"]
        mask = np.zeros(len(players), np.float32)
        for p in candidate_players:
            mask[players.index(p)] = 1.0
        blocks = []
        for blk in episode["blocks"]:
            cols = dict(decompress_block(blk))
            cols["tmask"] = (cols["tmask"] * mask[None, :]).astype(np.float32)
            cols["omask"] = (cols["omask"] * mask[None, :]).astype(np.float32)
            blocks.append(compress_block(cols))
        episode["blocks"] = blocks

    def _epoch_hook(self, record: Dict[str, Any]) -> None:
        payoff = self.league.payoff
        pool = [m.name for m in self.league.opponent_pool()]
        min_games = int(self.league_args.get("promote_games", 8))
        bar = float(self.league_args.get("promote_winrate", 0.55))
        coverage = payoff.coverage(CANDIDATE, pool, 1)
        wp = payoff.aggregate_win_points(CANDIDATE, pool)
        gate = (bool(pool) and wp is not None and wp >= bar
                and all(payoff.games(CANDIDATE, b) >= min_games for b in pool))
        if gate and f"main-{self.model_epoch}" in self.league.members:
            # a rollback can replay epoch numbers: re-freezing an existing
            # member would fail the boundary, so skip loudly; the next new
            # epoch promotes if the gate still holds
            print(f"league: main-{self.model_epoch} already frozen (epoch "
                  "replayed after a rollback?) — promotion skipped")
            gate = False
        if gate:
            member = self.league.freeze_candidate(self.model_epoch, self.trainer.steps)
            print("league: promotion gate PASSED (wp %.3f >= %.2f, >=%d games "
                  "vs each of %d opponents) — frozen %s"
                  % (wp, bar, min_games, len(pool), member.name))
        else:
            self.league.save()   # books and members durable at every boundary
        rated = payoff.elo(pool + [CANDIDATE], anchor=ANCHOR)
        spread = (round(max(rated.values()) - min(rated.values()), 1)
                  if len(rated) >= 2 else None)
        print("league: pool %d/%d members, candidate wp %s, coverage %.2f, "
              "elo spread %s, promotions %d"
              % (len(pool), len(self.league.members), "n/a" if wp is None else "%.3f" % wp,
                 coverage, spread, self.league.promotions))
        record["league_population"] = len(self.league.members)
        record["league_pool"] = len(pool)
        record["league_matches"] = payoff.matches
        record["league_forfeits"] = payoff.forfeits
        record["league_payoff_coverage"] = round(coverage, 4)
        record["league_candidate_wp"] = None if wp is None else round(wp, 4)
        record["league_elo_spread"] = spread
        record["league_promotions"] = self.league.promotions

    def run(self) -> int:
        try:
            return super().run()
        finally:
            # matches fed after the last boundary (in-flight episodes
            # draining) survive the run
            self.league.save()


def league_main(args: Dict[str, Any], device=None) -> int:
    """``--league``: the league's learner with local actor threads, on the
    card unless ``device`` says otherwise; returns its exit code (75 after
    a SIGTERM drain)."""
    return LeagueLearner(args, device=device).run()
