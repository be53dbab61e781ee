"""The league training plane: population-based training.

Counterpart of ``handyrl_tpu/league``: a persistent population of frozen
snapshots and anchors (league.py) on the manifest-verified checkpoint
store, PFSP matchmaking over a shared payoff ledger (matchmaker.py, the
ledger network battles record into too), and a learner that serves frozen
opponents from resident ModelRouter engines (learner.py).  Entry point:
``python -m handyrl_tpu_torch.main --league``.
"""

from .league import ANCHOR, CANDIDATE, League, Member
from .learner import LeagueLearner, LeagueModelServer, league_main
from .matchmaker import Matchmaker, PayoffMatrix, pfsp_weights

__all__ = [
    "ANCHOR", "CANDIDATE", "League", "Member",
    "LeagueLearner", "LeagueModelServer", "league_main",
    "Matchmaker", "PayoffMatrix", "pfsp_weights",
]
