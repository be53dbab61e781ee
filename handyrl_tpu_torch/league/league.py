"""League registry: the persistent population behind league training.

Counterpart of ``handyrl_tpu/league/league.py``.  A population member is a
role plus a checkpoint epoch in the manifest-verified store
(``models/{epoch}.ckpt``):

* ``anchor``: the fixed reference opponent (epoch 0 = the zero-output
  RandomModel, ``LocalModelServer.get(0)``).  Anchors never retire: they
  give the payoff matrix a stationary column, so Elo is comparable across
  the run;
* ``frozen``: a past candidate snapshot frozen by the promotion gate
  (named ``main-{epoch}``), the fictitious self-play pool;
* ``main``: the live candidate (it plays under the reserved name
  ``candidate`` until frozen);
* ``exploiter``: a member registered to attack a specific main; the
  registry and the matchmaker carry the role.

The registry (members and the payoff ledger) persists to
``models/LEAGUE.json`` through the checkpoint plane's atomic write, as the
same JSON the JAX package writes, so a league run resumes with its
population and books.  On load, members whose snapshots no longer verify
are dropped loudly (their books are kept): a match against a corrupt
snapshot would be served the latest params and poison the books.
"""

from __future__ import annotations

import json
import os
from dataclasses import asdict, dataclass
from typing import Any, Dict, List, Optional

from ..runtime.checkpoint import atomic_write_bytes, verify_snapshot
from .matchmaker import PayoffMatrix

__all__ = ["ANCHOR", "CANDIDATE", "LEAGUE_NAME", "ROLES", "League", "Member"]

LEAGUE_NAME = "LEAGUE.json"
CANDIDATE = "candidate"      # the ledger name of the live (not yet frozen) candidate
ANCHOR = "random"            # the epoch-0 RandomModel anchor

ROLES = ("anchor", "frozen", "main", "exploiter")


@dataclass
class Member:
    name: str
    epoch: int
    role: str = "frozen"
    frozen_at_step: int = 0

    def __post_init__(self):
        if self.role not in ROLES:
            raise ValueError(f"member role {self.role!r} not one of {ROLES}")


class League:
    """Population registry and the shared payoff ledger, on disk."""

    def __init__(self, model_dir: str, league_args: Optional[Dict[str, Any]] = None):
        cfg = dict(league_args or {})
        self.model_dir = model_dir
        self.max_population = max(2, int(cfg.get("max_population", 16)))
        self.members: Dict[str, Member] = {}
        self.payoff = PayoffMatrix()
        self.promotions = 0
        # whether this process writes models/LEAGUE.json (one process does)
        self.owner = True
        if not self.load():
            # a fresh league: the anchor gives the first candidate an
            # opponent and the Elo scale its zero
            self.members[ANCHOR] = Member(ANCHOR, 0, "anchor")

    # -- membership -----------------------------------------------------------

    def add(self, name: str, epoch: int, role: str = "frozen",
            frozen_at_step: int = 0) -> Member:
        if name in self.members:
            raise ValueError(f"league member {name!r} already registered")
        if name == CANDIDATE:
            raise ValueError(
                f"{CANDIDATE!r} is the reserved ledger name of the live "
                "candidate; frozen members need concrete names"
            )
        member = Member(name, int(epoch), role, int(frozen_at_step))
        self.members[name] = member
        return member

    def freeze_candidate(self, epoch: int, steps: int = 0) -> Member:
        """The promotion gate passed: freeze the candidate's snapshot into
        the population as ``main-{epoch}`` and hand it the candidate's
        books (the games that earned the promotion describe the frozen
        policy), so the next candidate starts with clean books."""
        member = self.add(f"main-{int(epoch)}", epoch, "frozen", steps)
        self.payoff.adopt(CANDIDATE, member.name)
        self.promotions += 1
        self.save()
        return member

    def opponent_pool(self) -> List[Member]:
        """The active matchmaking pool: anchors plus the newest frozen
        members up to ``max_population`` (older ones retire from
        matchmaking but keep their snapshots and books)."""
        anchors = [m for m in self.members.values() if m.role == "anchor"]
        frozen = sorted(
            (m for m in self.members.values() if m.role in ("frozen", "exploiter")),
            key=lambda m: m.epoch,
        )
        slots = max(0, self.max_population - len(anchors))
        return anchors + frozen[-slots:] if slots else anchors

    def frozen_epochs(self) -> List[int]:
        """Every registered snapshot epoch, retired members included (their
        books reference those params): the checkpoint GC's pin set."""
        return sorted({m.epoch for m in self.members.values() if m.epoch > 0})

    # -- persistence ------------------------------------------------------------

    def _path(self) -> str:
        return os.path.join(self.model_dir, LEAGUE_NAME)

    def save(self) -> None:
        if not self.owner:
            return
        payload = {
            "version": 1,
            "promotions": self.promotions,
            "members": [asdict(m) for m in self.members.values()],
            "payoff": self.payoff.to_dict(),
        }
        atomic_write_bytes(self._path(), json.dumps(payload, indent=1, sort_keys=True).encode())

    def load(self) -> bool:
        """Restore a saved league; False when there is none.  Members whose
        snapshots fail digest verification are dropped loudly; their books
        are kept."""
        try:
            with open(self._path()) as f:
                payload = json.load(f)
        except FileNotFoundError:
            return False
        except OSError as exc:
            # the file exists but cannot be read: a fresh anchor-only league
            # would empty the GC pin set and let gc_snapshots delete the
            # frozen members' snapshots
            raise RuntimeError(
                f"{self._path()} exists but cannot be read "
                f"({type(exc).__name__}: {exc}); refusing to start a fresh "
                "league over an unreadable registry (its frozen members' "
                "snapshots would be GC'd)"
            )
        except ValueError as exc:
            raise RuntimeError(
                f"{self._path()} is corrupt ({exc}); the league registry is "
                "atomic-write — inspect the model dir (delete the file to "
                "explicitly start a fresh league)"
            )
        self.promotions = int(payload.get("promotions", 0))
        self.payoff = PayoffMatrix.from_dict(payload.get("payoff", {}))
        self.members = {}
        for raw in payload.get("members", []):
            member = Member(
                str(raw["name"]), int(raw["epoch"]), str(raw.get("role", "frozen")),
                int(raw.get("frozen_at_step", 0)),
            )
            if member.epoch > 0 and verify_snapshot(self.model_dir, member.epoch) is False:
                print(
                    f"[handyrl_tpu_torch] league: dropping member {member.name!r} — "
                    f"snapshot {member.epoch}.ckpt fails digest verification "
                    "(its payoff books are kept)"
                )
                continue
            self.members[member.name] = member
        if ANCHOR not in self.members:
            self.members[ANCHOR] = Member(ANCHOR, 0, "anchor")
        return True
