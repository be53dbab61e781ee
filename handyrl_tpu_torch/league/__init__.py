"""League bookkeeping: the payoff ledger (``PayoffMatrix``) that network
battles record into.  Population training waits for ROADMAP A10."""

from .matchmaker import PayoffMatrix

__all__ = ["PayoffMatrix"]
