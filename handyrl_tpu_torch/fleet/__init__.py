"""The fleet tier's server-resident session cache.  The fleet router, the
edge replica and the autoscaler wait for ROADMAP A10."""

from .sessions import SessionCache

__all__ = ["SessionCache"]
