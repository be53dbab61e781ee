"""The fleet tier: the session-affinity router over N serving replicas, the
server-resident session cache, and the autoscaler.

Import order matters, as in the JAX package: ``serving.server`` imports
``fleet.sessions``, and ``router_tier`` imports ``serving.client``, so
``sessions`` comes first and everything here imports serving submodules,
never the ``serving`` package.  The CPU edge replica waits for ROADMAP A10.
"""

from .sessions import SessionCache
from .router_tier import FleetRouter, ReplicaSpec, fleet_main
from .autoscale import AutoscaleDecider, Autoscaler, ProcessReplicaFactory

__all__ = [
    "AutoscaleDecider",
    "Autoscaler",
    "FleetRouter",
    "ProcessReplicaFactory",
    "ReplicaSpec",
    "SessionCache",
    "fleet_main",
]
