"""The fleet tier: the session-affinity router over N serving replicas, the
server-resident session cache, and the autoscaler.

Import order matters, as in the JAX package: ``serving.server`` imports
``fleet.sessions``, and ``router_tier`` imports ``serving.client``, so
``sessions`` comes first and everything here imports serving submodules,
never the ``serving`` package.  ``edge`` serves an exported artifact as
feed-forward capacity (``--edge``).
"""

from .sessions import SessionCache
from .router_tier import FleetRouter, ReplicaSpec, fleet_main
from .autoscale import AutoscaleDecider, Autoscaler, ProcessReplicaFactory
from .edge import EdgeReplica, edge_main

__all__ = [
    "AutoscaleDecider",
    "Autoscaler",
    "EdgeReplica",
    "FleetRouter",
    "ProcessReplicaFactory",
    "ReplicaSpec",
    "SessionCache",
    "edge_main",
    "fleet_main",
]
