"""The inference serving plane.

Counterpart of ``handyrl_tpu/serving``: continuous batching with deadlines
and load shedding (``ContinuousBatcher``), N resident snapshot engines and
ensembles with warm-then-flip hot swap (``ModelRouter``), and the network
front and its pipelined client (``ServingServer``, ``ServingClient``),
over the port's framed-socket transport and checkpoint manifest.
"""

from .batcher import (
    BadRequest,
    ContinuousBatcher,
    DeadlineExceeded,
    RequestShed,
    ServeError,
)
from .client import ServingClient, ServingError
from .router import EnsembleRoute, ModelRouter, RouteError
from .server import ServingServer, serve_main

__all__ = [
    "BadRequest",
    "ContinuousBatcher",
    "DeadlineExceeded",
    "RequestShed",
    "ServeError",
    "ServingClient",
    "ServingError",
    "EnsembleRoute",
    "ModelRouter",
    "RouteError",
    "ServingServer",
    "serve_main",
]
