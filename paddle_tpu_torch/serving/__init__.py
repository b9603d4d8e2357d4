"""Serving above the single engine (counterpart of paddle_tpu.serving):
``fleet.py``'s :class:`FleetRouter` makes N continuous-batching engines one
health-checked fleet with failover, tail hedging and graceful drain. The
router starts its threads only when constructed."""
from .fleet import (DOWN, DRAINING, HEALTHY, PARKED, SUSPECT, FleetRouter,  # noqa: F401
                    FleetUnavailable)

__all__ = ["FleetRouter", "FleetUnavailable", "HEALTHY", "SUSPECT", "DOWN", "DRAINING",
           "PARKED"]
