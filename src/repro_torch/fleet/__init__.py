"""In-process multi-replica serving: fleet index, router, fabric."""
from repro_torch.fleet.fabric import (FleetConfig, FleetFabric, FleetMetrics,
                                      build_fleet, replicate_model)
from repro_torch.fleet.index import FleetIndex
from repro_torch.fleet.router import POLICIES, Router, RouterConfig

__all__ = ["FleetConfig", "FleetFabric", "FleetMetrics", "FleetIndex",
           "POLICIES", "Router", "RouterConfig", "build_fleet",
           "replicate_model"]
