"""Distributed-execution pieces of the port: the straggler model the
service simulates arrivals with, and the fault runtime -- seeded fault
plans and their injector, per-worker health and deadlines, elastic
membership, and the measured thread-per-worker runtime.  Moving state
across device meshes (``reshard``, ``reshard_like``) waits for the
multi-device runtime and raises ``NotImplementedError``."""

from repro_torch.distributed.elastic import (
    ElasticWorkerPool,
    reshard,
    reshard_like,
)
from repro_torch.distributed.faults import (
    FAULT_KINDS,
    FaultInjector,
    FaultPlan,
    RoundFaults,
    WorkerFault,
)
from repro_torch.distributed.health import WorkerHealthTracker
from repro_torch.distributed.straggler import (
    StragglerModel,
    expected_kth_completion,
)
from repro_torch.distributed.worker_runtime import (
    MeasuredRound,
    MeasuredWorkerRuntime,
)

__all__ = [
    "ElasticWorkerPool",
    "FAULT_KINDS",
    "FaultInjector",
    "FaultPlan",
    "MeasuredRound",
    "MeasuredWorkerRuntime",
    "RoundFaults",
    "StragglerModel",
    "WorkerFault",
    "WorkerHealthTracker",
    "expected_kth_completion",
    "reshard",
    "reshard_like",
]
