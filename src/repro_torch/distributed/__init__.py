"""Distribution substrate of the port: logical sharding rules, meshes on
``torch.distributed``, the SPMD coded runtime, moving state across meshes
(``reshard``, ``reshard_like``), the straggler model the service simulates
arrivals with, and the fault runtime -- seeded fault plans and their
injector, per-worker health and deadlines, elastic membership, and the
measured thread-per-worker runtime."""

from repro_torch.distributed.coded_runtime import (
    DistributedCodedFFT,
    DistributedCodedPlan,
)
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
from repro_torch.distributed.mesh import test_mesh
from repro_torch.distributed.sharding import (
    MULTI_POD_RULES,
    SINGLE_POD_RULES,
    current_mesh,
    logical_spec,
    lshard,
    named_sharding,
    use_rules,
)
from repro_torch.distributed.straggler import (
    StragglerModel,
    expected_kth_completion,
)
from repro_torch.distributed.worker_runtime import (
    MeasuredRound,
    MeasuredWorkerRuntime,
)

__all__ = [
    "DistributedCodedFFT",
    "DistributedCodedPlan",
    "ElasticWorkerPool",
    "FAULT_KINDS",
    "FaultInjector",
    "FaultPlan",
    "MULTI_POD_RULES",
    "MeasuredRound",
    "MeasuredWorkerRuntime",
    "RoundFaults",
    "SINGLE_POD_RULES",
    "StragglerModel",
    "WorkerFault",
    "WorkerHealthTracker",
    "current_mesh",
    "expected_kth_completion",
    "logical_spec",
    "lshard",
    "named_sharding",
    "reshard",
    "reshard_like",
    "test_mesh",
    "use_rules",
]
