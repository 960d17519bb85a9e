"""The port's own copies of the Nexus core: host I/O, the worker node and
the density simulator.

Copies of their ``repro.core`` namesakes (jax-free Python), trimmed only
of code the port's paths cannot reach, each saying what it left out:
``metrics``, ``transport``, ``fabric``, ``storage``, ``streaming``,
``arena``, ``planes`` (the vsock control plane, 4 KB message bound),
``credentials``, ``hints``, ``ratelimit``, ``cache`` (the SharedCache),
``backend``, ``faults`` (the FaultPlane and its `FaultInjector`),
``guardrails``, ``workloads`` (the paper suite, the multi-I/O scenarios,
the chaos suite and the MLServe suite), ``plan``, ``lifecycle``,
``supervisor``, ``frontend``, ``analysis`` (PlanCheck: ProfileInfer,
PlanVerify, its mutation suite and matrix driver), ``runtime`` (the
worker node), ``trace`` (Azure-like MMPP arrival generation), ``fluid``
(the mean-value bracket of the density search), ``des`` (the
virtual-time cluster simulator for density sweeps, paper §7.1) and
``cluster`` (fleet-scale dispatch over per-node density simulators);
``calibrate`` is the read side of the MLServe calibration, with a
byte-identical copy of its ``calibration.json``. Every constant keeps the
reference's value. The package exports what ``repro.core`` exports.
"""
from repro_torch.core.backend import NexusBackend
from repro_torch.core.frontend import (BaselineClient, GuestContext,
                                       HandlerContext, NexusClient, S3Api)
from repro_torch.core.plan import PhasePlan, SYSTEMS, SystemSpec, compile_plan
from repro_torch.core.runtime import WorkerNode
from repro_torch.core.storage import ObjectStore
from repro_torch.core.workloads import (ComputeSegment, Get, IOProfile, Put,
                                        REGISTRY, SCENARIOS, SUITE, Workload)

__all__ = [
    "NexusBackend", "BaselineClient", "GuestContext", "NexusClient",
    "HandlerContext", "S3Api",
    "PhasePlan", "SYSTEMS", "SystemSpec", "compile_plan",
    "WorkerNode", "ObjectStore",
    "ComputeSegment", "Get", "IOProfile", "Put",
    "REGISTRY", "SCENARIOS", "SUITE", "Workload",
]
