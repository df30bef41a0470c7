"""Elastic serving fleet over the port's engine: replica groups behind a
router, hot weight swap from committed checkpoints, preemption-safe
sequence failover, the prefill/decode role split with KV handoff, and
the supervisor. The counterpart of ``paddle_tpu/serving``, module for
module:

    Router ──place (least-load + prefix-affinity)──► LocalReplica /
      │ health: heartbeats on the store              ProcessReplica
      │ failover: re-place the journaled sequence      │ engine
      ▼ exactly-once: resume at the delivery cursor    ▼ WeightWatcher
    consumers (stream of token ids)                  committed LATEST

Entry points:

- ``Router``               — request surface (stream/generate) + fleet
                             membership, placement, health, failover,
                             role-split prefill/decode routing and
                             drain-with-transfer
- ``LocalReplica``         — in-process replica (tests, single-box)
- ``ProcessReplica``       — subprocess replica
                             (``python -m paddle_tpu_torch.serving.worker``;
                             real SIGKILL drills)
- ``WeightWatcher``        — committed-LATEST hot weight swap
- ``FileStore``            — shared-dir heartbeat store (TCPStore API,
                             + delete/CAS/TTL-sweep verbs)
- ``PrefixStore``          — fleet-tier spill store for evicted prefix
                             KV pages (kv_transfer.py: the kvpages/v1
                             codec, byte-compatible with the JAX
                             package's, + two-tier content-addressed
                             store)
- ``Supervisor``           — the fleet autopilot: doctor findings + SLO
                             attainment -> bounded remediation (replace /
                             quarantine / scale) through the router's
                             spawn/drain/remove verbs
- ``MeshGenerationEngine`` — tensor-parallel serving: one device mesh
                             behind one replica (``make_mesh``,
                             ``param_spec``; mesh_engine.py)
"""

from .store import FileStore  # noqa: F401
from .kv_transfer import (  # noqa: F401
    PrefixStore, pack_pages, unpack_pages, unpack_scales, KV_SCHEMA,
)
from .replica import (  # noqa: F401
    LocalReplica, ProcessReplica, ReplicaDeadError, WeightWatcher,
    HeartbeatPublisher, HB_KEY_PREFIX,
)
from .router import (  # noqa: F401
    Router, NoLiveReplicaError, RequestShedError, HedgePolicy,
)
from .supervisor import (  # noqa: F401
    Supervisor, SupervisorPolicy,
)
from .mesh_engine import (  # noqa: F401
    MeshGenerationEngine, make_mesh, param_spec,
)

__all__ = [
    "Router", "NoLiveReplicaError", "RequestShedError", "HedgePolicy",
    "LocalReplica",
    "ProcessReplica", "ReplicaDeadError", "WeightWatcher",
    "HeartbeatPublisher", "FileStore", "HB_KEY_PREFIX",
    "PrefixStore", "pack_pages", "unpack_pages", "unpack_scales",
    "KV_SCHEMA",
    "Supervisor", "SupervisorPolicy",
    "MeshGenerationEngine", "make_mesh", "param_spec",
]
