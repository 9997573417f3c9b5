"""sparkdl_tpu_torch.serving: online model serving on the card.

Port of ``sparkdl_tpu.serving``'s device half: a dynamic micro-batcher that
admits concurrent single-item requests into a slot block (or, padded, into
shape buckets) and runs them through compiled programs
(:class:`ProgramCache` over the engine), a continuous-batching decode plane
on a slot pool, admission control with typed load shedding, per-tenant fair
shares and deadlines, and ``serving.*`` metrics in
:mod:`sparkdl_tpu_torch.utils.metrics`; :class:`ModelServer` is the front
door.

The replica plane runs each ``ModelServer`` in a process of its own
behind a router: :class:`ReplicaSupervisor` spawns and restarts
:class:`ReplicaSpec` replicas, the :class:`Router` places requests on them
over the typed wire (TCP or a shared-memory ring), :class:`ResultCache`
answers repeats, :class:`Autoscaler` sizes the fleet and
:class:`RolloutController` moves traffic from one version of the fleet to
the next behind a canary SLO, or rolls it back. Its names load lazily, on
first use.
"""

from sparkdl_tpu_torch.serving.admission import AdmissionQueue, Request, TenantPolicy
from sparkdl_tpu_torch.serving.batcher import MicroBatcher, ServingConfig
from sparkdl_tpu_torch.serving.cache import ProgramCache
from sparkdl_tpu_torch.serving.decode import ClientGone, DecodeEndpoint, DecodeRequest
from sparkdl_tpu_torch.serving.errors import (
    DeadlineExceeded,
    NoLiveReplicas,
    RemoteReplicaError,
    ReplicaDraining,
    ServerClosed,
    ServerOverloaded,
    ServingError,
    TenantThrottled,
)
from sparkdl_tpu_torch.serving.server import ModelServer

__all__ = [
    "AdmissionQueue",
    "ClientGone",
    "DeadlineExceeded",
    "DecodeEndpoint",
    "DecodeRequest",
    "MicroBatcher",
    "ModelServer",
    "NoLiveReplicas",
    "ProgramCache",
    "RemoteReplicaError",
    "ReplicaDraining",
    "Request",
    "ServerClosed",
    "ServerOverloaded",
    "ServingConfig",
    "ServingError",
    "TenantPolicy",
    "TenantThrottled",
]

#: the replica plane's classes, by the module that defines them: they pull
#: in subprocess and socket machinery, so they load only when asked for
_REPLICA_PLANE = {
    "Autoscaler": "sparkdl_tpu_torch.serving.autoscale",
    "ReplicaSpec": "sparkdl_tpu_torch.serving.replica",
    "ReplicaSupervisor": "sparkdl_tpu_torch.serving.supervisor",
    "ResultCache": "sparkdl_tpu_torch.serving.result_cache",
    "RolloutController": "sparkdl_tpu_torch.serving.rollout",
    "Router": "sparkdl_tpu_torch.serving.router",
}


def __getattr__(name):
    if name in _REPLICA_PLANE:
        import importlib

        return getattr(importlib.import_module(_REPLICA_PLANE[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
