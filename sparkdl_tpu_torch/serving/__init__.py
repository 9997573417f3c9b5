"""sparkdl_tpu_torch.serving: online model serving on the card.

Port of ``sparkdl_tpu.serving``'s device half: a dynamic micro-batcher that
admits concurrent single-item requests into a slot block (or, padded, into
shape buckets) and runs them through compiled programs
(:class:`ProgramCache` over the engine), a continuous-batching decode plane
on a slot pool, admission control with typed load shedding, per-tenant fair
shares and deadlines, and ``serving.*`` metrics in
:mod:`sparkdl_tpu_torch.utils.metrics`; :class:`ModelServer` is the front
door.

The replica plane (``ReplicaSupervisor``, ``ReplicaSpec``, ``Router``,
``Autoscaler``, ``RolloutController``, ``ResultCache``: the wire, transport,
router, supervisor, rollout, autoscale, result cache and faultnet modules)
is not ported yet: asking for one of its names raises ``AttributeError``
naming ROADMAP item 10b.
"""

from sparkdl_tpu_torch.serving.admission import AdmissionQueue, Request, TenantPolicy
from sparkdl_tpu_torch.serving.batcher import MicroBatcher, ServingConfig
from sparkdl_tpu_torch.serving.cache import ProgramCache
from sparkdl_tpu_torch.serving.decode import ClientGone, DecodeEndpoint, DecodeRequest
from sparkdl_tpu_torch.serving.errors import (
    DeadlineExceeded,
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
    "ProgramCache",
    "Request",
    "ServerClosed",
    "ServerOverloaded",
    "ServingConfig",
    "ServingError",
    "TenantPolicy",
    "TenantThrottled",
]

#: the replica plane's names, not ported yet
_REPLICA_PLANE = ("ReplicaSupervisor", "ReplicaSpec", "Router", "Autoscaler",
                  "RolloutController", "ResultCache", "NoLiveReplicas",
                  "RemoteReplicaError", "ReplicaDraining")


def __getattr__(name):
    if name in _REPLICA_PLANE:
        raise AttributeError(
            f"sparkdl_tpu_torch.serving.{name} belongs to the replica plane, which is not "
            "ported yet (ROADMAP item 10b)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
