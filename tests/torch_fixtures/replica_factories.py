"""Zero-argument replica factories for the CPU tests of the replica plane.

A replica process builds its server from a ``module:callable`` name
(:class:`~sparkdl_tpu_torch.serving.replica.ReplicaSpec`), and the port's
demo factories build on the card unless told otherwise. These wrappers
build the same servers with ``device="cpu"`` and one intra-op thread;
a test ships them into its replicas with
``ReplicaSpec(factory="replica_factories:demo_server_plain",
pythonpath=(FIXTURES,))``. Importable without JAX."""

import os

import torch

from sparkdl_tpu_torch.serving import replica

#: the directory a ``ReplicaSpec.pythonpath`` names to import this module
FIXTURES = os.path.dirname(os.path.abspath(__file__))


def spec(name: str, **kw):
    """A :class:`ReplicaSpec` for the factory ``name`` of this module."""
    return replica.ReplicaSpec(factory=f"replica_factories:{name}", pythonpath=(FIXTURES,),
                               **kw)


def _cpu() -> str:
    torch.set_num_threads(1)
    return "cpu"


def demo_server_plain():
    return replica.demo_server_plain(device=_cpu())


def demo_server_decode():
    return replica.demo_server_decode(device=_cpu())
