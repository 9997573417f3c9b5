"""The port's sequence-parallel attention against dense attention and the
JAX package's, in gloo groups of 2 and 4 CPU processes.

Each group (``tests/torch_fixtures/parallel_workers.py::context_cases``,
one per size, started once for the module) runs ``make_sp_attention`` with
``impl`` ``"ring"``, ``"ulysses"`` and ``"ulysses-flash"`` (the flash
kernels' plain version on the CPU), causal and not, with and without
``kv_len`` padding. Each rank passes rows of its own, drawn from a numpy
seed and its rank (as a data-parallel fit's ranks do), and gets its own
rows' output back. Oracles, float32 at atol 1e-5 / rtol 1e-5:

- the port's ``full_attention`` on each rank's rows;
- the JAX package's ``make_sp_attention`` on a 2- or 4-device CPU mesh
  over every rank's rows as one global batch (its Pallas kernels in
  interpret mode for ``ulysses-flash``, as ``tests/test_ops.py`` runs
  them);
- ring and Ulysses-flash gradients of ``(out ** 2).sum()`` against dense
  attention's, at atol 1e-4.

Also ``pad_tokens_for_sp`` over an odd token count and the error for heads
that do not divide by the group's size.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from sparkdl_tpu.parallel.context import make_sp_attention as jax_make_sp_attention
from sparkdl_tpu_torch.parallel.context import full_attention

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_fixtures")
sys.path.insert(0, FIXTURES)
import parallel_workers as pw  # noqa: E402
from dist_launch import run_group  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-4, rtol=0)
WORLDS = (2, 4)


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """Each group size's per-rank results, started once (in turn: a group
    of 4 and one of 2 at a time keep the suite's cores free)."""
    return {world: run_group(world, "parallel_workers:context_cases",
                             str(tmp_path_factory.mktemp(f"ctx{world}")), seed=0)
            for world in WORLDS}


def inputs(rank):
    """Rank ``rank``'s rows."""
    return [torch.from_numpy(a) for a in pw.qkv(rank)]


@pytest.mark.parametrize("case", pw.CONTEXT_CASES, ids=lambda c: f"{c[0]}-causal{c[1]}-kv{c[2]}")
@pytest.mark.parametrize("world", WORLDS)
def test_sp_attention_matches_full_attention(groups, world, case):
    impl, causal, kv_len = case
    for rank, result in enumerate(groups[world]):
        want = full_attention(*inputs(rank), causal=causal, kv_len=kv_len).numpy()
        np.testing.assert_allclose(result[case], want, err_msg=f"rank {rank}", **TOL)


@pytest.mark.parametrize("case", pw.CONTEXT_CASES, ids=lambda c: f"{c[0]}-causal{c[1]}-kv{c[2]}")
@pytest.mark.parametrize("world", WORLDS)
def test_sp_attention_matches_jax(groups, world, case):
    impl, causal, kv_len = case
    mesh = Mesh(np.asarray(jax.devices()[:world]), ("seq",))
    fn = jax_make_sp_attention(mesh, "seq", impl=impl, causal=causal, kv_len=kv_len)
    rows = [pw.qkv(rank) for rank in range(world)]
    want = np.asarray(fn(*(jnp.asarray(np.concatenate(t)) for t in zip(*rows))))
    got = np.concatenate([result[case] for result in groups[world]])
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("impl", ["ring", "ulysses-flash"])
@pytest.mark.parametrize("world", WORLDS)
def test_sp_gradients_match_full_attention(groups, world, impl):
    for rank, result in enumerate(groups[world]):
        leaves = [t.requires_grad_() for t in inputs(rank)]
        (full_attention(*leaves, causal=True) ** 2).sum().backward()
        for name, got, leaf in zip("qkv", result[("grad", impl)], leaves):
            np.testing.assert_allclose(got, leaf.grad.numpy(),
                                       err_msg=f"d{name}, rank {rank}", **GRAD_TOL)


@pytest.mark.parametrize("world", WORLDS)
def test_padded_token_count_matches_full_attention(groups, world):
    # S - 3 tokens divide by neither 2 nor 4: padded, the pad keys masked
    for rank, result in enumerate(groups[world]):
        odd = [t[:, :pw.S - 3] for t in inputs(rank)]
        np.testing.assert_allclose(result["padded"], full_attention(*odd).numpy(),
                                   err_msg=f"rank {rank}", **TOL)


@pytest.mark.parametrize("world", WORLDS)
def test_ulysses_rejects_indivisible_heads(groups, world):
    for result in groups[world]:
        assert "divisible" in result.get("indivisible", ""), result.get("indivisible")
