"""The port's data-parallel step, device slices and mesh placement.

- **DP step** in a gloo group of 2 CPU processes
  (``tests/torch_fixtures/parallel_workers.py::dp_cases``): each rank's
  share of one global batch (8 rows, the last 3 zero-weight padding, so
  rank 1 holds one real row) through ``make_train_step(..., mesh=...)``.
  Held only to the single-device step on the whole batch, never to the JAX
  package's DP tests (their gradient test fails on the reference): loss and
  gradients at rtol 1e-5 / atol 1e-6, weighted and unweighted, every rank
  the same.
- **loss over steps**: full-batch SGD of a tiny ViT, DP over the two ranks,
  against the JAX package's one-device ``make_train_step`` from the same
  converted weights (atol 1e-5 / rtol 1e-4, the ViT parity tests' bound).
- **placement**: the mesh branch of ``default_device_placer`` keeps each
  rank's contiguous rows (a leaf that does not split stays whole);
  ``runner.global_batch``, ``replicate`` (rank 0's values everywhere) and
  ``place_global`` (a rank's shard of a full value).
- **device slices**: ``partition_devices`` splits and its uneven-split
  error, ``device_slice`` and ``resolve_device``, ``make_mesh`` without a
  group, ``runner.initialize``'s refusals.
"""

import os
import sys
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh

from sparkdl_tpu.models import vit as jax_vit
from sparkdl_tpu.parallel.trainer import init_train_state as jax_init_train_state
from sparkdl_tpu.parallel.trainer import make_train_step as jax_make_train_step
from sparkdl_tpu_torch.models import vit as port_vit
from sparkdl_tpu_torch.models.convert import vit_state_dict_from_flax
from sparkdl_tpu_torch.parallel import runner, trainer
from sparkdl_tpu_torch.utils.device import resolve_device

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_fixtures")
sys.path.insert(0, FIXTURES)
import parallel_workers as pw  # noqa: E402
from dist_launch import run_group  # noqa: E402

DP_TOL = dict(rtol=1e-5, atol=1e-6)
LOSS_TOL = dict(atol=1e-5, rtol=1e-4)
VARIANT = "ViT-dp-test"
GEOMETRY = (8, 64, 2, 2, 128)
IMAGE, CLASSES, ROWS, STEPS = 16, 3, 8, 3


@pytest.fixture(scope="module")
def vit_case():
    """The tiny ViT's PRNGKey(0) weights and its rows."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jax_vit.VIT_VARIANTS, VARIANT, GEOMETRY)
        mp.setitem(port_vit.VIT_VARIANTS, VARIANT, GEOMETRY)
        module = jax_vit.ViT(variant=VARIANT, num_classes=CLASSES, image_size=IMAGE)
        params = module.init(jax.random.PRNGKey(0), np.zeros((1, IMAGE, IMAGE, 3), np.float32))
        rng = np.random.RandomState(5)
        x = rng.rand(ROWS, IMAGE, IMAGE, 3).astype(np.float32)
        y = (np.arange(ROWS) % CLASSES).astype(np.int32)
        yield module, params, x, y


@pytest.fixture(scope="module")
def group(vit_case, tmp_path_factory):
    _, params, x, y = vit_case
    vit = (VARIANT, GEOMETRY, vit_state_dict_from_flax(params), x, y, STEPS)
    return run_group(2, "parallel_workers:dp_cases", str(tmp_path_factory.mktemp("dp")),
                     seed=0, vit=vit)


@pytest.mark.parametrize("weighted", [True, False], ids=["weighted", "unweighted"])
def test_dp_step_gradients_equal_the_single_device_step(group, weighted):
    batch = pw.dp_batch(0)
    if not weighted:
        batch = {k: v for k, v in batch.items() if k != "w"}
    loss, grads, after = pw.one_step(pw.tiny_net(0), batch, weighted=weighted)
    key = "weighted" if weighted else "unweighted"
    for rank, result in enumerate(group):
        got_loss, got_grads, got_after = result[key]
        np.testing.assert_allclose(got_loss, loss, err_msg=f"rank {rank}", **DP_TOL)
        for name in grads:
            np.testing.assert_allclose(got_grads[name], grads[name],
                                       err_msg=f"{name}, rank {rank}", **DP_TOL)
            np.testing.assert_allclose(got_after[name], after[name],
                                       err_msg=f"{name}, rank {rank}", **DP_TOL)


def test_the_ragged_batch_gives_rank_1_one_real_row():
    # the case above is ragged: rank 0 holds rows 0-3, rank 1 row 4 and
    # three zero-weight pad rows
    w = pw.DP_WEIGHTS.reshape(2, 4)
    assert w[0].tolist() == [1, 1, 1, 1] and w[1].tolist() == [1, 0, 0, 0]


def test_dp_losses_over_steps_match_the_jax_one_device_step(group, vit_case):
    module, params, x, y = vit_case

    def per_sample(p, batch):
        logits = module.apply(p, batch["x"])
        return optax.softmax_cross_entropy_with_integer_labels(logits, batch["y"])

    tx = optax.sgd(0.05)
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    step = jax_make_train_step(per_sample, tx, mesh, donate=False, weighted=True)
    state = jax_init_train_state(jax.tree_util.tree_map(jnp.asarray, params), tx)
    batch = {"x": jnp.asarray(x), "y": jnp.asarray(y), "w": jnp.ones(ROWS, jnp.float32)}
    want = []
    for _ in range(STEPS):
        state, loss = step(state, batch)
        want.append(float(loss))
    for result in group:
        np.testing.assert_allclose(result["vit_losses"], want, **LOSS_TOL)


def test_the_mesh_placer_keeps_each_ranks_rows(group):
    x = pw.dp_batch(0)["x"].numpy()
    for rank, result in enumerate(group):
        np.testing.assert_array_equal(result["placed"]["x"], x[4 * rank:4 * rank + 4])
        # three rows do not split over two ranks: placed whole
        np.testing.assert_array_equal(result["placed"]["odd"], np.arange(3))


def test_runner_places_global_batches_and_replicas(group):
    for rank, result in enumerate(group):
        got = result["runner"]
        # two ranks' (2, 3) rows make one (4, 3) batch sharded on "data"
        assert got["global_shape"] == (4, 3)
        np.testing.assert_array_equal(got["global"], np.repeat([[0.0], [1.0]], 2, axis=0)
                                      * np.ones((4, 3)))
        np.testing.assert_array_equal(got["replicated"], np.ones(4))
        np.testing.assert_array_equal(got["a_local"],
                                      np.arange(8.0).reshape(4, 2)[2 * rank:2 * rank + 2])
        np.testing.assert_array_equal(got["b_local"], np.arange(3.0))


def test_partition_devices_splits_and_errors():
    cpus = [torch.device("cpu")] * 4
    assert trainer.partition_devices(2, cpus) == [cpus[:2], cpus[2:]]
    assert trainer.partition_devices(1, cpus) == [cpus]
    cards = [torch.device("cuda", i) for i in range(4)]
    assert trainer.partition_devices(4, cards) == [[c] for c in cards]
    with pytest.raises(ValueError, match="4 devices do not partition into 3 equal slices"):
        trainer.partition_devices(3, cpus)
    with pytest.raises(ValueError, match="k must be >= 1"):
        trainer.partition_devices(0, cpus)
    with pytest.raises(ValueError, match="0 devices"):
        trainer.partition_devices(1, [])


def test_a_device_slice_is_the_threads_card():
    seen = {}

    def trial(name, devices):
        trainer.bind_device_slice(devices)
        seen[name] = (trainer.current_device_slice(), resolve_device(None))

    threads = [threading.Thread(target=trial, args=(n, [torch.device("cpu")]))
               for n in ("a", "b")]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert seen == {n: ([torch.device("cpu")], torch.device("cpu")) for n in "ab"}
    # the binding is the thread's own, and a scope restores the old one
    assert trainer.current_device_slice() is None
    with trainer.device_slice(["cpu"]):
        assert resolve_device(None) == torch.device("cpu")
        assert resolve_device("cpu") == torch.device("cpu")
    assert trainer.current_device_slice() is None
    with trainer.device_slice(["cpu", "cpu"]):
        with pytest.raises(ValueError, match="bound to 2 devices"):
            resolve_device(None)


def test_a_mesh_needs_a_process_group():
    assert not runner.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        trainer.make_mesh()


def test_initialize_refuses_without_a_card_or_an_address(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        runner.initialize()
    with pytest.raises(ValueError, match="coordinator address"):
        runner.initialize(num_processes=2, process_id=0, device="cpu")
    assert not runner.is_initialized()
    assert runner.host_shard_indices(7, 1, 3).tolist() == [1, 4]
