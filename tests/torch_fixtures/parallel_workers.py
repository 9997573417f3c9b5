"""Rank functions of the port's parallel tests, run by :mod:`dist_launch`
in gloo groups of CPU processes. Each takes plain arguments, builds its
inputs from numpy seeds (the test process builds the same ones for its
oracles) and returns numpy arrays. Imports torch and the port only."""

import numpy as np
import torch

from sparkdl_tpu_torch.parallel import runner

#: the context cases' shapes: heads divide by 2 and 4; seq by 2 and 4
B, S, H, D = 2, 32, 4, 32


def qkv(seed: int, shape=(B, S, H, D)):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(3)]


CONTEXT_CASES = [(impl, causal, kv_len)
                 for impl in ("ring", "ulysses", "ulysses-flash")
                 for causal in (False, True)
                 for kv_len in (None, 27)]


def context_cases(seed: int = 0):
    """Every ``make_sp_attention`` case of :data:`CONTEXT_CASES` over the
    whole group's ``seq`` mesh, ring and ulysses-flash gradients of
    ``(out ** 2).sum()``, ``pad_tokens_for_sp`` over an odd token count,
    and the indivisible-heads error. Each rank passes its own rows,
    ``qkv(seed + rank)``, as in a data-parallel fit."""
    from sparkdl_tpu_torch.parallel.context import (
        make_sp_attention,
        pad_tokens_for_sp,
        ulysses_attention,
    )

    mesh = runner.make_global_mesh(("seq",))
    q, k, v = (torch.from_numpy(a) for a in qkv(seed + runner.process_index()))
    out = {}
    for impl, causal, kv_len in CONTEXT_CASES:
        fn = make_sp_attention(mesh, "seq", impl=impl, causal=causal, kv_len=kv_len)
        out[(impl, causal, kv_len)] = fn(q, k, v).numpy()
    for impl in ("ring", "ulysses-flash"):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        fn = make_sp_attention(mesh, "seq", impl=impl, causal=True)
        (fn(*leaves) ** 2).sum().backward()
        out[("grad", impl)] = [t.grad.numpy() for t in leaves]
    odd = [t[:, :S - 3] for t in (q, k, v)]
    out["padded"] = pad_tokens_for_sp(mesh, "seq", impl="ulysses").__call__(*odd).numpy()
    n = runner.process_count()
    few = torch.zeros((1, 2 * n, n // 2 if n > 2 else 1, D))
    try:
        ulysses_attention(few, few, few, group=mesh.get_group("seq"))
    except ValueError as exc:
        out["indivisible"] = str(exc)
    return out


# ----------------------------------------------------------------------
# the data-parallel step
# ----------------------------------------------------------------------
#: the DP cases' global batch: 8 rows, the last 3 zero-weight padding (a
#: ragged batch: with 4 ranks, rank 2 holds one real row, rank 3 none)
DP_ROWS = 8
DP_WEIGHTS = np.array([1, 1, 1, 1, 1, 0, 0, 0], np.float32)


def tiny_net(seed: int) -> torch.nn.Module:
    """Dense(8 -> 16) -> relu -> Dense(16 -> 4), weights from a numpy seed."""
    rng = np.random.RandomState(seed)
    net = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.ReLU(), torch.nn.Linear(16, 4))
    with torch.no_grad():
        for p in net.parameters():
            p.copy_(torch.from_numpy(rng.randn(*p.shape).astype(np.float32) * 0.5))
    return net


def dp_batch(seed: int):
    rng = np.random.RandomState(seed + 1)
    return {"x": torch.from_numpy(rng.randn(DP_ROWS, 8).astype(np.float32)),
            "y": torch.from_numpy(rng.randint(0, 4, DP_ROWS)),
            "w": torch.from_numpy(DP_WEIGHTS)}


def per_sample_ce(module, batch):
    return torch.nn.functional.cross_entropy(module(batch["x"]), batch["y"], reduction="none")


def mean_ce(module, batch):
    return per_sample_ce(module, batch).mean()


def one_step(net, batch, mesh=None, weighted=True):
    """One SGD step of ``make_train_step``: (loss, gradients, weights after)."""
    from sparkdl_tpu_torch.parallel.trainer import init_train_state, make_train_step

    state = init_train_state(net, lambda ps: torch.optim.SGD(ps, lr=0.1))
    step = make_train_step(per_sample_ce if weighted else mean_ce, mesh=mesh, weighted=weighted)
    state, loss = step(state, batch)
    return (float(loss), {n: p.grad.numpy().copy() for n, p in net.named_parameters()},
            {n: p.detach().numpy().copy() for n, p in net.named_parameters()})


def dp_cases(seed: int = 0, vit=None):
    """The DP step's loss and gradients on this rank's share of
    :func:`dp_batch`, weighted (the ragged batch) and unweighted (every
    row, equal shares); the mesh-branch placer's rows; with ``vit`` (a
    ``(variant, geometry, state_dict, x, y, steps)`` tuple) the losses of
    full-batch SGD steps of a ViT."""
    from sparkdl_tpu_torch.data.device import default_device_placer
    from sparkdl_tpu_torch.parallel.trainer import make_mesh, shard_batch

    mesh = make_mesh()
    batch = dp_batch(seed)
    out = {"weighted": one_step(tiny_net(seed), shard_batch(batch, mesh), mesh)}
    unweighted = {k: v for k, v in batch.items() if k != "w"}
    out["unweighted"] = one_step(tiny_net(seed), shard_batch(unweighted, mesh), mesh,
                                 weighted=False)
    placer = default_device_placer(["cpu"] * runner.process_count())
    out["placed"] = placer({"x": batch["x"].numpy(), "odd": np.arange(3)})
    out["placed"] = {k: v.numpy() for k, v in out["placed"].items()}
    out["runner"] = runner_cases(mesh)
    if vit is not None:
        out["vit_losses"] = vit_losses(mesh, *vit)
    return out


def runner_cases(mesh):
    """``global_batch``, ``replicate`` and ``place_global`` on this rank."""
    from torch.distributed.tensor import Replicate, Shard

    rank = runner.process_index()
    local = np.full((2, 3), float(rank), np.float32)
    batch = runner.global_batch({"x": local}, mesh)["x"]
    # each rank starts from other numbers; replicate gives rank 0's
    tree = {"w": torch.full((4,), float(rank + 1))}
    runner.replicate(tree, mesh)
    full = {"a": torch.arange(8.0).reshape(4, 2), "b": torch.arange(3.0)}
    placed = runner.place_global(full, mesh, {"a": [Shard(0)], "b": [Replicate()]})
    return {"global_shape": tuple(batch.shape), "global": batch.full_tensor().numpy(),
            "replicated": tree["w"].numpy(),
            "a_local": placed["a"].to_local().numpy(), "b_local": placed["b"].to_local().numpy()}


def vit_losses(mesh, variant, geometry, state_dict, x, y, steps):
    """Full-batch SGD steps of a tiny ViT, DP over ``mesh``: each rank its
    contiguous share of the rows."""
    from sparkdl_tpu_torch.models.vit import VIT_VARIANTS, ViT
    from sparkdl_tpu_torch.parallel.trainer import init_train_state, make_train_step, shard_batch

    VIT_VARIANTS[variant] = geometry
    model = ViT(variant, num_classes=int(y.max()) + 1, image_size=x.shape[1])
    model.load_state_dict(state_dict)
    state = init_train_state(model, lambda ps: torch.optim.SGD(ps, lr=0.05))
    step = make_train_step(per_sample_ce, mesh=mesh)
    batch = shard_batch({"x": torch.from_numpy(x), "y": torch.from_numpy(y).long(),
                         "w": torch.ones(len(y))}, mesh)
    return [float(step(state, batch)[1]) for _ in range(steps)]


# ----------------------------------------------------------------------
# the estimators in a group
# ----------------------------------------------------------------------
def _frame(rows, label_key="label"):
    from sparkdl_tpu_torch.sql.session import TorchSession

    return TorchSession.builder.getOrCreate().createDataFrame(
        [{"uri": u, label_key: l} for u, l in rows])


def vit_fits(rows, variant, geometry, num_classes, image_size, fit_params, initial,
             mesh_shape=None, checkpoint_dir=None, dp=True, foreach=False, resume_dir=None,
             sp_impl=None):
    """``TorchImageFileEstimator`` fits of a tiny ViT over the group: DP
    (with ``dp``) and, with ``mesh_shape``, DP x TP under ``VIT_TP_RULES``.
    ``foreach`` makes the optimizer SGD's multi-tensor update, a card's
    default. With ``sp_impl``, a DP fit whose attention is
    ``pad_tokens_for_sp`` over the whole group with that ``impl``
    (``"sp"``). With ``resume_dir``, a DP x TP adam fit of one epoch
    checkpointed there and resumed to two (``"resumed"``), and the same two
    epochs uninterrupted (``"straight"``). Returns each fit's step losses and
    its fitted weights."""
    from sparkdl_tpu_torch.estimators import TorchImageFileEstimator
    from sparkdl_tpu_torch.models.vit import VIT_VARIANTS, ViT
    from sparkdl_tpu_torch.parallel.context import pad_tokens_for_sp
    from sparkdl_tpu_torch.parallel.tp import VIT_TP_RULES

    VIT_VARIANTS[variant] = geometry
    df = _frame(rows)
    lr = fit_params["learning_rate"]
    optimizer = (lambda ps: torch.optim.SGD(ps, lr=lr, foreach=True)) if foreach else "sgd"

    def fit(attn_impl="full", **kw):
        fitted = TorchImageFileEstimator(
            inputCol="uri", outputCol="out", labelCol="label", imageLoader=np.load,
            module=ViT(variant, num_classes=num_classes, image_size=image_size,
                       attn_impl=attn_impl),
            optimizer=optimizer, fitParams=dict(fit_params), initialVariables=initial,
            device="cpu", **kw).fit(df)
        return {"losses": list(fitted._training_losses),
                "weights": {k: v.numpy() for k, v in fitted.module.state_dict().items()}}

    out = {}
    if dp:
        out["dp"] = fit()
    if sp_impl is not None:
        mesh = runner.make_global_mesh(("seq",))
        out["sp"] = fit(attn_impl=pad_tokens_for_sp(mesh, "seq", impl=sp_impl))
    if mesh_shape is not None:
        out["tp"] = fit(shardingRules=VIT_TP_RULES, meshShape=tuple(mesh_shape),
                        checkpointDir=checkpoint_dir)
    if resume_dir is not None:
        optimizer = "adam"
        tp = dict(shardingRules=VIT_TP_RULES, meshShape=tuple(mesh_shape))
        fit_params = dict(fit_params, epochs=1)
        fit(checkpointDir=resume_dir, **tp)
        fit_params["epochs"] = 2
        out["resumed"] = fit(checkpointDir=resume_dir, **tp)
        out["straight"] = fit(**tp)
    return out


def keras_phases(model_dir, rows, bn_rows, fit_params, bn_fit_params, tp=None):
    """The JAX package's multi-host worker phases, on this rank of the
    group: ``KerasImageFileEstimator`` fits of the Dense model in memory and
    streaming, each rank's transform of its own shard, the BN CNN fit, and
    with ``tp`` (``vit_fits``'s keyword arguments) a DP x TP ViT fit."""
    import os

    from sparkdl_tpu_torch.estimators import KerasImageFileEstimator
    from sparkdl_tpu_torch.models.keras_model import read_keras_file
    from sparkdl_tpu_torch.transformers.keras_image import KerasImageFileTransformer

    def keras_fit(model, data, params, **kw):
        fitted = KerasImageFileEstimator(
            inputCol="uri", outputCol="out", labelCol="label", imageLoader=np.load,
            modelFile=os.path.join(model_dir, model), kerasOptimizer="sgd", kerasLoss="mse",
            kerasFitParams=dict(params), device="cpu", **kw).fit(_frame(data))
        return flat_weights(read_keras_file(fitted.getModelFile())[1])

    out = {"fit": keras_fit("model.keras", rows, fit_params),
           "streaming": keras_fit("model.keras", rows, dict(fit_params, streaming=True)),
           "bn": keras_fit("bn_model.keras", bn_rows, bn_fit_params)}
    keep = runner.host_shard_indices(len(rows))
    shard = [{"uri": rows[i][0]} for i in keep]
    from sparkdl_tpu_torch.sql.session import TorchSession

    t = KerasImageFileTransformer(inputCol="uri", outputCol="out",
                                  modelFile=os.path.join(model_dir, "model.keras"),
                                  imageLoader=np.load, device="cpu")
    got = t.transform(TorchSession.builder.getOrCreate().createDataFrame(shard)).collect()
    out["transform"] = {"indices": keep,
                        "outputs": np.stack([np.asarray(r["out"].toArray()) for r in got])}
    if tp is not None:
        out["tp"] = vit_fits(**tp)
    return out


def flat_weights(weights, prefix=()):
    """A Keras weight tree as ``{(layer path..., index): array}``."""
    out = {}
    for name, arrays in weights.items():
        if isinstance(arrays, dict):
            out.update(flat_weights(arrays, prefix + (name,)))
        else:
            out.update({prefix + (name, i): np.asarray(a) for i, a in enumerate(arrays)})
    return out


def keras_checkpointed_fit(model_dir, rows, fit_params, checkpoint_dir, tp=None):
    """A checkpointed Dense-model fit (the elastic-restart case; the group
    may be killed mid-fit), and with ``tp`` a checkpointed DP x TP ViT fit.
    Returns the weights and the epoch each fit resumed from."""
    import logging
    import os

    from sparkdl_tpu_torch.estimators import KerasImageFileEstimator
    from sparkdl_tpu_torch.models.keras_model import read_keras_file

    resumed = []

    class Resumed(logging.Handler):
        def emit(self, record):
            if record.getMessage().startswith("resuming from checkpoint epoch"):
                resumed.append(int(record.getMessage().rsplit(" ", 1)[1]))

    logger = logging.getLogger("sparkdl_tpu_torch.estimators.checkpointing")
    logger.setLevel(logging.INFO)
    logger.addHandler(Resumed())
    fitted = KerasImageFileEstimator(
        inputCol="uri", outputCol="out", labelCol="label", imageLoader=np.load,
        modelFile=os.path.join(model_dir, "model.keras"), kerasOptimizer="sgd",
        kerasLoss="mse", kerasFitParams=dict(fit_params), checkpointDir=checkpoint_dir,
        device="cpu").fit(_frame(rows))
    out = {"weights": flat_weights(read_keras_file(fitted.getModelFile())[1]),
           "resumed": list(resumed)}
    if tp is not None:
        resumed.clear()
        out["tp"] = vit_fits(**tp)
        out["tp_resumed"] = list(resumed)
    return out
