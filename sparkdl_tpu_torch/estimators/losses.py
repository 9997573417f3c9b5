"""Keras loss and optimizer names -> PyTorch losses and ``torch.optim``.

A trimmed copy of ``sparkdl_tpu.estimators.losses``: the per-sample losses
(Keras ``from_logits=False`` conventions: they consume the model's
*outputs*), their mean forms, their lookup, and every optimizer name of the
JAX package: ``torch.optim`` where its update is optax's at optax's
defaults (sgd, adam, adamw), :mod:`sparkdl_tpu_torch.estimators.optimizers`
for the rest. ``get_optimizer`` returns a factory
``params -> torch.optim.Optimizer``, the counterpart of an optax
transformation: the caller builds it over the parameters it trains.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch

from sparkdl_tpu_torch.estimators import optimizers
from sparkdl_tpu_torch.parallel.trainer import OptimizerFactory

_EPS = 1e-7


def _clip(p: torch.Tensor) -> torch.Tensor:
    return p.clamp(_EPS, 1.0 - _EPS)


def _reduce_sample_dims(x: torch.Tensor) -> torch.Tensor:
    """Mean over every axis but the leading batch axis -> shape (batch,)."""
    return x.reshape(x.shape[0], -1).mean(dim=-1)


# Per-sample forms: loss(y_true, y_pred) -> (batch,). The estimator uses
# them directly so padded rows in a ragged final batch are masked exactly.
def per_sample_categorical_crossentropy(y_true, y_pred):
    return _reduce_sample_dims(
        -(y_true * torch.log(_clip(y_pred))).sum(dim=-1)[..., None]
    )


def per_sample_sparse_categorical_crossentropy(y_true, y_pred):
    picked = torch.take_along_dim(
        _clip(y_pred), y_true.long()[..., None], dim=-1
    )[..., 0]
    return _reduce_sample_dims(-torch.log(picked)[..., None])


def per_sample_binary_crossentropy(y_true, y_pred):
    p = _clip(y_pred)
    return _reduce_sample_dims(
        -(y_true * torch.log(p) + (1.0 - y_true) * torch.log(1.0 - p))
    )


def per_sample_mean_squared_error(y_true, y_pred):
    return _reduce_sample_dims((y_pred - y_true) ** 2)


def per_sample_mean_absolute_error(y_true, y_pred):
    return _reduce_sample_dims((y_pred - y_true).abs())


def categorical_crossentropy(y_true, y_pred):
    return per_sample_categorical_crossentropy(y_true, y_pred).mean()


def sparse_categorical_crossentropy(y_true, y_pred):
    return per_sample_sparse_categorical_crossentropy(y_true, y_pred).mean()


def binary_crossentropy(y_true, y_pred):
    return per_sample_binary_crossentropy(y_true, y_pred).mean()


def mean_squared_error(y_true, y_pred):
    return ((y_pred - y_true) ** 2).mean()


def mean_absolute_error(y_true, y_pred):
    return (y_pred - y_true).abs().mean()


_LOSSES = {
    "categorical_crossentropy": categorical_crossentropy,
    "sparse_categorical_crossentropy": sparse_categorical_crossentropy,
    "binary_crossentropy": binary_crossentropy,
    "mean_squared_error": mean_squared_error,
    "mse": mean_squared_error,
    "mean_absolute_error": mean_absolute_error,
    "mae": mean_absolute_error,
}

_PER_SAMPLE_LOSSES = {
    "categorical_crossentropy": per_sample_categorical_crossentropy,
    "sparse_categorical_crossentropy": per_sample_sparse_categorical_crossentropy,
    "binary_crossentropy": per_sample_binary_crossentropy,
    "mean_squared_error": per_sample_mean_squared_error,
    "mse": per_sample_mean_squared_error,
    "mean_absolute_error": per_sample_mean_absolute_error,
    "mae": per_sample_mean_absolute_error,
}

# Keras default learning rates per optimizer name.
_DEFAULT_LR = {
    "sgd": 0.01,
    "adam": 0.001,
    "adamw": 0.001,
    "rmsprop": 0.001,
    "adagrad": 0.001,
    "nadam": 0.001,
    "lamb": 0.001,
    "lion": 1e-4,
}

# optax's defaults, under which torch.optim's update rules are optax's:
# adam/adamw b1=0.9, b2=0.999, eps=1e-8 (eps outside the square root in
# both), and adamw's decoupled weight_decay=1e-4 (torch's default is 1e-2).
_OPTIMIZERS = {
    "sgd": lambda params, lr: torch.optim.SGD(params, lr=lr),
    "adam": lambda params, lr: torch.optim.Adam(
        params, lr=lr, betas=(0.9, 0.999), eps=1e-8
    ),
    "adamw": lambda params, lr: torch.optim.AdamW(
        params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4
    ),
    # optax's updates that torch.optim does not reproduce
    "rmsprop": optimizers.OptaxRMSprop,
    "adagrad": optimizers.OptaxAdagrad,
    "nadam": optimizers.OptaxNadam,
    "lamb": optimizers.OptaxLamb,
    "lion": optimizers.OptaxLion,
}


def get_loss_fn(loss: Union[str, Callable]) -> Callable:
    """``loss(y_true, y_pred) -> scalar`` from a Keras loss name or callable."""
    if callable(loss):
        return loss
    name = loss.lower()
    if name not in _LOSSES:
        raise ValueError(f"Unknown loss {loss!r}; supported: {sorted(_LOSSES)}")
    return _LOSSES[name]


def get_per_sample_loss_fn(loss: Union[str, Callable]) -> Optional[Callable]:
    """``loss(y_true, y_pred) -> (batch,)`` per-sample losses for a known
    Keras loss name; ``None`` for custom callables (no per-sample form is
    derivable)."""
    if callable(loss):
        return None
    return _PER_SAMPLE_LOSSES.get(loss.lower())


def get_optimizer(
    optimizer, learning_rate: Optional[float] = None
) -> OptimizerFactory:
    """A factory ``params -> torch.optim.Optimizer`` from a Keras optimizer
    name (Keras-default lr unless overridden), or the caller's own factory
    passed through."""
    if callable(optimizer):
        return optimizer
    name = str(optimizer).lower()
    if name not in _OPTIMIZERS:
        raise ValueError(
            f"Unknown optimizer {optimizer!r}; supported: {sorted(_OPTIMIZERS)}"
        )
    lr = learning_rate if learning_rate is not None else _DEFAULT_LR[name]
    build = _OPTIMIZERS[name]
    return lambda params: build(params, lr=lr)
