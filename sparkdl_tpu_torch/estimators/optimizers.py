"""optax's rmsprop, adagrad, nadam, lamb and lion as ``torch.optim``
optimizers.

``torch.optim`` has no optimizer whose update is any of these optax
transformations at optax's defaults: its RMSprop and Adagrad put ``eps``
outside the square root (and Adagrad's accumulator starts at 0), its NAdam
follows Dozat's momentum schedule, and it has no LAMB or Lion. Each class
here is the chain ``sparkdl_tpu.estimators.losses`` builds through optax
0.2.6 (``optax._src.alias`` and ``transform``), update for update, with
optax's defaults:

- :class:`OptaxRMSprop`: ``scale_by_rms(decay=0.9, eps=1e-8,
  initial_scale=0)``, ``eps`` inside the square root;
- :class:`OptaxAdagrad`: ``scale_by_rss(initial_accumulator_value=0.1,
  eps=1e-7)``, ``where(sum > 0, rsqrt(sum + eps), 0)``;
- :class:`OptaxNadam`: ``scale_by_adam(b1=0.9, b2=0.999, eps=1e-8,
  nesterov=True)``, the bias-corrected Nesterov form;
- :class:`OptaxLamb`: ``scale_by_adam(eps=1e-6)``,
  ``add_decayed_weights(0)``, ``scale_by_trust_ratio()``: each parameter
  tensor (one Keras variable, optax's leaf) scaled by
  ``||param|| / ||update||``, or by 1 where either norm is 0;
- :class:`OptaxLion`: ``scale_by_lion(b1=0.9, b2=0.99)``,
  ``add_decayed_weights(1e-3)``.

Each ends with ``scale_by_learning_rate``: the parameter moves by ``-lr``
times the update. The step count and the moments are tensors in
``self.state``, so ``state_dict()`` round-trips through a checkpoint. These
are plain PyTorch updates: no TPU kernel computes them.
"""

from __future__ import annotations

from typing import Iterable

import torch


class _OptaxOptimizer(torch.optim.Optimizer):
    """One update per parameter tensor: ``_init_state(p, group)`` gives a
    parameter's state tensors, ``_update(p, g, state, group)`` the optax
    update (before the learning rate)."""

    def __init__(self, params: Iterable, lr: float, **defaults):
        super().__init__(params, dict(lr=lr, **defaults))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["step"] = torch.zeros((), dtype=torch.float32)
                    state.update(self._init_state(p, group))
                state["step"] += 1
                update = self._update(p, p.grad, state, group)
                p.add_(update, alpha=-group["lr"])
        return loss


class OptaxRMSprop(_OptaxOptimizer):
    def __init__(self, params, lr: float = 1e-3, decay: float = 0.9, eps: float = 1e-8,
                 initial_scale: float = 0.0):
        super().__init__(params, lr, decay=decay, eps=eps, initial_scale=initial_scale)

    def _init_state(self, p, group):
        return {"nu": torch.full_like(p, group["initial_scale"],
                                      memory_format=torch.preserve_format)}

    def _update(self, p, g, state, group):
        decay = group["decay"]
        nu = state["nu"]
        nu.mul_(decay).add_(g * g, alpha=1 - decay)
        return g * torch.rsqrt(nu + group["eps"])


class OptaxAdagrad(_OptaxOptimizer):
    def __init__(self, params, lr: float = 1e-3, initial_accumulator_value: float = 0.1,
                 eps: float = 1e-7):
        super().__init__(params, lr, initial_accumulator_value=initial_accumulator_value,
                         eps=eps)

    def _init_state(self, p, group):
        return {"sum_of_squares": torch.full_like(
            p, group["initial_accumulator_value"], memory_format=torch.preserve_format)}

    def _update(self, p, g, state, group):
        total = state["sum_of_squares"]
        total.add_(g * g)
        scale = torch.where(total > 0, torch.rsqrt(total + group["eps"]),
                            torch.zeros_like(total))
        return scale * g


class _AdamMoments(_OptaxOptimizer):
    """``scale_by_adam``'s moments and bias correction."""

    def _init_state(self, p, group):
        return {"mu": torch.zeros_like(p, memory_format=torch.preserve_format),
                "nu": torch.zeros_like(p, memory_format=torch.preserve_format)}

    def _moments(self, g, state, group):
        b1, b2 = group["betas"]
        state["mu"].mul_(b1).add_(g, alpha=1 - b1)
        state["nu"].mul_(b2).add_(g * g, alpha=1 - b2)
        return b1, b2, int(state["step"].item())


class OptaxNadam(_AdamMoments):
    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8):
        super().__init__(params, lr, betas=tuple(betas), eps=eps)

    def _update(self, p, g, state, group):
        b1, b2, t = self._moments(g, state, group)
        mu_hat = (b1 * (state["mu"] / (1 - b1 ** (t + 1)))
                  + (1 - b1) * (g / (1 - b1 ** t)))
        nu_hat = state["nu"] / (1 - b2 ** t)
        return mu_hat / (torch.sqrt(nu_hat) + group["eps"])


class OptaxLamb(_AdamMoments):
    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-6,
                 weight_decay: float = 0.0):
        super().__init__(params, lr, betas=tuple(betas), eps=eps, weight_decay=weight_decay)

    def _update(self, p, g, state, group):
        b1, b2, t = self._moments(g, state, group)
        mu_hat = state["mu"] / (1 - b1 ** t)
        nu_hat = state["nu"] / (1 - b2 ** t)
        update = mu_hat / (torch.sqrt(nu_hat) + group["eps"]) + group["weight_decay"] * p
        param_norm, update_norm = torch.linalg.vector_norm(p), torch.linalg.vector_norm(update)
        ratio = torch.where((param_norm == 0) | (update_norm == 0),
                            torch.ones_like(param_norm), param_norm / update_norm)
        return update * ratio


class OptaxLion(_OptaxOptimizer):
    def __init__(self, params, lr: float = 1e-4, betas=(0.9, 0.99),
                 weight_decay: float = 1e-3):
        super().__init__(params, lr, betas=tuple(betas), weight_decay=weight_decay)

    def _init_state(self, p, group):
        return {"mu": torch.zeros_like(p, memory_format=torch.preserve_format)}

    def _update(self, p, g, state, group):
        b1, b2 = group["betas"]
        mu = state["mu"]
        update = torch.sign((1 - b1) * g + b1 * mu)
        mu.mul_(b2).add_(g, alpha=1 - b2)
        return update + group["weight_decay"] * p
