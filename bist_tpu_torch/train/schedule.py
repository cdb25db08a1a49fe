"""Noam (or constant) learning-rate schedule + Adam (after
`bist_tpu.train.schedule`; the constant rate is `optax.adam(lr)`'s, for
`tasks.tgifqa`).

Parity: NoamOpt (model/optimize.py:9-34) — lr(step) = factor · d_model^-0.5 ·
min(step^-0.5, step · warmup^-1.5), step counting from 1, driving
Adam(lr, betas=(0.9, 0.98), eps=1e-9) (train.py:129-130).

The update is optax's `adam` written out on the parameter tree: the first
update reads the schedule at count 0 (Noam step 1) and bias-corrects with
count 1; mu_hat / (sqrt(nu_hat) + eps), scaled by -lr.  It runs on lists of
tensors with `torch._foreach_*` ops and updates the parameters in place.

The count is a 0-d int32 tensor on the parameters' device, advanced in
place, and the learning rate and the bias corrections are float32 tensors
computed from it there (as optax computes them in float32): a CUDA graph
that captured an update reads the advanced count at each replay, where a
Python number would stay at its value at capture.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple

import torch


def noam_schedule(d_model: int, warmup: int, factor: float = 1.0):
    scale = factor * (d_model ** -0.5)
    inv_warmup = warmup ** -1.5

    def sched(count):
        """The rate after `count` updates: a float for an int count, a
        float32 0-d tensor on the count's device for a tensor count."""
        if isinstance(count, torch.Tensor):
            step = count.float() + 1.0         # NoamOpt._step starts at 1
            return scale * torch.minimum(step ** -0.5, step * inv_warmup)
        step = count + 1.0
        return scale * min(step ** -0.5, step * inv_warmup)

    return sched


def constant_schedule(lr: float):
    """The rate `lr` at every count (optax's constant learning rate), as a
    float32 0-d tensor on the count's device."""

    def sched(count: torch.Tensor) -> torch.Tensor:
        return torch.full((), lr, dtype=torch.float32, device=count.device)

    return sched


class Adam(NamedTuple):
    """Adam with a learning-rate schedule: `init(leaves)` gives the state,
    `update(leaves, grads, state)` updates the leaves and the state's
    tensors in place and returns the state (the same tensors)."""

    schedule: object
    b1: float = 0.9
    b2: float = 0.98
    eps: float = 1e-9

    def init(self, leaves: List[torch.Tensor]) -> Dict:
        return {"count": torch.zeros((), dtype=torch.int32, device=leaves[0].device),
                "mu": [torch.zeros_like(t) for t in leaves],
                "nu": [torch.zeros_like(t) for t in leaves]}

    @torch.no_grad()
    def update(self, leaves: List[torch.Tensor], grads: List[torch.Tensor],
               state: Dict) -> Dict:
        count = state["count"]
        mu, nu = state["mu"], state["nu"]
        lr = self.schedule(count)
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, grads, alpha=1.0 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - self.b2)
        count.add_(1)
        t = count.float()
        mu_hat = torch._foreach_div(mu, 1.0 - torch.pow(self.b1, t))
        denom = torch._foreach_div(nu, 1.0 - torch.pow(self.b2, t))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        torch._foreach_div_(mu_hat, denom)
        torch._foreach_mul_(mu_hat, lr)
        torch._foreach_sub_(leaves, mu_hat)
        return {"count": count, "mu": mu, "nu": nu}


def make_optimizer(d_model: int, warmup: int, factor: float = 1.0,
                   b1: float = 0.9, b2: float = 0.98, eps: float = 1e-9) -> Adam:
    return Adam(noam_schedule(d_model, warmup, factor), b1=b1, b2=b2, eps=eps)
