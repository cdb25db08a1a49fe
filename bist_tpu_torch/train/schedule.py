"""Noam learning-rate schedule + Adam (after `bist_tpu.train.schedule`).

Parity: NoamOpt (model/optimize.py:9-34) — lr(step) = factor · d_model^-0.5 ·
min(step^-0.5, step · warmup^-1.5), step counting from 1, driving
Adam(lr, betas=(0.9, 0.98), eps=1e-9) (train.py:129-130).

The update is optax's `adam` written out on the parameter tree: the first
update reads the schedule at count 0 (Noam step 1) and bias-corrects with
count 1; mu_hat / (sqrt(nu_hat) + eps), scaled by -lr.  It runs on lists of
tensors with `torch._foreach_*` ops and updates the parameters in place.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple

import torch


def noam_schedule(d_model: int, warmup: int, factor: float = 1.0):
    scale = factor * (d_model ** -0.5)
    inv_warmup = warmup ** -1.5

    def sched(count: int) -> float:
        step = count + 1.0                     # NoamOpt._step starts at 1
        return scale * min(step ** -0.5, step * inv_warmup)

    return sched


class Adam(NamedTuple):
    """Adam with a learning-rate schedule: `init(leaves)` gives the state,
    `update(leaves, grads, state)` updates the leaves in place and returns
    the next state."""

    schedule: object
    b1: float = 0.9
    b2: float = 0.98
    eps: float = 1e-9

    def init(self, leaves: List[torch.Tensor]) -> Dict:
        return {"count": 0,
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
        t = count + 1
        mu_hat = torch._foreach_div(mu, 1.0 - self.b1 ** t)
        denom = torch._foreach_div(nu, 1.0 - self.b2 ** t)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        torch._foreach_div_(mu_hat, denom)
        torch._foreach_add_(leaves, mu_hat, alpha=-lr)
        return {"count": t, "mu": mu, "nu": nu}


def make_optimizer(d_model: int, warmup: int, factor: float = 1.0,
                   b1: float = 0.9, b2: float = 0.98, eps: float = 1e-9) -> Adam:
    return Adam(noam_schedule(d_model, warmup, factor), b1=b1, b2=b2, eps=eps)
