"""The JAX trainers' optax chains, update for update (``AdamW``)."""

from __future__ import annotations

import math
from typing import Any, Dict, Iterable, List, Optional, Sequence

import torch


class AdamW:
    """``optax.apply_if_finite(optax.chain(optax.clip_by_global_norm(clip),
    optax.adamw(exponential_decay(lr, 1, lr_decay), b1, b2,
    weight_decay=0.01)), max_consecutive_errors)`` over a list of
    parameters, which ``step`` updates in place; ``clip=None`` leaves the
    clip out of the chain and ``lr_decay=1.0`` keeps the rate constant.

    - clip: g stays below the global norm ``clip``, else becomes
      g / norm * clip;
    - Adam with bias correction, eps 1e-8 outside the square root;
    - decoupled weight decay 0.01 * p, scaled by the learning rate with the
      Adam update;
    - the learning rate of the n-th applied update is lr * lr_decay ** n;
    - gradients that are not all finite leave the parameters, moments and
      count as they are (``total_notfinite`` counts them), unless more than
      ``max_consecutive_errors`` came in a row.

    ``step``'s ``keep`` freezes parameters as the JAX diffusion trainer does
    around its optimizer: their gradients count as zeros (in the global
    norm, the finiteness test and the moments) and their updates are
    dropped, weight decay included."""

    weight_decay = 0.01
    eps = 1e-8
    max_consecutive_errors = 10000

    def __init__(self, params: Iterable[torch.Tensor], lr: float,
                 lr_decay: float, b1: float, b2: float,
                 clip: Optional[float]):
        self.params = list(params)
        self.lr, self.lr_decay, self.b1, self.b2 = lr, lr_decay, b1, b2
        self.clip = clip
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0                 # applied updates
        self.notfinite_count = 0       # non-finite gradients in a row
        self.total_notfinite = 0
        self.finite = True             # the last step's gradients were

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor],
             keep: Optional[Sequence[bool]] = None) -> bool:
        """Apply one update from ``grads`` (one per parameter), to the
        parameters whose ``keep`` is true (all by default); False when it
        was skipped."""
        if len(grads) != len(self.params):
            raise ValueError(f"{len(grads)} gradients for "
                             f"{len(self.params)} parameters")
        if keep is not None:
            grads = [g if k else torch.zeros_like(g)
                     for g, k in zip(grads, keep)]
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        norm_value = norm.item()
        # a finite global norm means finite gradients; an infinite one may
        # still come from finite values whose squares overflow
        finite = math.isfinite(norm_value) or all(
            bool(torch.isfinite(g).all()) for g in grads)
        self.finite = finite
        self.notfinite_count = 0 if finite else self.notfinite_count + 1
        if not finite:
            self.total_notfinite += 1
            if self.notfinite_count <= self.max_consecutive_errors:
                return False
        if self.clip is not None and not norm_value < self.clip:
            grads = torch._foreach_div(grads, norm)
            torch._foreach_mul_(grads, self.clip)
        lr = self.lr * self.lr_decay ** self.count
        self.count += 1
        b1, b2 = self.b1, self.b2
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, grads, alpha=1 - b1)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1 - b2)
        mu_hat = torch._foreach_div(self.mu, 1 - b1 ** self.count)
        denom = torch._foreach_div(self.nu, 1 - b2 ** self.count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        update = torch._foreach_div(mu_hat, denom)
        torch._foreach_add_(update, self.params, alpha=self.weight_decay)
        params = self.params
        if keep is not None:
            params = [p for p, k in zip(params, keep) if k]
            update = [u for u, k in zip(update, keep) if k]
        if params:
            torch._foreach_add_(params, update, alpha=-lr)
        return True

    def state_dict(self) -> Dict[str, Any]:
        return {"mu": self.mu, "nu": self.nu, "count": self.count,
                "notfinite_count": self.notfinite_count,
                "total_notfinite": self.total_notfinite}

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, Any]) -> None:
        for ours, theirs in ((self.mu, state["mu"]), (self.nu, state["nu"])):
            if len(theirs) != len(ours):
                raise ValueError(f"{len(theirs)} moments for {len(ours)} "
                                 f"parameters")
            for a, b in zip(ours, theirs):
                a.copy_(b)
        self.count = int(state["count"])
        self.notfinite_count = int(state["notfinite_count"])
        self.total_notfinite = int(state["total_notfinite"])
