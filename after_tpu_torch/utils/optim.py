"""The JAX trainers' optax chains, update for update (``AdamW``)."""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Sequence

import torch


class AdamW:
    """``optax.apply_if_finite(optax.chain(optax.clip_by_global_norm(clip),
    optax.adamw(exponential_decay(lr, 1, lr_decay), b1, b2,
    weight_decay=0.01)), max_consecutive_errors)`` over a list of
    parameters, which ``step`` updates in place; ``clip=None`` leaves the
    clip out of the chain and ``lr_decay=1.0`` keeps the rate constant.

    - clip: g stays as it is while the global norm is below ``clip``, else
      becomes g / norm * clip;
    - Adam with bias correction, eps 1e-8 outside the square root;
    - decoupled weight decay 0.01 * p, scaled by the learning rate with the
      Adam update;
    - the learning rate of the n-th applied update is lr * lr_decay ** n;
    - gradients that are not all finite leave the parameters, moments and
      count as they are (``total_notfinite`` counts them), unless more than
      ``max_consecutive_errors`` came in a row.

    The state lives on the parameters' device at fixed addresses, so that a
    step can be captured in a CUDA graph: the moments in one flat buffer
    each (``mu`` and ``nu`` are per-parameter views of them), and
    ``count``, ``notfinite_count``, ``total_notfinite`` and the last step's
    ``finite`` as 0-dim tensors.  A step reads nothing back to the host: the
    learning rate and the bias corrections are computed on the device in
    f32, as optax computes them.  A skipped update never multiplies by a
    0/1 mask: its gradients are selected away to zeros (``masked_fill_``)
    before they reach the moments, whose decay is then 1, so that the
    moments keep their bits, and its parameter update is selected away to
    zeros.

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
        self.device = (self.params[0].device if self.params
                       else torch.device("cpu"))
        self._sizes = [p.numel() for p in self.params]
        total = sum(self._sizes)
        self._mu = torch.zeros(total, device=self.device)
        self._nu = torch.zeros(total, device=self.device)
        self.mu = self._views(self._mu)
        self.nu = self._views(self._nu)
        # each parameter as a flat alias of its storage
        self._flat_params = [p.detach().view(-1) for p in self.params]
        # a frozen parameter's gradient in the flat one
        self._zeros = torch.zeros(max(self._sizes, default=0),
                                  device=self.device)

        def scalar(dtype):
            return torch.zeros((), dtype=dtype, device=self.device)
        self.count = scalar(torch.int32)            # applied updates
        self.notfinite_count = scalar(torch.int32)  # non-finite in a row
        self.total_notfinite = scalar(torch.int32)
        self.finite = torch.ones((), dtype=torch.bool, device=self.device)

    def _views(self, flat: torch.Tensor) -> List[torch.Tensor]:
        return [v.view_as(p) for v, p in zip(flat.split(self._sizes),
                                             self.params)]

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor],
             keep: Optional[Sequence[bool]] = None) -> torch.Tensor:
        """Apply one update from ``grads`` (one per parameter), to the
        parameters whose ``keep`` is true (all by default).  Returns a 0-dim
        device bool: whether the update was applied."""
        if len(grads) != len(self.params):
            raise ValueError(f"{len(grads)} gradients for "
                             f"{len(self.params)} parameters")
        kept = ([True] * len(grads) if keep is None
                else [bool(k) for k in keep])
        g = torch.cat([t.reshape(-1) if k else self._zeros[:n]
                       for t, k, n in zip(grads, kept, self._sizes)])
        # an infinite global norm may come from finite values whose squares
        # overflow: finiteness is tested on the values, as optax does
        finite = torch.isfinite(g).all()
        self.finite.copy_(finite)
        self.notfinite_count.copy_(
            torch.where(finite, 0, self.notfinite_count + 1))
        self.total_notfinite.add_(~finite)
        apply = finite | (self.notfinite_count > self.max_consecutive_errors)
        skip = ~apply

        if self.clip is not None:
            norm = torch.linalg.vector_norm(g)
            g.mul_(torch.where(norm < self.clip, 1.0, self.clip / norm))
        g.masked_fill_(skip, 0.0)
        b1, b2 = self.b1, self.b2
        self._mu.mul_(torch.where(apply, b1, 1.0)).add_(g, alpha=1 - b1)
        self._nu.mul_(torch.where(apply, b2, 1.0)).addcmul_(
            g, g, value=1 - b2)
        lr = self.lr * torch.pow(self.lr_decay, self.count.float())
        # the bias corrections of this update (count + 1 >= 1: finite also
        # where the update is skipped and selected away below)
        count = self.count + 1
        update = torch.div(self._mu, 1 - torch.pow(b1, count))
        update.div_(torch.div(self._nu, 1 - torch.pow(b2, count))
                    .sqrt_().add_(self.eps))
        self.count.add_(apply)
        params = [p for p, k in zip(self._flat_params, kept) if k]
        updates = [u for u, k in zip(update.split(self._sizes), kept) if k]
        if params:
            torch._foreach_add_(updates, params, alpha=self.weight_decay)
            update.mul_(-lr).masked_fill_(skip, 0.0)
            torch._foreach_add_(params, updates)
        return apply

    def state_dict(self) -> Dict[str, Any]:
        """The checkpoint form: the moments per parameter and the counts as
        Python ints (read back from the device)."""
        return {"mu": self.mu, "nu": self.nu, "count": int(self.count),
                "notfinite_count": int(self.notfinite_count),
                "total_notfinite": int(self.total_notfinite)}

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Writes ``state`` (a ``state_dict``) into the optimizer's tensors,
        in place."""
        for ours, theirs in ((self.mu, state["mu"]), (self.nu, state["nu"])):
            if len(theirs) != len(ours):
                raise ValueError(f"{len(theirs)} moments for {len(ours)} "
                                 f"parameters")
            for a, b in zip(ours, theirs):
                a.copy_(b)
        for name in ("count", "notfinite_count", "total_notfinite"):
            getattr(self, name).fill_(int(state[name]))
        self.finite.fill_(True)
