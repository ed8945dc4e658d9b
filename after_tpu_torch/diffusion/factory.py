"""Model-class selection by ``cfg.diffusion_type`` (counterpart of
after_tpu/diffusion/factory.py)."""

from __future__ import annotations

from .rectified_flow import RectifiedFlow


def make_model(cfg) -> RectifiedFlow:
    """The diffusion model for ``cfg.diffusion_type``: the rectified flow;
    EDM is not ported yet."""
    kind = getattr(cfg, "diffusion_type", "rectified") or "rectified"
    if kind == "edm":
        raise NotImplementedError(
            "the port has no EDM model yet (diffusion_type='edm')")
    if kind == "rectified":
        return RectifiedFlow(cfg)
    raise ValueError(f"unknown diffusion_type {kind!r} "
                     "(expected 'rectified' or 'edm')")
