"""Model-class selection by ``cfg.diffusion_type`` (counterpart of
after_tpu/diffusion/factory.py): the rectified flow or EDM, on the same
sub-models and interface."""

from __future__ import annotations

from .edm import EDM
from .rectified_flow import RectifiedFlow


def make_model(cfg, streaming: bool = False) -> RectifiedFlow:
    """The diffusion model for ``cfg.diffusion_type`` (its streaming form
    with ``streaming``)."""
    kind = getattr(cfg, "diffusion_type", "rectified") or "rectified"
    if kind == "edm":
        return EDM(cfg, streaming=streaming)
    if kind == "rectified":
        return RectifiedFlow(cfg, streaming=streaming)
    raise ValueError(f"unknown diffusion_type {kind!r} "
                     "(expected 'rectified' or 'edm')")

