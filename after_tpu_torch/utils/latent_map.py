"""2-D timbre-latent map for XY-pad control surfaces (counterpart of
after_tpu/utils/latent_map.py): the projector model, its training, the
embeddings it trains on, and the density PNG behind the pad.

The projector's weights load from the JAX projector's params with
``utils.from_jax.load_module``, and ``save_projector`` writes them under
the same flax names (``projector.npz``), so that ``load_projector`` walks
them the same way.  ``load_projector`` also reads a JAX artifact's
``projector.msgpack`` (flax's ``serialization.to_bytes`` of the params):
``read_msgpack`` decodes msgpack and flax's ndarray extension by hand, since
neither msgpack nor flax need be installed where the port serves.  The
density map is numpy only (histogram, Gaussian blur and a minimal PNG
encoder).
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

PROJECTOR_FILE = "projector.npz"
# the JAX artifact's projector (after_tpu/utils/latent_map.py:save_projector)
JAX_PROJECTOR_FILE = "projector.msgpack"


class SmallAutoencoder(nn.Module):
    """z_timbre (B, D) <-> 2-D map."""

    def __init__(self, in_dim: int = 6, hidden: int = 64):
        super().__init__()
        self.enc1 = nn.Linear(in_dim, hidden)
        self.enc2 = nn.Linear(hidden, hidden)
        self.enc3 = nn.Linear(hidden, 2)
        self.dec1 = nn.Linear(2, hidden)
        self.dec2 = nn.Linear(hidden, hidden)
        self.dec3 = nn.Linear(hidden, in_dim)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.enc1(x))
        h = torch.relu(self.enc2(h))
        return torch.tanh(self.enc3(h))

    def decode(self, m: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.dec1(m))
        h = torch.relu(self.dec2(h))
        return self.dec3(h)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.decode(self.encode(x))


def train_projector(embeddings: np.ndarray, num_steps: int = 20000,
                    batch_size: int = 64, lr: float = 1e-3, seed: int = 0,
                    device=None,
                    projector: Optional[SmallAutoencoder] = None
                    ) -> SmallAutoencoder:
    """The 2-D projector trained on (N, D) timbre embeddings: Adam at
    ``lr`` on the mean squared reconstruction error, each step on
    ``batch_size`` rows drawn with ``np.random.RandomState(seed)`` as the
    JAX package draws them.  It starts from ``projector`` when given, else
    from port-native weights of ``seed``; on the card unless ``device`` is
    "cpu"."""
    from .device import resolve_device
    from .init import init_weights

    device = resolve_device(device)
    emb = torch.as_tensor(np.asarray(embeddings, np.float32), device=device)
    if projector is None:
        projector = SmallAutoencoder(in_dim=emb.shape[-1])
        init_weights(projector, seed)
    projector = projector.to(device).train()
    opt = torch.optim.Adam(projector.parameters(), lr=lr, eps=1e-8)
    rng = np.random.RandomState(seed)
    for _ in range(num_steps):
        idx = torch.as_tensor(rng.randint(0, emb.shape[0], batch_size))
        batch = emb[idx.to(device)]
        loss = torch.mean(torch.square(projector(batch) - batch))
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
    return projector.eval()


@torch.no_grad()
def store_timbre_embeddings(pipeline, store: str, n_samples: int = 512,
                            batch_size: int = 16) -> np.ndarray:
    """(N, zt) timbre vectors of a latent store's records (``z``, stored
    (C, T)), through ``pipeline.timbre`` (a ``TransferPipeline``): what the
    projector trains on at export."""
    from ..dataset.dataset import SimpleDataset

    ds = SimpleDataset(store, keys=("z",))
    if len(ds) == 0:
        raise SystemExit(f"dataset store {store} is empty; cannot train "
                         "the timbre map")
    n = min(n_samples, len(ds))
    embs, batch, shape0 = [], [], None
    for i in np.linspace(0, len(ds) - 1, n).astype(int):
        # records store latents as (C, T); the pipeline runs (B, T, C)
        z = np.asarray(ds[int(i)]["z"], np.float32).T
        if shape0 is None:
            shape0 = z.shape
        elif z.shape != shape0:
            raise SystemExit(
                f"store records have differing latent shapes "
                f"({shape0} vs {z.shape} at record {int(i)}); the timbre "
                "map needs fixed-length records (re-run prepare_dataset)")
        batch.append(z)
        if len(batch) == batch_size:
            embs.append(pipeline.timbre(np.stack(batch)).cpu().numpy())
            batch = []
    if batch:
        embs.append(pipeline.timbre(np.stack(batch)).cpu().numpy())
    return np.concatenate(embs, axis=0)


def _flax_params(projector: SmallAutoencoder) -> Dict[str, np.ndarray]:
    """{"params/<layer>/kernel" | "params/<layer>/bias": array}: the flax
    names and layouts (kernel (in, out)) of the projector's weights."""
    out = {}
    for name, layer in projector.named_children():
        out[f"params/{name}/kernel"] = layer.weight.detach().cpu().numpy().T
        out[f"params/{name}/bias"] = layer.bias.detach().cpu().numpy()
    return out


def save_projector(out_dir: str, projector: SmallAutoencoder,
                   embeddings: np.ndarray) -> None:
    """The trained projector (``projector.npz``, flax names) and the
    density PNG of the embeddings' pad positions (``map.png``, the XY pad's
    background) into an artifact."""
    np.savez(os.path.join(out_dir, PROJECTOR_FILE), **_flax_params(projector))
    with torch.no_grad():
        p = next(projector.parameters())
        emb2d = projector.encode(torch.as_tensor(
            np.asarray(embeddings, np.float32), device=p.device))
    generate_map_png(emb2d.cpu().numpy(), os.path.join(out_dir, "map.png"))


# flax's msgpack extension types (flax/serialization.py:_MsgpackExtType)
_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3


def _flax_array(payload: bytes) -> np.ndarray:
    """flax's ndarray extension: msgpack of (shape, dtype name, C-order
    bytes); bf16 (no numpy dtype) widens to f32, exactly."""
    shape, name, raw = read_msgpack(payload)
    name = name.decode() if isinstance(name, bytes) else name
    if name == "bfloat16":
        bits = np.frombuffer(raw, "<u2").astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(raw, np.dtype(name)).reshape(shape).copy()


def read_msgpack(data: bytes):
    """The object of a msgpack document: maps, arrays, strings, bytes,
    numbers, booleans and nil, and flax's extensions (ndarrays and numpy
    scalars as numpy arrays, complex numbers)."""
    pos = 0

    def take(n: int) -> bytes:
        nonlocal pos
        if pos + n > len(data):
            raise ValueError("msgpack: truncated document")
        out = data[pos:pos + n]
        pos += n
        return out

    def unsigned(n: int) -> int:
        return int.from_bytes(take(n), "big")

    def ext(code: int, n: int):
        payload = take(n)
        if code in (_EXT_NDARRAY, _EXT_NPSCALAR):
            return _flax_array(payload)
        if code == _EXT_COMPLEX:
            re, im = read_msgpack(payload)
            return complex(re, im)
        raise ValueError(f"msgpack: unknown extension type {code}")

    def value():
        b = take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return {value(): value() for _ in range(b & 0x0F)}
        if 0x90 <= b <= 0x9F:
            return [value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return take(b & 0x1F).decode()
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in (0xC4, 0xC5, 0xC6):                 # bin 8/16/32
            return take(unsigned(1 << (b - 0xC4)))
        if b in (0xC7, 0xC8, 0xC9):                 # ext 8/16/32
            n = unsigned(1 << (b - 0xC7))
            return ext(int.from_bytes(take(1), "big", signed=True), n)
        if b == 0xCA:
            return struct.unpack(">f", take(4))[0]
        if b == 0xCB:
            return struct.unpack(">d", take(8))[0]
        if 0xCC <= b <= 0xCF:                       # uint 8/16/32/64
            return unsigned(1 << (b - 0xCC))
        if 0xD0 <= b <= 0xD3:                       # int 8/16/32/64
            return int.from_bytes(take(1 << (b - 0xD0)), "big", signed=True)
        if 0xD4 <= b <= 0xD8:                       # fixext 1/2/4/8/16
            code = int.from_bytes(take(1), "big", signed=True)
            return ext(code, 1 << (b - 0xD4))
        if b in (0xD9, 0xDA, 0xDB):                 # str 8/16/32
            return take(unsigned(1 << (b - 0xD9))).decode()
        if b in (0xDC, 0xDD):                       # array 16/32
            return [value() for _ in range(unsigned(2 if b == 0xDC else 4))]
        if b in (0xDE, 0xDF):                       # map 16/32
            return {value(): value()
                    for _ in range(unsigned(2 if b == 0xDE else 4))}
        raise ValueError(f"msgpack: unknown type byte {b:#x}")

    out = value()
    if pos != len(data):
        raise ValueError("msgpack: bytes after the document")
    return out


def _projector_tree(art_dir: str) -> Optional[Dict]:
    """The projector's params of an artifact dir as a nested dict of numpy
    arrays under flax names: from the port's ``projector.npz``, else from a
    JAX artifact's ``projector.msgpack``; None where there is neither."""
    path = os.path.join(art_dir, PROJECTOR_FILE)
    if os.path.exists(path):
        tree: Dict = {}
        with np.load(path) as z:
            for key in z.files:
                node = tree
                *parents, leaf = key.split("/")
                for p in parents:
                    node = node.setdefault(p, {})
                node[leaf] = z[key]
        return tree
    path = os.path.join(art_dir, JAX_PROJECTOR_FILE)
    if os.path.exists(path):
        with open(path, "rb") as f:
            return read_msgpack(f.read())
    return None


def load_projector(art_dir: str, in_dim: int,
                   device=None) -> Optional[SmallAutoencoder]:
    """The projector of an artifact dir (the port's ``projector.npz``, or a
    JAX artifact's ``projector.msgpack``), or None where it has none; on
    the card unless ``device`` is "cpu"."""
    from .device import resolve_device
    from .from_jax import load_module

    tree = _projector_tree(art_dir)
    if tree is None:
        return None
    projector = SmallAutoencoder(in_dim=in_dim)
    load_module(projector, tree)
    return projector.to(resolve_device(device)).eval()


def png_bytes(rgb: np.ndarray) -> bytes:
    """Minimal PNG encoder for (H, W, 3) uint8."""
    h, w, _ = rgb.shape
    raw = b"".join(b"\x00" + rgb[i].tobytes() for i in range(h))

    def chunk(tag, data):
        c = tag + data
        return struct.pack(">I", len(data)) + c + struct.pack(
            ">I", zlib.crc32(c) & 0xFFFFFFFF)

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 9))
            + chunk(b"IEND", b""))


def generate_map_png(embeddings_2d: np.ndarray, path: str, bins: int = 500,
                     sigma: float = 12.0, gamma: float = 0.5) -> np.ndarray:
    """Blurred density image of the 2-D embedding cloud, written to
    ``path`` as a PNG; returns the (bins, bins, 3) image."""
    from scipy.ndimage import gaussian_filter

    hist, _, _ = np.histogram2d(
        embeddings_2d[:, 0], embeddings_2d[:, 1], bins=bins,
        range=[[-1, 1], [-1, 1]])
    img = gaussian_filter(hist.T[::-1], sigma=sigma)
    img = img / (img.max() + 1e-9)
    img = img ** gamma
    rgb = np.stack([20 + 200 * img, 30 + 160 * img, 60 + 120 * img],
                   axis=-1).clip(0, 255).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(png_bytes(rgb))
    return rgb
