"""Reference PyTorch checkpoints as the JAX package's parameter trees of
numpy arrays (the port's copy of after_tpu/utils/port_torch.py), which
``utils/from_jax.py`` loads into the port's modules.

Conventions handled:
- torch Conv1d weight (out, in, k)            -> (k, in, out)
- torch ConvTranspose1d weight (in, out, k)   -> (k, in, out), taps flipped
- torch Linear weight (out, in)               -> (in, out)
- torch weight_norm pairs weight_g/weight_v   -> ("g", "kernel"): g the
  per-output-channel magnitudes, kernel = v
- BatchNorm running stats                     -> batch_stats (mean/var)
- torch GroupNorm/LayerNorm weight/bias       -> scale/bias

The name mapping is mechanical per sub-network, since both trees have the
same structure; see ``map_denoiser_v2`` etc. for the correspondences.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def _t(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def conv_kernel(w) -> np.ndarray:
    """torch (out, in, k) -> (k, in, out)."""
    return _t(w).transpose(2, 1, 0)


def conv_transpose_kernel(w) -> np.ndarray:
    """torch ConvTranspose1d (in, out, k) -> (k, in, out), the tap axis
    flipped: the JAX package's transposed conv treats the kernel as a
    forward conv's."""
    return _t(w).transpose(2, 0, 1)[::-1].copy()


def linear_kernel(w) -> np.ndarray:
    """torch (out, in) -> (in, out)."""
    return _t(w).transpose(1, 0)


def wn_conv(prefix: str, sd: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """weight-normed torch conv -> {"kernel": v, "g": g} in our layout.

    torch stores weight_v (out,in,k) and weight_g (out,1,1); our apply
    recomputes w = g * v/||v|| identically (ops/conv.py).
    """
    out = {}
    if prefix + ".weight_v" in sd:
        out["kernel"] = conv_kernel(sd[prefix + ".weight_v"])
        out["g"] = _t(sd[prefix + ".weight_g"]).reshape(-1)
    elif prefix + ".parametrizations.weight.original1" in sd:
        out["kernel"] = conv_kernel(
            sd[prefix + ".parametrizations.weight.original1"])
        out["g"] = _t(
            sd[prefix + ".parametrizations.weight.original0"]).reshape(-1)
    else:
        out["kernel"] = conv_kernel(sd[prefix + ".weight"])
    if prefix + ".bias" in sd:
        out["bias"] = _t(sd[prefix + ".bias"])
    return out


def wn_conv_transpose(prefix: str, sd: Dict[str, Any]) -> Dict[str, np.ndarray]:
    out = {}
    if prefix + ".weight_v" in sd:
        out["kernel"] = conv_transpose_kernel(sd[prefix + ".weight_v"])
        out["g"] = _t(sd[prefix + ".weight_g"]).reshape(-1)
    elif prefix + ".parametrizations.weight.original1" in sd:
        out["kernel"] = conv_transpose_kernel(
            sd[prefix + ".parametrizations.weight.original1"])
        out["g"] = _t(
            sd[prefix + ".parametrizations.weight.original0"]).reshape(-1)
    else:
        out["kernel"] = conv_transpose_kernel(sd[prefix + ".weight"])
    if prefix + ".bias" in sd:
        out["bias"] = _t(sd[prefix + ".bias"])
    return out


def dense(prefix: str, sd: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """torch Linear OR 1x1 Conv1d -> flax Dense params."""
    w = _t(sd[prefix + ".weight"])
    if w.ndim == 3:          # (out, in, 1) conv1d used as a linear layer
        w = w[:, :, 0]
    out = {"kernel": w.transpose(1, 0)}
    if prefix + ".bias" in sd:
        out["bias"] = _t(sd[prefix + ".bias"])
    return out


def layer_norm(prefix: str, sd: Dict[str, Any]) -> Dict[str, np.ndarray]:
    out = {}
    if prefix + ".weight" in sd:
        out["scale"] = _t(sd[prefix + ".weight"])
    if prefix + ".bias" in sd:
        out["bias"] = _t(sd[prefix + ".bias"])
    return out


def batch_norm(prefix: str, sd: Dict[str, Any]):
    """-> (params {scale,bias}, stats {mean,var})."""
    params = {"scale": _t(sd[prefix + ".weight"]),
              "bias": _t(sd[prefix + ".bias"])}
    stats = {"mean": _t(sd[prefix + ".running_mean"]),
             "var": _t(sd[prefix + ".running_var"])}
    return params, stats


def snake(prefix: str, sd: Dict[str, Any]) -> Dict[str, np.ndarray]:
    return {"alpha": _t(sd[prefix + ".alpha"]).reshape(-1),
            "beta": _t(sd[prefix + ".beta"]).reshape(-1)}


# ---------------------------------------------------------------------------
# DenoiserV2 mapping (reference transformerv2.py:461 -> models/denoiser.py)
# ---------------------------------------------------------------------------


def map_denoiser_v2(sd: Dict[str, Any], n_layers: int,
                    prefix: str = "net.") -> Dict[str, Any]:
    """Reference DenoiserV2 state_dict -> our Denoiser params."""
    p: Dict[str, Any] = {}
    tb = prefix + "denoiser_trans_block."
    # embedding MLP (transformerv2.py:488-492)
    p["emb_dense1"] = dense(prefix + "embedding.0", sd)
    p["emb_dense2"] = dense(prefix + "embedding.2", sd)
    # patchify (transformerv2.py:387-391: Rearrange, Linear, GELU)
    p["patchify"] = dense(tb + "patchify_and_embed.1", sd)
    if tb + "patchify_and_embed_tcond.1.weight" in sd:
        p["tcond_patchify"] = dense(tb + "patchify_and_embed_tcond.1", sd)
    if tb + "pos_embed.weight" in sd:
        p["pos_embed"] = _t(sd[tb + "pos_embed.weight"])
    for i in range(n_layers):
        b = tb + f"decoder_blocks.{i}."
        blk: Dict[str, Any] = {
            "attn": {"qkv": dense(b + "self_attention.qkv_linear", sd)},
            "norm1": layer_norm(b + "norm1", sd),
            "norm3": layer_norm(b + "norm3", sd),
            "mlp": {"Dense_0": dense(b + "mlp.mlp.0", sd),
                    "Dense_1": dense(b + "mlp.mlp.2", sd)},
        }
        if b + "linear.weight" in sd:
            blk["cond_linear"] = dense(b + "linear", sd)
        if b + "tcond_linear.weight" in sd:
            blk["tcond_linear"] = dense(b + "tcond_linear", sd)
        p[f"block_{i}"] = blk
    p["out_proj"] = dense(tb + "out_proj.0", sd)
    return p


# ---------------------------------------------------------------------------
# ECAPA mapping (reference ecapa_encoder.py:459 -> models/ecapa.py)
# ---------------------------------------------------------------------------


def _tdnn(prefix: str, sd):
    params = {"conv": {"Conv_0": {
        "kernel": conv_kernel(sd[prefix + ".conv.conv.weight"]),
        "bias": _t(sd[prefix + ".conv.conv.bias"])}}}
    bn_p, bn_s = batch_norm(prefix + ".norm", sd)
    params["bn"] = bn_p
    return params, {"bn": bn_s}


def map_ecapa(sd: Dict[str, Any], n_blocks: int, res2net_scale: int = 8,
              prefix: str = "encoder.") -> Dict[str, Dict[str, Any]]:
    """Reference ECAPATDNN state_dict -> {"params":..., "batch_stats":...}."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}

    def put(name, pair):
        params[name], stats[name] = pair

    put("block_0", _tdnn(prefix + "blocks.0", sd))
    for i in range(1, n_blocks - 1):
        b = prefix + f"blocks.{i}."
        bp: Dict[str, Any] = {}
        bs: Dict[str, Any] = {}
        bp["tdnn1"], bs["tdnn1"] = _tdnn(b + "tdnn1", sd)
        bp["tdnn2"], bs["tdnn2"] = _tdnn(b + "tdnn2", sd)
        r2p: Dict[str, Any] = {}
        r2s: Dict[str, Any] = {}
        for j in range(res2net_scale - 1):
            r2p[f"tdnn_{j}"], r2s[f"tdnn_{j}"] = _tdnn(
                b + f"res2net_block.blocks.{j}", sd)
        bp["res2net"], bs["res2net"] = r2p, r2s
        bp["se"] = {"conv1": dense(b + "se_block.conv1.conv", sd),
                    "conv2": dense(b + "se_block.conv2.conv", sd)}
        if b + "shortcut.conv.weight" in sd:
            bp["shortcut"] = dense(b + "shortcut.conv", sd)
        params[f"block_{i}"], stats[f"block_{i}"] = bp, bs
    put("mfa", _tdnn(prefix + "mfa", sd))
    asp_p: Dict[str, Any] = {}
    asp_s: Dict[str, Any] = {}
    asp_p["tdnn"], asp_s["tdnn"] = _tdnn(prefix + "asp.tdnn", sd)
    asp_p["conv"] = dense(prefix + "asp.conv.conv", sd)
    params["asp"], stats["asp"] = asp_p, asp_s
    bn_p, bn_s = batch_norm(prefix + "asp_bn", sd)
    params["asp_bn"], stats["asp_bn"] = bn_p, bn_s
    params["fc"] = dense(prefix + "fc.conv", sd)
    return {"params": params, "batch_stats": stats}


def load_reference_checkpoint(path: str) -> Dict[str, Any]:
    """torch.load a reference checkpoint's model_state on CPU."""
    d = torch.load(path, map_location="cpu", weights_only=False)
    return d.get("model_state", d)


# ---------------------------------------------------------------------------
# Codec mapping (reference SimpleNetsStream.py:832 -> models/autoencoder.py)
# ---------------------------------------------------------------------------


def _conv_block(prefix: str, sd, use_norm: bool) -> Dict[str, Any]:
    """Reference ConvBlock1d ([GN] -> Snake -> wn conv) under `prefix.net`."""
    out: Dict[str, Any] = {}
    if use_norm:
        # the codec's StreamGroupNorm holds its GroupNorm as "gn" (the JAX
        # package's map_codec leaves out that level)
        out["gn"] = {"gn": {"scale": _t(sd[prefix + ".net.0.gn.weight"]),
                            "bias": _t(sd[prefix + ".net.0.gn.bias"])}}
    out["act"] = snake(prefix + ".net.1", sd)
    out["conv"] = wn_conv(prefix + ".net.2", sd)
    return out


def _res_block(prefix: str, sd, use_norm: bool) -> Dict[str, Any]:
    """Reference ResnetBlock1d: AlignBranches([block1, block2], to_out)."""
    out = {"block1": _conv_block(prefix + ".net.branches.0.0", sd, use_norm),
           "block2": _conv_block(prefix + ".net.branches.0.1", sd, use_norm)}
    if prefix + ".net.branches.1.weight_v" in sd:
        out["to_out"] = wn_conv(prefix + ".net.branches.1", sd)
    return out


def _res_block_nores(prefix: str, sd, use_norm: bool) -> Dict[str, Any]:
    """ResnetBlock1dNoRes: plain CachedSequential [block1, block2]."""
    return {"block1": _conv_block(prefix + ".net.0", sd, use_norm),
            "block2": _conv_block(prefix + ".net.1", sd, use_norm)}


def map_codec(sd: Dict[str, Any], n_stages: int, num_blocks: int = 3,
              use_norm: bool = True) -> Dict[str, Any]:
    """Reference AutoEncoder state_dict -> our AudioCodec params
    ({"encoder": ..., "decoder": ...})."""
    enc: Dict[str, Any] = {}
    enc["to_in"] = _res_block("encoder.net.0", sd, use_norm)
    for i in range(n_stages):
        stage = f"encoder.net.{1 + i}.net"
        d: Dict[str, Any] = {}
        for j in range(num_blocks):
            d[f"res_{j}"] = _res_block(f"{stage}.{j}", sd, use_norm)
        d["act"] = snake(f"{stage}.{num_blocks}", sd)
        d["down"] = wn_conv(f"{stage}.{num_blocks + 1}", sd)
        enc[f"down_{i}"] = d
    enc["act"] = snake(f"encoder.net.{1 + n_stages}", sd)
    enc["to_out"] = wn_conv(f"encoder.net.{2 + n_stages}", sd)

    dec: Dict[str, Any] = {}
    dec["to_in"] = wn_conv("decoder.net.0", sd)
    for i in range(n_stages):
        stage = f"decoder.net.{1 + i}.net"
        u: Dict[str, Any] = {"act": snake(f"{stage}.0", sd),
                             "up": wn_conv_transpose(f"{stage}.1", sd)}
        for j in range(num_blocks):
            u[f"res_{j}"] = _res_block(f"{stage}.{2 + j}", sd, use_norm)
        dec[f"up_{i}"] = u
    dec["to_out"] = _res_block_nores("decoder.synth.branches.0", sd, use_norm)
    return {"encoder": enc, "decoder": dec}


# ---------------------------------------------------------------------------
# Encoder1D mapping (reference encoder.py:117 -> models/encoder.py)
# ---------------------------------------------------------------------------


def _v2_conv_block(prefix: str, sd):
    """Reference V2ConvBlock1D branch layout:
    [bn1=0, act=1, conv1=2, bn2=3, act=4, dropout=5, conv2=6]."""
    b = prefix + ".net.branches.0."
    bn1_p, bn1_s = batch_norm(b + "0", sd)
    bn2_p, bn2_s = batch_norm(b + "3", sd)
    params = {"bn1": bn1_p, "conv1": wn_conv(b + "2", sd),
              "bn2": bn2_p, "conv2": wn_conv(b + "6", sd)}
    stats = {"bn1": bn1_s, "bn2": bn2_s}
    return params, stats


def map_encoder1d(sd: Dict[str, Any], n_channels: int,
                  prefix: str = "") -> Dict[str, Dict[str, Any]]:
    """Reference Encoder1D state_dict -> {"params", "batch_stats"}.

    n_channels = len(cfg.channels); net indices 0..n-1 are V2EncoderBlock1D
    (conv block + pool), index n is the final V2ConvBlock1D."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for i in range(n_channels):
        base = f"{prefix}net.{i}"
        cp, cs = _v2_conv_block(base + ".net.0", sd)
        bp = {"conv": cp, "pool": wn_conv(base + ".net.1", sd)}
        params[f"block_{i}"] = bp
        stats[f"block_{i}"] = {"conv": cs}
    op, os_ = _v2_conv_block(f"{prefix}net.{n_channels}", sd)
    params["out_block"] = op
    stats["out_block"] = os_
    return {"params": params, "batch_stats": stats}
