"""Parse a reference run's gin config into the port's typed configs (the
port's copy of after_tpu/utils/gin_import.py).

``import_torch`` derives the architecture (stages, layers, channel stacks)
from the run's own ``config.gin``.  This is a small reader of gin's binding
syntax - macros (``NAME = value``), scoped bindings
(``scope/mod.Class.param = value``) and block form (``mod.Class:`` and
indented ``param = value`` lines) - not a gin interpreter: ``@references``
stay strings, ``%macros`` resolve recursively.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Any, Dict, Optional, Tuple


def _parse_value(raw: str, macros: Dict[str, Any]) -> Any:
    raw = raw.split("#", 1)[0].strip()
    if raw.startswith("%"):
        name = raw[1:]
        if name in macros:
            return macros[name]
        return raw
    if raw.startswith("@"):
        return raw
    try:
        return ast.literal_eval(raw)
    except (ValueError, SyntaxError):
        # list containing %macros / @refs, or a bare token
        m = re.fullmatch(r"\[(.*)\]", raw, re.S)
        if m:
            return [
                _parse_value(part, macros)
                for part in re.split(r",(?![^\[\(]*[\]\)])", m.group(1))
                if part.strip()]
        return raw


def parse_gin(path: str) -> Dict[str, Any]:
    """Gin file -> {"MACRO": value, "scope/mod.Class.param": value}.

    Multi-line `[...]` values are joined; imports and `from __gin__ ...`
    lines are ignored."""
    out: Dict[str, Any] = {}
    block: Optional[str] = None
    with open(path) as f:
        lines = f.read().splitlines()

    # join continuation lines of open brackets
    joined, buf, depth = [], "", 0
    for line in lines:
        code = line.split("#", 1)[0]
        buf = (buf + " " + line.strip()) if buf else line
        depth += code.count("[") + code.count("(") \
            - code.count("]") - code.count(")")
        if depth <= 0:
            joined.append(buf)
            buf, depth = "", 0
    if buf:
        joined.append(buf)

    for line in joined:
        code = line.split("#", 1)[0].rstrip()
        stripped = code.strip()
        if (not stripped or stripped.startswith(("import ", "from "))):
            continue
        if stripped.endswith(":") and "=" not in stripped:
            block = stripped[:-1].strip()
            continue
        m = re.match(r"([\w./%@-]+)\s*=\s*(.+)", stripped)
        if not m:
            continue
        key, raw = m.group(1), m.group(2)
        indented = code[0].isspace()
        if indented and block:
            key = f"{block}.{key}"
        else:
            block = None
        out[key] = _parse_value(raw, out)
    # second pass: resolve %macros recorded before their definition
    for k, v in list(out.items()):
        if isinstance(v, str) and v.startswith("%") and v[1:] in out:
            out[k] = out[v[1:]]
        elif isinstance(v, list):
            out[k] = [out[x[1:]] if isinstance(x, str) and x.startswith("%")
                      and x[1:] in out else x for x in v]
    return out


def lookup(bindings: Dict[str, Any], suffix: str, default: Any = None,
           scope: Optional[str] = None) -> Any:
    """Value of the binding whose key ends with `.suffix` (optionally
    constrained to a `scope/` prefix)."""
    for k, v in bindings.items():
        if not k.endswith("." + suffix) and k != suffix:
            continue
        if scope is not None and not k.startswith(scope + "/"):
            continue
        if scope is None and "/" in k:
            continue
        return v
    if scope is not None:  # scoped param expressed unscoped (operative cfg)
        return lookup(bindings, suffix, default)
    return default


def find_gin_config(checkpoint_path: str) -> Optional[str]:
    """``config.gin`` next to a reference checkpoint file (the layout of a
    reference run directory)."""
    d = os.path.dirname(os.path.abspath(checkpoint_path))
    p = os.path.join(d, "config.gin")
    return p if os.path.exists(p) else None


def codec_config_from_gin(path: str):
    """config.gin of a codec run -> AutoEncoderConfig (the geometry fields
    the state-dict mapper and the export command need)."""
    from ..config import AutoEncoderConfig, with_overrides

    b = parse_gin(path)
    upd: Dict[str, Any] = {}

    def put(field, suffix, conv=lambda x: x):
        v = lookup(b, f"AutoEncoder.{suffix}")
        if v is not None:
            upd[field] = conv(v)

    put("pqmf_bands", "pqmf_bands", int)
    put("z_channels", "z_channels", int)
    put("base_channels", "channels", int)
    put("multipliers", "multipliers", tuple)
    put("factors", "factors", tuple)
    put("dilations", "dilations", tuple)
    put("kernel_size", "kernel_size", int)
    put("decoder_ratio", "decoder_ratio", float)
    put("use_norm", "use_norm", bool)
    put("use_loudness", "use_loudness", bool)
    put("use_noise", "use_noise", bool)
    bott = lookup(b, "AutoEncoder.bottleneck")
    if isinstance(bott, str):
        for name in ("relu", "tanh", "vae"):
            if name in bott.lower():
                upd["bottleneck"] = name
                break
    sr = b.get("SR")
    if sr is not None:
        upd["sr"] = int(sr)
    pad_mode = lookup(b, "get_padding.mode")
    if pad_mode is not None:
        upd["causal"] = pad_mode == "causal"
    return with_overrides(AutoEncoderConfig(), upd)


def diffusion_config_from_gin(path: str):
    """config.gin of a diffusion run -> AfterConfig (architecture geometry:
    denoiser dims, ECAPA stack, Encoder1D stacks)."""
    from ..config import AfterConfig, with_overrides

    b = parse_gin(path)
    upd: Dict[str, Any] = {}

    def put(field, suffix, conv=lambda x: x, scope=None):
        v = lookup(b, suffix, scope=scope)
        if v is not None and not (isinstance(v, str) and v.startswith("%")):
            upd[field] = conv(v)

    put("sr", "SR", int)
    for macro, field in (("IN_SIZE", None), ("ZS_CHANNELS", "zs_channels"),
                         ("ZT_CHANNELS", "zt_channels"),
                         ("STRUCTURE_TYPE", "structure_type")):
        v = b.get(macro)
        if v is not None and field:
            upd[field] = v

    dn = "DenoiserV2"
    for f in ("embed_dim", "noise_embed_dims", "n_layers", "mlp_multiplier",
              "local_attention_size", "attention_chunk_size"):
        put(f"denoiser.{f}", f"{dn}.{f}", int)
    put("denoiser.causal", f"{dn}.causal", bool)
    put("denoiser.pos_emb_type", f"{dn}.pos_emb_type", str)
    put("denoiser.dropout", f"{dn}.dropout", float)

    ec = "ECAPATDNN"
    put("encoder.channels", f"{ec}.channels", tuple, scope="encoder")
    put("encoder.kernel_sizes", f"{ec}.kernel_sizes", tuple, scope="encoder")
    put("encoder.dilations", f"{ec}.dilations", tuple, scope="encoder")
    put("encoder.res2net_scale", f"{ec}.res2net_scale", int, scope="encoder")
    put("encoder.se_channels", f"{ec}.se_channels", int, scope="encoder")
    put("encoder.attention_channels", f"{ec}.attention_channels", int,
        scope="encoder")
    put("encoder.global_context", f"{ec}.global_context", bool,
        scope="encoder")
    put("encoder.regularisation", f"{ec}.regularisation", str,
        scope="encoder")

    for scope, sub in (("encoder_time", "encoder_time"),
                       ("classifier", "classifier")):
        put(f"{sub}.channels", "Encoder1D.channels", tuple, scope=scope)
        put(f"{sub}.ratios", "Encoder1D.ratios", tuple, scope=scope)
        put(f"{sub}.average_out", "Encoder1D.average_out", bool, scope=scope)

    n_signal = b.get("N_SIGNAL")
    cfg = with_overrides(AfterConfig(), upd)
    in_size = b.get("IN_SIZE")
    if isinstance(in_size, int):
        cfg = cfg.resolved(in_size=in_size,
                           n_signal=n_signal
                           if isinstance(n_signal, int) else None)
    return cfg
