"""Corpus parsers: map a dataset directory to (audio_files, midi_files,
metadatas) (the port's copy of after_tpu/dataset/parsers.py).

``simple_audio``, ``simple_midi``, ``slakh`` and ``vital``; WAV only (see
audio.py), other audio extensions are listed so users see what was skipped.
Slakh's ``metadata.yaml`` files are read by ``read_yaml_mapping``, a reader
of the YAML subset they use (nested block mappings of scalars), so that the
port needs no YAML package.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, List, Tuple

AUDIO_EXTS = (".wav", ".WAV")
UNSUPPORTED_EXTS = (".mp3", ".flac", ".ogg", ".opus", ".aif", ".aiff", ".m4a")
MIDI_EXTS = (".mid", ".midi", ".MID")

# Slakh instruments left out of a corpus
SLAKH_BANNED = ("drum", "percussion", "sound effect", "sound fx")


# ---------------------------------------------------------------------------
# the YAML subset of Slakh's metadata files
# ---------------------------------------------------------------------------

# plain scalars as YAML 1.1 (PyYAML's safe_load) resolves them; anything a
# YAML 1.1 reader would read as another type (octal, hex, sexagesimal,
# timestamps, numbers with underscores, .inf / .nan) is refused
_NULL = re.compile(r"~|null|Null|NULL")
_BOOL = {w: v for v, words in ((True, "yes Yes YES true True TRUE on On ON"),
                               (False, "no No NO false False FALSE off Off "
                                       "OFF"))
         for w in words.split()}
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9]*)")
_FLOAT = re.compile(r"[-+]?[0-9]+\.[0-9]*(?:[eE][-+][0-9]+)?")
_REFUSED = re.compile(
    r"[-+]?0[0-9_]+|[-+]?0[bxo].*|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?"
    r"|[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}.*|[-+]?\.?[0-9][0-9_.]*_[0-9_.eE+-]*"
    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN)|[-+]?\.[0-9].*"
    r"|[-+]?[0-9]+(?:\.[0-9]*)?[eE][0-9].*")
_INDICATORS = tuple("[]{}&*!|>%@`,?-") + ("- ",)


class YamlSubsetError(ValueError):
    pass


def _strip_comment(line: str) -> str:
    """``line`` without a trailing `` #`` comment outside quotes."""
    quote = None
    for i, c in enumerate(line):
        if quote:
            if c == quote:
                quote = None
        elif c in "\"'" and (i == 0 or line[i - 1] in " :"):
            quote = c
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _scalar(text: str, where: str) -> Any:
    text = text.strip()
    if text.startswith('"'):
        if not text.endswith('"') or len(text) < 2:
            raise YamlSubsetError(f"{where}: unterminated string {text!r}")
        try:
            return json.loads(text)
        except ValueError as e:
            raise YamlSubsetError(f"{where}: string {text!r}: {e}") from None
    if text.startswith("'"):
        inner = text[1:-1]
        if (not text.endswith("'") or len(text) < 2
                or "'" in inner.replace("''", "")):
            raise YamlSubsetError(f"{where}: bad quoted string {text!r}")
        return inner.replace("''", "'")
    if text == "" or _NULL.fullmatch(text):
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.fullmatch(text):
        return int(text)
    if _FLOAT.fullmatch(text):
        return float(text)
    if (_REFUSED.fullmatch(text) or text.startswith(_INDICATORS)
            or ": " in text or text.endswith(":") or "\t" in text):
        raise YamlSubsetError(f"{where}: {text!r} is outside the YAML subset "
                              f"this reader knows")
    return text


def read_yaml_mapping(path: str) -> Dict[Any, Any]:
    """A YAML file of nested block mappings of scalars -> nested dicts, as
    ``yaml.safe_load`` reads it.  Scalars: quoted strings, plain strings,
    integers, floats, booleans and null, with comments.  Anything else
    (sequences, flow collections, anchors, tags, multi-line scalars,
    documents markers) raises ``YamlSubsetError``."""
    with open(path) as f:
        lines = f.read().splitlines()
    root: Dict[Any, Any] = {}
    # (indent, mapping) of the open mappings; a key without a value waits
    # for a deeper line to open its mapping
    stack: List[Tuple[int, Dict[Any, Any]]] = [(-1, root)]
    pending = None        # (indent, parent mapping, key) of a bare "key:"
    for n, raw in enumerate(lines, 1):
        where = f"{path}:{n}"
        line = _strip_comment(raw).rstrip()
        if not line.strip():
            continue
        if "\t" in line[:len(line) - len(line.lstrip())]:
            raise YamlSubsetError(f"{where}: tab indentation")
        indent = len(line) - len(line.lstrip(" "))
        body = line.strip()
        if pending is not None:
            p_indent, parent, key = pending
            pending = None
            if indent > p_indent:
                parent[key] = {}
                stack.append((indent, parent[key]))
        while indent < stack[-1][0]:
            stack.pop()
        if indent != stack[-1][0]:
            if stack[-1][0] == -1 and not root:
                stack[-1] = (indent, root)
            else:
                raise YamlSubsetError(f"{where}: unexpected indentation")
        m = re.fullmatch(r"([^\s\"'#:][^:]*?|\"[^\"]*\"|'[^']*')"
                         r":(?:\s+(.*))?", body)
        if m is None:
            raise YamlSubsetError(f"{where}: {body!r} is not a 'key: value' "
                                  f"line")
        key = _scalar(m.group(1), where)
        mapping = stack[-1][1]
        if m.group(2) is None or not m.group(2).strip():
            mapping[key] = None
            pending = (indent, mapping, key)
        else:
            mapping[key] = _scalar(m.group(2), where)
    return root


# ---------------------------------------------------------------------------
# parsers
# ---------------------------------------------------------------------------


def _walk(path: str, exts) -> List[str]:
    out = []
    for root, _, files in os.walk(path):
        for f in sorted(files):
            if f.endswith(exts):
                out.append(os.path.join(root, f))
    return sorted(out)


def simple_audio(path: str, **kwargs):
    audio = _walk(path, AUDIO_EXTS)
    skipped = _walk(path, UNSUPPORTED_EXTS)
    if skipped:
        print(f"[parsers] skipped {len(skipped)} non-wav files "
              f"(no decoder available in this environment)")
    metadatas = [{"path": f, "name": os.path.splitext(os.path.basename(f))[0]}
                 for f in audio]
    return audio, [None] * len(audio), metadatas


def simple_midi(path: str, **kwargs):
    """Each audio file paired with a .mid file of the same stem; files
    without one are left out."""
    audio, _, metadatas = simple_audio(path)
    midis = []
    for f in audio:
        stem = os.path.splitext(f)[0]
        found = None
        for ext in MIDI_EXTS:
            if os.path.exists(stem + ext):
                found = stem + ext
                break
        midis.append(found)
    keep = [i for i, m in enumerate(midis) if m is not None]
    return ([audio[i] for i in keep], [midis[i] for i in keep],
            [metadatas[i] for i in keep])


def slakh(path: str, **kwargs):
    """Slakh2100 stems layout: Track*/stems/*.wav + MIDI/*.mid with a
    metadata.yaml instrument map; drums/fx stems are banned."""
    audio, midis, metadatas = [], [], []
    for track in sorted(os.listdir(path)):
        tdir = os.path.join(path, track)
        meta_file = os.path.join(tdir, "metadata.yaml")
        stems_dir = os.path.join(tdir, "stems")
        if not (os.path.isdir(stems_dir) and os.path.exists(meta_file)):
            continue
        meta = read_yaml_mapping(meta_file)
        for stem_id, info in (meta.get("stems") or {}).items():
            inst = str(info.get("inst_class", "")).lower()
            if any(b in inst for b in SLAKH_BANNED):
                continue
            wav = os.path.join(stems_dir, stem_id + ".wav")
            mid = os.path.join(tdir, "MIDI", stem_id + ".mid")
            if os.path.exists(wav):
                audio.append(wav)
                midis.append(mid if os.path.exists(mid) else None)
                metadatas.append({"path": wav, "track": track,
                                  "instrument": inst})
    return audio, midis, metadatas


def vital(path: str, **kwargs):
    """Flat folder of single-note renders named <patch>_<pitch>.wav."""
    audio = _walk(path, AUDIO_EXTS)
    metadatas = []
    for f in audio:
        name = os.path.splitext(os.path.basename(f))[0]
        parts = name.rsplit("_", 1)
        metadatas.append({"path": f, "patch": parts[0],
                          "pitch": parts[1] if len(parts) > 1 else ""})
    return audio, [None] * len(audio), metadatas


_PARSERS = {"simple_audio": simple_audio, "simple_midi": simple_midi,
            "slakh": slakh, "vital": vital}


def get_parser(name: str):
    if name not in _PARSERS:
        raise KeyError(f"unknown parser {name!r}; available: {sorted(_PARSERS)}")
    return _PARSERS[name]
