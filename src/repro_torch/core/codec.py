"""Pluggable wire codecs for host↔client frames.

A copy of ``repro/core/codec.py``: the wire contract, so the port's
frames and the reference's are the same bytes.

``transport.py`` frames chunks of testConfigs/results into single messages
(row ``batch`` frames or columnar ``batchc`` frames — see there); this module
decides how a framed dict becomes bytes on the wire:

* ``JsonCodec``   — UTF-8 JSON, the seed protocol.  Interoperates with any
  peer (including ``send_json``/``recv_json`` ZMQ code).
* ``BinaryCodec`` — a compact self-describing container that lifts every
  *uniformly-typed numeric column* (the dominant payload of a columnar
  ``batchc`` frame: config_id lists, hw-ladder knob columns, metric columns)
  out of the JSON body and packs it as a little-endian typed array
  (int64 / float64 / uint8-bool).  A *constant string column* — every
  element the same string, e.g. the per-chunk ``tenant`` tag a
  multi-tenant ``ExploreService`` stamps on each config (chunks are
  single-tenant, so the column is always uniform) — collapses to one
  ``(value, count)`` entry instead of N JSON copies.  Other strings and
  mixed columns stay in the JSON skeleton, so the codec is lossless and
  type-exact: ints stay ints, floats round-trip bit-for-bit (no decimal
  text detour), bools stay bools.  A message with nothing to pack
  degenerates to plain JSON bytes.

Bytes payloads (artifact blobs)
-------------------------------
The fleet artifact store ships pickled ``BuildResult`` blobs inside
``artifact_put``/``artifact_chunk`` frames (see ``core.transport``).  Under
``BinaryCodec`` a ``bytes`` value (tag ``"y"``) or a uniform list of
``bytes`` (tag ``"Y"``, per-element length table) is carried as a raw blob
segment appended after the JSON header — zero copies through text,
no base64 inflation.  ``JsonCodec`` cannot carry raw bytes in a JSON
document, so it falls back to a tagged base64 wrapper
(``{"__b64__": "..."}``) that ``decode_wire`` transparently unwraps: a
JSON-configured fleet still moves blobs correctly, it just pays the ~33%
base64 tax the binary codec avoids.  (A user payload dict whose *only* key
is literally ``__b64__`` would be mangled by the unwrap; no frame in this
protocol has that shape.)

Wire negotiation
----------------
Binary frames start with a magic prefix that is invalid as leading JSON
(0x93), so ``decode_wire`` can always sniff which codec produced a payload —
every transport in this repo decodes with it, which makes a binary host
readable by a JSON client and vice versa with **zero** configuration on the
receive path.  On the send path, client transports answer in the codec of
the last frame they received (``sniff_codec``): a binary host gets binary
result frames back, a JSON host gets JSON, regardless of how the client was
configured.  The host always speaks its configured codec (it initiates).
"""
from __future__ import annotations

import base64
import json
import struct
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

# 0x93 cannot begin a JSON document, so the prefix is unambiguous
MAGIC = b"\x93JXB1"
_INT64_MIN, _INT64_MAX = -(2 ** 63), 2 ** 63 - 1

# column type tags -> (numpy dtype, bytes per element); bytes payloads use
# the separate "y" (scalar) / "Y" (column) tags with explicit lengths
_DTYPES = {"i": ("<i8", 8), "f": ("<f8", 8), "b": ("u1", 1)}


def _json_default(obj):
    """JSON fallback for ``bytes``: tagged base64 (see module docstring)."""
    if isinstance(obj, (bytes, bytearray)):
        return {"__b64__": base64.b64encode(bytes(obj)).decode("ascii")}
    raise TypeError(f"not JSON serializable: {type(obj).__name__}")


def _json_object_hook(d: dict):
    if len(d) == 1 and "__b64__" in d and isinstance(d["__b64__"], str):
        return base64.b64decode(d["__b64__"])
    return d


def _column_type(vals: list) -> Optional[str]:
    """Type tag if ``vals`` is a packable uniform scalar column, else None."""
    if not vals:
        return None
    t0 = type(vals[0])
    if t0 is bool:
        return "b" if all(type(v) is bool for v in vals) else None
    if t0 is int:
        if all(type(v) is int and _INT64_MIN <= v <= _INT64_MAX
               for v in vals):
            return "i"
        return None
    if t0 is float:
        return "f" if all(type(v) is float for v in vals) else None
    return None


class Codec:
    """encode() a framed message dict to wire bytes; decode is universal."""

    name: str = "?"

    def encode(self, msg: dict) -> bytes:
        raise NotImplementedError

    def decode(self, data: Union[bytes, str]) -> dict:
        return decode_wire(data)


class JsonCodec(Codec):
    name = "json"

    def encode(self, msg: dict) -> bytes:
        return json.dumps(msg, default=_json_default).encode("utf-8")


class BinaryCodec(Codec):
    name = "binary"

    def encode(self, msg: dict) -> bytes:
        packed: List[dict] = []
        blobs: List[bytes] = []
        skeleton = self._strip(msg, (), packed, blobs)
        if not packed:                  # nothing to pack: plain JSON is fine
            return json.dumps(msg, default=_json_default).encode("utf-8")
        header = json.dumps({"h": skeleton, "p": packed},
                            separators=(",", ":"),
                            default=_json_default).encode("utf-8")
        return b"".join([MAGIC, struct.pack("<I", len(header)), header]
                        + blobs)

    def _strip(self, obj: dict, path: Tuple[str, ...],
               packed: List[dict], blobs: List[bytes]) -> dict:
        """Copy ``obj`` minus packable columns, recording them in order."""
        out: Dict = {}
        for k, v in obj.items():
            if isinstance(v, dict):
                out[k] = self._strip(v, path + (k,), packed, blobs)
                continue
            if isinstance(v, (bytes, bytearray)):      # raw blob segment
                packed.append({"k": list(path) + [k], "t": "y", "n": len(v)})
                blobs.append(bytes(v))
                continue
            if isinstance(v, list):
                if v and all(isinstance(x, (bytes, bytearray)) for x in v):
                    packed.append({"k": list(path) + [k], "t": "Y",
                                   "l": [len(x) for x in v]})
                    blobs.append(b"".join(bytes(x) for x in v))
                    continue
                tag = _column_type(v)
                if tag is not None:
                    dt, _ = _DTYPES[tag]
                    packed.append({"k": list(path) + [k], "t": tag,
                                   "n": len(v)})
                    blobs.append(np.asarray(v, dt).tobytes())
                    continue
                if len(v) > 1 and type(v[0]) is str \
                        and all(type(x) is str and x == v[0] for x in v):
                    # constant string column (e.g. a chunk's tenant tags):
                    # one (value, count) entry, no blob segment
                    packed.append({"k": list(path) + [k], "t": "c",
                                   "n": len(v), "v": v[0]})
                    continue
            out[k] = v
        return out


def _decode_binary(data: bytes) -> dict:
    (hlen,) = struct.unpack_from("<I", data, len(MAGIC))
    off = len(MAGIC) + 4
    header = json.loads(data[off:off + hlen].decode("utf-8"),
                        object_hook=_json_object_hook)
    off += hlen
    msg = header["h"]
    for ent in header["p"]:
        tag = ent["t"]
        if tag == "y":                       # scalar bytes: raw slice
            n = ent["n"]
            col: object = data[off:off + n]
            off += n
        elif tag == "Y":                     # bytes column: length table
            parts = []
            for ln in ent["l"]:
                parts.append(data[off:off + ln])
                off += ln
            col = parts
        elif tag == "c":                     # constant string column
            col = [ent["v"]] * ent["n"]
        else:
            dt, width = _DTYPES[tag]
            n = ent["n"]
            col = np.frombuffer(data, dt, n, off).tolist()
            off += n * width
            if tag == "b":
                col = [bool(x) for x in col]
        tgt = msg
        for k in ent["k"][:-1]:
            tgt = tgt[k]
        tgt[ent["k"][-1]] = col
    return msg


def decode_wire(data: Union[bytes, bytearray, str]) -> dict:
    """Sniffing decoder: every transport reads both codecs transparently."""
    if isinstance(data, str):
        return json.loads(data, object_hook=_json_object_hook)
    if bytes(data[:len(MAGIC)]) == MAGIC:
        return _decode_binary(bytes(data))
    return json.loads(bytes(data).decode("utf-8"),
                      object_hook=_json_object_hook)


def sniff_codec(data: Union[bytes, bytearray, str]) -> str:
    """Which codec produced this payload ('json' | 'binary')."""
    if not isinstance(data, str) and bytes(data[:len(MAGIC)]) == MAGIC:
        return "binary"
    return "json"


JSON_CODEC = JsonCodec()
BINARY_CODEC = BinaryCodec()
CODECS: Dict[str, Codec] = {c.name: c for c in (JSON_CODEC, BINARY_CODEC)}


def resolve_codec(codec: Union[str, Codec, None]) -> Codec:
    if codec is None:
        return JSON_CODEC
    if isinstance(codec, Codec):
        return codec
    try:
        return CODECS[codec]
    except KeyError:
        raise ValueError(f"unknown codec {codec!r}; "
                         f"choose from {sorted(CODECS)}") from None
