"""Control-plane wire codec: UPER bit-level encoding with a JSON fallback.

The reference carries RRC/NAS/S1AP as ASN.1 UPER/APER (lib/src/asn1, 170k+
generated LoC).  Messages with a declared PER schema (stack/per.py — the
asn1_utils.cc-equivalent bit runtime) go on the wire as unaligned-PER frames
prefixed 0xA5; everything else uses the deterministic JSON tagging (which can
never start with 0xA5, so the two coexist on one wire).
"""

from __future__ import annotations

import dataclasses
import json

from . import per

PER_MAGIC = 0xA5

_REGISTRY: dict = {}


def register(cls):
    """Class decorator: make a dataclass wire-codable."""
    _REGISTRY[cls.__name__] = cls
    return cls


def _to_jsonable(v):
    if isinstance(v, bytes):
        return {"__b": v.hex()}
    if dataclasses.is_dataclass(v):
        return {"__t": type(v).__name__,
                "f": {f.name: _to_jsonable(getattr(v, f.name))
                      for f in dataclasses.fields(v)}}
    if isinstance(v, dict):
        return {k: _to_jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_to_jsonable(x) for x in v]
    return v


def _from_jsonable(v):
    if isinstance(v, dict):
        if "__b" in v:
            return bytes.fromhex(v["__b"])
        if "__t" in v:
            cls = _REGISTRY[v["__t"]]
            kw = {k: _from_jsonable(x) for k, x in v["f"].items()}
            return cls(**kw)
        return {k: _from_jsonable(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_from_jsonable(x) for x in v]
    return v


def encode(msg) -> bytes:
    if per.has_schema(msg):
        return bytes([PER_MAGIC]) + per.encode(msg)
    return json.dumps(_to_jsonable(msg), separators=(",", ":")).encode()


def decode(data: bytes):
    if data[:1] == bytes([PER_MAGIC]):
        return per.decode(data[1:])
    return _from_jsonable(json.loads(data.decode()))
