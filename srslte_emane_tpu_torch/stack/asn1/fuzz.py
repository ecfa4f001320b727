"""Randomized value generation over the PER schema DSL — the engine of the
differential codec fuzzer.

`rand_value(t, rng)` walks any `runtime.Type` declaration and produces a
random, schema-valid Python value: encode it with our codec, feed the bytes
to the REFERENCE's generated codec (`lib/src/asn1/rrc_asn1.cc`,
`liblte_s1ap.cc`, `liblte_mme.cc` via the harnesses in
`scripts/s1ap_interop/`), and require unpack + repack byte-identity.  The
reference's `lib/test/asn1/*` does the same with hand-picked values; the
fuzzer covers the whole declared surface.

Knobs:
  - avoid: field/alternative NAMES never generated.  Used for schema nodes
    that model a structured 3GPP type as an opaque OCTET STRING stand-in
    (random octets would be valid PER for us but garbage structure to the
    reference), and for post-REL-10 extension arms the reference's codec
    vintage predates.
  - p_opt / p_ext / p_extalt: presence probabilities for OPTIONAL fields,
    extension-addition groups, and extension CHOICE alternatives.
"""

from __future__ import annotations

import numpy as np

from . import runtime as rt

# Schema nodes whose contents the reference parses structurally but we
# model as opaque stand-ins (or whose semantic constraints a blind random
# draw would violate).  Fuzzing skips these; shrink this list by replacing
# stand-ins with real schemas.
DEFAULT_AVOID = frozenset({
    # SystemInformation: nonCriticalExtension is a structured v8a0-IE
    # chain in the reference, we carry it opaquely
    "non_crit_ext",
})


class FuzzConfig:
    def __init__(self, avoid=DEFAULT_AVOID, p_opt=0.55, p_ext=0.35,
                 p_extalt=0.2, max_seqof=3, max_octets=12, max_bits=24):
        self.avoid = frozenset(avoid) | DEFAULT_AVOID
        self.p_opt = p_opt
        self.p_ext = p_ext
        self.p_extalt = p_extalt
        self.max_seqof = max_seqof
        self.max_octets = max_octets
        self.max_bits = max_bits


def _flag_optional(flag) -> bool:
    return flag == "?" or (isinstance(flag, tuple) and flag[0] == "=")


def rand_value(t: rt.Type, rng: np.random.Generator,
               cfg: FuzzConfig | None = None):
    """Random schema-valid value for declaration `t`."""
    cfg = cfg or FuzzConfig()
    return _gen(t, rng, cfg)


def _gen(t, rng, cfg):
    if isinstance(t, rt.Ref):
        return _gen(t.target, rng, cfg)
    if isinstance(t, rt.Null):
        return None
    if isinstance(t, rt.Bool):
        return bool(rng.integers(0, 2))
    if isinstance(t, rt.Int):
        lo = 0 if t.lo is None else t.lo
        hi = t.hi if t.hi is not None else lo + int(rng.integers(0, 1 << 16))
        return int(rng.integers(lo, hi + 1))
    if isinstance(t, rt.Enum):
        # root values only: extension additions round-trip, but several
        # reference enums reject indices their vintage doesn't know
        return t.names[int(rng.integers(0, t.n_root))]
    if isinstance(t, rt.BitStr):
        n = int(rng.integers(t.lo, t.hi + 1))
        return "".join("01"[b] for b in rng.integers(0, 2, n))
    if isinstance(t, rt.UncBitStr):
        # never zero-length: the reference's dyn_bitstring::unpack
        # dereferences &octets_[0] on the resized-to-0 vector
        # (asn1_utils.cc:947) and fails on an empty BIT STRING, although
        # X.691 permits one (e.g. codebookSubsetRestriction-r10)
        n = int(rng.integers(1, cfg.max_bits + 1))
        return "".join("01"[b] for b in rng.integers(0, 2, n))
    if isinstance(t, rt.OctStr):
        lo = t.lo
        hi = t.hi if t.hi is not None else lo + cfg.max_octets
        n = int(rng.integers(lo, hi + 1))
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    if isinstance(t, rt.SeqOf):
        lo = t.lo
        hi = min(t.hi if t.hi is not None else lo + cfg.max_seqof,
                 lo + cfg.max_seqof)
        n = int(rng.integers(lo, max(lo, hi) + 1))
        return [_gen(t.elem, rng, cfg) for _ in range(n)]
    if isinstance(t, rt.Choice):
        def ok(name):
            return name not in cfg.avoid and not name.startswith("spare")
        allowed_root = [i for i in range(t.n_root) if ok(t.alts[i][0])]
        allowed_ext = [i for i in range(t.n_root, len(t.alts))
                       if ok(t.alts[i][0])]
        if not allowed_root and not allowed_ext:  # all spares: keep one
            allowed_root = list(range(t.n_root))
        if allowed_ext and (not allowed_root
                            or rng.random() < cfg.p_extalt):
            i = allowed_ext[int(rng.integers(0, len(allowed_ext)))]
        else:
            if not allowed_root:
                raise ValueError("all root alternatives avoided")
            i = allowed_root[int(rng.integers(0, len(allowed_root)))]
        name, typ = t.alts[i]
        return (name, _gen(typ, rng, cfg))
    if isinstance(t, rt.Seq):
        out = {}
        for name, typ, flag in t.fields:
            if _flag_optional(flag):
                if name in cfg.avoid or rng.random() >= cfg.p_opt:
                    continue
            elif name in cfg.avoid:
                raise ValueError(f"mandatory field {name} is avoided")
            out[name] = _gen(typ, rng, cfg)
        for g in t.ext_fields:
            if rng.random() >= cfg.p_ext:
                continue
            grp = g if isinstance(g, list) else [g]
            if any(gf[0] in cfg.avoid
                   and not _flag_optional(gf[2] if len(gf) > 2 else "")
                   for gf in grp):
                continue  # a mandatory member is avoided: skip the group
            vals = {}
            for gf in grp:
                gname, gtyp = gf[0], gf[1]
                gflag = gf[2] if len(gf) > 2 else ""
                if gname in cfg.avoid:
                    continue
                if _flag_optional(gflag) and rng.random() >= cfg.p_opt:
                    continue
                vals[gname] = _gen(gtyp, rng, cfg)
            if not vals and grp:
                # ensure the fired group is observable: force the first
                # non-avoided member
                for gf in grp:
                    if gf[0] not in cfg.avoid:
                        vals[gf[0]] = _gen(gf[1], rng, cfg)
                        break
            out.update(vals)
        return out
    raise TypeError(f"unknown schema node {type(t).__name__}")


def roundtrip_ok(t: rt.Type, v, aligned: bool = False):
    """our-encode -> our-decode -> our-re-encode must be byte-stable."""
    enc = rt.aper_encode if aligned else rt.uper_encode
    dec = rt.aper_decode if aligned else rt.uper_decode
    b1 = enc(t, v)
    v2 = dec(t, b1)
    b2 = enc(t, v2)
    return b1 == b2, b1, v2
