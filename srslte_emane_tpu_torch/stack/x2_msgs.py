"""X2AP message schemas (36.423 content subset).

Reference behavior: srsLTE has no X2 (S1 handover only); this framework adds
the X2 Handover Preparation / SN Status / data-forwarding content as typed
messages with UPER wire encoding, matching the shape of the S1AP set
(epc/mme.py) so both interfaces share the codec runtime.
"""

from __future__ import annotations

import dataclasses

from . import codec, per


@codec.register
@per.schema(("mme_ue_id", "int"), ("kenb_star", "bytes"),
            ("teid_spgw", "int"), ("teid_enb", "int"),
            ("source_pci", "cint", 0, 503), ("target_pci", "cint", 0, 503))
@dataclasses.dataclass
class X2HandoverRequest:
    mme_ue_id: int
    kenb_star: bytes
    teid_spgw: int
    teid_enb: int
    source_pci: int = 0
    target_pci: int = 0


@codec.register
@per.schema(("new_rnti", "cint", 0, 65535), ("preamble", "cint", 0, 63),
            ("teid_fwd", "int"))
@dataclasses.dataclass
class X2HandoverRequestAck:
    new_rnti: int
    preamble: int
    teid_fwd: int
