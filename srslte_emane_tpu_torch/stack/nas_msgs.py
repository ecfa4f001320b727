"""NAS EMM/ESM message schemas (24.301 content).

Reference behavior: `srsue/src/stack/upper/nas.cc` (attach, authentication,
security mode, PDN connectivity, service request) and `srsepc/src/mme/nas.cc`.
"""

from __future__ import annotations

import dataclasses

from . import codec, per


@codec.register
@per.schema(("imsi", "str"), ("pdn_type", "enum", ("ipv4", "ipv6", "ipv4v6")),
            ("esm_pdn_connectivity", "bool"), ("guti", "int", "?"))
@dataclasses.dataclass
class AttachRequest:
    """imsi XOR guti: a previously-registered UE attaches with its GUTI
    (24.301 §5.5.1.2.2); the MME asks for the IMSI via the identity
    procedure when the GUTI maps to no stored context."""
    imsi: str
    pdn_type: str = "ipv4"
    esm_pdn_connectivity: bool = True
    guti: int = None


@codec.register
@per.schema(("identity_type", "enum", ("imsi", "imei")))
@dataclasses.dataclass
class IdentityRequest:
    """24.301 §8.2.18: the network asks for a permanent identity when an
    attach GUTI is unknown (srsepc nas.cc identity procedure)."""
    identity_type: str = "imsi"


@codec.register
@per.schema(("imsi", "str"))
@dataclasses.dataclass
class IdentityResponse:
    imsi: str = ""


@codec.register
@per.schema(("rand", "bytes"), ("autn", "bytes"))
@dataclasses.dataclass
class AuthenticationRequest:
    rand: bytes
    autn: bytes


@codec.register
@per.schema(("res", "bytes"))
@dataclasses.dataclass
class AuthenticationResponse:
    res: bytes


@codec.register
@per.schema(("cause", "enum", ("mac-failure", "synch-failure")),
            ("auts", "bytes"))
@dataclasses.dataclass
class AuthenticationFailure:
    """24.301 §8.2.5: UE-side AKA failure; synch-failure carries the
    14-byte AUTS resynchronisation token (TS 33.102 §6.3.3)."""
    cause: str = "synch-failure"
    auts: bytes = b""


@codec.register
@per.schema()
@dataclasses.dataclass
class AuthenticationReject:
    pass


@codec.register
@per.schema(("cause", "cint", 0, 255))
@dataclasses.dataclass
class AttachReject:
    """24.301 §8.2.3: attach rejected with an EMM cause (#11 "PLMN not
    allowed" etc.; nas.cc attach-reject handling)."""
    cause: int = 11


@codec.register
@per.schema()
@dataclasses.dataclass
class DetachAccept:
    pass


@codec.register
@per.schema(("eea", "cint", 0, 7), ("eia", "cint", 0, 7))
@dataclasses.dataclass
class NasSecurityModeCommand:
    eea: int = 0
    eia: int = 2


@codec.register
@per.schema()
@dataclasses.dataclass
class NasSecurityModeComplete:
    pass


@codec.register
@per.schema(("ip_addr", "str"), ("guti", "int"),
            ("eps_bearer_id", "cint", 0, 15),
            ("pdn_type", "enum", ("ipv4", "ipv6", "ipv4v6")),
            ("ip6_iid", "bytes", "?"))
@dataclasses.dataclass
class AttachAccept:
    ip_addr: str = "172.16.0.2"
    guti: int = 0
    eps_bearer_id: int = 5
    # activate default EPS bearer context request is piggybacked
    pdn_type: str = "ipv4"
    # IPv6 interface identifier (24.301 §9.9.4.9: the PDN address carries
    # the 8-byte IID; the UE composes prefix + IID — gw.cc IPv6 path)
    ip6_iid: bytes = b""


@codec.register
@per.schema()
@dataclasses.dataclass
class AttachComplete:
    pass


@codec.register
@per.schema(("full_name", "str"), ("short_name", "str"))
@dataclasses.dataclass
class EmmInformation:
    """24.301 §8.2.13 EMM Information: network names pushed after attach
    (srsepc nas.cc pack_emm_information sends these very strings)."""
    full_name: str = "Software Radio Systems LTE"
    short_name: str = "srsLTE"


@codec.register
@per.schema(("switch_off", "bool"))
@dataclasses.dataclass
class DetachRequest:
    switch_off: bool = True


@codec.register
@per.schema(("guti", "int"))
@dataclasses.dataclass
class ServiceRequest:
    """24.301 Service Request: a registered-idle UE resuming user-plane
    bearers (paging response / pending UL data) without re-attaching."""

    guti: int = 0


@codec.register
@per.schema(("guti", "int"),
            ("service_type", "enum", ("mo-csfb", "mt-csfb",
                                      "mo-csfb-emergency")))
@dataclasses.dataclass
class ExtendedServiceRequest:
    """24.301 §8.2.15 Extended Service Request: circuit-switched fallback.
    The UE asks to be moved to a CS-capable RAT for a voice call
    (liblte_mme.cc LIBLTE_MME_MSG_TYPE_EXTENDED_SERVICE_REQUEST;
    srsepc nas.cc CSFB handling)."""

    guti: int = 0
    service_type: str = "mo-csfb"


@codec.register
@per.schema(("caller_id", "str"))
@dataclasses.dataclass
class CsServiceNotification:
    """24.301 §8.2.9 CS Service Notification: the MME tells a CONNECTED UE
    a mobile-terminated CS call is waiting (the idle-UE equivalent is a
    CS-domain page)."""

    caller_id: str = ""


@codec.register
@per.schema()
@dataclasses.dataclass
class ServiceAccept:
    pass


@codec.register
@per.schema(("cause", "cint", 0, 255))
@dataclasses.dataclass
class ServiceReject:
    cause: int = 9  # UE identity cannot be derived by the network


@codec.register
@per.schema(("guti", "int"), ("tac", "cint", 0, 65535))
@dataclasses.dataclass
class TrackingAreaUpdateRequest:
    """24.301 §8.2.29: periodic (T3412) or mobility-triggered TAU from a
    registered UE (nas.cc start_tracking_area_update)."""
    guti: int = 0
    tac: int = 0


@codec.register
@per.schema(("t3412", "cint", 0, 65535))
@dataclasses.dataclass
class TrackingAreaUpdateAccept:
    """24.301 §8.2.26: TAU accepted; carries the refreshed T3412."""
    t3412: int = 500


@codec.register
@per.schema(("eps_bearer_id", "cint", 0, 15), ("linked_bearer_id", "cint", 0, 15),
            ("qci", "cint", 0, 255), ("tft", "bytes"))
@dataclasses.dataclass
class ActivateDedicatedEpsBearerRequest:
    """24.301 §8.3.3 (nas.cc ESM dedicated bearer): carries the linked
    default bearer, QCI, and the packed 24.008 TFT (stack/tft.py)."""

    eps_bearer_id: int = 6
    linked_bearer_id: int = 5
    qci: int = 1
    tft: bytes = b""


@codec.register
@per.schema(("eps_bearer_id", "cint", 0, 15))
@dataclasses.dataclass
class ActivateDedicatedEpsBearerAccept:
    eps_bearer_id: int = 6
