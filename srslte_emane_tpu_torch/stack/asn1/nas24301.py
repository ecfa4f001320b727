"""24.301/24.008 NAS wire codec (byte-level TLV).

The reference carries NAS EMM/ESM as hand-packed TLV octets
(`lib/src/asn1/liblte_mme.cc`, ~13k LoC of pack/unpack pairs); its test
suite pins real captured messages (`lib/test/asn1/srslte_asn1_nas_test.cc`,
`srsue/test/upper/rrc_reconfig_test.cc`).  This module is a declarative
Python codec for the same wire format: each message is a field list over a
small set of IE primitives (V / half-octet V / LV / LV-E / TV / TLV /
half-octet TV), decoded to dicts and re-encoded byte-exact.

The message-level simulator keeps using `stack/nas_msgs.py` internally;
this codec exists for interop — decoding and generating the REAL wire
bytes (tests/test_nas_reference_vectors.py round-trips the reference's
captured vectors)."""

from __future__ import annotations

# protocol discriminators
PD_EMM = 7
PD_ESM = 2

# EMM message types (24.301 Table 9.8.1)
ATTACH_REQUEST = 0x41
ATTACH_ACCEPT = 0x42
ATTACH_COMPLETE = 0x43
ATTACH_REJECT = 0x44
DETACH_REQUEST = 0x45
DETACH_ACCEPT = 0x46
TAU_REQUEST = 0x48
TAU_ACCEPT = 0x49
TAU_COMPLETE = 0x4A
TAU_REJECT = 0x4B
EXTENDED_SERVICE_REQUEST = 0x4C
SERVICE_REJECT = 0x4E
SERVICE_ACCEPT = 0x4F
GUTI_REALLOCATION_COMMAND = 0x50
GUTI_REALLOCATION_COMPLETE = 0x51
AUTHENTICATION_REQUEST = 0x52
AUTHENTICATION_RESPONSE = 0x53
AUTHENTICATION_REJECT = 0x54
IDENTITY_REQUEST = 0x55
IDENTITY_RESPONSE = 0x56
AUTHENTICATION_FAILURE = 0x5C
SECURITY_MODE_COMMAND = 0x5D
SECURITY_MODE_COMPLETE = 0x5E
SECURITY_MODE_REJECT = 0x5F
EMM_STATUS = 0x60
EMM_INFORMATION = 0x61
DOWNLINK_NAS_TRANSPORT = 0x62
UPLINK_NAS_TRANSPORT = 0x63
CS_SERVICE_NOTIFICATION = 0x64
# ESM message types (24.301 Table 9.8.2)
ACT_DEFAULT_BEARER_REQ = 0xC1
ACT_DEFAULT_BEARER_ACCEPT = 0xC2
ACT_DEFAULT_BEARER_REJECT = 0xC3
ACT_DEDICATED_BEARER_REQ = 0xC5
ACT_DEDICATED_BEARER_ACCEPT = 0xC6
ACT_DEDICATED_BEARER_REJECT = 0xC7
MODIFY_BEARER_REQ = 0xC9
MODIFY_BEARER_ACCEPT = 0xCA
MODIFY_BEARER_REJECT = 0xCB
DEACT_BEARER_REQ = 0xCD
DEACT_BEARER_ACCEPT = 0xCE
PDN_CONNECTIVITY_REQUEST = 0xD0
PDN_CONNECTIVITY_REJECT = 0xD1
PDN_DISCONNECT_REQUEST = 0xD2
PDN_DISCONNECT_REJECT = 0xD3
BEARER_RESOURCE_ALLOC_REQUEST = 0xD4
BEARER_RESOURCE_ALLOC_REJECT = 0xD5
BEARER_RESOURCE_MOD_REQUEST = 0xD6
BEARER_RESOURCE_MOD_REJECT = 0xD7
ESM_INFORMATION_REQUEST = 0xD9
ESM_INFORMATION_RESPONSE = 0xDA
ESM_NOTIFICATION = 0xDB
ESM_STATUS = 0xE8

SEC_PLAIN = 0
SEC_SERVICE_REQUEST = 0xC  # 24.301 §9.3.1: Service Request's special header


class NasDecodeError(ValueError):
    pass


class _Reader:
    def __init__(self, data: bytes):
        self.d = data
        self.p = 0

    def take(self, n: int) -> bytes:
        if self.p + n > len(self.d):
            raise NasDecodeError(f"truncated at {self.p}+{n}/{len(self.d)}")
        out = self.d[self.p : self.p + n]
        self.p += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def peek(self):
        return self.d[self.p] if self.p < len(self.d) else None

    @property
    def exhausted(self):
        return self.p >= len(self.d)


# ---- field kinds ----------------------------------------------------------
# ("name", kind, *args); optional IEs carry their IEI.
#   v(n)     mandatory fixed n-byte value
#   half     mandatory half-octet value pair packed in one byte (hi, lo)
#   lv       mandatory 1-byte-length + value
#   lve      mandatory 2-byte-length + value (ESM container)
#   tlv(iei) optional IEI + 1-byte-length + value
#   tv(iei)  optional IEI + fixed n-byte value
#   thv(iei) optional half-octet: IEI in the high nibble, value in the low


def _dec_fields(r: _Reader, fields) -> dict:
    out = {}
    for f in fields:
        name, kind = f[0], f[1]
        if kind == "v":
            out[name] = r.take(f[2])
        elif kind == "half":
            b = r.u8()
            out[name] = (b >> 4, b & 0x0F)
        elif kind == "lv":
            out[name] = r.take(r.u8())
        elif kind == "lve":
            n = int.from_bytes(r.take(2), "big")
            out[name] = r.take(n)
        elif kind == "tlv":
            if r.peek() == f[2]:
                r.u8()
                out[name] = r.take(r.u8())
        elif kind == "tlve":
            if r.peek() == f[2]:
                r.u8()
                out[name] = r.take(int.from_bytes(r.take(2), "big"))
        elif kind == "tv":
            if r.peek() == f[2]:
                r.u8()
                out[name] = r.take(f[3])
        elif kind == "thv":
            b = r.peek()
            if b is not None and (b >> 4) == f[2]:
                out[name] = r.u8() & 0x0F
        else:
            raise AssertionError(kind)
    return out


def _enc_fields(msg: dict, fields) -> bytes:
    out = bytearray()
    for f in fields:
        name, kind = f[0], f[1]
        v = msg.get(name)
        if kind == "v":
            assert len(v) == f[2], (name, v)
            out += v
        elif kind == "half":
            out.append((v[0] << 4) | v[1])
        elif kind == "lv":
            out.append(len(v))
            out += v
        elif kind == "lve":
            out += len(v).to_bytes(2, "big")
            out += v
        elif kind == "tlv":
            if v is not None:
                out.append(f[2])
                out.append(len(v))
                out += v
        elif kind == "tlve":
            if v is not None:
                out.append(f[2])
                out += len(v).to_bytes(2, "big")
                out += v
        elif kind == "tv":
            if v is not None:
                out.append(f[2])
                out += v
        elif kind == "thv":
            if v is not None:
                out.append((f[2] << 4) | (v & 0x0F))
        else:
            raise AssertionError(kind)
    return bytes(out)


# ---- message field tables (24.301 §8; IEI values per liblte_mme.h) -------

ATTACH_ACCEPT_FIELDS = (
    ("attach_result", "half"),       # result + spare half octet
    ("t3412", "v", 1),               # GPRS timer
    ("tai_list", "lv"),
    ("esm_container", "lve"),
    ("guti", "tlv", 0x50),           # EPS mobile identity
    ("lai", "tv", 0x13, 5),
    ("ms_identity", "tlv", 0x23),
    ("emm_cause", "tv", 0x53, 1),
    ("t3402", "tv", 0x17, 1),
    ("t3423", "tv", 0x59, 1),
    ("equivalent_plmns", "tlv", 0x4A),
    ("emergency_numbers", "tlv", 0x34),
    ("eps_network_feature_support", "tlv", 0x64),
    ("additional_update_result", "thv", 0xF),
)

ACT_DEFAULT_BEARER_REQ_FIELDS = (
    ("eps_qos", "lv"),
    ("apn", "lv"),
    ("pdn_address", "lv"),
    ("transaction_id", "tlv", 0x5D),
    ("negotiated_qos", "tlv", 0x30),
    ("llc_sapi", "tv", 0x32, 1),
    ("radio_priority", "thv", 0x8),
    ("packet_flow_id", "tlv", 0x34),
    ("apn_ambr", "tlv", 0x5E),
    ("esm_cause", "tv", 0x58, 1),
    ("protocol_config_options", "tlv", 0x27),
)

ACT_DEDICATED_BEARER_REQ_FIELDS = (
    ("linked_ebi", "half"),          # linked EPS bearer id + spare
    ("eps_qos", "lv"),
    ("tft", "lv"),
    ("transaction_id", "tlv", 0x5D),
    ("negotiated_qos", "tlv", 0x30),
    ("llc_sapi", "tv", 0x32, 1),
    ("radio_priority", "thv", 0x8),
    ("packet_flow_id", "tlv", 0x34),
    ("protocol_config_options", "tlv", 0x27),
)

ATTACH_REQUEST_FIELDS = (
    ("ksi_attach_type", "half"),     # NAS KSI (hi) + EPS attach type (lo)
    ("eps_mobile_identity", "lv"),
    ("ue_network_capability", "lv"),
    ("esm_container", "lve"),
    ("old_ptmsi_signature", "tv", 0x19, 3),
    ("additional_guti", "tlv", 0x50),
    ("last_visited_tai", "tv", 0x52, 5),
    ("drx_parameter", "tv", 0x5C, 2),
    ("ms_network_capability", "tlv", 0x31),
    ("old_lai", "tv", 0x13, 5),
    ("tmsi_status", "thv", 0x9),
    ("ms_classmark2", "tlv", 0x11),
    ("ms_classmark3", "tlv", 0x20),
    ("supported_codecs", "tlv", 0x40),
    ("additional_update_type", "thv", 0xF),
    ("voice_domain_pref", "tlv", 0x5D),
    ("device_properties", "thv", 0xD),
    ("old_guti_type", "thv", 0xE),
    ("ms_network_feature_support", "thv", 0xC),
)

ATTACH_COMPLETE_FIELDS = (("esm_container", "lve"),)

ATTACH_REJECT_FIELDS = (
    ("emm_cause", "v", 1),
    ("esm_container", "tlve", 0x78),
    ("t3346", "tlv", 0x5F),
)

DETACH_REQUEST_FIELDS = (  # UE-originating layout (8.2.11.1)
    ("ksi_detach_type", "half"),     # NAS KSI (hi) + detach type (lo)
    ("eps_mobile_identity", "lv"),
)

DETACH_ACCEPT_FIELDS = ()

TAU_REQUEST_FIELDS = (
    ("ksi_update_type", "half"),     # NAS KSI (hi) + EPS update type (lo)
    ("old_guti", "lv"),
    ("noncurrent_native_ksi", "thv", 0xB),
    ("gprs_cksn", "thv", 0x8),
    ("old_ptmsi_signature", "tv", 0x19, 3),
    ("additional_guti", "tlv", 0x50),
    ("nonce_ue", "tv", 0x55, 4),
    ("ue_network_capability", "tlv", 0x58),
    ("last_visited_tai", "tv", 0x52, 5),
    ("drx_parameter", "tv", 0x5C, 2),
    ("radio_cap_info_update_needed", "thv", 0xA),
    ("eps_bearer_context_status", "tlv", 0x57),
    ("ms_network_capability", "tlv", 0x31),
    ("old_lai", "tv", 0x13, 5),
    ("tmsi_status", "thv", 0x9),
    ("ms_classmark2", "tlv", 0x11),
    ("ms_classmark3", "tlv", 0x20),
    ("supported_codecs", "tlv", 0x40),
    ("additional_update_type", "thv", 0xF),
    ("voice_domain_pref", "tlv", 0x5D),
    ("old_guti_type", "thv", 0xE),
    ("device_properties", "thv", 0xD),
    ("ms_network_feature_support", "thv", 0xC),
)

TAU_ACCEPT_FIELDS = (
    ("update_result", "half"),       # EPS update result + spare
    ("t3412", "tv", 0x5A, 1),
    ("guti", "tlv", 0x50),
    ("tai_list", "tlv", 0x54),
    ("eps_bearer_context_status", "tlv", 0x57),
    ("lai", "tv", 0x13, 5),
    ("ms_identity", "tlv", 0x23),
    ("emm_cause", "tv", 0x53, 1),
    ("t3402", "tv", 0x17, 1),
    ("t3423", "tv", 0x59, 1),
    ("equivalent_plmns", "tlv", 0x4A),
    ("emergency_numbers", "tlv", 0x34),
    ("eps_network_feature_support", "tlv", 0x64),
    ("additional_update_result", "thv", 0xF),
    ("t3412_ext", "tlv", 0x5E),
)

TAU_COMPLETE_FIELDS = ()

TAU_REJECT_FIELDS = (
    ("emm_cause", "v", 1),
    ("t3346", "tlv", 0x5F),
)

EXTENDED_SERVICE_REQUEST_FIELDS = (
    ("ksi_service_type", "half"),    # NAS KSI (hi) + service type (lo)
    ("m_tmsi", "lv"),
    ("csfb_response", "thv", 0xB),
    ("eps_bearer_context_status", "tlv", 0x57),
    ("device_properties", "thv", 0xD),
)

SERVICE_REJECT_FIELDS = (
    ("emm_cause", "v", 1),
    ("t3442", "tv", 0x5B, 1),
    ("t3346", "tlv", 0x5F),
)

SERVICE_ACCEPT_FIELDS = (  # 24.301 §8.2.24
    ("eps_bearer_context_status", "tlv", 0x57),
)

GUTI_REALLOCATION_COMMAND_FIELDS = (
    ("guti", "lv"),
    ("tai_list", "tlv", 0x54),
)

GUTI_REALLOCATION_COMPLETE_FIELDS = ()

AUTHENTICATION_REQUEST_FIELDS = (
    ("ksi", "half"),                 # spare (hi) + NAS KSI (lo)
    ("rand", "v", 16),
    ("autn", "lv"),
)

AUTHENTICATION_RESPONSE_FIELDS = (("res", "lv"),)
AUTHENTICATION_REJECT_FIELDS = ()
AUTHENTICATION_FAILURE_FIELDS = (
    ("emm_cause", "v", 1),
    ("auts", "tlv", 0x30),
)

IDENTITY_REQUEST_FIELDS = (("identity_type", "half"),)
IDENTITY_RESPONSE_FIELDS = (("mobile_identity", "lv"),)

SECURITY_MODE_COMMAND_FIELDS = (
    ("selected_nas_algs", "v", 1),
    ("ksi", "half"),
    ("replayed_ue_capabilities", "lv"),
    ("imeisv_request", "thv", 0xC),
    ("replayed_nonce_ue", "tv", 0x55, 4),
    ("nonce_mme", "tv", 0x56, 4),
)

SECURITY_MODE_COMPLETE_FIELDS = (("imeisv", "tlv", 0x23),)
SECURITY_MODE_REJECT_FIELDS = (("emm_cause", "v", 1),)
EMM_STATUS_FIELDS = (("emm_cause", "v", 1),)

EMM_INFORMATION_FIELDS = (
    ("full_network_name", "tlv", 0x43),
    ("short_network_name", "tlv", 0x45),
    ("local_time_zone", "tv", 0x46, 1),
    ("utc_and_tz", "tv", 0x47, 7),
    ("daylight_saving", "tlv", 0x49),
)

DL_NAS_TRANSPORT_FIELDS = (("nas_container", "lv"),)
UL_NAS_TRANSPORT_FIELDS = (("nas_container", "lv"),)

CS_SERVICE_NOTIFICATION_FIELDS = (
    ("paging_identity", "v", 1),
    ("cli", "tlv", 0x60),
    ("ss_code", "tv", 0x61, 1),
    ("lcs_indicator", "tv", 0x62, 1),
    ("lcs_client_identity", "tlv", 0x63),
)

# ---- ESM (24.301 §8.3) ----

_PCO = ("protocol_config_options", "tlv", 0x27)

ACT_DEFAULT_BEARER_ACCEPT_FIELDS = (_PCO,)
ACT_DEFAULT_BEARER_REJECT_FIELDS = (("esm_cause", "v", 1), _PCO)
ACT_DEDICATED_BEARER_ACCEPT_FIELDS = (_PCO,)
ACT_DEDICATED_BEARER_REJECT_FIELDS = (("esm_cause", "v", 1), _PCO)

MODIFY_BEARER_REQ_FIELDS = (
    ("new_eps_qos", "tlv", 0x5B),
    ("tft", "tlv", 0x36),
    ("new_qos", "tlv", 0x30),
    ("negotiated_llc_sapi", "tv", 0x32, 1),
    ("radio_priority", "thv", 0x8),
    ("packet_flow_id", "tlv", 0x34),
    ("apn_ambr", "tlv", 0x5E),
    _PCO,
)
MODIFY_BEARER_ACCEPT_FIELDS = (_PCO,)
MODIFY_BEARER_REJECT_FIELDS = (("esm_cause", "v", 1), _PCO)

DEACT_BEARER_REQ_FIELDS = (
    ("esm_cause", "v", 1),
    _PCO,
    ("t3396", "tlv", 0x37),
)
DEACT_BEARER_ACCEPT_FIELDS = (_PCO,)

PDN_CONNECTIVITY_REQUEST_FIELDS = (
    ("pdn_request_type", "half"),    # PDN type (hi) + request type (lo)
    ("esm_info_transfer_flag", "thv", 0xD),
    ("apn", "tlv", 0x28),
    _PCO,
    ("device_properties", "thv", 0xC),
)
PDN_CONNECTIVITY_REJECT_FIELDS = (
    ("esm_cause", "v", 1),
    _PCO,
    ("t3396", "tlv", 0x37),
)

PDN_DISCONNECT_REQUEST_FIELDS = (("linked_ebi", "half"), _PCO)
PDN_DISCONNECT_REJECT_FIELDS = (("esm_cause", "v", 1), _PCO)

BEARER_RESOURCE_ALLOC_REQUEST_FIELDS = (
    ("linked_ebi", "half"),
    ("traffic_flow_aggregate", "lv"),
    ("required_traffic_flow_qos", "lv"),
    _PCO,
    ("device_properties", "thv", 0xC),
)
BEARER_RESOURCE_ALLOC_REJECT_FIELDS = (
    ("esm_cause", "v", 1),
    _PCO,
    ("t3396", "tlv", 0x37),
)

BEARER_RESOURCE_MOD_REQUEST_FIELDS = (
    ("ebi_for_packet_filter", "half"),
    ("traffic_flow_aggregate", "lv"),
    ("required_qos", "tlv", 0x5B),
    ("esm_cause", "tv", 0x58, 1),
    _PCO,
    ("device_properties", "thv", 0xC),
)
BEARER_RESOURCE_MOD_REJECT_FIELDS = (
    ("esm_cause", "v", 1),
    _PCO,
    ("t3396", "tlv", 0x37),
)

ESM_INFORMATION_REQUEST_FIELDS = ()
ESM_INFORMATION_RESPONSE_FIELDS = (("apn", "tlv", 0x28), _PCO)
ESM_NOTIFICATION_FIELDS = (("notification_indicator", "lv"),)
ESM_STATUS_FIELDS = (("esm_cause", "v", 1),)

_EMM_MSGS = {
    ATTACH_REQUEST: ("attach_request", ATTACH_REQUEST_FIELDS),
    ATTACH_ACCEPT: ("attach_accept", ATTACH_ACCEPT_FIELDS),
    ATTACH_COMPLETE: ("attach_complete", ATTACH_COMPLETE_FIELDS),
    ATTACH_REJECT: ("attach_reject", ATTACH_REJECT_FIELDS),
    DETACH_REQUEST: ("detach_request", DETACH_REQUEST_FIELDS),
    DETACH_ACCEPT: ("detach_accept", DETACH_ACCEPT_FIELDS),
    TAU_REQUEST: ("tracking_area_update_request", TAU_REQUEST_FIELDS),
    TAU_ACCEPT: ("tracking_area_update_accept", TAU_ACCEPT_FIELDS),
    TAU_COMPLETE: ("tracking_area_update_complete", TAU_COMPLETE_FIELDS),
    TAU_REJECT: ("tracking_area_update_reject", TAU_REJECT_FIELDS),
    EXTENDED_SERVICE_REQUEST: ("extended_service_request",
                               EXTENDED_SERVICE_REQUEST_FIELDS),
    SERVICE_REJECT: ("service_reject", SERVICE_REJECT_FIELDS),
    SERVICE_ACCEPT: ("service_accept", SERVICE_ACCEPT_FIELDS),
    GUTI_REALLOCATION_COMMAND: ("guti_reallocation_command",
                                GUTI_REALLOCATION_COMMAND_FIELDS),
    GUTI_REALLOCATION_COMPLETE: ("guti_reallocation_complete",
                                 GUTI_REALLOCATION_COMPLETE_FIELDS),
    AUTHENTICATION_REQUEST: ("authentication_request",
                             AUTHENTICATION_REQUEST_FIELDS),
    AUTHENTICATION_RESPONSE: ("authentication_response",
                              AUTHENTICATION_RESPONSE_FIELDS),
    AUTHENTICATION_REJECT: ("authentication_reject",
                            AUTHENTICATION_REJECT_FIELDS),
    AUTHENTICATION_FAILURE: ("authentication_failure",
                             AUTHENTICATION_FAILURE_FIELDS),
    IDENTITY_REQUEST: ("identity_request", IDENTITY_REQUEST_FIELDS),
    IDENTITY_RESPONSE: ("identity_response", IDENTITY_RESPONSE_FIELDS),
    SECURITY_MODE_COMMAND: ("security_mode_command",
                            SECURITY_MODE_COMMAND_FIELDS),
    SECURITY_MODE_COMPLETE: ("security_mode_complete",
                             SECURITY_MODE_COMPLETE_FIELDS),
    SECURITY_MODE_REJECT: ("security_mode_reject",
                           SECURITY_MODE_REJECT_FIELDS),
    EMM_STATUS: ("emm_status", EMM_STATUS_FIELDS),
    EMM_INFORMATION: ("emm_information", EMM_INFORMATION_FIELDS),
    DOWNLINK_NAS_TRANSPORT: ("downlink_nas_transport",
                             DL_NAS_TRANSPORT_FIELDS),
    UPLINK_NAS_TRANSPORT: ("uplink_nas_transport", UL_NAS_TRANSPORT_FIELDS),
    CS_SERVICE_NOTIFICATION: ("cs_service_notification",
                              CS_SERVICE_NOTIFICATION_FIELDS),
}
_ESM_MSGS = {
    ACT_DEFAULT_BEARER_REQ: ("activate_default_eps_bearer_context_request",
                             ACT_DEFAULT_BEARER_REQ_FIELDS),
    ACT_DEFAULT_BEARER_ACCEPT: ("activate_default_eps_bearer_context_accept",
                                ACT_DEFAULT_BEARER_ACCEPT_FIELDS),
    ACT_DEFAULT_BEARER_REJECT: ("activate_default_eps_bearer_context_reject",
                                ACT_DEFAULT_BEARER_REJECT_FIELDS),
    ACT_DEDICATED_BEARER_REQ: ("activate_dedicated_eps_bearer_context_request",
                               ACT_DEDICATED_BEARER_REQ_FIELDS),
    ACT_DEDICATED_BEARER_ACCEPT: (
        "activate_dedicated_eps_bearer_context_accept",
        ACT_DEDICATED_BEARER_ACCEPT_FIELDS),
    ACT_DEDICATED_BEARER_REJECT: (
        "activate_dedicated_eps_bearer_context_reject",
        ACT_DEDICATED_BEARER_REJECT_FIELDS),
    MODIFY_BEARER_REQ: ("modify_eps_bearer_context_request",
                        MODIFY_BEARER_REQ_FIELDS),
    MODIFY_BEARER_ACCEPT: ("modify_eps_bearer_context_accept",
                           MODIFY_BEARER_ACCEPT_FIELDS),
    MODIFY_BEARER_REJECT: ("modify_eps_bearer_context_reject",
                           MODIFY_BEARER_REJECT_FIELDS),
    DEACT_BEARER_REQ: ("deactivate_eps_bearer_context_request",
                       DEACT_BEARER_REQ_FIELDS),
    DEACT_BEARER_ACCEPT: ("deactivate_eps_bearer_context_accept",
                          DEACT_BEARER_ACCEPT_FIELDS),
    PDN_CONNECTIVITY_REQUEST: ("pdn_connectivity_request",
                               PDN_CONNECTIVITY_REQUEST_FIELDS),
    PDN_CONNECTIVITY_REJECT: ("pdn_connectivity_reject",
                              PDN_CONNECTIVITY_REJECT_FIELDS),
    PDN_DISCONNECT_REQUEST: ("pdn_disconnect_request",
                             PDN_DISCONNECT_REQUEST_FIELDS),
    PDN_DISCONNECT_REJECT: ("pdn_disconnect_reject",
                            PDN_DISCONNECT_REJECT_FIELDS),
    BEARER_RESOURCE_ALLOC_REQUEST: ("bearer_resource_allocation_request",
                                    BEARER_RESOURCE_ALLOC_REQUEST_FIELDS),
    BEARER_RESOURCE_ALLOC_REJECT: ("bearer_resource_allocation_reject",
                                   BEARER_RESOURCE_ALLOC_REJECT_FIELDS),
    BEARER_RESOURCE_MOD_REQUEST: ("bearer_resource_modification_request",
                                  BEARER_RESOURCE_MOD_REQUEST_FIELDS),
    BEARER_RESOURCE_MOD_REJECT: ("bearer_resource_modification_reject",
                                 BEARER_RESOURCE_MOD_REJECT_FIELDS),
    ESM_INFORMATION_REQUEST: ("esm_information_request",
                              ESM_INFORMATION_REQUEST_FIELDS),
    ESM_INFORMATION_RESPONSE: ("esm_information_response",
                               ESM_INFORMATION_RESPONSE_FIELDS),
    ESM_NOTIFICATION: ("notification", ESM_NOTIFICATION_FIELDS),
    ESM_STATUS: ("esm_status", ESM_STATUS_FIELDS),
}


# ---- top level ------------------------------------------------------------

def decode(data: bytes) -> dict:
    """Decode one NAS message (plain or security-protected) to a dict.

    Security-protected messages keep mac/seq verbatim and decode the inner
    plain message recursively (the simulator's ciphering is EEA0-style for
    these vectors, matching how the reference test decodes them)."""
    r = _Reader(bytes(data))
    first = r.u8()
    sec_hdr, pd = first >> 4, first & 0x0F
    # the high nibble is a security-header type ONLY for EMM; for ESM it
    # is the EPS bearer identity (24.301 §9.2)
    if pd == PD_EMM and sec_hdr == SEC_SERVICE_REQUEST:
        # Service Request (24.301 §8.2.25): its own 4-byte format —
        # KSI(3)+sequence(5) then a 2-byte short MAC, no msg-type octet
        b = r.u8()
        return dict(protocol_discriminator=pd, msg_name="service_request",
                    security_header=sec_hdr, ksi=b >> 5, seq=b & 0x1F,
                    short_mac=r.take(2))
    if pd == PD_EMM and sec_hdr != SEC_PLAIN:
        mac = r.take(4)
        seq = r.u8()
        inner = decode(r.d[r.p :])
        return dict(security_header=sec_hdr, protocol_discriminator=pd,
                    mac=mac, seq=seq, inner=inner)
    if pd == PD_EMM:
        msg_type = r.u8()
        if msg_type not in _EMM_MSGS:
            raise NasDecodeError(f"EMM message 0x{msg_type:02x} not supported")
        name, fields = _EMM_MSGS[msg_type]
        out = dict(protocol_discriminator=pd, msg_type=msg_type,
                   msg_name=name)
        out.update(_dec_fields(r, fields))
        if "esm_container" in out:
            try:
                out["esm"] = decode(out["esm_container"])
            except NasDecodeError:
                pass  # container kept verbatim; caller sees raw bytes
        return out
    if pd == PD_ESM:
        # first octet: EPS bearer id (hi) + pd (lo); then PTI, msg type
        ebi = sec_hdr
        pti = r.u8()
        msg_type = r.u8()
        if msg_type not in _ESM_MSGS:
            raise NasDecodeError(f"ESM message 0x{msg_type:02x} not supported")
        name, fields = _ESM_MSGS[msg_type]
        out = dict(protocol_discriminator=pd, eps_bearer_id=ebi, pti=pti,
                   msg_type=msg_type, msg_name=name)
        out.update(_dec_fields(r, fields))
        return out
    raise NasDecodeError(f"protocol discriminator {pd} not supported")


def encode(msg: dict) -> bytes:
    """Inverse of decode: byte-exact re-encode."""
    if msg.get("msg_name") == "service_request":
        return bytes([(SEC_SERVICE_REQUEST << 4) | PD_EMM,
                      (msg["ksi"] << 5) | (msg["seq"] & 0x1F)]) \
            + msg["short_mac"]
    if "mac" in msg:
        first = (msg["security_header"] << 4) | msg["protocol_discriminator"]
        return (bytes([first]) + msg["mac"] + bytes([msg["seq"]])
                + encode(msg["inner"]))
    pd = msg["protocol_discriminator"]
    if pd == PD_EMM:
        name, fields = _EMM_MSGS[msg["msg_type"]]
        return (bytes([pd, msg["msg_type"]]) + _enc_fields(msg, fields))
    if pd == PD_ESM:
        name, fields = _ESM_MSGS[msg["msg_type"]]
        head = bytes([(msg["eps_bearer_id"] << 4) | pd, msg["pti"],
                      msg["msg_type"]])
        return head + _enc_fields(msg, fields)
    raise NasDecodeError(f"cannot encode pd {pd}")


# ---- semantic helpers for the tested substructures -----------------------

def parse_guti(b: bytes) -> dict:
    """EPS mobile identity, GUTI flavor (24.301 §9.9.3.12)."""
    assert b[0] & 0x0F == 0x06, "not a GUTI mobile identity"
    return dict(
        plmn=b[1:4].hex(),
        mme_group_id=int.from_bytes(b[4:6], "big"),
        mme_code=b[6],
        m_tmsi=int.from_bytes(b[7:11], "big"),
    )


def parse_apn(b: bytes) -> str:
    """APN label encoding (24.008 §10.5.6.1)."""
    out, p = [], 0
    while p < len(b):
        n = b[p]
        out.append(b[p + 1 : p + 1 + n].decode())
        p += 1 + n
    return ".".join(out)


def parse_pdn_address(b: bytes) -> dict:
    """24.301 §9.9.4.9: ipv4 = 4 octets; ipv6 = 8-octet interface
    identifier; ipv4v6 = IID then IPv4."""
    typ = b[0] & 0x07
    names = {1: "ipv4", 2: "ipv6", 3: "ipv4v6"}
    out = dict(type=names.get(typ, typ))
    if typ == 1:
        out["ipv4"] = ".".join(str(x) for x in b[1:5])
    elif typ == 2:
        out["ip6_iid"] = bytes(b[1:9])
    elif typ == 3:
        out["ip6_iid"] = bytes(b[1:9])
        out["ipv4"] = ".".join(str(x) for x in b[9:13])
    return out


def parse_tft(b: bytes) -> dict:
    """Traffic flow template (24.008 §10.5.6.12), filters as raw contents."""
    op = b[0] >> 5
    n_filters = b[0] & 0x0F
    filters, p = [], 1
    for _ in range(n_filters):
        ident = b[p] & 0x0F
        direction = (b[p] >> 4) & 0x3
        precedence = b[p + 1]
        n = b[p + 2]
        filters.append(dict(id=ident, direction=direction,
                            precedence=precedence,
                            components=b[p + 3 : p + 3 + n]))
        p += 3 + n
    return dict(op_code=op, filters=filters)
