"""M2AP (36.443) aligned-PER codec — reference-vector subset.

The reference's M2AP codec is `lib/src/asn1/liblte_m2ap.cc`; its test
(`lib/test/asn1/srslte_asn1_m2ap_test.cc`) pins six captured PDUs
(M2 Setup request/response, MBMS Session Start request/response, MBMS
Scheduling Information request/response).  This module decodes them over
the shared ALIGNED-PER runtime (`aper.py`): the asserted IEs are modeled
semantically; any other IE keeps its raw open-type bytes, so every PDU
re-encodes byte-exact regardless."""

from __future__ import annotations

from .aper import (AperError, BitReader, BitWriter, Pdu, ProtocolIE,
                   decode_ap_pdu, encode_ap_pdu, read_constrained,
                   write_constrained)

# procedure codes (36.443 §9.3.7 / liblte_m2ap.h)
PROC_SESSION_START = 0
PROC_SESSION_STOP = 1
PROC_SCHEDULING_INFORMATION = 2
PROC_M2SETUP = 5

# protocol IE ids (liblte_m2ap.h LIBLTE_M2AP_IE_ID_*)
ID_MCE_MBMS_M2AP_ID = 0
ID_ENB_MBMS_M2AP_ID = 1
ID_TMGI = 2
ID_MBMS_SERVICE_AREA = 6
ID_TNL_INFORMATION = 7
ID_GLOBAL_ENB_ID = 13
ID_ENB_NAME = 14
ID_CONFIG_DATA_LIST = 15
ID_CONFIG_DATA_ITEM = 16
ID_GLOBAL_MCE_ID = 17
ID_MCCH_BCCH_CONFIG_LIST = 19
ID_MCCH_UPDATE_TIME = 25


# ---- per-IE semantic codecs ----------------------------------------------

def _read_global_enb_id(r: BitReader) -> dict:
    """GlobalENB-ID ::= SEQ{pLMNidentity OCTET(3), eNB-ID CHOICE{macro
    BIT STRING(20), short(18), long(21)}}."""
    ext = r.read_bits(1)
    if ext:
        raise AperError("GlobalENB-ID extension")
    plmn = r.read_octets(3)
    if r.read_bits(1):  # choice extension marker
        raise AperError("eNB-ID choice extension")
    alt = r.read_bits(1)  # 2 alternatives in liblte's model: macro/short?
    if alt:
        raise AperError("only macro eNB-ID supported")
    bits = int.from_bytes(r.read_octets(3), "big") >> 4  # 20 bits + 4 pad
    return dict(plmn=plmn, enb_id=bits)


def _write_global_enb_id(w: BitWriter, v: dict):
    w.write_bits(0, 1)
    w.write_octets(bytes(v["plmn"]))
    w.write_bits(0, 2)
    w.write_octets(((v["enb_id"] << 4) & 0xFFFFFF).to_bytes(3, "big"))


def _read_name(r: BitReader) -> str:
    """ENBname/MCEname ::= PrintableString (SIZE(1..150, ...)): extensible
    size constraint -> 1 ext bit + 8-bit length field + aligned chars."""
    if r.read_bits(1):
        raise AperError("name size extension")
    n = r.read_bits(8) + 1
    return r.read_octets(n).decode()


def _write_name(w: BitWriter, v: str):
    w.write_bits(0, 1)
    w.write_bits(len(v) - 1, 8)
    w.write_octets(v.encode())


def _read_config_data_item(r: BitReader) -> dict:
    """ENB-MBMS-Configuration-data-Item ::= SEQ{eCGI, mbsfnSyncArea
    INTEGER(0..65535), mbmsServiceAreaList SEQ(SIZE(1..256)) OF OCTSTR}."""
    if r.read_bits(1):
        raise AperError("config item extension")
    if r.read_bits(1):  # eCGI extension
        raise AperError("eCGI extension")
    plmn = r.read_octets(3)
    cell_id = int.from_bytes(r.read_octets(4), "big") >> 4  # 28 bits + pad
    sync_area = read_constrained(r, 0, 65535)
    n_sa = read_constrained(r, 1, 256)
    sas = []
    for _ in range(n_sa):
        ln = r.read_octets(1)[0]
        sas.append(r.read_octets(ln))
    return dict(plmn=plmn, cell_id=cell_id, mbsfn_sync_area=sync_area,
                service_areas=sas)


def _write_config_data_item(w: BitWriter, v: dict):
    w.write_bits(0, 2)
    w.write_octets(bytes(v["plmn"]))
    w.write_octets(((v["cell_id"] << 4) & 0xFFFFFFFF).to_bytes(4, "big"))
    write_constrained(w, v["mbsfn_sync_area"], 0, 65535)
    write_constrained(w, len(v["service_areas"]), 1, 256)
    for sa in v["service_areas"]:
        w.write_octets(bytes([len(sa)]))
        w.write_octets(bytes(sa))


def _read_config_data_list(r: BitReader) -> list:
    """SEQ (SIZE(1..256)) OF ProtocolIE-Single-Container(config item)."""
    n = read_constrained(r, 1, 256)
    from .aper import read_ie_container  # single containers share layout
    out = []
    for _ in range(n):
        ie_id = read_constrained(r, 0, 65535)
        crit = ("reject", "ignore", "notify")[r.read_bits(2)]
        from .aper import read_open_type
        body = read_open_type(r)
        assert ie_id == ID_CONFIG_DATA_ITEM, ie_id
        out.append(_read_config_data_item(BitReader(body)))
    return out


def _write_config_data_list(w: BitWriter, items: list):
    from .aper import write_open_type
    write_constrained(w, len(items), 1, 256)
    for it in items:
        write_constrained(w, ID_CONFIG_DATA_ITEM, 0, 65535)
        w.write_bits(0, 2)  # criticality reject
        bw = BitWriter()
        _write_config_data_item(bw, it)
        write_open_type(w, bw.to_bytes())


def _read_mbms_id24(r: BitReader) -> int:
    """MCE-MBMS-M2AP-ID ::= INTEGER (0..16777215): range 2^24 -> octet
    count determinant (2 bits for 1..3) + aligned value octets."""
    n = read_constrained(r, 1, 3)
    return int.from_bytes(r.read_octets(n), "big")


def _write_mbms_id24(w: BitWriter, v: int):
    n = max(1, (v.bit_length() + 7) // 8)
    write_constrained(w, n, 1, 3)
    w.write_octets(v.to_bytes(n, "big"))


def _read_tmgi(r: BitReader) -> dict:
    if r.read_bits(1):
        raise AperError("TMGI extension")
    return dict(plmn=r.read_octets(3), service_id=r.read_octets(3))


def _write_tmgi(w: BitWriter, v: dict):
    w.write_bits(0, 1)
    w.write_octets(bytes(v["plmn"]))
    w.write_octets(bytes(v["service_id"]))


def _read_service_area(r: BitReader) -> bytes:
    ln = r.read_octets(1)[0]
    return r.read_octets(ln)


def _write_service_area(w: BitWriter, v: bytes):
    w.write_octets(bytes([len(v)]))
    w.write_octets(bytes(v))


def _read_ip(r: BitReader) -> bytes:
    """IPAddress ::= OCTET STRING (SIZE(4..16))."""
    n = read_constrained(r, 4, 16)
    return r.read_octets(n)


def _read_tnl_information(r: BitReader) -> dict:
    if r.read_bits(1):
        raise AperError("TNL extension")
    ipmc = _read_ip(r)
    ipsrc = _read_ip(r)
    teid = r.read_octets(4)
    return dict(ipmc=ipmc, ipsource=ipsrc, gtp_teid=teid)


def _write_tnl_information(w: BitWriter, v: dict):
    w.write_bits(0, 1)
    for addr in (v["ipmc"], v["ipsource"]):
        write_constrained(w, len(addr), 4, 16)
        w.write_octets(bytes(addr))
    w.write_octets(bytes(v["gtp_teid"]))


_DECODERS = {
    ID_GLOBAL_ENB_ID: _read_global_enb_id,
    ID_GLOBAL_MCE_ID: lambda r: dict(
        plmn=(r.read_bits(1), r.read_octets(3))[1], mce_id=r.read_octets(2)),
    ID_ENB_NAME: _read_name,
    ID_CONFIG_DATA_LIST: _read_config_data_list,
    ID_MCE_MBMS_M2AP_ID: _read_mbms_id24,
    ID_ENB_MBMS_M2AP_ID: lambda r: read_constrained(r, 0, 65535),
    ID_TMGI: _read_tmgi,
    ID_MBMS_SERVICE_AREA: _read_service_area,
    ID_TNL_INFORMATION: _read_tnl_information,
    ID_MCCH_UPDATE_TIME: lambda r: read_constrained(r, 0, 255),
}


def _write_global_mce_id(w: BitWriter, v: dict):
    w.write_bits(0, 1)
    w.write_octets(bytes(v["plmn"]))
    w.write_octets(bytes(v["mce_id"]))


_ENCODERS = {
    ID_GLOBAL_ENB_ID: _write_global_enb_id,
    ID_GLOBAL_MCE_ID: _write_global_mce_id,
    ID_ENB_NAME: _write_name,
    ID_CONFIG_DATA_LIST: _write_config_data_list,
    ID_MCE_MBMS_M2AP_ID: _write_mbms_id24,
    ID_ENB_MBMS_M2AP_ID: lambda w, v: write_constrained(w, v, 0, 65535),
    ID_TMGI: _write_tmgi,
    ID_MBMS_SERVICE_AREA: _write_service_area,
    ID_TNL_INFORMATION: _write_tnl_information,
    ID_MCCH_UPDATE_TIME: lambda w, v: write_constrained(w, v, 0, 255),
}


def decode_pdu(data: bytes) -> Pdu:
    return decode_ap_pdu(data, _DECODERS)


def encode_pdu(pdu: Pdu) -> bytes:
    return encode_ap_pdu(pdu, _ENCODERS)
