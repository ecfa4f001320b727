"""System simulator: scripted ideal-PHY test driver for an unmodified UE
stack — the TTCN-3 harness role.

Reference behavior: `srsue/test/ttcn3/` — a "system simulator" with an ideal
fake PHY (lte_ttcn3_phy.cc) drives the fully unmodified UE stack against
scripted 3GPP TS 36.523 procedures (srsue/test/ttcn3/README.md:1-14).

Here SysSim impersonates the network side below RRC: it terminates the UE's
MAC-level messages directly (no OTA bus, no SINR — the "ideal PHY"), lets a
test script exchange RRC/NAS messages with the UE, and exposes expectation
helpers plus full scripted procedures (attach with real Milenage AKA +
EIA2/EEA2 NAS security, RLF injection, paging) — the systematic
protocol-conformance pressure of the TS 36.523 suite, applied to the
production `stack.ue_stack.UeStack`.
"""

from __future__ import annotations

import collections
import hashlib

from ..stack import (codec, nas_msgs, nas_wire, pdu, rrc_msgs, rrc_wire,
                     security)
from ..stack.ue_stack import UeStack


class SysSim:
    """Ideal-PHY test system around one UE stack."""

    def __init__(self, ue: UeStack, rnti: int = 0x46, key: bytes = None,
                 opc: bytes = None):
        self.ue = ue
        self.rnti = rnti
        self.tti = 0
        self.key = key if key is not None else ue.usim.key
        self.opc = opc if opc is not None else ue.usim.opc
        self.sqn = 32  # network-side AKA sequence number
        self.nas_sec = None  # EPS security context after a completed SMC
        self.ul_rrc = collections.deque()  # decoded UL RRC messages
        self.ul_nas = collections.deque()
        self.mute_rar = False  # suppress the automatic ideal RAR
        from ..stack import rlc as rlc_mod, pdcp as pdcp_mod

        self._reset_srb1()

    def _reset_srb1(self):
        from ..stack import rlc as rlc_mod, pdcp as pdcp_mod

        self._rlc = rlc_mod.RlcAm(deliver=self._srb1_sdu)
        self._pdcp = pdcp_mod.PdcpEntity(
            deliver=self._srb1_rrc, is_srb=True, bearer_id=1, is_ue=False)

    # ---- SRB1 network side ----
    def _srb1_sdu(self, sdu):
        self._pdcp.write_pdu(sdu)

    def _srb1_rrc(self, sdu):
        msg = rrc_wire.decode_ul_dcch(sdu)
        if isinstance(msg, rrc_msgs.UlInformationTransfer):
            self.ul_nas.append(self._dec_nas(msg.nas_pdu))
        else:
            self.ul_rrc.append(msg)
            nas_pdu = getattr(msg, "nas_pdu", b"")
            if nas_pdu:
                self.ul_nas.append(self._dec_nas(nas_pdu))

    def _dec_nas(self, data: bytes):
        if self.nas_sec is not None and data and (data[0] >> 4) in (1, 2, 3, 4):
            plain, ok = self.nas_sec.unprotect(bytes(data), downlink=False)
            assert ok, "UE NAS MAC failed at the SS"
            return nas_wire.decode(plain)
        return nas_wire.decode(bytes(data))

    def dl_rrc(self, msg):
        """Deliver a DL RRC message to the UE on SRB1 (ideal PHY)."""
        data = self._pdcp.write_sdu(rrc_wire.encode_dl_dcch(msg))
        self._rlc.write_sdu(data)
        self._pump_dl()

    def dl_nas(self, msg, new_ctx: bool = False):
        """Deliver a DL NAS message (protected once a context exists)."""
        data = nas_wire.encode(msg)
        if self.nas_sec is not None:
            data = self.nas_sec.protect(data, downlink=True,
                                        new_ctx=new_ctx,
                                        cipher=not new_ctx)
        self.dl_rrc(rrc_msgs.DlInformationTransfer(nas_pdu=data))

    def dl_ccch(self, msg):
        # route by logical channel, like the real MAC: SI-RNTI for BCCH,
        # P-RNTI for PCCH, C-RNTI-less DL-CCCH otherwise
        if isinstance(msg, (rrc_msgs.Sib1, rrc_msgs.Sib2, rrc_msgs.Sib3)):
            data, rnti = rrc_wire.encode_bcch(msg), self.ue.SI_RNTI
        elif isinstance(msg, rrc_msgs.Paging):
            data, rnti = rrc_wire.encode_pcch(msg), self.ue.P_RNTI
        else:
            data, rnti = rrc_wire.encode_dl_ccch(msg), None
        mac_pdu = pdu.pack([(pdu.LCID_CCCH, data)])
        self.ue.tb_decoded(self.tti, mac_pdu, 30.0, rnti=rnti)

    def _pump_dl(self):
        while self._rlc.has_data():
            p = self._rlc.read_pdu(1000)
            if p is None:
                break
            self.ue.tb_decoded(self.tti, pdu.pack([(1, p)]), 30.0)

    # ---- UL pump: grant everything the UE wants to send ----
    def step(self, n: int = 1):
        from ..runtime.phy_adapter import UlGrant

        for _ in range(n):
            self.tti += 1
            self.ue.tick()
            if self.tti == 1:  # SS broadcasts system information first
                self.dl_ccch(rrc_msgs.Sib1())
                self.dl_ccch(rrc_msgs.Sib2())
            pre = self.ue.get_prach(self.tti)
            if pre is not None and not self.mute_rar:
                # immediate ideal RAR
                rar = pdu.pack_rar(rapid=pre, ta=0, ul_grant=0,
                                   t_crnti=self.rnti)
                self.ue.tb_decoded(self.tti, rar, 30.0)
            self.ue.ul_grant(self.tti, UlGrant(self.rnti, 0, 8, 9))
            for g, payload in self.ue.get_pusch(self.tti):
                for lcid, sdu in pdu.unpack(payload):
                    if lcid == pdu.LCID_CCCH:
                        m = rrc_wire.decode_ul_ccch(sdu)
                        if isinstance(m, (
                                rrc_msgs.RrcConnectionRequest,
                                rrc_msgs.RrcConnectionReestablishmentRequest)):
                            # a NEW connection: fresh SRB1 entities on
                            # the network side too (the UE reset its own)
                            self._reset_srb1()
                        self.ul_rrc.append(m)
                    elif lcid == 1:
                        self._to_ue_srb1_rlc(sdu)
            self._pump_dl()

    def _to_ue_srb1_rlc(self, rlc_pdu):
        # feed UE's UL RLC PDUs into our network-side RLC entity
        self._rlc.write_pdu(rlc_pdu)

    # ---- expectations ----
    def expect_rrc(self, cls, within: int = 20):
        for _ in range(within):
            for m in self.ul_rrc:
                if isinstance(m, cls):
                    self.ul_rrc.remove(m)  # consume: a repeat expectation
                    return m               # must see a FRESH message
            self.step()
        raise AssertionError(f"UE did not send {cls.__name__}")

    def expect_nas(self, cls, within: int = 20):
        for _ in range(within):
            for m in self.ul_nas:
                if isinstance(m, cls):
                    self.ul_nas.remove(m)  # consume (see expect_rrc)
                    return m
            self.step()
        raise AssertionError(f"UE did not send {cls.__name__}")

    def expect_none(self, cls, for_n: int = 20, nas: bool = False):
        """Assert the UE does NOT send `cls` within for_n TTIs."""
        q = self.ul_nas if nas else self.ul_rrc
        for _ in range(for_n):
            self.step()
            for m in q:
                assert not isinstance(m, cls), \
                    f"UE unexpectedly sent {cls.__name__}: {m}"

    # ---- scripted procedures (the TS 36.523 building blocks) ----

    def auth_vector(self, bogus_mac: bool = False):
        """(rand, autn): a real Milenage AKA vector from the subscriber
        key (hss.cc:265 role); bogus_mac corrupts MAC-A — the UE must
        answer AuthenticationFailure(mac-failure)."""
        self.sqn += 32
        rand = hashlib.sha256(b"rand%d" % self.sqn).digest()[:16]
        res, ck, ik, ak = security.milenage_f2345(self.key, self.opc, rand)
        sqn = self.sqn.to_bytes(6, "big")
        amf = b"\x80\x00"
        mac = security.milenage_f1(self.key, self.opc, rand, sqn, amf)
        if bogus_mac:
            mac = bytes(b ^ 0xFF for b in mac)
        autn = bytes(a ^ b for a, b in zip(sqn, ak)) + amf + mac
        self._kasme = security.kdf_kasme(ck, ik, b"\x00\xf1\x10", autn[:6])
        return rand, autn

    def rrc_connect(self, within: int = 40):
        """Answer the UE's next RRCConnectionRequest with a Setup and
        return the SetupComplete."""
        self.expect_rrc(rrc_msgs.RrcConnectionRequest, within)
        self.dl_rrc_ccch_setup()
        return self.expect_rrc(rrc_msgs.RrcConnectionSetupComplete, within)

    def dl_rrc_ccch_setup(self):
        self.dl_ccch(rrc_msgs.RrcConnectionSetup(con_res_id=0))

    def attach(self, within: int = 60):
        """Run the complete attach: connection, AKA, NAS SMC (real EIA2
        context from here), Attach Accept -> Complete."""
        self.rrc_connect(within)
        self.expect_nas(nas_msgs.AttachRequest, within)
        rand, autn = self.auth_vector()
        self.dl_nas(nas_msgs.AuthenticationRequest(rand=rand, autn=autn))
        self.expect_nas(nas_msgs.AuthenticationResponse, within)
        self.nas_sec = nas_wire.NasSecurity(self._kasme, eia=2, eea=2)
        self.dl_nas(nas_msgs.NasSecurityModeCommand(eea=2, eia=2),
                    new_ctx=True)
        self.expect_nas(nas_msgs.NasSecurityModeComplete, within)
        self.dl_nas(nas_msgs.AttachAccept(guti=0xC0FFEE))
        self.expect_nas(nas_msgs.AttachComplete, within)
        assert self.ue.emm_state == "REGISTERED"

    def inject_rlf(self):
        """Out-of-sync indications until the UE declares radio link
        failure (36.331 T310/N310 role)."""
        for _ in range(self.ue.N310 + 2):
            self.step()
            self.ue.sync_indication(self.tti, False, -5.0)
