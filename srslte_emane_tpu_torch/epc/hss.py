"""HSS: subscriber DB + Milenage/XOR authentication vector generation.

Reference behavior: `srsepc/src/hss/hss.cc` — CSV user DB, Milenage and XOR
AKA vectors (hss.cc:265-342), SQN resynchronisation.
"""

from __future__ import annotations

import dataclasses
import os

from ..stack import security


@dataclasses.dataclass
class Subscriber:
    imsi: str
    key: bytes
    op: bytes = b"\x00" * 16
    opc: bytes = None
    algo: str = "milenage"  # or "xor"
    sqn: int = 0
    ip_alloc: str = None

    def __post_init__(self):
        if self.opc is None:
            self.opc = security.milenage_opc(self.key, self.op)


class Hss:
    def __init__(self, db_path: str = None):
        self.subs = {}
        if db_path and os.path.exists(db_path):
            self.load_csv(db_path)

    def add(self, sub: Subscriber):
        self.subs[sub.imsi] = sub

    def load_csv(self, path: str):
        """srsepc user_db.csv format subset: name,algo,imsi,key,op_type,op[,...]"""
        for line in open(path):
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split(",")
            name, algo, imsi, key = parts[0], parts[1], parts[2], bytes.fromhex(parts[3])
            op_type, op = parts[4], bytes.fromhex(parts[5])
            sub = Subscriber(imsi=imsi, key=key, algo=algo,
                             op=op if op_type == "op" else b"\x00" * 16,
                             opc=op if op_type == "opc" else None)
            self.add(sub)

    def save_csv(self, path: str):
        with open(path, "w") as f:
            for s in self.subs.values():
                f.write(f"ue,{s.algo},{s.imsi},{s.key.hex()},opc,{s.opc.hex()}\n")

    def get_auth_vector(self, imsi: str, plmn: bytes = b"\x00\xf1\x10"):
        """Returns dict(rand, autn, xres, kasme) or None (hss.cc:265)."""
        sub = self.subs.get(imsi)
        if sub is None:
            return None
        rand = os.urandom(16)
        sub.sqn += 1
        sqn = sub.sqn.to_bytes(6, "big")
        amf = b"\x80\x00"
        if sub.algo == "xor":
            xdout = bytes(k ^ r for k, r in zip(sub.key, rand))
            res, ck, ik = xdout[:8], xdout, xdout[::-1][:16]
            ak = xdout[3:9]
            mac_a = xdout[:8]
        else:
            res, ck, ik, ak = security.milenage_f2345(sub.key, sub.opc, rand)
            mac_a = security.milenage_f1(sub.key, sub.opc, rand, sqn, amf)
        sqn_xor_ak = bytes(a ^ b for a, b in zip(sqn, ak))
        autn = sqn_xor_ak + amf + mac_a
        kasme = security.kdf_kasme(ck, ik, plmn, sqn_xor_ak)
        return dict(rand=rand, autn=autn, xres=res, kasme=kasme)

    def resync(self, imsi: str, rand: bytes, auts: bytes):
        """AKA sequence-number resynchronisation (hss.cc resync_sqn /
        TS 33.102 §6.3.5): recover SQN_ms from AUTS = (SQN_ms ^ AK*) ||
        MAC-S, verify MAC-S, adopt the UE's counter, and hand back a
        fresh vector.  Returns None when MAC-S fails."""
        sub = self.subs.get(imsi)
        if sub is None or len(auts) != 14 or sub.algo != "milenage":
            return None
        ak_star = security.milenage_f5_star(sub.key, sub.opc, rand)
        sqn_ms = bytes(a ^ b for a, b in zip(auts[:6], ak_star))
        mac_s = security.milenage_f1_star(sub.key, sub.opc, rand, sqn_ms,
                                          b"\x00\x00")
        if mac_s != auts[6:]:
            return None
        sub.sqn = int.from_bytes(sqn_ms, "big")
        return self.get_auth_vector(imsi)
