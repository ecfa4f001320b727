"""RLC layer: TM / UM / AM entities with spec-exact 36.322 framing.

Reference behavior: `lib/src/upper/{rlc.cc,rlc_tm.cc,rlc_um.cc,rlc_am.cc}` —
AM = tx/rx windows, segmentation/reassembly with LI fields, poll/status PDUs,
re-segmentation (AMD PDU segments with SO/LSF, rlc_am.cc build_segment /
handle_data_pdu_segment), t_reordering + poll_retransmit timers
(rlc_am.h:99-230); UM = 5/10-bit SN reordering window; per-queue metrics
(the fork's queue_metrics.h patch).

Wire formats are bit-exact 36.322:
  - UMD PDU §6.2.1.3 (5/10-bit SN) and AMD PDU §6.2.1.4 fixed headers;
  - the E/LI extension part §6.2.1.5: 12-bit (E(1)+LI(11)) fields packed
    consecutively, 4 padding bits after an odd count;
  - AMD PDU segment §6.2.1.5a: RF=1 fixed header + LSF(1) + SO(15);
  - STATUS PDU §6.2.2.5: D/C CPT ACK_SN(10) E1 [NACK_SN(10) E1 E2
    [SOstart(15) SOend(15)]]*, SOend=0x7FFF meaning "to PDU end".
PCAPs of these PDUs dissect with Wireshark's rlc-lte dissector
(utils/pcap.py writes the matching UDP-framed context header).

API mirrors the reference interfaces (ue_interfaces.h:265-321):
  write_sdu(sdu)            <- PDCP
  read_pdu(nof_bytes)->pdu  <- MAC pull (one transmission opportunity)
  write_pdu(pdu)            <- MAC delivery
  sdu_queue_out             -> PDCP delivery callback
Timers tick per TTI via timer_tick().
"""

from __future__ import annotations

import collections

MOD_UM = 1024  # 10-bit SN
MOD_AM = 1024
SO_END_OF_PDU = 0x7FFF  # STATUS SOend special value (36.322 §6.2.2.5)


# ------------------------------------------------------------ bit packing

class _BitWriter:
    """MSB-first bit accumulator; to_bytes pads the tail with zeros."""

    __slots__ = ("val", "n")

    def __init__(self):
        self.val = 0
        self.n = 0

    def put(self, v: int, nbits: int):
        self.val = (self.val << nbits) | (v & ((1 << nbits) - 1))
        self.n += nbits

    def to_bytes(self) -> bytes:
        pad = (-self.n) % 8
        return (self.val << pad).to_bytes((self.n + pad) // 8, "big")


class _BitReader:
    __slots__ = ("data", "pos")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def get(self, nbits: int) -> int:
        v = 0
        for _ in range(nbits):
            byte = self.data[self.pos >> 3]
            v = (v << 1) | ((byte >> (7 - (self.pos & 7))) & 1)
            self.pos += 1
        return v

    def rest(self) -> bytes:
        """Byte-align (skip extension padding) and return the payload."""
        return self.data[(self.pos + 7) >> 3:]


def _ext_nbytes(n_li: int) -> int:
    """Bytes the E/LI extension part occupies (12 bits per LI, padded)."""
    return (12 * n_li + 7) // 8


def _li_cost(k: int) -> int:
    """Marginal header bytes of adding the (k+1)-th LI (alternates 2/1)."""
    return _ext_nbytes(k + 1) - _ext_nbytes(k)


def _put_ext(w: _BitWriter, lis) -> None:
    for i, li in enumerate(lis):
        w.put(0 if i == len(lis) - 1 else 1, 1)
        w.put(li, 11)


def _get_ext(r: _BitReader, e_first: int):
    lis = []
    e = e_first
    while e:
        e = r.get(1)
        lis.append(r.get(11))
    return lis


# ---------------------------------------------------------------- TM

class RlcTm:
    def __init__(self, deliver):
        self.deliver = deliver
        self.q = collections.deque()
        self.metrics = collections.Counter()

    def write_sdu(self, sdu: bytes):
        self.q.append(bytes(sdu))

    def read_pdu(self, nof_bytes: int):
        if self.q and len(self.q[0]) <= nof_bytes:
            self.metrics["tx_pdus"] += 1
            return self.q.popleft()
        return None

    def write_pdu(self, pdu: bytes):
        self.metrics["rx_pdus"] += 1
        self.deliver(pdu)

    def timer_tick(self):
        pass

    def needs_tick(self) -> bool:
        return False

    def has_data(self):
        return bool(self.q)


# ------------------------------------------------- shared segmentation

def _fill_pdu(tx_q, room: int):
    """Concatenate + segment queued SDUs into one data field of at most
    `room` bytes (36.322 §5.1.2 / §5.1.3.1).  Returns (segs, lis, fi_end)
    or (None, None, None) when nothing fits."""
    segs, lis = [], []
    fi_end = 0
    while tx_q and room > 0:
        cost_li = _li_cost(len(lis)) if segs else 0
        sdu = tx_q[0]
        if len(sdu) + cost_li <= room:
            if segs:
                lis.append(len(segs[-1]))
                room -= cost_li
            segs.append(tx_q.popleft())
            room -= len(segs[-1])
        else:
            take = room - cost_li
            if take <= 0:
                break
            if segs:
                lis.append(len(segs[-1]))
            segs.append(sdu[:take])
            tx_q[0] = sdu[take:]
            fi_end = 1
            break
    if not segs:
        return None, None, None
    return segs, lis, fi_end


# ---------------------------------------------------------------- UM

class RlcUm:
    """UM with 10-bit (default) or 5-bit SN; segmentation + reassembly +
    reordering (36.322 §5.1.2 / rlc_um.cc)."""

    def __init__(self, deliver, t_reordering: int = 35, sn_bits: int = 10):
        assert sn_bits in (5, 10)
        self.deliver = deliver
        self.sn_bits = sn_bits
        self.sn_mod = 1 << sn_bits
        self.tx_q = collections.deque()
        self.tx_sn = 0
        self.rx = {}
        self.vr_ur = 0  # earliest SN still considered for reordering
        self.t_reord = 0
        self.t_reordering = t_reordering
        self.partial = b""
        self.metrics = collections.Counter()
        self._carry_start = False

    def _pack(self, fi_s, fi_e, sn, lis, payload):
        w = _BitWriter()
        if self.sn_bits == 10:
            w.put(0, 3)  # R1 (36.322 §6.2.1.3 10-bit UMD)
            w.put((fi_s << 1) | fi_e, 2)
            w.put(1 if lis else 0, 1)
            w.put(sn, 10)
        else:
            w.put((fi_s << 1) | fi_e, 2)
            w.put(1 if lis else 0, 1)
            w.put(sn, 5)
        _put_ext(w, lis)
        return w.to_bytes() + payload

    def _unpack(self, pdu):
        r = _BitReader(pdu)
        if self.sn_bits == 10:
            r.get(3)
            fi = r.get(2)
            e = r.get(1)
            sn = r.get(10)
        else:
            fi = r.get(2)
            e = r.get(1)
            sn = r.get(5)
        lis = _get_ext(r, e)
        return fi >> 1, fi & 1, sn, lis, r.rest()

    def write_sdu(self, sdu: bytes):
        self.tx_q.append(bytes(sdu))

    def has_data(self):
        return bool(self.tx_q)

    def read_pdu(self, nof_bytes: int):
        """One transmission opportunity: concatenate + segment SDUs into a
        single UMD PDU of at most nof_bytes."""
        hdr = 2 if self.sn_bits == 10 else 1
        if not self.tx_q or nof_bytes < hdr + 2:
            return None
        segs, lis, fi_end = _fill_pdu(self.tx_q, nof_bytes - hdr)
        if segs is None:
            return None
        fi_start = 1 if self._carry_start else 0
        self._carry_start = fi_end == 1
        pdu = self._pack(fi_start, fi_end, self.tx_sn, lis, b"".join(segs))
        self.tx_sn = (self.tx_sn + 1) % self.sn_mod
        self.metrics["tx_pdus"] += 1
        return pdu

    def write_pdu(self, pdu: bytes):
        fi_s, fi_e, sn, lis, payload = self._unpack(pdu)
        self.metrics["rx_pdus"] += 1
        self.rx[sn] = (fi_s, fi_e, lis, payload)
        self._reassemble()

    def _reassemble(self):
        # in-order delivery from vr_ur
        while self.vr_ur in self.rx:
            fi_start, fi_end, lis, payload = self.rx.pop(self.vr_ur)
            pos = 0
            parts = []
            for li in lis:
                parts.append(payload[pos : pos + li])
                pos += li
            parts.append(payload[pos:])
            for i, part in enumerate(parts):
                first, last = i == 0, i == len(parts) - 1
                starts = not (first and fi_start)
                ends = not (last and fi_end)
                if starts and not self.partial:
                    if ends:
                        self.deliver(part)
                        self.metrics["rx_sdus"] += 1
                    else:
                        self.partial = part
                elif not starts and self.partial:
                    self.partial += part
                    if ends:
                        self.deliver(self.partial)
                        self.metrics["rx_sdus"] += 1
                        self.partial = b""
                elif starts and self.partial:
                    # loss in the middle: drop stale partial
                    self.partial = b""
                    if ends:
                        self.deliver(part)
                        self.metrics["rx_sdus"] += 1
                    else:
                        self.partial = part
            self.vr_ur = (self.vr_ur + 1) % self.sn_mod

    def needs_tick(self) -> bool:
        return bool(self.rx)

    def timer_tick(self):
        # gap detection: skip over losses after t_reordering
        if self.rx and self.vr_ur not in self.rx:
            self.t_reord += 1
            if self.t_reord >= self.t_reordering:
                self.t_reord = 0
                self.partial = b""
                self.vr_ur = min(self.rx.keys())
                self._reassemble()
        else:
            self.t_reord = 0


# ---------------------------------------------------------------- AM

class RlcAm:
    """AM with 10-bit SN: ARQ via 36.322 STATUS PDUs, re-segmentation of
    retransmissions to fit any grant (AMD PDU segments, RF/SO/LSF), polling."""

    def __init__(self, deliver, poll_pdu: int = 4, t_poll_retx: int = 35,
                 max_retx: int = 16, on_max_retx=None):
        self.deliver = deliver
        self.tx_q = collections.deque()
        self.tx_sn = 0
        self.vt_a = 0  # oldest unacked SN (modular window base)
        # sn -> dict(payload, lis, fi_s, fi_e) (unacked, re-packable)
        self.tx_window = {}
        self.retx_q = collections.deque()  # (sn, so, end) byte range
        self.pdus_since_poll = 0
        self.poll_pdu = poll_pdu
        self.t_poll_retx = t_poll_retx
        self._poll_timer = 0
        self.rx = {}  # sn -> (fi_s, fi_e, lis, payload) complete PDUs
        self.rx_segs = {}  # sn -> {so: (fi_s, fi_e, lis, data, lsf)}
        self.vr_r = 0
        self.status_requested = False
        self.max_retx = max_retx
        self.retx_count = collections.Counter()
        self.on_max_retx = on_max_retx
        self.partial = b""
        self._carry_start = False
        self.metrics = collections.Counter()

    def _dist(self, sn: int) -> int:
        """Modular distance of sn from the window base vt_a."""
        return (sn - self.vt_a) % MOD_AM

    # -- transmit side --
    def write_sdu(self, sdu: bytes):
        self.tx_q.append(bytes(sdu))

    def has_data(self):
        return bool(self.tx_q or self.retx_q or self.status_requested)

    def _pack_amd(self, rec, sn, poll):
        w = _BitWriter()
        w.put(1, 1)  # D/C = data
        w.put(0, 1)  # RF = 0
        w.put(poll, 1)
        w.put((rec["fi_s"] << 1) | rec["fi_e"], 2)
        w.put(1 if rec["lis"] else 0, 1)
        w.put(sn, 10)
        _put_ext(w, rec["lis"])
        return w.to_bytes() + rec["payload"]

    def _pack_segment(self, rec, sn, so, take, poll):
        """AMD PDU segment (36.322 §6.2.1.5a): bytes [so, so+take) of the
        original PDU's data field, with FI/LIs recomputed for the window."""
        payload = rec["payload"]
        end = so + take
        lsf = 1 if end == len(payload) else 0
        # absolute SDU boundaries inside the original data field
        bset, acc = [], 0
        for li in rec["lis"]:
            acc += li
            bset.append(acc)
        inner = [b - so for b in bset if so < b < end]
        seg_lis = [inner[0]] + [b - a for a, b in zip(inner, inner[1:])] \
            if inner else []
        starts_sdu = (so == 0 and rec["fi_s"] == 0) or so in bset
        ends_sdu = (end == len(payload) and rec["fi_e"] == 0) or end in bset
        w = _BitWriter()
        w.put(1, 1)  # D/C
        w.put(1, 1)  # RF = 1: segment
        w.put(poll, 1)
        w.put(((0 if starts_sdu else 1) << 1) | (0 if ends_sdu else 1), 2)
        w.put(1 if seg_lis else 0, 1)
        w.put(sn, 10)
        w.put(lsf, 1)
        w.put(so, 15)
        _put_ext(w, seg_lis)
        return w.to_bytes() + payload[so:end]

    def _count_retx(self, sn: int):
        self.retx_count[sn] += 1
        self.metrics["retx_pdus"] += 1
        if self.retx_count[sn] > self.max_retx and self.on_max_retx:
            self.on_max_retx()

    def _read_retx(self, nof_bytes: int):
        """Serve the retransmission queue, re-segmenting to the grant
        (rlc_am.cc build_segment role).  Returns a PDU or None."""
        while self.retx_q:
            sn, so, end = self.retx_q[0]
            rec = self.tx_window.get(sn)
            if rec is None:  # acked meanwhile
                self.retx_q.popleft()
                continue
            end = len(rec["payload"]) if end is None else \
                min(end, len(rec["payload"]))
            if so >= end:
                self.retx_q.popleft()
                continue
            full = so == 0 and end == len(rec["payload"])
            if full:
                need = 2 + _ext_nbytes(len(rec["lis"])) + len(rec["payload"])
                if need <= nof_bytes:
                    self.retx_q.popleft()
                    self._count_retx(sn)
                    return self._pack_amd(rec, sn, poll=1)
            # segment: shrink take until header + take fits the grant
            take = min(end - so, max(1, nof_bytes - 4))
            while take > 0:
                bset, acc = [], 0
                for li in rec["lis"]:
                    acc += li
                    bset.append(acc)
                n_li = sum(1 for b in bset if so < b < so + take)
                need = 4 + _ext_nbytes(n_li) + take
                if need <= nof_bytes:
                    break
                take -= need - nof_bytes
            if take <= 0:
                return None  # grant too small for any segment
            self._count_retx(sn)
            pdu = self._pack_segment(rec, sn, so, take, poll=1)
            if so + take >= end:
                self.retx_q.popleft()
            else:
                self.retx_q[0] = (sn, so + take, end)
            self.metrics["retx_segments"] += 1
            return pdu
        return None

    def read_pdu(self, nof_bytes: int):
        if self.status_requested:
            self.status_requested = False
            return self._build_status(nof_bytes)
        pdu = self._read_retx(nof_bytes)
        if pdu is not None:
            return pdu
        if not self.tx_q or nof_bytes < 5:
            return None
        segs, lis, fi_end = _fill_pdu(self.tx_q, nof_bytes - 2)
        if segs is None:
            return None
        fi_start = 1 if self._carry_start else 0
        self._carry_start = fi_end == 1
        poll = 0
        self.pdus_since_poll += 1
        if self.pdus_since_poll >= self.poll_pdu or not self.tx_q:
            poll = 1
            self.pdus_since_poll = 0
        rec = dict(payload=b"".join(segs), lis=lis, fi_s=fi_start,
                   fi_e=fi_end)
        pdu = self._pack_amd(rec, self.tx_sn, poll)
        self.tx_window[self.tx_sn] = rec
        self.tx_sn = (self.tx_sn + 1) % MOD_AM
        self.metrics["tx_pdus"] += 1
        return pdu

    MAX_NACKS = 16

    def _build_status(self, nof_bytes: int = 1 << 30) -> bytes:
        """36.322 §6.2.2.5 STATUS PDU.  Partially received SNs are NACKed
        with an E2 SOstart/SOend range covering their first gap.

        If the NACK list must be truncated (count or grant), ACK_SN is
        lowered to the first unreported missing SN so the transmitter never
        falsely acks a gap."""
        missing = self._missing_report()
        budget_bits = 8 * nof_bytes - (1 + 3 + 10 + 1)
        nacks = []
        for m in missing:
            cost = 12 + (30 if m[1] is not None else 0)
            if len(nacks) >= self.MAX_NACKS or budget_bits < cost:
                break
            nacks.append(m)
            budget_bits -= cost
        if len(nacks) < len(missing):
            ack_sn = missing[len(nacks)][0]
        else:
            ack_sn = self._highest_expected()
        w = _BitWriter()
        w.put(0, 1)  # D/C = control
        w.put(0, 3)  # CPT = STATUS
        w.put(ack_sn, 10)
        w.put(1 if nacks else 0, 1)
        for i, (sn, so_s, so_e) in enumerate(nacks):
            w.put(sn, 10)
            w.put(0 if i == len(nacks) - 1 else 1, 1)  # E1
            if so_s is None:
                w.put(0, 1)  # E2
            else:
                w.put(1, 1)
                w.put(so_s, 15)
                w.put(SO_END_OF_PDU if so_e is None else so_e, 15)
        self.metrics["tx_status"] += 1
        return w.to_bytes()

    def _rx_dist(self, sn: int) -> int:
        return (sn - self.vr_r) % MOD_AM

    def _highest_expected(self):
        """SN after the highest (even partially) received, modular."""
        got = list(self.rx.keys()) + list(self.rx_segs.keys())
        if not got:
            return self.vr_r
        hi = max(got, key=self._rx_dist)
        return (hi + 1) % MOD_AM

    def _missing_report(self):
        """[(sn, so_start|None, so_end|None)] in modular order from vr_r:
        fully missing SNs as plain NACKs, partially received SNs as one
        SO-range NACK covering their first gap."""
        got = list(self.rx.keys()) + list(self.rx_segs.keys())
        if not got:
            return []
        span = self._rx_dist(max(got, key=self._rx_dist))
        out = []
        for i in range(span + 1):
            sn = (self.vr_r + i) % MOD_AM
            if sn in self.rx:
                continue
            segs = self.rx_segs.get(sn)
            if segs is None:
                if i < span:  # SNs past the highest received aren't known
                    out.append((sn, None, None))
                continue
            # first gap in the segment coverage
            cur = 0
            total = None
            for so in sorted(segs):
                _, _, _, data, lsf = segs[so]
                if so > cur:
                    out.append((sn, cur, so))
                    break
                cur = max(cur, so + len(data))
                if lsf:
                    total = so + len(data)
            else:
                if total is None or cur < total:
                    out.append((sn, cur, None))  # tail missing / LSF unseen
        return out

    # -- receive side --
    def write_pdu(self, pdu: bytes):
        if not pdu:
            return
        r = _BitReader(pdu)
        dc = r.get(1)
        if dc == 0:
            self._handle_status(pdu)
            return
        rf = r.get(1)
        poll = r.get(1)
        fi = r.get(2)
        e = r.get(1)
        sn = r.get(10)
        self.metrics["rx_pdus"] += 1
        if poll:
            self.status_requested = True
        # receive window: PDUs modularly behind vr_r are duplicates of
        # already-delivered data — acknowledge (via status) but don't store
        if self._rx_dist(sn) >= MOD_AM // 2:
            self.metrics["rx_dup"] += 1
            self.status_requested = True
            return
        if rf == 0:
            lis = _get_ext(r, e)
            self.rx[sn] = (fi >> 1, fi & 1, lis, r.rest())
            self.rx_segs.pop(sn, None)
        else:
            lsf = r.get(1)
            so = r.get(15)
            lis = _get_ext(r, e)
            if sn in self.rx:
                self.metrics["rx_dup"] += 1
            else:
                self.rx_segs.setdefault(sn, {})[so] = (
                    fi >> 1, fi & 1, lis, r.rest(), lsf)
                self.metrics["rx_segments"] += 1
                self._try_assemble(sn)
        self._deliver_in_order()

    def _try_assemble(self, sn: int):
        """Reassemble an AMD PDU from its segments once coverage of
        [0, total) is complete (rlc_am.cc handle_data_pdu_segment)."""
        segs = self.rx_segs[sn]
        total = None
        for so, (_, _, _, data, lsf) in segs.items():
            if lsf:
                total = so + len(data)
        if total is None:
            return
        cur = 0
        for so in sorted(segs):
            if so > cur:
                return  # gap
            cur = max(cur, so + len(segs[so][3]))
        if cur < total:
            return
        # merge: data by coverage walk, boundaries from per-segment LIs/FIs
        payload = bytearray()
        bset = set()
        fi_s_full = fi_e_full = 1
        cur = 0
        for so in sorted(segs):
            fi_s, fi_e, lis, data, lsf = segs[so]
            seg_end = so + len(data)
            if seg_end > cur:
                payload += data[cur - so:]
                cur = seg_end
            acc = so
            for li in lis:
                acc += li
                bset.add(acc)
            if so == 0:
                fi_s_full = fi_s
            if fi_s == 0 and so > 0:
                bset.add(so)
            if lsf:
                fi_e_full = fi_e
            elif fi_e == 0:
                bset.add(seg_end)
        inner = sorted(b for b in bset if 0 < b < total)
        lis_full = [inner[0]] + [b - a for a, b in zip(inner, inner[1:])] \
            if inner else []
        del self.rx_segs[sn]
        self.rx[sn] = (fi_s_full, fi_e_full, lis_full, bytes(payload))
        self.metrics["rx_reassembled"] += 1

    def _deliver_in_order(self):
        while self.vr_r in self.rx:
            fi_start, fi_end, lis, payload = self.rx.pop(self.vr_r)
            pos = 0
            parts = []
            for li in lis:
                parts.append(payload[pos : pos + li])
                pos += li
            parts.append(payload[pos:])
            for i, part in enumerate(parts):
                first, last = i == 0, i == len(parts) - 1
                is_start = not (first and fi_start)
                is_end = not (last and fi_end)
                if is_start:
                    self.partial = b""
                self.partial += part
                if is_end:
                    self.deliver(self.partial)
                    self.metrics["rx_sdus"] += 1
                    self.partial = b""
            self.vr_r = (self.vr_r + 1) % MOD_AM

    def _handle_status(self, pdu: bytes):
        r = _BitReader(pdu)
        r.get(1)  # D/C
        if r.get(3) != 0:  # CPT: only STATUS defined
            return
        ack_sn = r.get(10)
        e1 = r.get(1)
        nacks = []
        while e1:
            sn = r.get(10)
            e1 = r.get(1)
            e2 = r.get(1)
            if e2:
                so_s = r.get(15)
                so_e = r.get(15)
                nacks.append((sn, so_s,
                              None if so_e == SO_END_OF_PDU else so_e))
            else:
                nacks.append((sn, 0, None))
        self.metrics["rx_status"] += 1
        self._poll_timer = 0
        nacked_sns = {n[0] for n in nacks}
        # ack everything in [vt_a, ack_sn) (modular) except nacked
        ack_dist = self._dist(ack_sn)
        for sn in list(self.tx_window.keys()):
            if self._dist(sn) < ack_dist and sn not in nacked_sns:
                del self.tx_window[sn]
                self.retx_count.pop(sn, None)
        queued = {q[0] for q in self.retx_q}
        for sn, so_s, so_e in nacks:
            if sn in self.tx_window and sn not in queued:
                self.retx_q.append((sn, so_s, so_e))
        # advance the window base to the oldest unacked
        if self.tx_window:
            self.vt_a = min(self.tx_window.keys(), key=self._dist)
        else:
            self.vt_a = self.tx_sn

    def needs_tick(self) -> bool:
        """Timer work is only possible with rx state or unacked data —
        event-driven tickers skip fully idle entities."""
        return bool(self.rx or self.rx_segs or self.tx_window)

    def timer_tick(self):
        """Returns truthy when timer work CREATED pending data (a status
        trigger or poll retransmission) — event-driven schedulers use this
        to re-arm their per-UE pending hints."""
        # fast path: a fully idle entity (no rx state, nothing unacked) has
        # no timer work — this is every idle UE's bearer every TTI at
        # deployment scale
        if not self.rx and not self.rx_segs and not self.tx_window:
            self._poll_timer = 0
            return False
        woke = False
        # reordering: if gaps persist, request nothing here (receiver-driven
        # status comes from polls); a t_reordering-based status trigger:
        if self._missing_report():
            self.status_requested = True
            woke = True
        # t-PollRetransmit (36.322): unacked data with no status feedback ->
        # retransmit the oldest unacked PDU with a fresh poll
        if self.tx_window and not self.retx_q:
            self._poll_timer += 1
            if self._poll_timer >= self.t_poll_retx:
                self._poll_timer = 0
                oldest = min(self.tx_window.keys(), key=self._dist)
                self.retx_q.append((oldest, 0, None))
                self.metrics["poll_retx"] += 1
                woke = True
        else:
            self._poll_timer = 0
        return woke
