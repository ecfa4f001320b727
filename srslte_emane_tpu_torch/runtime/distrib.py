"""Distributed OTA bus: nodes in separate processes/hosts, one SINR hub.

Reference behavior: the reference runs one OS process per network node
(eNB/UE/EPC) with EMANE's OTA multicast bus between them (SURVEY.md §2.8).
Here an OtaHub process owns the propagation model and TTI barrier; node
processes attach a RemoteBus (same send_msg/get_messages/step_tti surface as
runtime.otabus.OtaBus, so phy adapters run unchanged).  Transport is
length-prefixed pickles over TCP — the host-side DCN path; device-side PHY
state stays local to each node's chips (parallel/mesh).
"""

from __future__ import annotations

import socket
import struct
import threading

import numpy as np

from . import sinr as sinr_mod
from ..utils import wire


def _send(sock, obj):
    data = wire.dumps(obj)
    sock.sendall(struct.pack("!I", len(data)) + data)


def _recv(sock):
    hdr = b""
    while len(hdr) < 4:
        chunk = sock.recv(4 - len(hdr))
        if not chunk:
            raise ConnectionError("peer closed")
        hdr += chunk
    n = struct.unpack("!I", hdr)[0]
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(min(1 << 16, n - len(buf)))
        if not chunk:
            raise ConnectionError("peer closed")
        buf += chunk
    return wire.safe_loads(buf)


class OtaHub:
    """Central adjudicator: barrier per TTI, SINR for all emissions."""

    def __init__(self, prop: sinr_mod.Propagation, node_ids, n_prb: int,
                 host: str = "127.0.0.1", port: int = 0):
        self.prop = prop
        self.node_ids = list(node_ids)
        self.n_prb = n_prb
        self.srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.srv.bind((host, port))
        self.srv.listen(len(node_ids))
        self.port = self.srv.getsockname()[1]
        self.conns = {}
        self.tti = 0
        self._stop = False
        self.thread = threading.Thread(target=self._run, daemon=True)

    def start(self):
        self.thread.start()
        return self

    def _run(self):
        # accept one connection per node
        while len(self.conns) < len(self.node_ids) and not self._stop:
            conn, _ = self.srv.accept()
            hello = _recv(conn)
            self.conns[hello["node_id"]] = conn
        # TTI barrier loop
        try:
            while not self._stop:
                frames = []
                for nid, conn in self.conns.items():
                    msg = _recv(conn)
                    if msg.get("bye"):
                        self._stop = True
                        break
                    frames.extend(msg["frames"])
                if self._stop:
                    break
                testers = sinr_mod.adjudicate(frames, self.prop, self.n_prb,
                                              self.node_ids)
                self.tti = (self.tti + 1) % 10240
                for nid, conn in self.conns.items():
                    deliveries = [
                        (fr, testers[(id(fr), nid)]._rb)
                        for fr in frames if fr.src != nid
                    ]
                    _send(conn, dict(tti=self.tti, deliveries=deliveries,
                                     noise=self.prop.noise_floor_dbm))
        except (ConnectionError, OSError):
            pass
        finally:
            # close every node connection on exit so surviving nodes get
            # ConnectionError from their blocking _recv instead of hanging
            # when one peer dies without BYE
            self.stop()

    def stop(self):
        self._stop = True
        for c in self.conns.values():
            try:
                c.close()
            except OSError:
                pass
        self.srv.close()


class RemoteBus:
    """Client-side bus facade for one node process (OtaBus-compatible)."""

    def __init__(self, host: str, port: int, node_id: int):
        self.node_id = node_id
        self.sock = socket.create_connection((host, port))
        _send(self.sock, dict(node_id=node_id))
        self.curr_tti = 0
        self._pending = []
        self._delivered = []

    def send_msg(self, frame):
        self._pending.append(frame)

    def step_tti(self):
        _send(self.sock, dict(frames=self._pending))
        self._pending = []
        resp = _recv(self.sock)
        self.curr_tti = resp["tti"]
        for fr, rb in resp["deliveries"]:
            tester = sinr_mod.SinrTester(np.asarray(rb), resp["noise"])
            self._delivered.append((fr, tester))

    def get_messages(self, node_id: int):
        assert node_id == self.node_id
        out = self._delivered
        self._delivered = []
        return out

    def close(self):
        try:
            _send(self.sock, dict(bye=True, frames=[]))
        except OSError:
            pass
        self.sock.close()


# ---------------------------------------------------------------------------
# Native hub path: the C++ `ota_hub` daemon (native/ota_hub.cpp) owns the
# TTI barrier and per-RB SINR; payloads cross the wire as opaque pickled
# bytes with a compact binary tx-control header — the libemanelte split
# (OTA payload + TxControl metadata) in native code.
# ---------------------------------------------------------------------------

_HUB_BIN = __import__("os").path.join(
    __import__("os").path.dirname(__file__), "..", "native", "ota_hub")
_HUB_SRC = _HUB_BIN + ".cpp"


def _ensure_hub_built() -> bool:
    """(Re)build the hub daemon when missing or older than its source, the
    same on-demand strategy as native_bus._load — the binary is not
    committed to git."""
    import os
    import subprocess

    try:
        fresh = (os.path.isfile(_HUB_BIN)
                 and os.path.getmtime(_HUB_BIN) >= os.path.getmtime(_HUB_SRC))
    except OSError:
        fresh = False
    if not fresh:
        try:
            subprocess.run(["g++", "-O3", "-std=c++17", "-o", _HUB_BIN,
                            _HUB_SRC], check=True, capture_output=True)
        except Exception:
            return False
    return os.access(_HUB_BIN, os.X_OK)


def native_hub_available() -> bool:
    return _ensure_hub_built()


class NativeHub:
    """Launches the C++ hub daemon; node ids must be 0..N-1 (rows of the
    pathloss matrix)."""

    def __init__(self, prop: sinr_mod.Propagation, n_nodes: int, n_prb: int):
        import os
        import subprocess
        import tempfile

        assert _ensure_hub_built(), "ota_hub build failed (g++ missing?)"
        self.prop = prop
        fd, self._plfile = tempfile.mkstemp(suffix=".txt")
        with os.fdopen(fd, "w") as f:
            for row in np.asarray(prop.pathloss_db, dtype=np.float64):
                f.write(" ".join(f"{v:.6f}" for v in row) + "\n")
        self.proc = subprocess.Popen(
            [_HUB_BIN, "0", str(n_nodes), str(n_prb),
             str(prop.noise_floor_dbm), self._plfile],
            stdout=subprocess.PIPE, text=True)
        line = self.proc.stdout.readline().strip()
        assert line.startswith("PORT "), line
        self.port = int(line.split()[1])

    def stop(self):
        import os

        self.proc.terminate()
        self.proc.wait(timeout=5)
        os.unlink(self._plfile)


class NativeRemoteBus:
    """OtaBus-compatible client for the native hub (one per node process)."""

    def __init__(self, host: str, port: int, node_id: int, n_prb: int):
        self.node_id = node_id
        self.n_prb = n_prb
        self.sock = socket.create_connection((host, port))
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        body = struct.pack("<BH", 1, node_id)
        self.sock.sendall(struct.pack("<I", len(body)) + body)
        self.curr_tti = 0
        self._pending = []
        self._delivered = []

    def send_msg(self, frame):
        self._pending.append(frame)

    def _frame_header(self, fr):
        mask = bytearray(self.n_prb)
        for ch in fr.txc.channels:
            for p in list(ch.prb_slot0) + list(ch.prb_slot1):
                mask[p] = 1
        if not fr.txc.channels:
            mask = bytearray(b"\x01" * self.n_prb)
        tx_dbm = 10.0 * np.log10(fr.txc.reference_signal_power_mw + 1e-12)
        return struct.pack("<HBfH", fr.src, int(fr.txc.is_downlink),
                           tx_dbm, self.n_prb) + bytes(mask)

    def step_tti(self):
        parts = [struct.pack("<BH", 2, len(self._pending))]
        for fr in self._pending:
            payload = wire.dumps(fr)
            parts.append(self._frame_header(fr))
            parts.append(struct.pack("<I", len(payload)) + payload)
        self._pending = []
        body = b"".join(parts)
        self.sock.sendall(struct.pack("<I", len(body)) + body)
        resp = self._recv_msg()
        assert resp[0] == 4
        tti, noise = struct.unpack_from("<If", resp, 1)
        n, off = struct.unpack_from("<H", resp, 9)[0], 11
        self.curr_tti = tti
        for _ in range(n):
            src, is_dl = struct.unpack_from("<HB", resp, off)
            off += 3
            rb = np.frombuffer(resp, dtype="<f4", count=self.n_prb, offset=off).copy()
            off += 4 * self.n_prb
            plen = struct.unpack_from("<I", resp, off)[0]
            off += 4
            fr = wire.safe_loads(resp[off : off + plen])
            off += plen
            self._delivered.append((fr, sinr_mod.SinrTester(rb, noise)))
        return tti

    def _recv_msg(self):
        hdr = b""
        while len(hdr) < 4:
            c = self.sock.recv(4 - len(hdr))
            if not c:
                raise ConnectionError("hub closed")
            hdr += c
        n = struct.unpack("<I", hdr)[0]
        buf = bytearray()
        while len(buf) < n:
            c = self.sock.recv(min(1 << 16, n - len(buf)))
            if not c:
                raise ConnectionError("hub closed")
            buf += c
        return bytes(buf)

    def get_messages(self, node_id: int):
        assert node_id == self.node_id
        out = self._delivered
        self._delivered = []
        return out

    def close(self):
        try:
            body = struct.pack("<B", 3)
            self.sock.sendall(struct.pack("<I", len(body)) + body)
        except OSError:
            pass
        self.sock.close()
