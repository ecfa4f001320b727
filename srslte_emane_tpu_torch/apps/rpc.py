"""Typed-message RPC transport for control-plane interfaces between
processes — the SCTP/S1AP and GTP-C transport role.

Reference behavior: S1-MME rides SCTP (srsenb/src/stack/upper/s1ap.cc,
srsepc/src/mme/s1ap.cc); here the NAS-transport and UE-context procedures
cross the wire as REAL 36.413 APER S1AP PDUs (epc/s1ap_wire.py bridging the
typed epc/mme.py dataclasses to the capture-proven stack/asn1/s1ap36413
codec), framed length-prefixed over TCP (this kernel has no SCTP support);
remaining procedures ride as typed messages, with a server dispatching
dotted method paths onto a served object.
"""

from __future__ import annotations

import socket
import struct
import threading

from ..epc import s1ap_wire
from ..utils import wire


def _send(sock, obj):
    data = wire.dumps(obj)
    sock.sendall(struct.pack("!I", len(data)) + data)


def _recv(sock):
    hdr = b""
    while len(hdr) < 4:
        c = sock.recv(4 - len(hdr))
        if not c:
            raise ConnectionError
        hdr += c
    n = struct.unpack("!I", hdr)[0]
    buf = b""
    while len(buf) < n:
        c = sock.recv(min(1 << 16, n - len(buf)))
        if not c:
            raise ConnectionError
        buf += c
    return wire.safe_loads(buf)


class RpcServer:
    """Serves method calls {path: "a.b.c", args, kwargs} on `obj`."""

    def __init__(self, obj, host: str = "127.0.0.1", port: int = 0):
        self.obj = obj
        self.lock = threading.Lock()
        self.srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.srv.bind((host, port))
        self.srv.listen(16)
        self.host, self.port = self.srv.getsockname()
        self._stop = False
        self.thread = threading.Thread(target=self._accept_loop, daemon=True)
        self.thread.start()

    def _accept_loop(self):
        self.srv.settimeout(0.2)
        while not self._stop:
            try:
                conn, _ = self.srv.accept()
            except socket.timeout:
                continue
            except OSError:
                break  # stop() closed the listening socket
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True).start()

    def _serve_conn(self, conn):
        try:
            while not self._stop:
                req = _recv(conn)
                with self.lock:
                    try:
                        target = self.obj
                        for part in req["path"].split("."):
                            target = getattr(target, part)
                        # malformed APER payloads error back to the
                        # caller instead of killing the server thread
                        args = s1ap_wire.decode_args(req["path"],
                                                     req["args"])
                        result = target(*args, **req.get("kwargs", {}))
                        result = s1ap_wire.encode_result(req["path"],
                                                         args, result)
                        _send(conn, dict(ok=True, result=result))
                    except Exception as e:  # propagate to caller
                        _send(conn, dict(ok=False, error=repr(e)))
        except (ConnectionError, OSError):
            pass
        finally:
            conn.close()

    def stop(self):
        self._stop = True
        self.srv.close()


class RpcClient:
    def __init__(self, host: str, port: int):
        self.sock = socket.create_connection((host, port))
        self.lock = threading.Lock()

    def call(self, path: str, *args, **kwargs):
        args = s1ap_wire.encode_args(path, args, kwargs)
        with self.lock:
            _send(self.sock, dict(path=path, args=args, kwargs=kwargs))
            resp = _recv(self.sock)
        if not resp["ok"]:
            raise RuntimeError(f"remote error in {path}: {resp['error']}")
        return s1ap_wire.decode_result(path, resp["result"])

    def close(self):
        self.sock.close()


class _PathProxy:
    def __init__(self, client: RpcClient, prefix: str):
        self._client = client
        self._prefix = prefix

    def __getattr__(self, name):
        return _PathProxy(self._client, f"{self._prefix}.{name}")

    def __call__(self, *args, **kwargs):
        return self._client.call(self._prefix, *args, **kwargs)


class RemoteMme:
    """eNB-side S1AP client: looks like epc.mme.Mme to EnbStack, transports
    over RPC; s1_setup publishes a local callback server for the MME's
    eNB-directed procedures (dl_nas/ctx_setup/ho_*/gtpu_dl)."""

    def __init__(self, host: str, port: int):
        self._cli = RpcClient(host, port)
        self._cb_server = None

    def s1_setup(self, enb_id: int, enb_iface):
        self._cb_server = RpcServer(enb_iface)
        return self._cli.call("s1_setup_remote", enb_id,
                              self._cb_server.host, self._cb_server.port)

    @property
    def spgw(self):
        return _PathProxy(self._cli, "spgw")

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return _PathProxy(self._cli, name)


class EpcFrontend:
    """EPC-side shim served by RpcServer: wraps the real Mme and turns
    registered eNB endpoints back into RPC clients (incl. gtpu_dl)."""

    def __init__(self, mme):
        self.mme = mme
        self.spgw = mme.spgw

    def s1_setup_remote(self, enb_id: int, host: str, port: int):
        proxy = _EnbProxy(RpcClient(host, port))
        return self.mme.s1_setup(enb_id, proxy)

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self.mme, name)


class _EnbProxy:
    def __init__(self, client: RpcClient):
        self._client = client
        self.cell_pci = client.call("get_pci")

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return _PathProxy(self._client, name)
