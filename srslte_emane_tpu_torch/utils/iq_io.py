"""IQ file / stream IO — the `lib/src/phy/io/` equivalents.

Reference behavior: filesource/filesink (raw complex-float binary),
netsource/netsink (UDP/TCP sample streams), binsource.  srsLTE captures and
the checked-in test fixtures are interleaved float32 I/Q ("cf_t").
"""

from __future__ import annotations

import socket

import numpy as np


def read_cf32(path: str, max_samples: int = None) -> np.ndarray:
    raw = np.fromfile(path, dtype=np.complex64, count=max_samples or -1)
    return raw


def write_cf32(path: str, samples: np.ndarray):
    np.asarray(samples, dtype=np.complex64).tofile(path)


class NetSink:
    """TCP sample sink (netsink.c role)."""

    def __init__(self, host: str, port: int):
        self.sock = socket.create_connection((host, port))

    def send(self, samples: np.ndarray):
        self.sock.sendall(np.asarray(samples, np.complex64).tobytes())

    def close(self):
        self.sock.close()


class NetSource:
    """TCP sample source (netsource.c role)."""

    def __init__(self, port: int, host: str = "127.0.0.1"):
        self.srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.srv.bind((host, port))
        self.srv.listen(1)
        self.port = self.srv.getsockname()[1]
        self.conn = None

    def accept(self):
        self.conn, _ = self.srv.accept()

    def recv(self, n_samples: int) -> np.ndarray:
        need = n_samples * 8
        buf = b""
        while len(buf) < need:
            chunk = self.conn.recv(need - len(buf))
            if not chunk:
                break
            buf += chunk
        return np.frombuffer(buf, dtype=np.complex64)

    def close(self):
        if self.conn:
            self.conn.close()
        self.srv.close()
