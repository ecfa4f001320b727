"""Metrics hub: periodic pull from sources, fan-out to listeners.

Reference behavior: `lib/include/srslte/common/metrics_hub.h` + per-app
metrics_{stdout,csv,ostatistic}.cc — the hub pulls `get_metrics()` from the
eNB/UE/EPC objects and fans out to a stdout table, CSV file, and the
OpenStatistic query endpoint (srsenb/src/main.cc:411-444;
metrics_ostatistic.cc:36-145).

The ostatistic equivalent here is OStatServer: a TCP endpoint answering JSON
queries against the latest snapshot tables (query with the `ostatistic` CLI
equivalent: `echo '{"q":"tables"}' | nc host port`).
"""

from __future__ import annotations

import csv
import io
import json
import socket
import threading
import time
import typing


class MetricsHub:
    def __init__(self):
        self.sources = {}  # name -> callable() -> dict
        self.listeners = []
        self.last = {}

    def add_source(self, name: str, fn: typing.Callable[[], dict]):
        self.sources[name] = fn

    def add_listener(self, listener):
        self.listeners.append(listener)

    def poll(self):
        snap = {name: dict(fn()) for name, fn in self.sources.items()}
        snap["_ts"] = time.time()
        self.last = snap
        for l in self.listeners:
            l.on_metrics(snap)
        return snap


class StdoutMetrics:
    """Compact table printer (metrics_stdout.cc)."""

    def __init__(self, out=None):
        import sys

        self.out = out or sys.stdout

    def on_metrics(self, snap: dict):
        for name, vals in snap.items():
            if name.startswith("_"):
                continue
            kv = " ".join(f"{k}={v}" for k, v in sorted(vals.items()))
            print(f"[{name}] {kv}", file=self.out)


class CsvMetrics:
    """CSV appender (metrics_csv.cc)."""

    def __init__(self, path: str):
        self.path = path
        self._header = None

    def on_metrics(self, snap: dict):
        flat = {"ts": snap.get("_ts", 0.0)}
        for name, vals in snap.items():
            if name.startswith("_"):
                continue
            for k, v in vals.items():
                flat[f"{name}.{k}"] = v
        write_header = self._header != list(flat.keys())
        with open(self.path, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(flat.keys()))
            if write_header:
                w.writeheader()
                self._header = list(flat.keys())
            w.writerow(flat)


class OStatServer:
    """JSON-over-TCP snapshot query endpoint (the OpenStatistic role,
    default port mirrors the reference's 47100)."""

    def __init__(self, hub: MetricsHub, host: str = "127.0.0.1", port: int = 0):
        self.hub = hub
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.sock.bind((host, port))
        self.port = self.sock.getsockname()[1]
        self.sock.listen(4)
        self._stop = False
        self.thread = threading.Thread(target=self._serve, daemon=True)
        self.thread.start()

    def _serve(self):
        self.sock.settimeout(0.2)
        while not self._stop:
            try:
                conn, _ = self.sock.accept()
            except socket.timeout:
                continue
            try:
                req = conn.recv(4096).decode("utf-8", "replace") or "{}"
                try:
                    q = json.loads(req) if req.strip() else {}
                    if not isinstance(q, dict):
                        q = {}
                except json.JSONDecodeError:
                    # malformed query: answer with an error, keep serving
                    q = {"q": None}
                    conn.sendall(b'{"error": "bad query"}')
                    continue
                if q.get("q") == "tables":
                    resp = {"tables": [k for k in self.hub.last if not k.startswith("_")]}
                elif q.get("q"):
                    resp = self.hub.last.get(q["q"], {})
                else:
                    resp = self.hub.last
                conn.sendall(json.dumps(resp, default=str).encode())
            except OSError:
                pass  # client went away mid-reply; server keeps running
            finally:
                conn.close()

    def stop(self):
        self._stop = True
        self.thread.join(timeout=1)
        self.sock.close()
