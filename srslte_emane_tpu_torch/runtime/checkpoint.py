"""Emulation checkpoint/resume.

Reference behavior: the radio has none (SURVEY.md §5 — ephemeral state is
rebuilt by protocol re-sync; persistent state is config + HSS DB + FFTW
wisdom).  For long faster-than-real-time emulations this framework adds real
snapshots: the whole network object graph (stacks, RLC/PDCP state, HARQ
counters, bus queues, propagation) serializes losslessly; the
compiled-executable cache persists separately (bench.py jax cache dir).
"""

from __future__ import annotations

import io
import pickle


def snapshot(system: dict) -> bytes:
    """system: the netsim.build_network dict (net/bus/mme/spgw/enb/ues/hss)."""
    return pickle.dumps(system, protocol=pickle.HIGHEST_PROTOCOL)


def restore(blob: bytes) -> dict:
    return pickle.loads(blob)


def save(system: dict, path: str):
    with open(path, "wb") as f:
        f.write(snapshot(system))


def load(path: str) -> dict:
    with open(path, "rb") as f:
        return restore(f.read())
