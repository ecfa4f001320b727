"""Waveform-level multi-cell network step: every link at IQ fidelity.

Twin of the reference's `models/multicell.py`: every cell's full DL
subframe is synthesized (models/enb_dl), superposed at each UE with
per-link complex gains + AWGN, and the full UE receive chain (models/
ue_dl) runs against the serving cell, so co-channel interference, CRS
collisions and capture come out of the waveform itself.  As in the
reference, one noise draw serves every UE of a step, scaled by each UE's
own signal power.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops import channel, cplx
from . import enb_dl, ue_dl


@dataclasses.dataclass(frozen=True)
class MulticellConfig:
    cells: tuple  # tuple of enb_dl.DlSubframeConfig
    # ue i serves cell serving[i] and holds grant index grant_of[i] there
    serving: tuple = (0,)
    grant_of: tuple = (0,)
    snr_db: float = 30.0


def step(cfg: MulticellConfig, payloads, gains, gen: torch.Generator):
    """One TTI at waveform level.

    payloads: per cell, a list of (B, tbs) tensors matching its grants;
    gains: (n_ue, n_cells, 2) cf link gains; gen: the AWGN generator.
    Returns per UE (ok (B,), payload bits, estimated SNR (B,)) from the
    full receive chain."""
    tx = torch.stack([enb_dl.build_subframe(c, p) for c, p in zip(cfg.cells, payloads)],
                     dim=1)  # (B, n_cells, T, 2)
    gains = torch.as_tensor(gains, dtype=torch.float32, device=tx.device)
    state = gen.get_state()
    results = []
    for ui, serving in enumerate(cfg.serving):
        rx = cplx.mul(gains[ui][None, :, None, :], tx).sum(dim=1)  # (B, T, 2)
        gen.set_state(state)  # the same standard-normal draw for every UE
        rx = channel.awgn(gen, rx, cfg.snr_db)
        res, _ = ue_dl.decode_subframe(rx, cfg.cells[serving])
        gi = cfg.grant_of[ui]
        results.append((res.crc_ok[gi], res.payloads[gi], res.snr_db))
    return results
