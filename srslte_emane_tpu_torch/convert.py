"""State carried across from the reference package.

The links have no weights: their state is the HARQ soft buffers (the
per-CB w-buffer lists of `sch.init_softbuffer` / `sch.decode_tb`, for PDSCH
and PUSCH alike, and one such list per codeword on the MIMO path) and the link, downlink-subframe or uplink-subframe
configuration.  These helpers rebuild both from plain data, without
importing jax: soft buffers arrive as numpy arrays, the configuration as
the reference dataclass's fields (`dataclasses.asdict`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .models.enb_dl import DlSubframeConfig
from .models.pdsch_link import LinkConfig
from .models.ue_ul import UlSubframeConfig
from .phch.grid import CellConfig


def softbuffer_from_numpy(arrays, device=None, dtype=torch.float32) -> list:
    """Per-CB w-buffers (list of (B, 3*Kp) numpy arrays, any float dtype
    including bf16) -> list of tensors of `dtype` on `device`.  Goes through
    float32, which holds every bf16 and float32 value exactly."""
    return [torch.from_numpy(np.array(a, dtype=np.float32)).to(device=device, dtype=dtype)
            for a in arrays]


def softbuffers_from_numpy(codewords, device=None, dtype=torch.float32) -> list:
    """Per-codeword soft buffers, as `pdsch.decode_tm` carries them (a list
    over codewords of per-CB w-buffer lists, or None for a codeword with no
    buffer yet) -> the same nesting of tensors, each codeword through
    `softbuffer_from_numpy`."""
    return [None if cw is None else softbuffer_from_numpy(cw, device, dtype) for cw in codewords]


def _with_cell(fields: dict) -> dict:
    """`cell` as a port CellConfig; it may come as a dict (as
    `dataclasses.asdict` gives it) or any object with the CellConfig fields."""
    cell = fields.pop("cell", None)
    if cell is not None and not isinstance(cell, dict):
        cell = {f.name: getattr(cell, f.name) for f in dataclasses.fields(CellConfig)}
    if cell is not None:
        fields["cell"] = CellConfig(**cell)
    return fields


def link_config_from_fields(**fields) -> LinkConfig:
    """Port LinkConfig from the reference LinkConfig's fields."""
    fields = _with_cell(fields)
    if fields.get("prb_mask") is not None:
        fields["prb_mask"] = tuple(fields["prb_mask"])
    return LinkConfig(**fields)


def ul_config_from_fields(**fields) -> UlSubframeConfig:
    """Port UlSubframeConfig from the reference UlSubframeConfig's fields."""
    return UlSubframeConfig(**_with_cell(fields))


def dl_config_from_fields(**fields) -> DlSubframeConfig:
    """Port DlSubframeConfig from the reference DlSubframeConfig's fields
    (grants as tuples of (rnti, prb_mask, Qm, tbs, l_aggr, cce_start))."""
    fields = _with_cell(fields)
    fields["grants"] = tuple((g[0], tuple(g[1]), *g[2:]) for g in fields.get("grants", ()))
    return DlSubframeConfig(**fields)
