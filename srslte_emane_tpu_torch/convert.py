"""State carried across from the reference package.

The link has no weights: its state is the HARQ soft buffers (the per-CB
w-buffer lists of `sch.init_softbuffer` / `sch.decode_tb`) and the link
configuration.  These helpers rebuild both from plain data, without
importing jax: soft buffers arrive as numpy arrays, the configuration as
the reference dataclass's fields (`dataclasses.asdict`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .models.pdsch_link import LinkConfig
from .phch.grid import CellConfig


def softbuffer_from_numpy(arrays, device=None, dtype=torch.float32) -> list:
    """Per-CB w-buffers (list of (B, 3*Kp) numpy arrays, any float dtype
    including bf16) -> list of tensors of `dtype` on `device`.  Goes through
    float32, which holds every bf16 and float32 value exactly."""
    return [torch.from_numpy(np.array(a, dtype=np.float32)).to(device=device, dtype=dtype)
            for a in arrays]


def link_config_from_fields(**fields) -> LinkConfig:
    """Port LinkConfig from the reference LinkConfig's fields; `cell` may be
    a dict (as `dataclasses.asdict` gives it) or any object with the
    CellConfig fields."""
    cell = fields.pop("cell", None)
    if cell is not None and not isinstance(cell, dict):
        cell = {f.name: getattr(cell, f.name) for f in dataclasses.fields(CellConfig)}
    if cell is not None:
        fields["cell"] = CellConfig(**cell)
    if fields.get("prb_mask") is not None:
        fields["prb_mask"] = tuple(fields["prb_mask"])
    return LinkConfig(**fields)
