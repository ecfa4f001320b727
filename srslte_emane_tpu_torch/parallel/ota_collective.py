"""OTA superposition over a device mesh: the multi-device "air interface".

Reference parallelism being replaced (SURVEY.md §2.8 / §5): one OS process
per network node exchanging OTA frames over the EMANE multicast bus
(`EMANELTE::MHAL::ENB/UE::send_msg/get_messages`).  Here the nodes are
sharded over the 'node' mesh axis and the over-the-air superposition
  rx_i = sum_j  g_ij * tx_j   (j over ALL nodes, both local and remote)
is one all-gather over the node axis followed by a local mixing product.

Twin of the reference's `parallel/ota_collective.py`:
- tx waveforms are (n_nodes, B, S, 2) split-complex, node-sharded (a list of
  shards from `mesh.node_sharding`); the gather moves each shard to every
  other node row's device once per step (the OTA "broadcast"), the minimum
  traffic any emulated shared medium needs, and `Mesh.transfers` counts it;
- the mix is rx = g @ tx per re/im part: a complex product is 4 real
  `torch.matmul`s; self-interference is excluded by zeroing diag(g);
- HARQ softbuffers / chest state stay WITH their rx node and never move.
"""

from __future__ import annotations

import numpy as np
import torch

from . import mesh as mesh_mod


def _mix(g_re: torch.Tensor, g_im: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """rx = g @ tx in split-complex: x (n, B, S, 2) -> (m, B, S, 2),
    g (m, n) complex as two real parts."""
    n, m = x.shape[0], g_re.shape[0]
    xr, xi = x[..., 0].reshape(n, -1), x[..., 1].reshape(n, -1)
    yr = g_re @ xr - g_im @ xi
    yi = g_re @ xi + g_im @ xr
    return torch.stack([yr, yi], -1).reshape((m,) + x.shape[1:])


def _node_shards(mesh, tx) -> list:
    return list(tx) if isinstance(tx, (list, tuple)) else mesh_mod.node_sharding(mesh, tx)


def _noise_rows(gen: torch.Generator, noise_std: float, shape: tuple, devices) -> dict:
    """{device: noise_std complex white noise of `shape`} for each of
    `devices`, drawn there from a copy of gen's state, so every device holds
    the one draw from `gen` that an unsharded medium adds (as the reference
    draws under the output sharding) and nothing moves between devices; gen
    then advances as by that draw.  The devices are of gen's type (cards of
    one kind: a CUDA draw is the same on each)."""
    state, drawn = gen.get_state(), {}
    for dev in devices:
        if dev.type != gen.device.type:
            raise ValueError(f"ota_mix_sharded: a {gen.device.type} generator for noise on {dev}")
        g = torch.Generator(device=dev)
        g.set_state(state)
        drawn[dev] = noise_std * torch.randn(shape, generator=g, device=dev) / np.sqrt(2.0)
    gen.set_state(g.get_state())
    return drawn


def ota_mix_sharded(mesh, tx, gains, gen: torch.Generator = None, noise_std: float = 0.0):
    """All-nodes OTA superposition over a sharded node axis.

    tx: (n_nodes, B, S, 2) waveforms, node-sharded (a list of node shards,
    or one tensor, which is node-sharded first); gains: (n_nodes, n_nodes)
    complex link matrix (row = rx, col = tx; diagonal ignored).  With
    noise_std and `gen`, complex white noise of variance noise_std^2 is
    added as one draw from `gen` over the whole (n_nodes, B, S, 2) shape
    would add it (`_noise_rows`).  Returns rx node-sharded like tx."""
    shards = _node_shards(mesh, tx)
    n = sum(s.shape[0] for s in shards)
    g = np.asarray(gains, np.complex64) * (1.0 - np.eye(n, dtype=np.float32))
    rows = np.cumsum([0] + [s.shape[0] for s in shards])
    noise = None
    if noise_std and gen is not None:
        noise = _noise_rows(gen, noise_std, (n,) + tuple(shards[0].shape[1:]),
                            {s.device for s in shards})
    rx = []
    for i, own in enumerate(shards):
        dst = mesh.node_position(i)
        # the OTA broadcast: every node's waveform to this node row's device
        tx_all = torch.cat([mesh.send(s, mesh.node_position(j), dst) for j, s in enumerate(shards)])
        g_rows = g[rows[i]:rows[i + 1]]
        g_re = torch.from_numpy(np.ascontiguousarray(g_rows.real)).to(own.device)
        g_im = torch.from_numpy(np.ascontiguousarray(g_rows.imag)).to(own.device)
        y = _mix(g_re, g_im, tx_all)
        if noise is not None:
            y = y + noise[own.device][rows[i]:rows[i + 1]]
        rx.append(y)
    return rx


def total_rx_power_psum(mesh, tx) -> torch.Tensor:
    """Per-node medium occupancy check: sum over the WHOLE medium of each
    node's mean tx power, computed with a psum instead of gathering
    waveforms (one scalar per node row to position 0), the cheap collective
    for carrier-sense style logic.  Returns a 0-d tensor on position 0's
    device."""
    shards = _node_shards(mesh, tx)
    # per-node mean over (B, S), then sum nodes: local + psum
    parts = [(s ** 2).sum(-1).mean(dim=(1, 2)).sum() for s in shards]
    return sum(mesh.send(p, mesh.node_position(i), 0) for i, p in enumerate(parts))
