"""Multi-device sharding of the PHY pipeline.

Reference parallelism being replaced (SURVEY.md §2.8): one OS process per
network node (eNB/UE/EPC) communicating over the EMANE OTA bus, with
`sf_worker` thread pools pipelining TTIs inside each process.

Twin of the reference's `parallel/mesh.py`: a 2-D logical mesh
    ('node', 'sf')
where 'node' shards emulated cells/links and 'sf' shards subframe batches.
One process drives every device of the mesh (single controller, as JAX
does), so a sharded value is a list of tensors, one per shard, each on its
device; `batch_sharding` / `replicated` / `node_sharding` place a value and
`gather` reads one back.  The PHY step is pure data parallelism over (node
x subframe): it moves nothing between devices.  What does move a tensor
from one mesh position to another goes through `Mesh.send`, which counts it
in `Mesh.transfers`, so a step's cross-device traffic is a number a test
can read.

With device="cpu" the mesh lays `n_devices` virtual devices on the CPU (the
reference's tests run on 8 virtual XLA CPU devices); they are positions on
the grid that share the host.
"""

from __future__ import annotations

import torch


class Mesh:
    """A (node, sf) grid of torch devices and the count of tensors moved
    between its positions.  Positions are numbered node-major, the order in
    which P(('node', 'sf')) flattens the grid."""

    axis_names = ("node", "sf")

    def __init__(self, devices: list, node_axis: int):
        assert len(devices) % node_axis == 0, (len(devices), node_axis)
        self.devices = list(devices)
        self.shape = {"node": node_axis, "sf": len(devices) // node_axis}
        self.transfers = 0

    @property
    def size(self) -> int:
        return len(self.devices)

    def node_position(self, i: int) -> int:
        """The position that holds node row i's shard: (i, sf=0)."""
        return i * self.shape["sf"]

    def send(self, x: torch.Tensor, src: int, dst: int) -> torch.Tensor:
        """x, held at position src, on position dst's device; counts one
        transfer when the positions differ."""
        self.transfers += src != dst
        return x.to(self.devices[dst])

    def __repr__(self):
        return f"Mesh({self.shape}, {[str(d) for d in self.devices]})"


def make_mesh(n_devices: int = None, node_axis: int = None, device="cuda") -> Mesh:
    """The ('node', 'sf') mesh over the first n_devices devices of type
    `device`: CUDA cards (all of them by default; raises where there is
    none), or n_devices virtual CPU devices (1 by default).  node_axis
    defaults to the reference's factorisation: 4, else 2, when it divides n
    and is smaller than n, else 1."""
    kind = torch.device(device).type
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device (pass device='cpu' for a virtual "
                               "CPU mesh)")
        devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if n_devices is not None:
            devs = devs[:n_devices]
    elif kind == "cpu":
        devs = [torch.device("cpu")] * (n_devices or 1)
    else:
        raise ValueError(f"make_mesh: device type {kind!r}")
    n = len(devs)
    if node_axis is None:
        # prefer a 2-D factorization when possible
        node_axis = 1
        for f in (4, 2):
            if n % f == 0 and n > f:
                node_axis = f
                break
    return Mesh(devs, node_axis)


def _split(x: torch.Tensor, parts: int, what: str) -> list:
    if x.shape[0] % parts:
        raise ValueError(f"{what}: a leading axis of {x.shape[0]} does not split into "
                         f"{parts} equal shards")
    return list(torch.chunk(x, parts))


def batch_sharding(mesh: Mesh, x) -> list:
    """x's leading (batch) axis split over both mesh axes (node*sf
    flattened): one shard per position, on its device."""
    shards = _split(torch.as_tensor(x), mesh.size, "batch_sharding")
    return [s.to(d) for s, d in zip(shards, mesh.devices)]


def node_sharding(mesh: Mesh, x) -> list:
    """x's leading axis split over the 'node' axis: one shard per node row,
    on the device of (row, sf=0)."""
    shards = _split(torch.as_tensor(x), mesh.shape["node"], "node_sharding")
    return [s.to(mesh.devices[mesh.node_position(i)]) for i, s in enumerate(shards)]


def replicated(mesh: Mesh, x) -> list:
    """x copied to every position's device."""
    x = torch.as_tensor(x)
    return [x.to(d) for d in mesh.devices]


def gather(shards: list) -> torch.Tensor:
    """The shards concatenated in order, as reading a sharded JAX array does:
    on their device when they share one (a 1-card mesh, or the virtual CPU
    mesh), else on the host (device-to-host copies; nothing moves between
    devices, so `Mesh.transfers` does not change).  So the results of the
    sharded entry points (`pdsch_link.make_link_step_sharded`,
    `waveblock.make_block_step_sharded`, `netscan.network_scan` with a
    mesh) lie on the card for a 1-card mesh and on the host for several."""
    if all(s.device == shards[0].device for s in shards):
        return torch.cat(shards)
    return torch.cat([s.cpu() for s in shards])
