"""Static machine topologies of the PyTorch port (DESIGN.md §11).

Counterpart of ``repro.alloc.machine``: the whole machine is one frozen
dataclass of per-node int32 tensors on one device.  Every constructor keeps the
reference's invariants, on which the placers rely:

- node ids are ``0..N-1`` in a fixed linear order (the "cable order"),
- ``group`` ids are nondecreasing along node index, so each group is one
  contiguous id range,
- ``group_start[i]`` / ``group_size[i]`` give node *i*'s group extent,
- ``N < 2**15`` and ``N * n_groups < 2**30``, so the placers' int32 sort
  keys stay below the ``2**30 - 1`` sentinel.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.core.jobs import resolve_device


@dataclasses.dataclass(frozen=True)
class Machine:
    """Per-node topology description (see the module docstring).
    ``n_groups`` is a host int: it sizes the placers' keys."""

    group: torch.Tensor        # i32[N] group id, nondecreasing along node index
    group_start: torch.Tensor  # i32[N] first node id of this node's group
    group_size: torch.Tensor   # i32[N] number of nodes in this node's group
    coord: torch.Tensor        # i32[N, 2] (row, col)-style coordinates
    n_groups: int

    @property
    def n_nodes(self) -> int:
        return self.group.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.group.device

    @functools.cached_property
    def group_last(self) -> torch.Tensor:
        """i64[N] last node id of this node's group (a gather index)."""
        return (self.group_start + self.group_size - 1).long()

    @functools.cached_property
    def before_group(self) -> torch.Tensor:
        """i64[N] ``max(group_start - 1, 0)``: where a cumulative count
        just before the node's group is read (a gather index)."""
        return torch.clamp(self.group_start - 1, min=0).long()

    @functools.cached_property
    def group_table(self) -> torch.Tensor:
        """i64[n_groups, S] the node ids of each group (S: the largest
        group), padded with ``N``: a gather index into a ``[..., N + 1]``
        mask whose last entry is False."""
        g = self.group.cpu().numpy()
        sizes = np.bincount(g, minlength=self.n_groups)
        table = np.full((self.n_groups, int(sizes.max())), self.n_nodes,
                        dtype=np.int64)
        for k in range(self.n_groups):
            ids = np.nonzero(g == k)[0]
            table[k, :len(ids)] = ids
        return torch.from_numpy(table).to(self.device)

    @functools.cached_property
    def in_first_group(self) -> torch.Tensor:
        """bool[N] ``group_start == 0``: no count lies before the group."""
        return self.group_start == 0

    def to(self, device) -> "Machine":
        return Machine(group=self.group.to(device),
                       group_start=self.group_start.to(device),
                       group_size=self.group_size.to(device),
                       coord=self.coord.to(device), n_groups=self.n_groups)

    def to_host(self) -> dict:
        """Numpy view, the reference's ``Machine.to_host()`` schema."""
        return {
            "group": self.group.cpu().numpy(),
            "group_start": self.group_start.cpu().numpy(),
            "group_size": self.group_size.cpu().numpy(),
            "coord": self.coord.cpu().numpy(),
            "n_groups": int(self.n_groups),
        }


def _from_groups(group: np.ndarray, coord: np.ndarray, device) -> Machine:
    n = group.shape[0]
    if n == 0:
        raise ValueError("machine must have at least one node")
    if (np.diff(group) < 0).any():
        raise ValueError("group ids must be nondecreasing along node index")
    n_groups = int(group.max()) + 1
    if n >= 2 ** 15 or n * n_groups >= 2 ** 30:
        raise ValueError(
            f"machine too large for int32 sort keys (N={n}, groups={n_groups}); "
            "all placement keys must stay below the 2**30 sentinel"
        )
    device = resolve_device(device)
    first_of = np.zeros(n_groups, dtype=np.int64)
    counts = np.zeros(n_groups, dtype=np.int64)
    for g in range(n_groups):
        idx = np.nonzero(group == g)[0]
        first_of[g] = idx[0] if len(idx) else 0
        counts[g] = len(idx)

    def i32(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(
            device)

    return Machine(group=i32(group), group_start=i32(first_of[group]),
                   group_size=i32(counts[group]), coord=i32(coord),
                   n_groups=n_groups)


def linear(n_nodes: int, *, group_size: int = 8, device=None) -> Machine:
    """1-D chain of nodes partitioned into contiguous racks of
    ``group_size``.  ``device=None`` means ``cuda``."""
    ids = np.arange(n_nodes, dtype=np.int64)
    group = ids // max(int(group_size), 1)
    coord = np.stack([np.zeros_like(ids), ids], axis=1)
    return _from_groups(group, coord, device)


def mesh2d(rows: int, cols: int, *, device=None) -> Machine:
    """``rows x cols`` mesh in row-major cable order; each row is one
    group."""
    ids = np.arange(rows * cols, dtype=np.int64)
    r, c = ids // cols, ids % cols
    return _from_groups(r, np.stack([r, c], axis=1), device)


def dragonfly(n_groups: int, nodes_per_group: int, *, device=None) -> Machine:
    """Dragonfly-style machine: all-to-all connected groups of
    ``nodes_per_group`` nodes; the contention model charges each distinct
    group a job spans."""
    ids = np.arange(n_groups * nodes_per_group, dtype=np.int64)
    g, k = ids // nodes_per_group, ids % nodes_per_group
    return _from_groups(g, np.stack([g, k], axis=1), device)
