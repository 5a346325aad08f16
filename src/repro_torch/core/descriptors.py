"""Segment descriptors as int32 slot tables (port of
``repro/core/descriptors.py``, the parts the flat plan uses).

A descriptor list maps each (token, k) routing assignment to its row in a
communication buffer of (groups x capacity) rows, -1 when dropped.  Where the
reference relies on JAX's ``mode="drop"`` scatters, this port writes -1 to a
dump row past the end and slices it off: torch index ops raise on (or wrap)
negative indices.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

I32 = torch.int32


def positions_within_groups(keys: torch.Tensor) -> torch.Tensor:
    """Each element's 0-based rank among the elements with the same key, in
    original order (one stable sort).  Negative keys rank like any other
    key; callers mask them out afterwards."""
    n = keys.shape[0]
    sk, order = torch.sort(keys, stable=True)
    idx = torch.arange(n, dtype=I32, device=keys.device)
    is_start = torch.ones(n, dtype=torch.bool, device=keys.device)
    if n > 1:
        is_start[1:] = sk[1:] != sk[:-1]
    starts = torch.cummax(torch.where(is_start, idx, -1), dim=0).values
    pos = torch.empty(n, dtype=I32, device=keys.device)
    pos[order] = idx - starts
    return pos


def group_counts(keys: torch.Tensor, num_groups: int) -> torch.Tensor:
    """Histogram of ``keys`` over [0, num_groups); negative keys ignored."""
    valid = keys >= 0
    safe = torch.where(valid, keys, num_groups).long()
    counts = torch.zeros(num_groups + 1, dtype=I32, device=keys.device)
    counts.index_add_(0, safe, valid.to(I32))
    return counts[:num_groups]


def drop_neg(idx: torch.Tensor, n: int) -> torch.Tensor:
    """Map -1 sentinels to the out-of-range index ``n``."""
    return torch.where(idx < 0, n, idx).to(I32)


class SlotTable(NamedTuple):
    """A descriptor list for one communication buffer.

    ``slot[t, k]`` is the row in the (groups x capacity) buffer for
    assignment (t, k), -1 when dropped; ``counts[g]`` the assignments per
    group before clipping, so overflow is observable."""

    slot: torch.Tensor
    counts: torch.Tensor
    capacity: int
    num_groups: int

    @property
    def total_rows(self) -> int:
        return self.capacity * self.num_groups

    def dropped(self) -> torch.Tensor:
        """Number of assignments that overflowed capacity."""
        return (self.counts - self.capacity).clamp_min(0).sum()


def build_slot_table(keys: torch.Tensor, num_groups: int, capacity: int,
                     valid: torch.Tensor | None = None) -> SlotTable:
    """Slot ``key * capacity + rank``; overflow and inactive (-1) -> -1."""
    shape = keys.shape
    flat = keys.reshape(-1)
    if valid is not None:
        flat = torch.where(valid.reshape(-1), flat, -1)
    pos = positions_within_groups(flat)
    ok = (flat >= 0) & (pos < capacity)
    slot = torch.where(ok, flat * capacity + pos, -1).to(I32)
    counts = group_counts(flat, num_groups)
    return SlotTable(slot.reshape(shape), counts, capacity, num_groups)
