"""The (data, model) grid of a training job (port of the host half of
``repro/launch/mesh.py``).

The reference lays its devices out as a ``(data, model)`` mesh: the batch is
sharded over ``data``, the sequence and the experts over ``model`` (the EP
axis).  The port's ranks take the same places: rank ``r`` of a world of
``data * model`` sits at ``(r // model, r % model)``, the order of jax's
mesh, so the ranks sharing a data index form one EP group (lane
``r % model``) and the ranks sharing a model index one data group (data rank
``r // model``).  The EP group is also the model group over which the dense
and moe families run Megatron-SP tensor parallelism
(``models/lm.tensor_parallel``).  :func:`make_host_mesh` builds these
groups; nothing here runs at import.  The production mesh of the reference
is a dry-run shape and has no counterpart.
"""

from __future__ import annotations

import dataclasses

import torch.distributed as dist


def host_mesh_shape(n: int, data: int | None = None,
                    model: int | None = None) -> tuple[int, int]:
    """``(data, model)`` of a world of ``n`` ranks: as given, or the
    reference's rule, ``model`` the first of 4 and 2 that divides ``n``
    (else 1) and ``data = n // model``."""
    if data is None or model is None:
        model = next((m for m in (4, 2) if n % m == 0 and n >= m), 1)
        return n // model, model
    if data * model != n:
        raise ValueError(f"a ({data}, {model}) mesh needs {data * model} "
                         f"ranks, the world has {n}")
    return data, model


@dataclasses.dataclass(frozen=True, eq=False)
class HostMesh:
    """This rank's groups of a ``(data, model)`` grid.  A group of one rank
    is None; a group of the whole world is ``dist.group.WORLD``."""
    data: int
    model: int
    data_group: dist.ProcessGroup | None   # the ranks of this model index
    ep_group: dist.ProcessGroup | None     # the ranks of this data index
    grid: dist.ProcessGroup | None         # every rank of the grid

    @property
    def data_index(self) -> int:
        return 0 if self.grid is None else dist.get_rank() // self.model

    def ep_domains(self) -> list[list[int]]:
        """The ranks of every EP group, in data order (each in lane order)."""
        return [[d * self.model + m for m in range(self.model)]
                for d in range(self.data)]


def make_host_mesh(data: int | None = None,
                   model: int | None = None) -> HostMesh:
    """The grid over the initialised world (``host_mesh_shape``; one rank
    without one).  Collective: every rank calls it, and every data group
    and every EP group is created on every rank, in the same order."""
    world = (dist.get_world_size()
             if dist.is_available() and dist.is_initialized() else 1)
    data, model = host_mesh_shape(world, data, model)
    if world == 1:
        return HostMesh(1, 1, None, None, None)
    whole = dist.group.WORLD

    def groups(n: int, ranks_of) -> list:
        if n == world:
            return [whole] * (world // n)
        if n == 1:
            return [None] * world
        return [dist.new_group(ranks_of(i)) for i in range(world // n)]

    eps = groups(model, lambda d: [d * model + m for m in range(model)])
    datas = groups(data, lambda m: [d * model + m for d in range(data)])
    r = dist.get_rank()
    return HostMesh(data, model, datas[r % model], eps[r // model], whole)
