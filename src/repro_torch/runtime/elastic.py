"""Elastic re-mesh: resume a checkpoint on another topology (port of
``repro/runtime/elastic.py``).

When ranks are lost, training continues on the grid that survives: the
parameters and optimizer state are restored from the committed checkpoint,
each rank keeping its lane, its TP, vocab and SSM-head shards and its
ZeRO-1 slice of the NEW (data, model) grid, whatever its model-group size
(the checkpoint holds whole leaves, ``checkpoint/checkpointer.py``); the
data pipeline keeps the global batch by gradient accumulation when the
data axis shrinks (:func:`accumulation_factor`).  Lane-major expert weights
move between EP widths on the host (:func:`relayout_expert_weights`, numpy,
the reference's function).
"""

from __future__ import annotations

import numpy as np

from repro_torch.checkpoint import checkpointer
from repro_torch.core.routing import ExpertPlacement


def remesh_restore(ckpt_dir: str, like_tree, mesh=None,
                   step: int | None = None, fsdp: bool = False,
                   tp: bool = False, vocab: tuple[int, int] | None = None,
                   ssm=None):
    """Restore ``like_tree`` (this rank's leaves on ``mesh``, a
    ``launch.mesh.HostMesh``; None: one rank holding everything; ``fsdp``:
    the expert leaves' f dim split over its data group; ``tp``: the TP
    leaves sharded over its model group, ``models/lm.tensor_parallel``;
    ``vocab`` = (V, d): the vocab pair split over it, a training tree,
    ``models/lm.vocab_parallel``; ``ssm``: the model's ``lm.ssm_dims``,
    its Mamba2 leaves cut by SSM head where the model group divides the
    heads) from ``ckpt_dir``, whatever grid saved it and whether it ran
    FSDP or TP or not; returns (tree, step)."""
    lay = (checkpointer.ONE if mesh is None
           else checkpointer.layout(mesh=mesh, fsdp=fsdp, tp=tp, vocab=vocab,
                                    ssm=ssm))
    return checkpointer.restore(ckpt_dir, like_tree, step, lay=lay)


def relayout_expert_weights(w_lane_major: np.ndarray, old: ExpertPlacement,
                            new: ExpertPlacement) -> np.ndarray:
    """(old_ep, E_local_old, ...) lane-major weights -> the new EP layout:
    the canonical (E, ...) table rebuilt from the old layout, then laid out
    for the new placement (replication handled both ways)."""
    e = old.n_experts
    canon = np.empty((e,) + w_lane_major.shape[2:], w_lane_major.dtype)
    for lane in range(old.ep):
        if old.n_experts >= old.ep:
            lo = lane * old.experts_per_lane
            canon[lo:lo + old.experts_per_lane] = w_lane_major[lane]
        else:
            canon[lane % e] = w_lane_major[lane, 0]
    out = np.empty((new.ep, new.experts_per_lane) + canon.shape[1:],
                   canon.dtype)
    for lane in range(new.ep):
        if new.n_experts >= new.ep:
            lo = lane * new.experts_per_lane
            out[lane] = canon[lo:lo + new.experts_per_lane]
        else:
            out[lane, 0] = canon[lane % e]
    return out


def accumulation_factor(old_data: int, new_data: int) -> int:
    """Gradient-accumulation steps that keep the global batch when the data
    axis shrinks from ``old_data`` to ``new_data``."""
    if old_data % new_data != 0:
        raise ValueError(f"{old_data} not divisible by {new_data}")
    return old_data // new_data
