"""Attention-free MoE-FFN stack (copy of ``repro/configs/moe_ffn_stream.py``):
consecutive MoE layers with nothing between them, ``h + moe(ln1 h)`` each,
the shape the cross-layer stream targets (the combine of layer i in flight
into layer i+1's prologue): ``--engine fused_pipe --moe-stream <block>``
chains each block of layers through one schedule
(``layers/moe.stream_moe_layers``), ``--moe-stream 0`` keeps per-layer
barriers."""

from repro_torch.configs.base import ArchConfig, MoESpec

ARCH = ArchConfig(
    name="moe-ffn-stream-1b",
    family="moe_ffn",
    n_layers=16,
    d_model=1024,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=32768,
    moe=MoESpec(n_experts=64, top_k=4, d_ff_expert=1024),
    source="stream benchmark setting (cross-layer pipelined dComm)",
)
