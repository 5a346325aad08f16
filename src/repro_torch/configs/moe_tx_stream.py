"""Attention-separated MoE transformer (copy of
``repro/configs/moe_tx_stream.py``): each layer is the parallel block
``h + attn(ln1 h) + moe(ln2 h)``, served through ``fusco.tx_layer_stream``."""

from repro_torch.configs.base import ArchConfig, MoESpec

ARCH = ArchConfig(
    name="moe-tx-stream-1b",
    family="moe_tx",
    n_layers=16,
    d_model=1024,
    n_heads=16,
    n_kv_heads=4,
    head_dim=64,
    d_ff=0,
    vocab=32768,
    moe=MoESpec(n_experts=64, top_k=4, d_ff_expert=1024),
    source="attention-separated stream setting (tail in flight across attention)",
)
