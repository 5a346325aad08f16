from repro_torch.configs.base import ArchConfig, MoESpec

ARCH = ArchConfig(
    name="qwen3-moe-30b-a3b", family="moe", n_layers=48, d_model=2048,
    n_heads=32, n_kv_heads=4, d_ff=768, vocab=151936, head_dim=128,
    qk_norm=True, rope_theta=1e6,
    moe=MoESpec(n_experts=128, top_k=8, d_ff_expert=768, norm_topk=True),
    source="hf:Qwen/Qwen3-30B-A3B; hf")
