from repro_torch.configs.base import ArchConfig, MoESpec

ARCH = ArchConfig(
    name="mixtral-8x22b", family="moe", n_layers=56, d_model=6144, n_heads=48,
    n_kv_heads=8, d_ff=16384, vocab=32768, head_dim=128, rope_theta=1e6,
    window=4096,   # SWA per assignment -> long_500k runnable
    moe=MoESpec(n_experts=8, top_k=2, d_ff_expert=16384, norm_topk=True),
    source="arXiv:2401.04088; hf")
