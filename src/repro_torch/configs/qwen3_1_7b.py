from repro_torch.configs.base import ArchConfig

ARCH = ArchConfig(
    name="qwen3-1.7b", family="dense", n_layers=28, d_model=2048, n_heads=16,
    n_kv_heads=8, d_ff=6144, vocab=151936, head_dim=128, qk_norm=True,
    rope_theta=1e6, source="hf:Qwen/Qwen3-8B family; hf")
