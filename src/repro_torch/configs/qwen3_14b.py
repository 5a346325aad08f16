from repro_torch.configs.base import ArchConfig

ARCH = ArchConfig(
    name="qwen3-14b", family="dense", n_layers=40, d_model=5120, n_heads=40,
    n_kv_heads=8, d_ff=17408, vocab=151936, head_dim=128, qk_norm=True,
    rope_theta=1e6, source="hf:Qwen/Qwen3-8B family; hf")
