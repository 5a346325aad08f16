from repro_torch.configs.base import ArchConfig, SsmSpec

# parallel attn+mamba heads; SWA everywhere except 3 global layers.
ARCH = ArchConfig(
    name="hymba-1.5b", family="hybrid", n_layers=32, d_model=1600, n_heads=25,
    n_kv_heads=5, d_ff=5504, vocab=32001, head_dim=64, rope_theta=1e4,
    window=1024, global_layers=(0, 15, 31),
    ssm=SsmSpec(d_state=16, head_dim=64, expand=2, n_groups=1, chunk=256),
    source="arXiv:2411.13676; hf")
