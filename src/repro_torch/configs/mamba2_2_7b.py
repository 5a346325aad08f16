from repro_torch.configs.base import ArchConfig, SsmSpec

# 64L d_model=2560, attn-free; d_inner = 2*d = 5120, 80 heads x headdim 64,
# ssm_state=128 (SSD). [arXiv:2405.21060]
ARCH = ArchConfig(
    name="mamba2-2.7b", family="ssm", n_layers=64, d_model=2560, n_heads=0,
    n_kv_heads=0, d_ff=0, vocab=50280,
    ssm=SsmSpec(d_state=128, head_dim=64, expand=2, n_groups=1, chunk=256),
    source="arXiv:2405.21060; unverified")
