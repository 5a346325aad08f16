from repro_torch.configs.base import ArchConfig

# M-RoPE backbone; the vision frontend is a stub: a batch carries patch
# embeddings and (3, S) position ids (``models/zoo.make_smoke_batch``).
ARCH = ArchConfig(
    name="qwen2-vl-7b", family="vlm", n_layers=28, d_model=3584, n_heads=28,
    n_kv_heads=4, d_ff=18944, vocab=152064, head_dim=128, rope_theta=1e6,
    mrope_sections=(16, 24, 24), source="arXiv:2409.12191; hf")
