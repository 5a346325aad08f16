from repro_torch.configs.base import ArchConfig

# enc-dec: 24 encoder + 24 decoder layers; the audio frontend is a stub: a
# batch carries precomputed frame embeddings (``models/zoo.make_smoke_batch``).
ARCH = ArchConfig(
    name="seamless-m4t-large-v2", family="encdec", n_layers=24,
    encoder_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, d_ff=8192,
    vocab=256206, rope_theta=1e4, source="arXiv:2308.11596; hf")
