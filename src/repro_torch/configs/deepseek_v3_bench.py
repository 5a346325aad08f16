from repro_torch.configs.base import ArchConfig, MoESpec

# The paper's communication-benchmark setting (Table 2): hidden 7168,
# 256 experts, top-8, EP 64 — embedded in DeepSeek-V3 proportions (61L,
# vocab 129280; MLA simplified to GQA per DESIGN.md §2).  Used to roofline
# the paper's own benchmark point on the production mesh.
ARCH = ArchConfig(
    name="deepseek-v3-bench", family="moe", n_layers=61, d_model=7168,
    n_heads=56, n_kv_heads=8, d_ff=2048, vocab=129280, head_dim=128,
    qk_norm=True, rope_theta=1e6,
    moe=MoESpec(n_experts=256, top_k=8, d_ff_expert=2048, norm_topk=True),
    source="paper Table 2 + DeepSeek-V3 proportions; bench")
