"""Architecture registry: --arch <id> maps to a module here (the archs the
port knows so far; the reference registry is ``repro/configs/__init__.py``)."""

from importlib import import_module

_MODULES = {
    "qwen3-4b": "qwen3_4b",
    "qwen3-8b": "qwen3_8b",
    "qwen3-14b": "qwen3_14b",
    "qwen3-1.7b": "qwen3_1_7b",
    "mamba2-2.7b": "mamba2_2_7b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "mixtral-8x22b": "mixtral_8x22b",
    "hymba-1.5b": "hymba_1_5b",
    "qwen2-vl-7b": "qwen2_vl_7b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    # the paper's benchmark point (Table 2) in DeepSeek-V3 proportions
    "deepseek-v3-bench": "deepseek_v3_bench",
    "moe-tx-stream": "moe_tx_stream",
    "moe-ffn-stream": "moe_ffn_stream",
}

ARCH_IDS = tuple(_MODULES)


def get_arch(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    return import_module(f"repro_torch.configs.{_MODULES[name]}").ARCH
