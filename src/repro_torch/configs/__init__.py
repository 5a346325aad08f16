"""Architecture registry: --arch <id> maps to a module here (the archs the
port knows so far; the reference registry is ``repro/configs/__init__.py``)."""

from importlib import import_module

_MODULES = {
    "qwen3-1.7b": "qwen3_1_7b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
}

ARCH_IDS = tuple(_MODULES)


def get_arch(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    return import_module(f"repro_torch.configs.{_MODULES[name]}").ARCH
