"""Architecture registry: every LM architecture the JAX package assigns,
and the paper's CNNs, under the JAX registry's names and aliases."""
from __future__ import annotations

import importlib
from typing import Dict, Union

from repro_torch.core.config import CNNConfig, ModelConfig

ARCH_IDS = [
    "internvl2_26b",
    "dbrx_132b",
    "arctic_480b",
    "xlstm_125m",
    "internlm2_20b",
    "minitron_4b",
    "qwen3_32b",
    "qwen3_8b",
    "zamba2_1p2b",
    "musicgen_medium",
]
LM_IDS = ARCH_IDS
CNN_IDS = ["alexnet", "vgg16"]

_ALIASES = {
    "internvl2-26b": "internvl2_26b",
    "dbrx-132b": "dbrx_132b",
    "arctic-480b": "arctic_480b",
    "xlstm-125m": "xlstm_125m",
    "internlm2-20b": "internlm2_20b",
    "minitron-4b": "minitron_4b",
    "qwen3-32b": "qwen3_32b",
    "qwen3-8b": "qwen3_8b",
    "zamba2-1.2b": "zamba2_1p2b",
    "musicgen-medium": "musicgen_medium",
}


def get_config(name: str) -> Union[ModelConfig, CNNConfig]:
    """The config ``name``: an id of :data:`ARCH_IDS` or :data:`CNN_IDS`,
    an alias, or a name that becomes an id with ``-`` -> ``_`` and
    ``.`` -> ``p``, as in the JAX registry."""
    mod_name = _ALIASES.get(name, name.replace("-", "_").replace(".", "p"))
    if mod_name not in ARCH_IDS + CNN_IDS:
        raise KeyError(f"{name!r} is not a config ({ARCH_IDS + CNN_IDS})")
    return importlib.import_module(f"repro_torch.configs.{mod_name}").CONFIG


def all_lm_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}


def all_cnn_configs() -> Dict[str, CNNConfig]:
    return {a: get_config(a) for a in CNN_IDS}
