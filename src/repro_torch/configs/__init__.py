"""Registry of the port's configurations: the paper's CNNs and the LM
configs ported so far, under the JAX registry's names and aliases."""
from __future__ import annotations

import importlib
from typing import Union

from repro_torch.core.config import CNNConfig, ModelConfig

CNN_IDS = ["alexnet", "vgg16"]
LM_IDS = ["qwen3_8b"]
_ALIASES = {"qwen3-8b": "qwen3_8b"}


def get_config(name: str) -> Union[CNNConfig, ModelConfig]:
    """The config ``name``: one of :data:`CNN_IDS` or :data:`LM_IDS`, or an
    alias the JAX registry also takes.

    The JAX package's other LM configs are not ported yet (ROADMAP.md,
    Queue 1, slice 8: the LM side)."""
    mod_name = _ALIASES.get(name, name)
    if mod_name not in CNN_IDS + LM_IDS:
        raise KeyError(
            f"{name!r} is not a config of the port ({CNN_IDS + LM_IDS}); the "
            f"other LM configs come with ROADMAP.md Queue 1 slice 8 (the LM "
            f"side)")
    return importlib.import_module(f"repro_torch.configs.{mod_name}").CONFIG
