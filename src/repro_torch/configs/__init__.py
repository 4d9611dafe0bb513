"""Registry of the paper's CNN configurations."""
from __future__ import annotations

import importlib

from repro_torch.core.config import CNNConfig

CNN_IDS = ["alexnet", "vgg16"]


def get_config(name: str) -> CNNConfig:
    """The CNN config ``name`` (one of :data:`CNN_IDS`).

    The JAX package's LM configs are not ported yet (ROADMAP.md, Queue 1,
    slice 8: the LM side)."""
    if name not in CNN_IDS:
        raise KeyError(
            f"{name!r} is not a CNN config of the port ({CNN_IDS}); the LM "
            f"configs come with ROADMAP.md Queue 1 slice 8 (the LM side)")
    return importlib.import_module(f"repro_torch.configs.{name}").CONFIG
