"""The commit protocol of the JAX package's ``ckpt/checkpoint.py``.

``commit_dir`` writes a directory into ``<target>.tmp``, stamps
``_COMMITTED`` last and renames it into place, so a crash leaves either
the old committed target or ``.tmp`` wreckage that no reader trusts;
``clean_stale_tmp`` removes such wreckage. :mod:`repro_torch.pipeline.artifact`
commits a ``CompiledCNN`` under it.
"""
from __future__ import annotations

import shutil
from pathlib import Path
from typing import Callable


class CheckpointError(ValueError):
    """A checkpoint or artifact on disk does not match what its reader
    expects: uncommitted, truncated or corrupt leaves, wrong shapes or
    dtypes."""


def commit_dir(target: Path, write: Callable[[Path], None]) -> Path:
    """Atomically materialise ``target``: ``write(tmp)`` fills a
    ``<target>.tmp`` staging directory, then ``_COMMITTED`` is stamped and
    the directory renamed into place."""
    target = Path(target)
    tmp = Path(str(target) + ".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    write(tmp)
    (tmp / "_COMMITTED").write_text("ok")
    if target.exists():
        shutil.rmtree(target)
    tmp.rename(target)
    return target


def clean_stale_tmp(ckpt_dir: str) -> int:
    """Remove the ``*.tmp`` staging directories under ``ckpt_dir`` (a
    crashed writer's wreckage, never read). Returns how many went."""
    root = Path(ckpt_dir)
    if not root.exists():
        return 0
    stale = [d for d in root.iterdir()
             if d.is_dir() and d.name.endswith(".tmp")]
    for d in stale:
        shutil.rmtree(d, ignore_errors=True)
    return len(stale)
