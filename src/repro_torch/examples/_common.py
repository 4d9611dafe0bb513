"""What every example shares: the ``--device`` flag, the name of the
device a printed time was taken on, and the output directory."""
from __future__ import annotations

import argparse
import subprocess
import tempfile

import torch


def add_device_arg(ap: argparse.ArgumentParser, out: bool = False) -> None:
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device; raises "
                         "without one)")
    if out:
        ap.add_argument("--out", default=None,
                        help="directory for the outputs (default: a new "
                             "temporary one)")


def where(dev: torch.device) -> str:
    """The device a time was taken on: on the card, its name and power
    limit as ``nvidia-smi`` gives them."""
    if dev.type != "cuda":
        return f"the {dev.type.upper()} (host)"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={dev.index or 0}"],
            capture_output=True, text=True, timeout=30, check=True)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return f"{torch.cuda.get_device_name(dev)} (power limit unread)"


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def out_dir(args, name: str) -> str:
    """``--out``, or a new temporary directory named for the example."""
    if args.out is not None:
        return args.out
    return tempfile.mkdtemp(prefix=f"repro_torch_{name}_")
