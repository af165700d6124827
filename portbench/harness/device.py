"""The card: the check that there is one, what it is, and the guard
against the JAX package in the process."""

from __future__ import annotations

import os
import subprocess
import sys
import time

import torch

# Top-level module names that must not be loaded in a run, compared
# whole: ``sfm_tpu_torch`` is the port and passes, ``sfm_tpu`` does not.
FORBIDDEN = ("jax", "jaxlib", "flax", "sfm_tpu")


class NoCard(RuntimeError):
    pass


def require_cards(chips: int) -> torch.device:
    """The first card, or :class:`NoCard` when there is none or fewer
    than ``chips``."""
    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is false: this benchmark runs on a card")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"the cell asks for {chips} cards, the machine has "
                     f"{torch.cuda.device_count()}")
    return torch.device("cuda", 0)


def forbidden_modules(modules=None) -> list:
    """Names in ``sys.modules`` whose top-level name is forbidden."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".")[0] in FORBIDDEN)


def process_start(fallback: float) -> float:
    """Wall-clock time this process started (from /proc), else ``fallback``."""
    try:
        with open("/proc/self/stat") as fh:
            ticks = float(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
        started = time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
        return min(started, fallback)
    except (OSError, ValueError, IndexError):
        return fallback


def card_line() -> str:
    """``name, power limit`` of the cards as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
        return out.stdout.strip().replace("\n", "; ") or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def describe(dev: torch.device, count: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}
