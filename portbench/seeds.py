"""Every random stream of a run, drawn from `--seed` alone."""

from __future__ import annotations

import hashlib

import torch


def sub_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for one named stream of the run seeded `seed`."""
    digest = hashlib.sha256(f"{int(seed)}:{stream}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed: int, stream: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, stream))
