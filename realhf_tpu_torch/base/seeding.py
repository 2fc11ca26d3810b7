"""Deterministic seeding.

Randomness flows through explicit ``torch.Generator`` objects derived
from one experiment-level seed, so every model and sampling stream is
reproducible and streams of different components never collide.
"""

import hashlib
import random

import numpy as np
import torch

_base_seed = None


def set_random_seed(seed: int):
    global _base_seed
    _base_seed = int(seed)
    random.seed(seed)
    np.random.seed(seed % (2 ** 32))


def get_seed() -> int:
    if _base_seed is None:
        raise RuntimeError("Seed not set; call set_random_seed first.")
    return _base_seed


def derive_seed_from(base_seed: int, *names) -> int:
    """A stable 63-bit seed for a named component, e.g.
    ``derive_seed_from(1, 'model_init', 'actor')``."""
    h = hashlib.sha256(
        ("/".join(map(str, names)) + f"@{int(base_seed)}").encode())
    return int.from_bytes(h.digest()[:8], "little") & ((1 << 63) - 1)


def generator(seed: int, device="cpu") -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g
