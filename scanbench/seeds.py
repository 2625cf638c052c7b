"""Independent random streams drawn from one run seed.

Every stream (a column's values, the operations, the warm-up, the sampled
answers) takes its own seed from the run's ``--seed`` and its name, so the
same seed gives the same inputs, and one stream never shifts another.
"""
from __future__ import annotations

import hashlib

import numpy as np
import torch


def stream_seed(seed: int, name: str) -> int:
    """A 63-bit seed for the stream ``name`` of run seed ``seed`` (any int)."""
    digest = hashlib.sha256(f"{int(seed)}:{name}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def host_rng(seed: int, name: str) -> np.random.Generator:
    return np.random.default_rng(stream_seed(seed, name))


def device_generator(seed: int, name: str, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, name))
    return gen


def uniform(config: dict, column: str, rows: int, seed: int, device) -> torch.Tensor:
    """The raw values of ``column`` (int32[rows]) for run seed ``seed``,
    uniform over its ``min``..``max``, made on ``device``: the maker of a
    configuration that brings no ``configs/<name>.py``."""
    spec = config["columns"][column]
    gen = device_generator(seed, f"{config['name']}.{column}", device)
    return torch.randint(spec["min"], spec["max"] + 1, (rows,), generator=gen,
                         dtype=torch.int32, device=device)
