"""Reference of the shared-scan traffic: per key, the rows equal to it."""
from __future__ import annotations

import numpy as np
import torch

from scanbench.reference.words import blockwise, pack_bits


def columns(params: dict) -> list[str]:
    return [params["column"]]


class Truth:
    def __init__(self, params: dict, config: dict, raw: dict):
        spec = config["columns"][params["column"]]
        self.values = raw[params["column"]]
        hist = torch.zeros(spec["max"] + 1, dtype=torch.int64, device=self.values.device)
        for s in blockwise(self.values.shape[0]):
            hist += torch.bincount(self.values[s].to(torch.int64), minlength=hist.shape[0])
        self.hist = hist.cpu().numpy()

    def numbers(self, op: np.ndarray) -> np.ndarray:
        """The count of every key of the batch."""
        keys = op.astype(np.int64)
        inside = keys < self.hist.shape[0]
        return np.where(inside, self.hist[np.minimum(keys, self.hist.shape[0] - 1)], 0)

    def words(self, op: np.ndarray) -> list[torch.Tensor]:
        return [pack_bits(self.values == int(key)) for key in op]


def compare(got: np.ndarray, expected: np.ndarray) -> dict[str, int]:
    return {"count_mismatches": int((np.asarray(got) != expected).sum())}


def control_call(params: dict, config: dict, raw: dict, op: np.ndarray, span):
    """The reference in the program's place with each value compared one
    bit short of the width of the values the column holds (the guarantee
    broken: values compared whole)."""
    col = params["column"]
    low = (1 << (config["columns"][col]["max"].bit_length() - 1)) - 1
    with span("shared_scan_device"):
        values = raw[col] & low
        masks = [values == (int(key) & low) for key in op]
        words = [pack_bits(m) for m in masks]
        counts = torch.stack([m.sum() for m in masks])
    return counts.cpu().numpy(), words
