"""Faults planted underneath the timed path (in the port's kernel wrappers,
in a rehearsal's own process) for the tests that see ``correct`` come out
false.  One chip: no exchange between chips to leave out."""
from __future__ import annotations

from shared_simd_scan_tpu_torch.ops import aggregate, conj, scan

# (module, wrapper) the timed path of each traffic generator calls underneath
TARGETS = {
    "shared_scan": [(scan, "interval_scan_tiles")],
    "ssb_flight1": [(conj, "conj_range_scan_tiles"), (aggregate, "masked_aggregate_tiles")],
}


def stale(module, name):
    """Every call returns the first call's answer: a state left unchanged."""
    orig, first = getattr(module, name), []

    def wrapper(*args, **kwargs):
        out = orig(*args, **kwargs)
        if not first:
            first.append(out)
        return first[0]
    setattr(module, name, wrapper)


def half(module, name):
    """Only the first half of the rows scanned, the counts taken for the
    whole: half of the batch left out, the mean taken over the rest."""
    orig = getattr(module, name)

    def wrapper(*args, **kwargs):
        args = list(args)
        args[4] //= 2  # n, the fifth argument of both scan wrappers
        bits, counts = orig(*args, **kwargs)
        return bits, counts * 2
    setattr(module, name, wrapper)


def flip(module, name):
    """One bit of each answer's first bitvector flipped where it is
    produced, its count kept."""
    orig = getattr(module, name)

    def wrapper(*args, **kwargs):
        bits, counts = orig(*args, **kwargs)
        bits = bits.clone()
        bits.view(-1)[0] ^= 1
        return bits, counts
    setattr(module, name, wrapper)


def install(generator: str, fault: str) -> None:
    """Plant ``fault`` in the first wrapper the generator's path calls
    (``stale`` in the last: the masked aggregate, for flight 1)."""
    targets = TARGETS[generator]
    module, name = targets[-1] if fault == "stale" else targets[0]
    {"stale": stale, "half": half, "flip": flip}[fault](module, name)
