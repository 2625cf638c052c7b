"""The share of the traced slice in which no kernel, memset or copy runs on
the card, in %."""


def read(run):
    piece = run.slice
    if piece is None or piece.busy_s <= 0:
        return None
    return 100.0 * (1.0 - piece.busy_s / piece.window_s)
