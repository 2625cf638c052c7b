"""Reference of SSB query flight 1 on the date-sorted ``lineorder``:
``ssb_flight1``'s, unchanged.  Its sums and counts are one GROUP BY (day,
quantity, discount) and do not depend on the order of the rows; its
sampled bitvectors are made from the raw values as the configuration's
maker made them, sorted."""
from __future__ import annotations

from scanbench.reference.ssb_flight1 import Truth, columns, compare, control_call

__all__ = ["Truth", "columns", "compare", "control_call"]
