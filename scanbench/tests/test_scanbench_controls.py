"""The comparison that decides ``correct`` fails its control and every
fault a one-chip cell can have, at a size a CPU test can hold."""
from __future__ import annotations

import pytest

from scanbench.tests.rehearse import last_line, rehearse

CELLS = {"simdscan_9bit.interval8": "shared_scan", "ssb_sf100.flight1": "ssb_flight1"}


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_control_is_not_correct(cell):
    rc, out, err = rehearse(cell, seconds=2.0, extra=["--control"])
    assert rc == 0, err[-3000:]
    line = last_line(out)
    assert line["correct"] is False
    assert any(c["value"] > c["limit"] for c in line["checks"].values())


@pytest.mark.parametrize("fault", ["stale", "half", "flip"])
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_fault_is_not_correct(cell, fault):
    setup = f"from scanbench.tests import faults\nfaults.install({CELLS[cell]!r}, {fault!r})"
    rc, out, err = rehearse(cell, seconds=2.0, setup=setup)
    assert rc == 0, err[-3000:]
    line = last_line(out)
    assert line["correct"] is False, line["checks"]
    assert line["failed"] > 0
