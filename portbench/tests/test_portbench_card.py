"""On the card: each cell's path comes out correct at its own size with a
window of one unit, and its control does not. Skips where no CUDA device is
visible (decided in the ``card`` fixture)."""

from __future__ import annotations

import pytest

from portbench.harness.registry import Registry

CELLS = Registry().workload_names()


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_cell_and_its_control_on_the_card(card, cell):
    from portbench.control import readings

    limits = Registry().workload(cell)["check"]["limits"]
    out = readings(cell, 2 ** 31 + 99, True, device=card)
    assert all(out["program"][k] <= v for k, v in limits.items()), out
    assert any(out["control"][k] > v for k, v in limits.items()), out
    assert out["program_correct"] and not out["control_correct"], out
