"""The check that decides ``correct`` fails a broken timed path. A tiny
serving cell, dense under the open loop and with experts under a full
queue, runs the harness's whole CPU path (the card
check skipped) with a fault planted underneath, and ``correct`` comes
out false; unbroken, it comes out true; and the control (the reference
in fp8 at the served positions) reads above the limit."""
from __future__ import annotations

import pytest

from portbench.tests.conftest import add_cell, run_cell

LIMIT = 0.05


CELLS = {"chat": dict(experts=False, backlog=False),
         "batch": dict(experts=True, backlog=True)}


@pytest.fixture(params=sorted(CELLS))
def cell(request, tree):
    name = add_cell(tree, f"tiny{request.param}", LIMIT,
                    **CELLS[request.param])
    return tree, name


def test_sound_run_is_correct(cell):
    tree, name = cell
    out = run_cell(tree, name, "--control", "fp8", seed=2 ** 31 + 101)
    c = out["checks"]["logit_gap"]
    assert out["correct"] is True and c["value"] <= LIMIT
    assert c["compared"] >= 8
    assert out["controls"]["fp8"]["logit_gap"] > LIMIT


@pytest.mark.parametrize("fault", ["altered_token", "state_unchanged"])
def test_fault_is_not_correct(cell, fault):
    tree, name = cell
    out = run_cell(tree, name, seed=2 ** 31 + 102,
                   entry=("-m", "portbench.faults", fault))
    assert out["correct"] is False
    assert out["checks"]["logit_gap"]["value"] > LIMIT
