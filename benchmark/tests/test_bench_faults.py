"""The comparison catches what it is there to catch, at a size a test run
holds: the control (the reference one precision lower in the program's
place) and each planted fault of the timed path come out not correct,
through the rest of a run with the look for a card skipped."""

import pytest
import torch

from benchmark import harness
from benchmark.tests import tiny


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", ["nq_ar2.cotrain", "msdoc_ar2.cotrain",
                                  "nq_ar2.encode"])
def test_control_is_not_correct(name):
    c = tiny.cell(name)
    drv = harness.driver(c.entry["traffic"])
    state = drv.setup(c)
    drv.window(c, state, 0.5)
    assert all(x["value"] <= x["limit"] for x in drv.check(c, state))
    ctrl = drv.control(c, state)
    limits = c.params["limits"]
    assert any(v > limits[k] for k, v in ctrl.items()), ctrl


CASES = [("nq_ar2.cotrain", f) for f in ("step_unchanged", "half_batch",
                                          "alter_token")] + \
    [("msdoc_ar2.cotrain", f) for f in ("step_unchanged", "half_batch",
                                         "alter_token")] + \
    [("nq_ar2.encode", f) for f in ("half_batch", "alter_answer")]


@pytest.mark.parametrize("name,fault", CASES)
def test_fault_is_not_correct(name, fault):
    out = tiny.run(name, faults=(fault,))
    assert not out["correct"], out["compared"]


@pytest.mark.parametrize("name", ["nq_ar2.cotrain", "msdoc_ar2.cotrain"])
def test_half_batch_fails_moved_rows(name):
    """A step over half the queries leaves their tokens' embedding rows
    still: ``moved_rows`` alone reads it well past its limit."""
    out = tiny.run(name, faults=("half_batch",))
    moved = out["compared"]["moved_rows"]
    assert moved["value"] > 5 * moved["limit"], moved
