"""On the card, at each cell's own size: the program's readings pass the
cell's limits and the control (the reference one precision lower in the
program's place) fails one of them. Marked ``cuda``; each test skips
without a card. On the card:
``python -m pytest --noconftest -m cuda benchmark/tests/test_bench_card.py``
"""

import pytest

from benchmark import harness

CELLS = [w["name"] for w in harness.manifest()["workloads"]]
SEED = 2 ** 31 + 4242


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    harness.steady_environment()
    torch.set_num_threads(1)
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_program_passes_and_control_fails_at_the_cell_size(card, name):
    cell = harness.make_cell(name, SEED, card)
    drv = harness.driver(cell.entry["traffic"])
    state = drv.setup(cell)
    drv.window(cell, state, 0.0)
    compared = drv.check(cell, state)
    assert all(c["value"] <= c["limit"] for c in compared), compared
    control = drv.control(cell, state)
    limits = cell.params["limits"]
    assert any(v > limits[k] for k, v in control.items()), control
