"""The control on the card at a size a test run holds: the reference in
float32 with TF32 products, put in the program's place, fails the
cell's limits, while the program's own train passes them."""

import pytest
import torch

from benchmark import compare, run

CELLS = ["ml20m-r64.fused", "netflix-r100.fused", "ml20m-r64.xla"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: TF32 products exist only on "
                    "the card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_where_the_program_passes(card, cell):
    spec = run.load_cell(cell)
    cfg = run.shrink(spec["config"], 500_000, spec["config"]
                     ["num_iterations"])
    inputs = run.make_inputs(cfg, 20231, card)
    ref = run.reference_tables(cfg, inputs, card)
    limits = spec["limits"]
    trainer = run.make_trainer(cfg, spec["traffic"], inputs["coo"], card)
    got = trainer.train(init=inputs["init"])
    program = compare.readings(got.user_factors, got.item_factors, *ref)
    assert compare.judge([program], limits)["correct"], program
    control = compare.readings(*run.reference_tables(
        cfg, inputs, card, dtype=torch.float32, tf32=True), *ref)
    assert not compare.judge([control], limits)["correct"], control
