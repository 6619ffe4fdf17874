"""The control (the reference one precision step down, in the program's
place) fails where the program passes: at toy size on the CPU, and, marked
``chip``, at each cell's own size on the H100."""

import json

import pytest

import toy
from portbench import check
from portbench.cells import ROOT, load_cell
from portbench.control import readings

SEEDS = (11, 12, 13)


@pytest.mark.parametrize("seed", SEEDS)
def test_control_fails_the_toy_limits_where_the_program_passes(seed):
    cell = toy.cell("sd2")
    r = readings(cell, seed, "cpu")
    assert check.judge(r["program"], cell.limits), r
    assert not check.judge(r["control"], cell.limits), r
    for k in check.NUMBERS:
        assert r["control"][k] >= 3 * r["program"][k], (k, r)


CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.chip
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_the_cells_size(cuda, name):
    cell = load_cell(name)
    for seed in (2200000001, 2200000003, 2200000014):  # later steps 1, 6, 7
        r = readings(cell, seed, cuda)
        assert check.judge(r["program"], cell.limits), r
        assert not check.judge(r["control"], cell.limits), r


@pytest.mark.parametrize("seed", SEEDS)
def test_the_tf32_control_fails_the_fp32_toy_limits(seed):
    """A float32 configuration: the sound program (float32 on the CPU)
    reads far under the limits, its control (TF32, the unit itself) reads 1
    and fails them."""
    cell = toy.cell("fp32")
    r = readings(cell, seed, "cpu")
    assert check.judge(r["program"], cell.limits), r
    assert not check.judge(r["control"], cell.limits), r
    for k in check.NUMBERS[:2]:
        assert r["control"][k] == pytest.approx(1.0) and r["program"][k] < 0.1, r
