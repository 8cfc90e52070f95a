"""The lower-precision control comes out incorrect.

The configurations state bfloat16; the control is the plain reference
computed in the precision below it, fp8 (``reference/precision.py``), put
in the program's place. On the card (``gpu``) it runs at each cell's own
size on three seeds against the cell's limits, as ``calibrate.py`` reads
it for ``PERF.md``. On the CPU, at a test's size, it must read above the
program's float32 path by far in at least one number."""

import pytest
import torch

from portbench import harness, judge

from .conftest import tiny

CELLS = ["mnv2_pconv8.serve", "mnv2_pconv8.train_inpaint", "mnv2_pconv8.train_seg",
         "xception_pconv8.train_seg"]


def _numbers(cell, seed, device, control, seconds):
    drv = harness.mix_module(cell).Runner(cell, seed, device)
    drv.setup()
    if cell.traffic["kind"] == "serve":
        drv.window(seconds)
    drv.release()
    return drv.judge(control=control)


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_the_cells_limits_on_the_card(name, cuda):
    cell = harness.load_cell(name)
    for seed in (31, 32, 33):
        ok, checks = judge.checks(_numbers(cell, seed, cuda, "fp8", 2.0),
                                  judge.limits_for(name))
        assert not ok, checks


@pytest.mark.parametrize("name", CELLS)
def test_the_control_reads_far_above_the_program(name):
    cell = tiny(harness.load_cell(name))
    prog = _numbers(cell, 41, torch.device("cpu"), None, 0.5)
    ctl = _numbers(cell, 41, torch.device("cpu"), "fp8", 0.5)
    limits = judge.limits_for(name)
    assert any(ctl[k] > 3 * prog[k] and ctl[k] > limits[k] for k in limits), (prog, ctl)
