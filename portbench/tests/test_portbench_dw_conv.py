"""The three ``dw_conv_roofline`` readers on hand-built parts: the least
time of each cell's depthwise convs (from ``work.products``) over the
device time under the program's span ``dw.conv`` per served batch or step,
and nothing where the program has no such span (the parent of the
depthwise kernel)."""

import pytest

from portbench import harness, parts
from portbench.tests.test_portbench_parts import _Ctx, _trace

READERS = {"mnv2_pconv8.serve": "dw_conv_roofline.serve",
           "mnv2_pconv8.train_seg": "dw_conv_roofline.train",
           "xception_pconv8.train_seg": "dw_conv_roofline.card_paced"}
# the bytes' least time at 3.35 TB/s (bf16, batch 8): the 17 MobileNetV2
# forwards, those and the 15 stride-1 dx of its seg step, Xception's 38
# forwards and 36 stride-1 dx
BOUND_MS = {"mnv2_pconv8.serve": 0.35718, "mnv2_pconv8.train_seg": 0.66268,
            "xception_pconv8.train_seg": 2.33142}


def _parts(device_s):
    return parts.Parts({"dw.conv": device_s} if device_s else {},
                       {"serve.dispatch": [0.03] * 4, "train.update": [0.005] * 4})


@pytest.mark.parametrize("cell", sorted(READERS))
def test_reader_is_the_bound_over_the_span_time(cell):
    c = harness.load_cell(cell)
    assert READERS[cell] in {m["name"] for m in c.per_layer}
    tr = _trace()
    tr.parts = _parts(0.004 * 4)  # 4 ms a batch or step
    got = harness.metric_module(READERS[cell]).read(_Ctx(c, tr, 4))
    assert got == pytest.approx(100.0 * BOUND_MS[cell] / 4.0, rel=1e-4)


@pytest.mark.parametrize("cell", sorted(READERS))
def test_reader_reads_nothing_without_the_span(cell):
    c = harness.load_cell(cell)
    tr = _trace()
    tr.parts = _parts(0.0)
    assert harness.metric_module(READERS[cell]).read(_Ctx(c, tr, 4)) is None
