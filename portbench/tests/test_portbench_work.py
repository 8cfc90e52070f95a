"""The frozen work counters, pinned at hand-worked shapes and held to the
smoke script's originals, and the useful-FLOP rule."""

import json
from pathlib import Path

import pytest
import torch

from portbench import work

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def test_bound_takes_the_larger_of_operations_and_bytes():
    assert work.bound(989e9, 0.0) == pytest.approx((1.0, "operations"))
    assert work.bound(0.0, 3.35e9) == pytest.approx((1.0, "bytes"))
    assert work.bound(989e9, 2 * 3.35e9)[1] == "bytes"


def test_pconv_work_by_hand():
    # 16 pixels x 3 outputs x 9 taps x 2 inputs, twice; x 32, mask 16,
    # w 54, y 48 and M' 16 elements of 2 bytes
    assert work.pconv_work((1, 4, 4, 2), (1, 4, 4, 1), (3, 2, 3, 3)) == (1728.0, 332.0)
    flop, nbytes = work.pconv_bwd_work((1, 4, 4, 2), (1, 4, 4, 1), (3, 2, 3, 3), (1, 4, 4, 3))
    assert (flop, nbytes) == (3456.0, 2.0 * (64 + 48 + 16 + 108))


def test_k6_work_counts_only_taps_inside_the_image():
    # rows: 3 + 4 + 3, columns: 4 + 5 + 4 at d 1; at d 4 on 4 rows only the centre row
    assert work.k6_work((1, 4, 5, 2), 3, 1) == (2.0 * 2 * 10 * 13, 2.0 * 40 * 2 + 4.0 * 9 * 2)
    assert work.k6_work((1, 4, 4, 1), 3, 4)[0] == 2.0 * 4 * 4


def test_stem_work_by_hand():
    assert work.stem_dx_work(1, 2, 2) == (617472.0, 77384.0)
    assert work.stem_pool_work(1, 2, 2) == (2.0 * 4 * 64 * 64 * 9, 2.0 * (4 * 64 * 5 / 4 + 36864))


def test_the_copies_agree_with_the_smoke_script():
    smoke = pytest.importorskip("chip_smoke")
    bf = torch.bfloat16
    meta = lambda *s: torch.empty(s, dtype=bf, device="meta")  # noqa: E731
    x, m, w, g = meta(8, 64, 64, 67), meta(8, 64, 64, 2), meta(3, 67, 3, 3), meta(8, 64, 64, 3)
    assert work.pconv_work(x.shape, m.shape, w.shape) == smoke.pconv_work(x, m, w)
    assert work.pconv_bwd_work(x.shape, m.shape, w.shape, g.shape) == smoke.pconv_bwd_work(
        x, m, w, g)
    for d in (1, 2, 4, 48):
        y = meta(8, 128, 96, 144)
        assert work.k6_work(y.shape, 3, d) == smoke.k6_work(y, 3, d)
    assert work.bound(3e12, 4e9) == smoke.bound(3e12, 4e9)


def _cfg(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())


def test_the_rule_of_useful_flops():
    cfg = _cfg("mnv2_pconv8")
    cfg["image_size"] = [64, 64]
    cfg["inpainter"]["depth"] = 6
    serve = work.products(cfg, "serve", 1)
    assert work.useful_flops(cfg, "serve") == pytest.approx(2 * sum(r["macs"] for r in serve))
    # the U-Net's products with x only: its mask window counts are not products
    assert sum(r["kind"] == "pconv" for r in serve) == 2 * cfg["inpainter"]["depth"]
    seg = work.products(cfg, "seg", 1)
    assert not seg[0]["x_grad"] and all(r["x_grad"] for r in seg[1:])  # the page needs none
    assert all(r["w_grad"] for r in seg)
    inp = work.products(cfg, "inpaint", 2)
    vgg = [r for r in inp if r["kind"] == "conv"]
    assert vgg and not any(r["w_grad"] for r in vgg)  # the frozen trunk
    n_layers = sum(1 for v in cfg["loss"]["vgg_layers"] if v != "M")
    assert len(vgg) == 2 * n_layers  # the output and composite together, and the ground truth
    assert sum(r["x_grad"] for r in vgg) == n_layers
    grams = [r for r in inp if r["kind"] == "gram"]
    assert len(grams) == 3 * cfg["loss"]["vgg_taps"]
    assert sum(r["x_grad"] for r in grams) == 2 * cfg["loss"]["vgg_taps"]


@pytest.mark.parametrize("name,kind,lo,hi", [
    ("mnv2_pconv8", "serve", 80e9, 140e9),
    ("mnv2_pconv8", "inpaint", 600e9, 850e9),
    ("mnv2_pconv8", "seg", 70e9, 120e9),
    ("xception_pconv8", "seg", 800e9, 1300e9),
])
def test_useful_flops_at_the_cells_size(name, kind, lo, hi):
    assert lo < work.useful_flops(_cfg(name), kind) < hi
