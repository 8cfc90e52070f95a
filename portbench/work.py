"""The yardstick's arithmetic: peaks, bounds, and work counted from shapes.

``bound``, ``pconv_work``, ``pconv_bwd_work`` and ``k6_work`` are frozen
copies of the port's smoke script's counters, taken over shapes in place
of tensors, so that the yardstick does not move when the program does.
The stem's counts are the same script's K4/K5 formulas.

``products`` lists every convolution and matrix product of a
configuration's part with its geometry, by running the plain reference
on the meta device (no memory, no time), and ``useful_flops`` counts a
page's useful work from them by this rule:

* every conv and matmul counts 2 multiply-adds' worth of FLOPs per
  multiply-add: the partial convs' products with x (not their mask
  window counts), the segmenter, the VGG16 trunk and the Gram matrices;
* a forward pass counts each product once; a training step counts the
  forward, the data gradient where the product's input needs one (not
  for the page itself) and the weight gradient where its weight is
  trained, each as many FLOPs as the forward. So the trained U-Net or
  segmenter counts three times but for the first layer's data gradient,
  and the frozen VGG16 counts its forward on all three sets (output,
  composite, ground truth) and its data gradient on the two it
  differentiates; a Gram's backward is one product of its size;
* BatchNorm, pooling, upsampling, masks, the losses' element sums and
  Adam count 0.
"""

from __future__ import annotations

import torch

PEAK_BF16 = 989e12  # FLOP/s, one H100 SXM, dense bf16 (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12


def bound(flop: float, nbytes: float, peak: float = PEAK_BF16) -> tuple:
    """(ms, "operations" or "bytes"): the least time the card could take
    for ``flop`` operations at ``peak`` and ``nbytes`` moved once."""
    t_op, t_mem = flop / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_op, "operations") if t_op >= t_mem else (t_mem, "bytes")


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def pconv_work(x, mask, w, p: int | None = None) -> tuple:
    """(FLOP, bytes) of one stride-1 partial conv with P output pixels (by
    default x's, a same-size conv), x (N, H, W, Cin), mask (N, H, W, G), w
    (Cout, Cin, k, k) as shapes: 2 P Cout k^2 Cin multiply-adds; x, the
    mask and the weights read once, y and M' written once, all bf16."""
    n, h, wd, cin = x
    cout, _, k, _ = w
    p = n * h * wd if p is None else p
    flop = 2.0 * p * cout * k * k * cin
    nbytes = 2.0 * (_numel(x) + _numel(mask) + _numel(w) + p * cout + p)
    return flop, nbytes


def pconv_bwd_work(x, mask, w, g) -> tuple:
    """(FLOP, bytes) of that conv's backward: dx and dW are two products of
    the forward's size; x, g, the mask and the weights read once, dx and dW
    written once, all bf16."""
    flop, _ = pconv_work(x, mask, w)
    nbytes = 2.0 * (2 * _numel(x) + _numel(g) + _numel(mask) + 2 * _numel(w))
    return 2.0 * flop, nbytes


def k6_work(x, k: int, d: int, elem: int = 2) -> tuple:
    """(FLOP, bytes) of K6 on x (N, H, W, C), dilation d: a multiply-add for
    each (output pixel, tap) whose x lies inside the image, 2 N C
    sum_taps (H - |oi d|)+ (W - |oj d|)+ (separable: the rows' sum times
    the columns'); x and dy read once, dW (k k C f32) written once."""
    n, h, w, c = x
    offs = [abs(o) * d for o in range(-(k // 2), k // 2 + 1)]
    rows, cols = sum(max(0, h - o) for o in offs), sum(max(0, w - o) for o in offs)
    return 2.0 * n * c * rows * cols, 2.0 * _numel(x) * elem + 4.0 * k * k * c


def stem_dx_work(m: int, h: int, w: int) -> tuple:
    """(FLOP, bytes) of K4, the VGG stem's data gradient on x (M, H, W, 3)
    with g (M, H/2, W/2, 64): conv1's forward and data gradient (64 -> 64,
    3 x 3) and conv0's (3 -> 64, 3 x 3, 27 taps) forward and data gradient;
    x, g and the weights read once (bf16), dx written once (f32)."""
    px = m * h * w
    flop = 2.0 * px * 64 * 64 * 9 * 2 + 4.0 * px * 64 * 27
    nbytes = 2.0 * (px * 3 + px // 4 * 64 + 64 * 3 * 9 + 64 * 64 * 9) + 4.0 * px * 3
    return flop, nbytes


def stem_pool_work(m: int, h: int, w: int) -> tuple:
    """(FLOP, bytes) of K5, the stem's conv1 + ReLU + 2 x 2 pool on z0
    (M, H, W, 64): z0 read and the pooled quarter written, the weights
    read, all bf16."""
    flop = 2.0 * m * h * w * 64 * 64 * 9
    return flop, 2.0 * (m * h * w * 64 * 5 / 4 + 64 * 64 * 9)


def products(cfg: dict, kind: str, batch: int) -> list:
    """Every product (dicts of the reference's records) that the part of
    ``cfg`` behind ``kind`` runs for a batch of ``batch`` pages:
    'serve' the page cleaner's forward, 'inpaint' and 'seg' a training
    step's forward with the trained weights' gradient flags set."""
    from portbench.reference import losses, steps
    from portbench.reference.precision import f32

    prec = f32()
    prec.records = []
    h, w = cfg["image_size"]
    with torch.device("meta"):
        if kind == "serve":
            m = steps.build(cfg, "pipeline", prec).eval()
            x = torch.zeros(batch, 3, h, w)
            valid = torch.zeros(batch, 1, h, w)
            with torch.no_grad():
                m.seg(x)
                m.unet(x * valid, valid)
        elif kind == "inpaint":
            unet, vgg = steps.build(cfg, "unet", prec), steps.build(cfg, "vgg", prec)
            x, mask = torch.zeros(batch, 3, h, w), torch.zeros(batch, 1, h, w)
            losses.inpaint_loss(prec, vgg, unet(x * mask, mask), x, mask, cfg["loss"])
        elif kind == "seg":
            steps.build(cfg, "segmenter", prec)(torch.zeros(batch, 3, h, w))
        else:
            raise ValueError(f"no work kind {kind!r}")
    return prec.records


def useful_flops(cfg: dict, kind: str, batch: int = 1) -> float:
    """Useful FLOPs per page (module docstring's rule)."""
    total = 0.0
    for r in products(cfg, kind, batch):
        passes = 1
        if kind != "serve":
            passes += int(r["x_grad"]) + int(r["w_grad"])
        total += 2.0 * r["macs"] * passes
    return total / batch
