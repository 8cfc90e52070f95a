"""The depthwise conv's kernel route without a card: ``dw_plan``, the plain
version, the generalised Function, the routing, and a torch emulation of
the kernel's tile walk (``csrc/depthwise_conv.cu``), on the CPU.

The plain version is ``F.conv2d(groups=C)``; it and the Function are held
to JAX's conv and its VJP within 1e-5 of max |ref| in f32 (the bound of
``tests/test_torch_depthwise.py``). The emulation repeats the kernel's
index arithmetic (tiles, the TMA box with its zero fill, the lanes' runs
of outputs ``ostep`` apart and the input columns they share) and must
write every output once, equal to the f64 conv to 1e-12 of max |ref|
(f64 sums in another order). The flag tests restore
``USE_CUSTOM_WGRAD``.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import text_segmentation_image_inpainting_tpu_torch.ops.depthwise as tdw
from text_segmentation_image_inpainting_tpu.ops.conv import conv2d as jconv2d
from text_segmentation_image_inpainting_tpu_torch.models import TextSegmenter
from text_segmentation_image_inpainting_tpu_torch.models.mobilenet_v2 import ConvBNAct
from text_segmentation_image_inpainting_tpu_torch.ops.conv import conv_output_size
from text_segmentation_image_inpainting_tpu_torch.ops.kernels import depthwise_conv as kdc
from text_segmentation_image_inpainting_tpu_torch.utils.profiling import counters
from tests.test_torch_bridge import one_torch_thread

CSRC = (Path(__file__).resolve().parents[1]
        / "text_segmentation_image_inpainting_tpu_torch" / "csrc" / "depthwise_conv.cu")
SMS = 132  # an H100 SXM's SMs
SM_SHARED = 233472  # shared memory of one SM; a CTA also takes 1 KB of it


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    # torch's CPU ops on one thread: six test workers share the cores
    yield from one_torch_thread()


@pytest.fixture(autouse=True)
def _restore_flag():
    prev = tdw.USE_CUSTOM_WGRAD
    yield
    tdw.USE_CUSTOM_WGRAD = prev


def _rel_max(got, want):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


def _layers(backbone: str) -> list:
    """(x shape, stride, dilation) of every depthwise conv of the cells'
    segmenter at 512^2, batch 8, bf16, by forward hooks on the meta device."""
    kw = {} if backbone == "mobilenet_v2" else dict(backbone="xception", head="deeplab")
    model = TextSegmenter(dtype=torch.bfloat16, **kw).to("meta")
    seen = []

    def hook(m, args, out):
        c = m[0]
        if c.groups == c.in_channels == c.out_channels > 1:
            seen.append((tuple(args[0].shape), c.stride[0], c.dilation[0]))

    hooks = [m.register_forward_hook(hook) for m in model.modules() if isinstance(m, ConvBNAct)]
    with torch.no_grad():
        model(torch.zeros(8, 512, 512, 3, device="meta"))
    for h in hooks:
        h.remove()
    return seen


CELL_LAYERS = {b: _layers(b) for b in ("mobilenet_v2", "xception")}
CELL_SHAPES = sorted({(x, s, d) for v in CELL_LAYERS.values() for x, s, d in v})


def test_cell_layers_are_the_counted_ones():
    """17 MobileNetV2 and 38 Xception depthwise convs, all 3x3, two strided each."""
    assert len(CELL_LAYERS["mobilenet_v2"]) == 17 and len(CELL_LAYERS["xception"]) == 38
    for layers in CELL_LAYERS.values():
        assert sum(s == 2 for _, s, _ in layers) == 2


def test_constants_match_the_source():
    src = CSRC.read_text()
    const = {m.group(1): int(m.group(2))
             for m in re.finditer(r"constexpr int (\w+) = (\d+);", src)}
    assert const["NT"] == kdc.DW_THREADS
    assert const["MIN_CTAS"] == kdc.DW_CTAS_PER_SM
    assert const["VEC_BYTES"] == kdc.DW_VEC_BYTES
    assert const["MAX_BOX"] == kdc.DW_MAX_BOX
    assert const["BUF_BYTES"] == kdc.DW_BUF_BYTES
    assert const["MAX_CV"] == kdc.DW_MAX_CV
    assert const["NBUF"] == 2
    assert const["CPT"] == kdc.DW_CPT and const["RUN"] == kdc.DW_RUN
    assert re.search(r"k == 3 && q == 1", src) and re.search(r"k == 3 && q == 2", src)
    assert kdc.KERNEL_SIZES == (3,) and kdc.STRIDES == (1, 2)


def _check_plan(plan, n, ho, wo, c, k, s, d, elem):
    vec = kdc.DW_VEC_BYTES // elem
    v = c // vec
    assert plan.cblocks * plan.cv >= v and (plan.cblocks - 1) * plan.cv < v
    assert plan.cv in (1, 2, 4, 8)
    if plan.cv > 1:  # the widest block whose waste is at most 1/8
        assert plan.cblocks * plan.cv - v <= v * kdc.DW_CH_WASTE
    assert plan.ostep * s == plan.q * d and plan.q in (1, 2)
    assert plan.tw % (kdc.DW_RUN * plan.ostep) == 0
    # the halo matches the dilation: the box holds every input a tile reads
    assert plan.in_rows == (plan.th - 1) * s + (k - 1) * d + 1
    assert plan.in_cols == (plan.tw - 1) * s + (k - 1) * d + 1
    assert max(plan.in_rows, plan.in_cols, plan.cv * vec) <= kdc.DW_MAX_BOX
    # tiles cover the output
    tiles_h, tiles_w = -(-ho // plan.th), -(-wo // plan.tw)
    assert tiles_h * plan.th >= ho and tiles_w * plan.tw >= wo
    assert plan.tiles == n * plan.cblocks * tiles_h * tiles_w
    assert 1 <= plan.ctas <= min(plan.tiles, kdc.DW_CTAS_PER_SM * SMS)
    # shared memory: one buffer's box, two buffers a CTA, two CTAs an SM
    assert plan.box_bytes() <= kdc.DW_BUF_BYTES
    assert plan.smem_bytes() <= 232448
    assert kdc.DW_CTAS_PER_SM * (plan.smem_bytes() + 1024) <= SM_SHARED


@pytest.mark.parametrize("x,s,d", CELL_SHAPES)
@pytest.mark.parametrize("elem", [2, 4])
def test_dw_plan_at_the_cells_shapes(x, s, d, elem):
    n, h, w, c = x
    ho, wo = conv_output_size(h, 3, s, d, d), conv_output_size(w, 3, s, d, d)
    plan = kdc.dw_plan(n, ho, wo, c, 3, s, d, elem, SMS)
    _check_plan(plan, n, ho, wo, c, 3, s, d, elem)
    # every cell layer fills the card's CTAs with whole 128-byte lines where C allows
    assert plan.ctas == kdc.DW_CTAS_PER_SM * SMS
    assert plan.cv * kdc.DW_VEC_BYTES == 128 or c * elem < 1024


@pytest.mark.parametrize("n,h,w,c,s,d,elem", [
    (1, 5, 7, 8, 1, 1, 2),      # one vector of channels, a map smaller than a tile
    (2, 9, 13, 24, 2, 1, 4),    # odd map, stride 2
    (1, 3, 3, 16, 1, 4, 2),     # every off-centre tap in the padding
    (3, 40, 33, 1536, 1, 4, 2),
    (1, 250, 250, 8, 2, 3, 4),  # stride 2 at an odd dilation: q 2, ostep 3
])
def test_dw_plan_away_from_the_cells(n, h, w, c, s, d, elem):
    ho, wo = conv_output_size(h, 3, s, d, d), conv_output_size(w, 3, s, d, d)
    _check_plan(kdc.dw_plan(n, ho, wo, c, 3, s, d, elem, SMS), n, ho, wo, c, 3, s, d, elem)


def test_dw_plan_refuses():
    with pytest.raises(ValueError):
        kdc.dw_plan(1, 8, 8, 12, 3, 1, 1, 2, SMS)  # 12 bf16 channels: no whole vectors
    with pytest.raises(ValueError):
        kdc.dw_plan(1, 8, 8, 16, 3, 3, 1, 2, SMS)  # stride 3


def emulate(x, w, s, d, ph, pw, flip, sms=1):
    """The kernel's walk in f64: x (N, H, W, C), w (C, 1, k, k); returns y
    and how many times each output was written."""
    n, h, wd, c = x.shape
    k = w.shape[-1]
    elem = 2
    vec = kdc.DW_VEC_BYTES // elem
    ho, wo = conv_output_size(h, k, s, ph, d), conv_output_size(wd, k, s, pw, d)
    p = kdc.dw_plan(n, ho, wo, c, k, s, d, elem, sms)
    r = kdc.DW_RUN
    taps = w.reshape(c, k * k)
    if flip:
        taps = taps.flip(1)
    y = torch.zeros((n, ho, wo, c), dtype=torch.float64)
    writes = torch.zeros((n, ho, wo, c), dtype=torch.int64)
    tiles_w, tiles_h = -(-wo // p.tw), -(-ho // p.th)
    lanes = kdc.pixel_lanes(p.cv, elem)
    runs_row = p.tw // r
    for cta in range(p.ctas):
        for tile in range(cta, p.tiles, p.ctas):
            tx, rest = tile % tiles_w, tile // tiles_w
            ty, rest = rest % tiles_h, rest // tiles_h
            cb, img = rest % p.cblocks, rest // p.cblocks
            # the TMA box, zeros outside the tensor
            c0, col0, row0 = cb * p.cv * vec, tx * p.tw * s - pw, ty * p.th * s - ph
            box = torch.zeros((p.in_rows, p.in_cols, p.cv * vec), dtype=torch.float64)
            r0, r1 = max(row0, 0), min(row0 + p.in_rows, h)
            q0, q1 = max(col0, 0), min(col0 + p.in_cols, wd)
            cc = min(c, c0 + p.cv * vec) - c0
            if r1 > r0 and q1 > q0:
                box[r0 - row0:r1 - row0, q0 - col0:q1 - col0, :cc] = \
                    x[img, r0:r1, q0:q1, c0:c0 + cc]
            wt = torch.zeros((k * k, p.cv * vec), dtype=torch.float64)
            wt[:, :cc] = taps[c0:c0 + cc].T
            for pl in range(lanes):
                for run in range(pl, p.th * runs_row, lanes):
                    orow, rr = divmod(run, runs_row)
                    e = rr % p.ostep
                    ocol = (rr - e) * r + e
                    acc = torch.zeros((r, p.cv * vec), dtype=torch.float64)
                    for ki in range(k):
                        for m in range((r - 1) * p.q + k):
                            xv = box[orow * s + ki * d, ocol * s + m * d]
                            for i in range(r):
                                kj = m - i * p.q
                                if 0 <= kj < k:
                                    acc[i] += xv * wt[ki * k + kj]
                    oh = ty * p.th + orow
                    for i in range(r):
                        ow = tx * p.tw + ocol + i * p.ostep
                        if oh < ho and ow < wo:
                            y[img, oh, ow, c0:c0 + cc] = acc[i, :cc]
                            writes[img, oh, ow, c0:c0 + cc] += 1
    return y, writes


@pytest.mark.parametrize("n,h,w,c,s,d,pad,flip", [
    (1, 11, 13, 24, 1, 1, None, False),
    (2, 10, 9, 16, 2, 1, None, False),    # stride 2: q 2
    (1, 12, 17, 8, 1, 2, None, True),     # dx at d 2: runs 2 columns apart
    (1, 13, 12, 16, 2, 2, None, False),   # stride 2 at d 2: q 1
    (1, 9, 21, 8, 1, 4, (0, 4), False),   # a band: H padding 0
    (1, 7, 9, 8, 1, 1, (2, 1), True),     # dx of a band's conv: padding d(k-1) - 0 rows
])
def test_emulated_tile_walk_is_the_conv(n, h, w, c, s, d, pad, flip):
    g = torch.Generator().manual_seed(h * w + c + s + d)
    x = torch.randn((n, h, w, c), generator=g, dtype=torch.float64)
    wgt = torch.randn((c, 1, 3, 3), generator=g, dtype=torch.float64)
    ph, pw = pad or (d, d)
    y, writes = emulate(x, wgt, s, d, ph, pw, flip)
    want = F.conv2d(x.permute(0, 3, 1, 2), wgt.flip((2, 3)) if flip else wgt, None, s, (ph, pw),
                    d, c).permute(0, 2, 3, 1)
    assert y.shape == want.shape and bool((writes == 1).all())
    assert _rel_max(y, want) < 1e-12


def _jax_conv(x, kern, s, d):
    c, k = x.shape[-1], kern.shape[0]
    return jconv2d(jnp.asarray(x), jnp.asarray(kern), stride=s, padding=d * (k - 1) // 2,
                   dilation=d, groups=c)


@pytest.mark.parametrize("flag", [False, True])
@pytest.mark.parametrize("c,s,d,dtype", [
    (32, 1, 1, torch.float32),
    (96, 2, 1, torch.bfloat16),
    (144, 2, 2, torch.float32),
    (728, 1, 2, torch.bfloat16),
    (1536, 1, 4, torch.float32),
    (160, 1, 4, torch.bfloat16),
])
def test_plain_route_matches_conv2d_and_jax(c, s, d, dtype, flag):
    """The CPU route: ``depthwise_conv2d`` is the plain version, bit for bit
    ``F.conv2d`` of the weight cast to x's dtype, and JAX's conv of the same
    values (f32: 1e-5 of max |ref|; bf16: one rounding, 2^-8 relative, plus
    1e-5 of max |ref|)."""
    tdw.USE_CUSTOM_WGRAD = flag
    g = torch.Generator().manual_seed(c + s + d)
    x = torch.randn((2, 9, 10, c), generator=g).to(dtype)
    w = torch.randn((c, 1, 3, 3), generator=g) * 0.3
    before = counters()
    y = tdw.depthwise_conv2d(x, w, d, s)
    after = counters()
    assert after.get("dw.plain", 0) - before.get("dw.plain", 0) == 1
    assert after.get("dw.kernel", 0) == before.get("dw.kernel", 0)
    want = F.conv2d(x.permute(0, 3, 1, 2), w.to(dtype), None, s, d, d, c).permute(0, 2, 3, 1)
    assert torch.equal(y, want) and y.is_contiguous()
    ref = _jax_conv(x.float().numpy(), w.to(dtype).float().numpy().transpose(2, 3, 1, 0), s, d)
    if dtype is torch.float32:
        assert _rel_max(y.numpy(), ref) < 1e-5
    else:
        ref = torch.from_numpy(np.array(ref))
        torch.testing.assert_close(y.float(), ref, rtol=2**-8, atol=1e-5 * ref.abs().max().item())


@pytest.mark.parametrize("c,s,d,k6", [
    (32, 1, 1, False),    # C < 128: dW from the library
    (96, 2, 1, False),    # stride 2: dx and dW from the library
    (144, 2, 2, False),
    (128, 1, 2, True),    # K6's scope
    (200, 1, 4, True),
    (200, 1, 4, False),   # the same layer with the flag off
])
def test_function_grads_match_jax_vjp(c, s, d, k6):
    """f32: the Function's dx and dW (the plain forward, the library's
    stride-2 dx, dW from K6's plain version or the library) against JAX's
    VJP within 1e-5 of max |ref|; dW in the weight's dtype."""
    g = torch.Generator().manual_seed(7 + c + s + d)
    x = torch.randn((2, 11, 10, c), generator=g).requires_grad_(True)
    w = (torch.randn((c, 1, 3, 3), generator=g) * 0.3).requires_grad_(True)
    p = d
    y = tdw.DepthwiseConv2d.apply(x, w, s, d, p, p, False, k6)
    dy = torch.randn(y.shape, generator=g)
    y.backward(dy)
    _, vjp = jax.vjp(lambda a, b: _jax_conv(a, b, s, d), jnp.asarray(x.detach().numpy()),
                     jnp.asarray(w.detach().numpy().transpose(2, 3, 1, 0)))
    jdx, jdw = vjp(jnp.asarray(dy.numpy()))
    assert _rel_max(x.grad.numpy(), jdx) < 1e-5
    assert w.grad.dtype == torch.float32
    assert _rel_max(w.grad.numpy(), np.asarray(jdw).transpose(3, 2, 0, 1)) < 1e-5


@pytest.mark.parametrize("d,ph,pw", [(1, 1, 1), (2, 2, 2), (4, 4, 4), (2, 0, 2), (4, 0, 4)])
def test_stride1_dx_is_the_flipped_conv(d, ph, pw):
    """f64: at stride 1 the data gradient of the conv with padding (ph, pw)
    is the conv of dy with the taps flipped and padding d(k-1) - (ph, pw),
    the kernel's dx: torch-'same' padding and a band's H padding 0 alike."""
    g = torch.Generator().manual_seed(d + ph)
    c, k = 16, 3
    x = torch.randn((2, 13, 12, c), generator=g, dtype=torch.float64)
    w = torch.randn((c, 1, k, k), generator=g, dtype=torch.float64)
    y = kdc.depthwise_conv2d_plain(x, w, 1, d, (ph, pw))
    dy = torch.randn(y.shape, generator=g, dtype=torch.float64)
    want = torch.ops.aten.convolution_backward(
        dy.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2), w, None, [1, 1], [ph, pw], [d, d], False,
        [0, 0], c, [True, False, False])[0].permute(0, 2, 3, 1)
    got = kdc.depthwise_conv2d_plain(dy, w.flip((2, 3)), 1, d, (d * (k - 1) - ph, d * (k - 1) - pw))
    assert got.shape == x.shape
    assert _rel_max(got, want) < 1e-12


class _Cuda:
    """What ``in_scope`` reads of a tensor, for a card this sandbox lacks."""

    def __init__(self, dtype, c, cuda=True):
        self.is_cuda, self.dtype, self.shape = cuda, dtype, (2, 8, 8, c)

    def element_size(self):
        return torch.empty((), dtype=self.dtype).element_size()


@pytest.mark.parametrize("k,s,dtype,c,cuda,want", [
    (3, 1, torch.bfloat16, 728, True, True),
    (3, 2, torch.bfloat16, 96, True, True),
    (3, 1, torch.float32, 1536, True, True),
    (3, 1, torch.float64, 128, True, False),   # f64: the plain version
    (3, 1, torch.bfloat16, 128, False, False),  # the CPU
    (5, 1, torch.bfloat16, 128, True, False),   # a window the kernel is not built for
    (3, 3, torch.bfloat16, 128, True, False),   # stride 3
    (3, 1, torch.bfloat16, 12, True, False),    # 24-byte pixels: not whole vectors
])
def test_routing_by_what_the_input_shows(k, s, dtype, c, cuda, want):
    assert kdc.in_scope(_Cuda(dtype, c, cuda), k, s) is want


@pytest.mark.parametrize("s,grad", [(1, True), (2, True), (1, False)])
def test_kernel_route_calls(monkeypatch, s, grad):
    """With the kernel's route taken (its launcher replaced by the plain
    version): no gradient launches it directly; with one the Function
    launches the forward and, at stride 1 only, the flipped dx with padding
    d(k-1) - p; ``dw.kernel`` counts each conv once."""
    calls = []

    def fused(x, w, s_, d_, pad, flip=False):
        calls.append((s_, d_, tuple(pad), flip))
        return kdc.depthwise_conv2d_plain(x, w.flip((2, 3)) if flip else w, s_, d_, pad)

    monkeypatch.setattr(kdc, "in_scope", lambda x, k, stride: True)
    monkeypatch.setattr(kdc, "depthwise_conv2d_fused", fused)
    g = torch.Generator().manual_seed(s)
    c, d = 16, 2
    x = torch.randn((2, 9, 8, c), generator=g).requires_grad_(grad)
    w = torch.randn((c, 1, 3, 3), generator=g).requires_grad_(grad)
    before = counters()
    y = tdw.depthwise_conv2d(x, w, d, s)
    assert counters().get("dw.kernel", 0) - before.get("dw.kernel", 0) == 1
    assert (y.grad_fn is not None) is grad
    if grad:
        assert type(y.grad_fn).__name__ == "DepthwiseConv2dBackward"
        y.backward(torch.ones_like(y))
        ref_x = x.detach().clone().requires_grad_(True)
        F.conv2d(ref_x.permute(0, 3, 1, 2), w.detach(), None, s, d, d, c).sum().backward()
        torch.testing.assert_close(x.grad, ref_x.grad)
    want = [(s, d, (d, d), False)] + ([(1, d, (d, d), True)] if grad and s == 1 else [])
    assert calls == want


def test_launcher_refuses_a_cpu_tensor():
    x = torch.zeros((1, 4, 4, 16), dtype=torch.bfloat16)
    w = torch.zeros((16, 1, 3, 3))
    with pytest.raises(ValueError, match="CUDA"):
        kdc.depthwise_conv2d_fused(x, w, 1, 1, (1, 1))


def test_segmenter_counts_every_depthwise_conv_as_plain_on_the_cpu():
    """Every depthwise conv of a small MobileNetV2 segmenter goes through
    the op once a forward: 17 ``dw.plain`` on the CPU, none on the kernel."""
    model = TextSegmenter().eval()
    before = counters()
    with torch.no_grad():
        model(torch.zeros((1, 32, 32, 3)))
    after = counters()
    assert after.get("dw.plain", 0) - before.get("dw.plain", 0) == 17
    assert after.get("dw.kernel", 0) == before.get("dw.kernel", 0)
