"""The depthwise-conv weight gradient: kernel K6 and its plain version.

Counterpart of ``text_segmentation_image_inpainting_tpu/ops/pallas/depthwise_wgrad.py``
(``depthwise_wgrad``). For a stride-1 depthwise conv with dilation d and
torch-'same' padding p = d*(k-1)/2:

    dW[ki, kj, 0, c] = sum_{n, oh, ow} x[n, oh + ki*d - p, ow + kj*d - p, c] * dy[n, oh, ow, c]

with x zero outside the image, summed in f32. The CUDA source is
``csrc/depthwise_wgrad.cu``: one launch in which each CTA walks a band of
rows of one image and channel block with its x rows in a shared-memory
ring, and the last CTA of each channel block adds the CTAs' partial sums in
a fixed order. ``k6_plan`` (pure Python, CPU-tested) chooses the channel
block, the bands and the column strips. The rest of JAX's scope (any odd
k, any equal dilation), the windows the kernel is not built for and the
dilations whose halo leaves no strip that fits, runs its general form
(``dw_wgrad_gen``: a thread per (tap, channel) and chunk of pixels, the
chunks' partials added in order by ``dw_wgrad_gen_sum``), also counted as
K6. ``depthwise_wgrad`` takes the plain
version only for a tensor on the CPU; on a CUDA tensor it launches K6 or
raises, nothing falls back. ``K6_LAUNCHES`` counts the launches.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from text_segmentation_image_inpainting_tpu_torch.ops.kernels.partial_conv import gen_chunks

K6_LAUNCHES = 0
K6_GEN_LAUNCHES = 0  # the general form's launches, also counted in K6_LAUNCHES
# the kernel sizes K6's templated form is compiled for (one template
# instance each); every other odd k runs its general form
K6_KERNEL_SIZES = (1, 3, 5, 7)

# K6's geometry, as csrc/depthwise_wgrad.cu has it (tests/test_torch_k6_plan.py
# holds the two against each other)
K6_THREADS = 256  # NT: threads per CTA
K6_G = 4  # G: output rows summed per step
K6_PRE = 1  # PRE: steps in flight ahead of the step being summed
K6_MIN_CTAS = 2  # MIN_CTAS: CTAs per SM the kernel's registers are capped for
K6_MAX_BOX = 256  # MAX_BOX: most pixels of one TMA row
K6_ALIGN = 128  # ALIGN: ring rows start on 128 bytes
K6_PIXEL_BYTES = 64  # PB: bytes of a pixel's channel block, the one a CTA owns
SMEM_LIMIT = 232448 - 64  # MAX_SMEM: dynamic shared bytes a CTA can take beside its barriers
K6_MIN_ROWS = 4  # the fewest rows a band is cut to
K6_MAX_DILATION = 4096  # the most the templated form's launcher takes


class K6Plan(NamedTuple):
    """How K6 cuts (N, H, W, C): CTA (slot, cb) owns image ``slot // (bands
    * strips)``, rows ``[band * rows, +rows)`` and columns ``[strip * tw,
    +tw)`` of it (band, strip from the slot, strip fastest), channels
    ``[cb * cb_ch, +cb_ch)``, 64 bytes of each pixel. ``general``: the
    general form runs the call in ``chunks`` chunks of pixels (the other
    fields are then 0)."""

    cb_ch: int
    cblocks: int
    rows: int
    bands: int
    tw: int
    strips: int
    smem: int
    general: bool = False
    chunks: int = 0

    def slots(self, n: int) -> int:
        """CTAs per channel block: the grid is (slots(n), cblocks)."""
        return n * self.bands * self.strips


def k6_cpt(k: int) -> int:
    """Channels per lane: 4 at k <= 3, 2 at k 5, 1 at k 7 (the k*k sums and
    the k*k window of each channel stay in registers)."""
    return 4 if k <= 3 else 2 if k == 5 else 1


def _up128(b: int) -> int:
    return -(-b // K6_ALIGN) * K6_ALIGN


def k6_ring_bytes(p: int, tw: int) -> int:
    """The x ring (2p + G(PRE+1) rows of tw+2p pixels) and the dy ring
    (G(PRE+1) rows of tw pixels), each row on 128 bytes."""
    rows, pb = K6_G * (K6_PRE + 1), K6_PIXEL_BYTES
    return (2 * p + rows) * _up128((tw + 2 * p) * pb) + rows * _up128(tw * pb)


def k6_smem_bytes(k: int, p: int, tw: int, elem: int) -> int:
    """A CTA's dynamic shared memory: 128 bytes of alignment, then the rings
    or the warps' sums after them, whichever is larger."""
    red = (K6_THREADS // 32) * k * k * (K6_PIXEL_BYTES // elem) * 4
    return K6_ALIGN + max(k6_ring_bytes(p, tw), red)


@functools.lru_cache(maxsize=256)
def k6_plan(n: int, h: int, w: int, c: int, k: int, d: int, elem: int, sms: int) -> K6Plan:
    """K6's cut of one call. A row strip is the whole row unless one TMA row
    (256 pixels) or the rings would not fit. The bands minimise the rows
    one SM sums, ``ceil(CTAs / sms) * (rows + p + 2)`` (p for the halo rows
    a band re-reads, 2 for its start and end), ties to more bands. The
    general form (``gen_chunks`` chunks of pixels) where k is not one of
    K6_KERNEL_SIZES, d is above K6_MAX_DILATION, or even a one-column
    strip does not fit (a dilation far beyond the segmenter's)."""
    p = d * (k - 1) // 2
    tw = min(w, K6_MAX_BOX - 2 * p) if k in K6_KERNEL_SIZES and d <= K6_MAX_DILATION else 0
    while tw >= 1 and k6_smem_bytes(k, p, tw, elem) > SMEM_LIMIT:
        tw -= 1
    if tw < 1:
        return K6Plan(0, 0, 0, 0, 0, 0, 0, True, gen_chunks(n * h * w, k * k * c))
    strips = -(-w // tw)
    tw = -(-w // strips)
    cb_ch = K6_PIXEL_BYTES // elem
    cblocks = -(-c // cb_ch)
    pairs = n * cblocks * strips
    best = None
    for b in range(1, max(1, h // K6_MIN_ROWS) + 1):
        rows = -(-h // b)
        bands = -(-h // rows)
        cost = -(-pairs * bands // sms) * (rows + p + 2)
        if best is None or cost < best[0] or (cost == best[0] and bands > best[2]):
            best = (cost, rows, bands)
    _, rows, bands = best
    return K6Plan(cb_ch, cblocks, rows, bands, tw, strips, k6_smem_bytes(k, p, tw, elem))


def supported(stride, dilation, kernel_shape) -> bool:
    """K6's scope, as the JAX kernel's: a square odd-k stride-1 depthwise
    kernel (k, k, 1, C) with equal dilations and at least 128 channels."""
    kh, kw, cin_per_group, c = kernel_shape
    return (
        tuple(stride) == (1, 1)
        and dilation[0] == dilation[1]
        and kh == kw
        and kh % 2 == 1
        and cin_per_group == 1
        and c >= 128
    )


def depthwise_wgrad_reference(x: torch.Tensor, dy: torch.Tensor, k: int, d: int) -> torch.Tensor:
    """Plain version of K6: the explicit f32 sum over the k*k shifted slabs
    of the zero-padded x against dy. x, dy (N, H, W, C) -> (k, k, 1, C) f32."""
    n, h, w, c = x.shape
    p = d * (k - 1) // 2
    xp = F.pad(x.float(), (0, 0, p, p, p, p))
    dyf = dy.float()
    taps = [(xp[:, ki * d: ki * d + h, kj * d: kj * d + w, :] * dyf).sum(dim=(0, 1, 2))
            for ki in range(k) for kj in range(k)]
    return torch.stack(taps).reshape(k, k, 1, c)


def depthwise_wgrad(x: torch.Tensor, dy: torch.Tensor, k: int, d: int) -> torch.Tensor:
    """dW (k, k, 1, C) f32 of a stride-1 'same'-padded depthwise conv from
    its input ``x`` and output cotangent ``dy``, both (N, H, W, C) in one
    float dtype. K6 on CUDA (``dy`` is made contiguous NHWC first, as
    autograd hands it over with any strides), the plain version on the CPU.
    K6's result is a view of a (C, k*k) tensor, so its (C, 1, k, k)
    permutation is contiguous."""
    if x.device.type == "cpu":
        return depthwise_wgrad_reference(x, dy, k, d)
    return _launch_k6(x.contiguous(), dy.contiguous(), k, d)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# Per device: K6's partial sums and its tickets (zero between launches; each
# launch's last CTAs reset theirs). Launches on one device share them, so
# K6 runs on one stream at a time, as autograd's backward does.
_WORKSPACE: dict = {}


def _workspace(device: torch.device, floats: int, cblocks: int):
    part, tickets = _WORKSPACE.get(device.index, (None, None))
    if part is None or part.numel() < floats:
        part = torch.empty(max(floats, 1 << 20), dtype=torch.float32, device=device)
    if tickets is None or tickets.numel() < cblocks:
        tickets = torch.zeros(max(cblocks, 1024), dtype=torch.int32, device=device)
    _WORKSPACE[device.index] = (part, tickets)
    return part, tickets


def _launch_k6(x: torch.Tensor, dy: torch.Tensor, k: int, d: int) -> torch.Tensor:
    global K6_LAUNCHES, K6_GEN_LAUNCHES
    from text_segmentation_image_inpainting_tpu_torch.ops.kernels.build import check, load_library

    if not x.is_cuda or x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"K6 takes a bfloat16 or float32 CUDA x, got {x.dtype} on {x.device}")
    if x.dim() != 4:
        raise ValueError(f"x must be (N, H, W, C), got {tuple(x.shape)}")
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"dy must match x {tuple(x.shape)} {x.dtype} on {x.device}, got "
                         f"{tuple(dy.shape)} {dy.dtype} on {dy.device}")
    if not (x.is_contiguous() and dy.is_contiguous()):
        raise ValueError("K6 takes contiguous NHWC x and dy")
    if k < 1 or k % 2 == 0 or d < 1:
        raise ValueError(f"K6 takes an odd k and d >= 1 (JAX's scope), got k={k}, d={d}")
    n, h, w, c = x.shape
    elem = x.element_size()
    plan = k6_plan(n, h, w, c, k, d, elem, _sm_count(x.device.index))
    lib = load_library()
    if plan.general:
        part, _ = _workspace(x.device, plan.chunks * k * k * c, 1)
        dw = torch.empty((c, k, k), dtype=torch.float32, device=x.device)
        code = lib.tsii_dw_wgrad_gen(x.data_ptr(), dy.data_ptr(), part.data_ptr(), dw.data_ptr(),
                                     n, h, w, c, k, d, int(elem == 2), plan.chunks,
                                     torch.cuda.current_stream(x.device).cuda_stream)
        check(lib, code, "K6 (depthwise wgrad, general form)")
        K6_LAUNCHES += 1
        K6_GEN_LAUNCHES += 1
        return dw.permute(1, 2, 0).unsqueeze(2)
    # the CTAs' partial sums: (cblocks, CTAs per block, k*k, cb_ch) f32
    part, tickets = _workspace(x.device, plan.cblocks * plan.slots(n) * k * k * plan.cb_ch,
                               plan.cblocks)
    dw = torch.empty((c, k, k), dtype=torch.float32, device=x.device)
    code = lib.tsii_dw_wgrad(x.data_ptr(), dy.data_ptr(), part.data_ptr(), tickets.data_ptr(),
                             dw.data_ptr(), n, h, w, c, k, d, int(elem == 2), plan.rows, plan.tw,
                             torch.cuda.current_stream(x.device).cuda_stream)
    check(lib, code, "K6 (depthwise wgrad)")
    K6_LAUNCHES += 1
    return dw.permute(1, 2, 0).unsqueeze(2)
