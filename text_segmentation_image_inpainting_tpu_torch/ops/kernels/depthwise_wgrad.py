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
dilations whose halo leaves no strip that fits (or, from the routing cut
``K6_GEN_HALO``, that the general form does faster), runs its general form:
``dw_wgrad_gen_tiles`` walks tiles of taps over rows staged in shared
memory and ``dw_wgrad_gen_fold`` adds its CTAs' slots in order, as
``k6_gen_plan`` cuts the call; also counted as K6. ``depthwise_wgrad``
takes the plain version only for a tensor on the CPU; on a CUDA tensor it
launches K6 or raises, nothing falls back. ``K6_LAUNCHES`` counts the
launches.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

K6_LAUNCHES = 0
K6_GEN_LAUNCHES = 0  # the general form's launches, also counted in K6_LAUNCHES
# the kernel sizes K6's templated form is compiled for (one template
# instance each); every other odd k runs its general form
K6_KERNEL_SIZES = (1, 3, 5, 7)
# The routing cut: from this halo p = d*(k-1)/2 on, the general form takes
# the call even where the templated form fits. tools/gen_forms.py
# --k6-route measures both at the shapes near the template's limits: on
# the segmenter's block-2 map the general form was faster in both dtypes
# at every p from 25 (k 3, d 25-27; k 5, d 13; k 7, d 9), slower in both
# at p <= 20 and at k 5, d 12, mixed at p 24.
K6_GEN_HALO = 25

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
# the general form's (test_torch_k6_plan.py holds these to the .cu too)
K6_GEN_CH = 16  # GEN_CH: channels of a CTA's block, in both dtypes
K6_GEN_CPT = 4  # GEN_CPT: channels per lane
K6_GEN_NPX = K6_THREADS // (K6_GEN_CH // K6_GEN_CPT)  # GEN_NPX: pixel lanes of a CTA
K6_GEN_TJ = 8  # GEN_TJ: widest tile of tap columns a lane owns
K6_GEN_SEG = 64  # GEN_SEG: most columns a lane walks into one sum
K6_GEN_ZERO = 128  # GEN_ZERO: bytes of the zero pixel
# the plan's aims: the longest chain of f32 adds of a (tap, channel), and
# the partials (f32 values), each kept where a cut allows
K6_GEN_CHAIN = 160
K6_GEN_PART_FLOATS = 1 << 24
SM_SHARED = 233472  # shared memory of one SM; a CTA also takes 1 KB of it


class K6GenPlan(NamedTuple):
    """How K6's general form cuts (N, H, W, C). Taps whose shift reaches
    the image: rows |o| <= kri, columns |o| <= krj (kc = 2 krj + 1). A row
    of kc tap columns is ``ntj`` tiles of ``tj`` (the last shifted back to
    end at kc). CTA (slot, cb, z) owns image ``slot // (bands * strips)``,
    rows ``[band * rows, +rows)``, columns ``[strip * tw, +tw)`` (strip
    fastest), channels ``[16 cb, +16)``, tap rows ``[-kri + kg (z % ngr),
    +kg)`` and tiles ``[ntg (z // ngr), +ntg)``. ``fold``: the slots are
    added in blocks of ``fold``. ``chain``: the longest chain of f32 adds."""

    kri: int
    krj: int
    tj: int
    ntj: int
    ntg: int
    kg: int
    rows: int
    bands: int
    tw: int
    strips: int
    cblocks: int
    fold: int
    smem: int
    chain: int

    @property
    def kc(self) -> int:
        return 2 * self.krj + 1

    @property
    def ngr(self) -> int:
        return -(-(2 * self.kri + 1) // self.kg)

    @property
    def ngc(self) -> int:
        return -(-self.ntj // self.ntg)

    @property
    def ntap(self) -> int:
        return (2 * self.kri + 1) * self.kc

    def slots(self, n: int) -> int:
        """CTAs per (channel block, group): the grid is (slots(n), cblocks, ngr * ngc)."""
        return n * self.bands * self.strips

    def part_floats(self, n: int) -> int:
        return self.cblocks * self.slots(n) * self.ntap * K6_GEN_CH


class K6Plan(NamedTuple):
    """How K6 cuts (N, H, W, C): CTA (slot, cb) owns image ``slot // (bands
    * strips)``, rows ``[band * rows, +rows)`` and columns ``[strip * tw,
    +tw)`` of it (band, strip from the slot, strip fastest), channels
    ``[cb * cb_ch, +cb_ch)``, 64 bytes of each pixel. ``general``: the
    general form runs the call as ``gen`` cuts it (the other fields are
    then 0)."""

    cb_ch: int
    cblocks: int
    rows: int
    bands: int
    tw: int
    strips: int
    smem: int
    general: bool = False
    gen: Optional[K6GenPlan] = None

    def slots(self, n: int) -> int:
        """CTAs per channel block: the grid is (slots(n), cblocks)."""
        return n * self.bands * self.strips


def k6_cpt(k: int) -> int:
    """Channels per lane: 4 at k <= 3, 2 at k 5, 1 at k 7 (the k*k sums and
    the k*k window of each channel stay in registers)."""
    return 4 if k <= 3 else 2 if k == 5 else 1


def _up128(b: int) -> int:
    return -(-b // K6_ALIGN) * K6_ALIGN


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


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


def k6_tap_radii(h: int, w: int, k: int, d: int):
    """(kri, krj): the tap rows and columns whose shift o*d reaches the
    image, |o| <= kri (rows) and |o| <= krj (columns)."""
    hk = (k - 1) // 2
    return min(hk, (h - 1) // d), min(hk, (w - 1) // d)


def k6_gen_smem(h: int, w: int, k: int, d: int, tj: int, ntg: int, kg: int, tw: int,
                elem: int) -> int:
    """The general form's dynamic shared memory, as ``gen_geom`` has it: 128
    bytes of alignment, the zero pixel, then the x ring ((kg-1) d + G(PRE+1)
    rows of the widest staged x row, in TMA boxes of at most 256 pixels)
    and the dy ring (G(PRE+1) rows of tw pixels), each row with room for
    its skew of up to one 128-byte line, or the lanes' sums, the larger."""
    kc = 2 * k6_tap_radii(h, w, k, d)[1] + 1
    span = min(kc, ntg * tj)
    nxc = min(w, tw + (span - 1) * d)
    pb = K6_GEN_CH * elem
    sk = K6_ALIGN // pb  # a ring row starts up to sk - 1 pixels into its line
    bwx, bwg = min(K6_MAX_BOX, nxc + sk - 1), min(K6_MAX_BOX, tw + sk - 1)
    xrow = _up128(_cdiv(nxc + sk - 1, bwx) * bwx * pb)
    grow = _up128(_cdiv(tw + sk - 1, bwg) * bwg * pb)
    ring = ((kg - 1) * d + K6_G * (K6_PRE + 1)) * xrow + K6_G * (K6_PRE + 1) * grow
    red = K6_GEN_NPX * tj * K6_GEN_CH * 4
    return K6_ALIGN + K6_GEN_ZERO + max(ring, red)


def k6_gen_units(ni: int, tw: int, d: int):
    """A CTA's walk of a strip row, as the kernel has it, for ``ni`` items
    (tap row, tile): (lanes of the scarcest item, segment length, segments a
    class, units a step). The row's classes mod d that hold a column (min(d,
    tw)) are cut into segments of at most GEN_SEG columns, and into enough
    that every lane of an item has a unit; a segment is odd where a class
    has several (lanes on neighbouring segments then hit other banks)."""
    lpi = K6_GEN_NPX // ni
    ncls, m = min(d, tw), _cdiv(tw, d)
    spc = max(1, _cdiv(lpi, K6_G * ncls), _cdiv(m, K6_GEN_SEG))
    seg = _cdiv(m, spc)
    seg += spc > 1 and seg % 2 == 0
    return lpi, seg, spc, K6_G * ncls * spc


def _group_sizes(total: int, size: int):
    """(size, count) of the groups ``total`` is cut into, ``size`` each but the last."""
    full, rest = divmod(total, size)
    return [(size, full)] + ([(rest, 1)] if rest else [])


def _gen_fold(slots: int) -> int:
    return math.isqrt(slots - 1) + 1 if slots > 1 else 1


def _gen_walk(n, h, w, d, kri, kc, tj, ntg, kg, rows, tw, fold, elem):
    """(chain, work, latency, worst) of a cut. chain: the longest chain of
    f32 adds into one dW value: a lane's segment, its segments into its
    total (at most ceil(units / lanes) a step), the pairwise tree over the
    item's lanes, the slots in blocks of ``fold`` and the blocks. The
    rest, in microseconds of one SM, summed over the CTAs of one (image,
    band, strip, channel block) (the cost model's terms, ``GEN_COST``):
    work, the slowest lane's instructions (4 tj + 12 a column, 100 tj a
    segment) and the bytes the CTA stages; latency, a CTA's start and end
    and each step's wait for its rows where the step's sums are shorter;
    worst, the longest CTA."""
    steps = _cdiv(rows, K6_G)
    chain = work = latency = worst = 0
    pb = K6_GEN_CH * elem
    for kgc, nr in _group_sizes(2 * kri + 1, kg):
        for ntc, nc in _group_sizes(_cdiv(kc, tj), ntg):
            ni = kgc * ntc
            lpi, seg, _, units = k6_gen_units(ni, tw, d)
            per_lane = _cdiv(units, lpi)
            chain = max(chain, seg + steps * per_lane + (_cdiv(K6_GEN_NPX, ni) - 1).bit_length())
            nxc = min(w, tw + (min(kc, ntc * tj) - 1) * d)
            staged = (min(rows * kgc, rows + (kgc - 1) * d) * nxc + rows * tw) * pb
            step = GEN_COST["lane"] * per_lane * (min(seg, _cdiv(tw, d)) * (4 * tj + 12)
                                                  + GEN_COST["unit"] * tj)
            cta_work = steps * step + GEN_COST["byte"] * staged
            cta_lat = GEN_COST["cta"] + steps * max(0.0, GEN_COST["step"] - step)
            work += nr * nc * cta_work
            latency += nr * nc * cta_lat
            worst = max(worst, cta_work + cta_lat)
    slots = n * _cdiv(h, rows) * _cdiv(w, tw)
    return chain + fold + _cdiv(slots, fold), work, latency, worst


# The plan's cost model, fitted to the times of 2439 cuts on one NVIDIA
# H100 80GB HBM3 (700 W) at eight shapes in both dtypes
# (tools/k6_gen_cuts.py). At the eight shapes it was not fitted to
# (``HELD_OUT`` there, both dtypes) its cuts ran 1.070x the best forced
# cut in geometric mean (1.213x at worst), a fixed rule's 1.194x
# (1.773x). Its terms: microseconds per lane instruction of a CTA,
# lane instructions a segment per tap of the tile, a step's wait for its
# rows, a CTA's start and end, a byte staged, a partial the fold reads, and
# how far CTAs sharing an SM overlap their work (0: not at all, 1: fully;
# the kernel is held more by latency than by issue).
GEN_COST = dict(lane=0.0026, unit=100, step=4.5, cta=10.7, byte=3.3e-6, fold=1.1e-5, share=0.54)


def _strip_widths(w: int):
    """Strip widths to try, widest first: w / s for a few s."""
    seen = []
    for s in (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128, 192, 256):
        tw = _cdiv(w, s)
        if tw not in seen:
            seen.append(tw)
    if 1 not in seen:
        seen.append(1)
    return seen


def _band_rows(h: int):
    """Band heights to try: h / b for b up to 16, then a few more bands."""
    rows = []
    for b in (*range(1, 17), 20, 24, 28, 32, 40, 48, 64, 96, 128):
        r = _cdiv(h, b)
        if b > max(1, h // K6_MIN_ROWS) or r in rows:
            continue
        rows.append(r)
    return rows


@functools.lru_cache(maxsize=1024)
def k6_gen_plan(n: int, h: int, w: int, c: int, k: int, d: int, elem: int, sms: int) -> K6GenPlan:
    """The general form's cut of one call. The widest tiles of tap columns
    (at most GEN_TJ, a row cut into equal tiles) and the most tiles a
    column group whose rows fit the shared memory at one tap row a group in
    some strip; then, among strips (the widest three that fit), tap rows a
    group (at most 64 items a CTA) and bands of rows, the cut of least
    estimated time (``_gen_walk``'s terms, ``GEN_COST``), keeping the
    longest f32 chain within K6_GEN_CHAIN and the partials within
    K6_GEN_PART_FLOATS where a cut does."""
    kri, krj = k6_tap_radii(h, w, k, d)
    krn, kc = 2 * kri + 1, 2 * krj + 1
    cblocks = _cdiv(c, K6_GEN_CH)
    ntap = krn * kc

    def fits(tj, ntg, kg, tw):
        return k6_gen_smem(h, w, k, d, tj, ntg, kg, tw, elem) <= SMEM_LIMIT

    for ntj in range(_cdiv(kc, K6_GEN_TJ), kc + 1):
        tj = _cdiv(kc, ntj)
        if _cdiv(kc, tj) != ntj:
            continue  # the same tiles as fewer of them
        for ntg in range(min(ntj, K6_GEN_NPX), 0, -1):
            widths = [tw for tw in _strip_widths(w) if fits(tj, ntg, 1, tw)][:3]
            if widths:
                break
        if widths:
            break
    best = None
    for tw in widths:
        strips = _cdiv(w, tw)
        for kg in range(1, min(krn, K6_GEN_NPX // min(ntg, ntj)) + 1):
            if not fits(tj, ntg, kg, tw):
                break
            smem = k6_gen_smem(h, w, k, d, tj, ntg, kg, tw, elem)
            per_sm = max(1, min(K6_MIN_CTAS, SM_SHARED // (smem + 1024)))
            groups = _cdiv(krn, kg) * _cdiv(ntj, ntg)
            for rows in _band_rows(h):
                bands = _cdiv(h, rows)
                slots = n * bands * strips
                fold = _gen_fold(slots)
                chain, work, latency, worst = _gen_walk(n, h, w, d, kri, kc, tj, ntg, kg, rows,
                                                        tw, fold, elem)
                part = cblocks * slots * ntap * K6_GEN_CH
                # the SMs' time: the work and the latency, each overlapped
                # between the CTAs an SM holds, spread over the card, half a
                # CTA of tail; at least the longest CTA
                total = slots * cblocks * (work / per_sm ** GEN_COST["share"]
                                           + latency / per_sm) / sms
                mean = (work + latency) / groups
                time = max(total + 0.5 * mean, worst) + GEN_COST["fold"] * part
                key = (chain > K6_GEN_CHAIN, part > K6_GEN_PART_FLOATS,
                       chain if chain > K6_GEN_CHAIN else 0, time, -groups)
                if best is None or key < best[0]:
                    best = (key, K6GenPlan(kri, krj, tj, ntj, ntg, kg, rows, bands, tw, strips,
                                           cblocks, fold, smem, chain))
    return best[1]


@functools.lru_cache(maxsize=256)
def k6_plan(n: int, h: int, w: int, c: int, k: int, d: int, elem: int, sms: int) -> K6Plan:
    """K6's cut of one call. A row strip is the whole row unless one TMA row
    (256 pixels) or the rings would not fit. The bands minimise the rows
    one SM sums, ``ceil(CTAs / sms) * (rows + p + 2)`` (p for the halo rows
    a band re-reads, 2 for its start and end), ties to more bands. The
    general form (``k6_gen_plan``) where k is not one of K6_KERNEL_SIZES, d
    is above K6_MAX_DILATION, the halo p reaches the routing cut
    K6_GEN_HALO, or even a one-column strip does not fit."""
    p = d * (k - 1) // 2
    templated = k in K6_KERNEL_SIZES and d <= K6_MAX_DILATION and p < K6_GEN_HALO
    tw = min(w, K6_MAX_BOX - 2 * p) if templated else 0
    while tw >= 1 and k6_smem_bytes(k, p, tw, elem) > SMEM_LIMIT:
        tw -= 1
    if tw < 1:
        return K6Plan(0, 0, 0, 0, 0, 0, 0, True, k6_gen_plan(n, h, w, c, k, d, elem, sms))
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
    """K6 on contiguous CUDA x, dy, the form and its cut from ``k6_plan``.
    A dilation of max(H, W) or more leaves only the centre tap in the
    image, so d is clamped there: the taps that reach it, the plan and dW
    are those of any larger d."""
    global K6_LAUNCHES
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
        raise ValueError(f"K6 takes an odd k and d >= 1, got k={k}, d={d}")
    n, h, w, c = x.shape
    d = min(d, max(h, w, 1))
    elem = x.element_size()
    plan = k6_plan(n, h, w, c, k, d, elem, _sm_count(x.device.index))
    if plan.general:
        return _launch_k6_gen(x, dy, k, d, plan.gen)
    # the CTAs' partial sums: (cblocks, CTAs per block, k*k, cb_ch) f32
    part, tickets = _workspace(x.device, plan.cblocks * plan.slots(n) * k * k * plan.cb_ch,
                               plan.cblocks)
    dw = torch.empty((c, k, k), dtype=torch.float32, device=x.device)
    lib = load_library()
    code = lib.tsii_dw_wgrad(x.data_ptr(), dy.data_ptr(), part.data_ptr(), tickets.data_ptr(),
                             dw.data_ptr(), n, h, w, c, k, d, int(elem == 2), plan.rows, plan.tw,
                             torch.cuda.current_stream(x.device).cuda_stream)
    check(lib, code, "K6 (depthwise wgrad)")
    K6_LAUNCHES += 1
    return dw.permute(1, 2, 0).unsqueeze(2)


def _launch_k6_gen(x: torch.Tensor, dy: torch.Tensor, k: int, d: int,
                   g: K6GenPlan) -> torch.Tensor:
    """K6's general form on contiguous CUDA x, dy, cut as ``g`` (a
    ``K6GenPlan`` of these shapes) says."""
    global K6_LAUNCHES, K6_GEN_LAUNCHES
    from text_segmentation_image_inpainting_tpu_torch.ops.kernels.build import check, load_library

    n, h, w, c = x.shape
    # the CTAs' slots: (cblocks, slots, taps reaching the image, 16) f32
    part, _ = _workspace(x.device, g.part_floats(n), 1)
    dw = torch.empty((c, k, k), dtype=torch.float32, device=x.device)
    lib = load_library()
    code = lib.tsii_dw_wgrad_gen(x.data_ptr(), dy.data_ptr(), part.data_ptr(), dw.data_ptr(),
                                 n, h, w, c, k, d, int(x.element_size() == 2), g.tj, g.ntg, g.kg,
                                 g.rows, g.tw, g.fold,
                                 torch.cuda.current_stream(x.device).cuda_stream)
    check(lib, code, "K6 (depthwise wgrad, general form)")
    K6_LAUNCHES += 1
    K6_GEN_LAUNCHES += 1
    return dw.permute(1, 2, 0).unsqueeze(2)
