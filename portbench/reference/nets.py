"""Plain PyTorch reference of the benchmark's networks, in float32.

Built from a configuration file's sizes alone (``configs/*.json``) and
independent of the program: it imports nothing of the port. Tensors are
NCHW inside; the parameter names are those of the public torch layout of
these models (``encoder.stem.0.weight``, ``unet.enc_convs.0.conv.weight``,
``features.0.weight``, ...), so one state dict made by the benchmark loads
into the program and into this reference alike.

What the equations are:

* MobileNetV2 (arXiv:1801.04381) with DeepLab's output stride: a stage
  whose stride would pass the output stride runs at stride 1, its first
  block at the dilation so far, the later blocks at that dilation times
  the stride. Conv -> BatchNorm -> ReLU6; the projection is linear; a
  residual where stride 1 and the widths match.
* The dilated mini decoder: three 3x3 branches at rates 1/2/4, a 1x1
  fuse, bilinear x2 (half-pixel centres) and a 48-channel 1x1 skip at
  stride 4, a 3x3, x2 and a 24-channel skip at stride 2, a 3x3, the 1x1
  head with bias, x2. LeakyReLU(0.2).
* The port's variant of aligned Xception (DeepLab-v3+, arXiv:1802.02611;
  its changes from xception_41 are listed in the configuration): two stem
  convs, strided entry blocks, middle blocks with the identity skip, an
  exit block and two separable convs; each separable conv is a depthwise
  3x3 and a pointwise 1x1, each Conv -> BN -> ReLU; a block's skip is a
  1x1 conv + BN where the shape changes; the stride-4 tap is entry block
  1's output.
* The DeepLab-v3+ head: ASPP (a 1x1 and three dilated 3x3 branches and
  image-level pooling), a 1x1 fuse, x2 to stride 4, a 48-channel skip, two
  3x3 convs, the 1x1 head, x4. ReLU.
* BatchNorm: in training the batch's mean and biased variance over N, H,
  W normalise, and the running statistics move by r = 0.9 r + 0.1 batch
  (the biased variance too, as flax moves them); in eval the running
  statistics normalise. eps 1e-5.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from portbench.reference.precision import Precision, f32

ACTS = {
    "relu6": lambda x: torch.clamp(x, 0.0, 6.0),
    "relu": F.relu,
    "leaky": lambda x: F.leaky_relu(x, 0.2),
    "none": lambda x: x,
}


def conv(prec: Precision, x, w, b=None, *, stride=1, padding=0, dilation=1, groups=1,
         kind: str = "conv", mask_groups: int = 0):
    """One counted product: ``F.conv2d`` of the operands in ``prec``."""
    y = F.conv2d(prec.operand(x), prec.operand(w), None, stride, padding, dilation, groups)
    prec.record(kind, y.numel() * w.shape[1] * w.shape[2] * w.shape[3], x.requires_grad,
                w.requires_grad, x=tuple(x.shape), w=tuple(w.shape), y=tuple(y.shape),
                stride=stride, padding=padding, dilation=dilation, groups=groups,
                mask_groups=mask_groups)
    return prec.store(y if b is None else y + b.view(1, -1, 1, 1))


def up_bilinear(x, size):
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=False)


def use_precision(model: nn.Module, prec: Precision) -> nn.Module:
    for m in model.modules():
        m.prec = prec
    return model


class Conv(nn.Module):
    """A conv's parameters and geometry (padding: dilation * (k - 1) // 2)."""

    def __init__(self, cin, cout, k, stride=1, dilation=1, groups=1, bias=False, padding=None):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin // groups, k, k))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        self.stride, self.dilation, self.groups = stride, dilation, groups
        self.padding = dilation * (k - 1) // 2 if padding is None else padding
        self.prec = f32()

    def forward(self, x):
        return conv(self.prec, x, self.weight, self.bias, stride=self.stride,
                    padding=self.padding, dilation=self.dilation, groups=self.groups)


class BN(nn.Module):
    """``momentum`` 1 sets the running statistics to one batch's
    (``calibrate_bn``)."""

    def __init__(self, c: int):
        super().__init__()
        self.prec, self.momentum = f32(), 0.1
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        self.register_buffer("num_batches_tracked", torch.zeros((), dtype=torch.long))

    def forward(self, x):
        if self.training:
            mean = x.mean(dim=(0, 2, 3))
            var = (x - mean.view(1, -1, 1, 1)).square().mean(dim=(0, 2, 3))
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(1.0 - m).add_(m * mean)
                self.running_var.mul_(1.0 - m).add_(m * var)
                self.num_batches_tracked.add_(1)
        else:
            mean, var = self.running_mean, self.running_var
        scale = torch.rsqrt(var + 1e-5) * self.weight
        y = (x - mean.view(1, -1, 1, 1)) * scale.view(1, -1, 1, 1) + self.bias.view(1, -1, 1, 1)
        return self.prec.store(y)


@torch.no_grad()
def calibrate_bn(model: nn.Module, forward) -> None:
    """Set every BatchNorm's running statistics to those of the batch that
    ``forward()`` runs through ``model`` in training mode, as a trained
    model's statistics match what it sees; leaves ``model`` in eval mode."""
    bns = [m for m in model.modules() if isinstance(m, BN)]
    for m in bns:
        m.momentum = 1.0
    model.train()
    forward()
    for m in bns:
        m.momentum = 0.1
        m.num_batches_tracked.zero_()
    model.eval()


class ConvBNAct(nn.Module):
    """Children ``0`` (conv) and ``1`` (BN), then the activation."""

    def __init__(self, cin, cout, k, stride=1, dilation=1, groups=1, act="relu6"):
        super().__init__()
        self.add_module("0", Conv(cin, cout, k, stride, dilation, groups))
        self.add_module("1", BN(cout))
        self.act = act

    def forward(self, x):
        return self.prec.store(ACTS[self.act](self._modules["1"](self._modules["0"](x))))


# -- MobileNetV2 ------------------------------------------------------------

class InvertedResidual(nn.Module):
    def __init__(self, cin, cout, stride, t, dilation):
        super().__init__()
        hidden = cin * t
        layers = [] if t == 1 else [ConvBNAct(cin, hidden, 1)]
        layers += [ConvBNAct(hidden, hidden, 3, stride, dilation, groups=hidden),
                   Conv(hidden, cout, 1), BN(cout)]
        self.block = nn.Sequential(*layers)
        self.use_res = stride == 1 and cin == cout

    def forward(self, x):
        h = self.block(x)
        return self.prec.store(x + h) if self.use_res else h


class MobileNetV2(nn.Module):
    """Taps: s2 (the stem), s4 (the end of the stage whose width is
    ``s4_width``), out."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.stem = ConvBNAct(3, cfg["stem"], 3, stride=2)
        blocks, taps, cin = [], {}, cfg["stem"]
        stride_now, dilation = 2, 1
        for t, c, n, s in cfg["inverted_residual"]:
            for i in range(n):
                stride, d = (s if i == 0 else 1), dilation
                if stride > 1:
                    if stride_now >= cfg["output_stride"]:
                        stride, dilation = 1, dilation * s
                    else:
                        stride_now *= s
                blocks.append(InvertedResidual(cin, c, stride, t, d))
                cin = c
            if c == cfg["s4_width"]:
                taps[len(blocks) - 1] = "s4"
        self.blocks = nn.ModuleList(blocks)
        self.taps = taps
        self.out_channels = cin

    def forward(self, x):
        x = self.stem(x)
        taps = {"s2": x}
        for i, block in enumerate(self.blocks):
            x = block(x)
            if i in self.taps:
                taps[self.taps[i]] = x
        taps["out"] = x
        return taps


# -- Xception ---------------------------------------------------------------

class SeparableConv(nn.Module):
    def __init__(self, cin, cout, stride=1, dilation=1):
        super().__init__()
        self.dw = ConvBNAct(cin, cin, 3, stride, dilation, groups=cin, act="relu")
        self.pw = ConvBNAct(cin, cout, 1, act="relu")

    def forward(self, x):
        return self.pw(self.dw(x))


class XceptionBlock(nn.Module):
    def __init__(self, cin, widths, stride=1, dilation=1):
        super().__init__()
        seps, c = [], cin
        for i, f in enumerate(widths):
            seps.append(SeparableConv(c, f, stride if i == len(widths) - 1 else 1, dilation))
            c = f
        self.seps = nn.ModuleList(seps)
        self.skip = (None if stride == 1 and cin == widths[-1]
                     else ConvBNAct(cin, widths[-1], 1, stride, act="none"))

    def forward(self, x):
        h = x
        for sep in self.seps:
            h = sep(h)
        return self.prec.store((x if self.skip is None else self.skip(x)) + h)


class Xception(nn.Module):
    """Entry blocks each nominally stride 2, the exit block too; past the
    output stride a block runs at stride 1 and the dilation doubles after
    it. The middle flow runs at the dilation the entry flow ends with, the
    exit's separable convs at the one the exit block ends with."""

    def __init__(self, cfg: dict):
        super().__init__()
        if cfg["separable_conv"] != "conv_bn_relu" or cfg["low_level_tap"] != "entry.0":
            raise ValueError("the reference builds the port's variant alone: Conv-BN-ReLU "
                             "separable convs, the stride-4 tap after entry block 1")
        s1, s2 = cfg["stem"]
        self.stem1 = ConvBNAct(3, s1, 3, stride=2, act="relu")
        self.stem2 = ConvBNAct(s1, s2, 3, act="relu")
        plan, now, d = [], 2, 1
        for _ in range(len(cfg["entry"]) + 1):
            if now >= cfg["output_stride"]:
                plan.append((1, d))
                d *= 2
            else:
                plan.append((2, d))
                now *= 2
        cin, entries = s2, []
        for (stride, dil), widths in zip(plan, cfg["entry"]):
            entries.append(XceptionBlock(cin, widths, stride, dil))
            cin = widths[-1]
        self.entry = nn.ModuleList(entries)
        mid_d = plan[len(cfg["entry"]) - 1][1] * (2 if plan[len(cfg["entry"]) - 1][0] == 1 else 1)
        self.mid = nn.ModuleList([XceptionBlock(cin, [cin] * 3, 1, mid_d)
                                  for _ in range(cfg["middle_repeats"])])
        stride, dil = plan[len(cfg["entry"])]
        self.exit0 = XceptionBlock(cin, cfg["exit"], stride, dil)
        exit_d = dil * (2 if stride == 1 else 1)
        c1, c2 = cfg["exit_seps"]
        self.exit1 = SeparableConv(cfg["exit"][-1], c1, 1, exit_d)
        self.exit2 = SeparableConv(c1, c2, 1, exit_d)
        self.out_channels = c2

    def forward(self, x):
        x = self.stem2(self.stem1(x))
        taps = {"s2": x}
        for i, block in enumerate(self.entry):
            x = block(x)
            if i == 0:
                taps["s4"] = x
        for block in self.mid:
            x = block(x)
        taps["out"] = self.exit2(self.exit1(self.exit0(x)))
        return taps


# -- decoders and the segmenter ----------------------------------------------

class MiniDecoder(nn.Module):
    def __init__(self, c_out, c_s4, c_s2, cfg: dict):
        super().__init__()
        mid = cfg["decoder_mid"]
        self.aspp = nn.ModuleList([ConvBNAct(c_out, mid, 3, dilation=r, act="leaky")
                                   for r in cfg["aspp_rates"]])
        self.fuse = ConvBNAct(len(cfg["aspp_rates"]) * mid, mid, 1, act="leaky")
        self.skip4 = ConvBNAct(c_s4, cfg["skip4"], 1, act="leaky")
        self.dec4 = ConvBNAct(mid + cfg["skip4"], mid // 2, 3, act="leaky")
        self.skip2 = ConvBNAct(c_s2, cfg["skip2"], 1, act="leaky")
        self.dec2 = ConvBNAct(mid // 2 + cfg["skip2"], mid // 4, 3, act="leaky")
        self.head = Conv(mid // 4, 1, 1, bias=True)

    def forward(self, taps):
        x = self.fuse(torch.cat([b(taps["out"]) for b in self.aspp], 1))
        s4, s2 = taps["s4"], taps["s2"]
        x = self.dec4(torch.cat([up_bilinear(x, s4.shape[2:]), self.skip4(s4)], 1))
        x = self.dec2(torch.cat([up_bilinear(x, s2.shape[2:]), self.skip2(s2)], 1))
        return up_bilinear(self.head(x), (2 * s2.shape[2], 2 * s2.shape[3]))


class DeepLabDecoder(nn.Module):
    def __init__(self, c_out, c_s4, cfg: dict):
        super().__init__()
        mid = cfg["decoder_mid"]
        self.aspp = nn.ModuleList([ConvBNAct(c_out, mid, 1, act="relu")]
                                  + [ConvBNAct(c_out, mid, 3, dilation=r, act="relu")
                                     for r in cfg["aspp_rates"]])
        self.image_pool = ConvBNAct(c_out, mid, 1, act="relu")
        self.fuse = ConvBNAct((len(cfg["aspp_rates"]) + 2) * mid, mid, 1, act="relu")
        self.skip4 = ConvBNAct(c_s4, cfg["skip4"], 1, act="relu")
        self.dec0 = ConvBNAct(mid + cfg["skip4"], mid, 3, act="relu")
        self.dec1 = ConvBNAct(mid, mid, 3, act="relu")
        self.head = Conv(mid, 1, 1, bias=True)

    def forward(self, taps):
        out = taps["out"]
        branches = [b(out) for b in self.aspp]
        pooled = self.image_pool(out.mean(dim=(2, 3), keepdim=True))
        branches.append(pooled.expand(-1, -1, out.shape[2], out.shape[3]))
        x = self.fuse(torch.cat(branches, 1))
        s4 = taps["s4"]
        x = torch.cat([up_bilinear(x, s4.shape[2:]), self.skip4(s4)], 1)
        x = self.head(self.dec1(self.dec0(x)))
        return up_bilinear(x, (4 * s4.shape[2], 4 * s4.shape[3]))


class Segmenter(nn.Module):
    """pages (N, 3, H, W) -> text logits (N, 1, H, W)."""

    def __init__(self, cfg: dict):
        super().__init__()
        if cfg["backbone"] == "mobilenet_v2":
            self.encoder = MobileNetV2(cfg)
            c_s4, c_s2 = cfg["s4_width"], cfg["stem"]
        else:
            self.encoder = Xception(cfg)
            c_s4, c_s2 = cfg["entry"][0][-1], cfg["stem"][1]
        if cfg["head"] == "mini":
            self.decoder = MiniDecoder(self.encoder.out_channels, c_s4, c_s2, cfg)
        else:
            self.decoder = DeepLabDecoder(self.encoder.out_channels, c_s4, cfg)

    def forward(self, x):
        return self.decoder(self.encoder(x))


# -- the partial-convolution U-Net (arXiv:1804.07723) -------------------------

def partial_conv(prec, x, m, sizes, w, b, stride, padding):
    """y = W^T (X . M) * sum(1) / sum(M) + b where sum(M) > 0, else 0;
    M' = 1[sum(M) > 0]. ``m`` holds one channel per group of ``sizes``
    feature channels; sum(M) weighs each group's window count by its size
    and sum(1) is k * k * Cin."""
    k = w.shape[2]
    mb = torch.cat([m[:, g:g + 1].expand(-1, c, -1, -1) for g, c in enumerate(sizes)], 1)
    feat = conv(prec, x * mb, w, stride=stride, padding=padding, kind="pconv",
                mask_groups=len(sizes))
    ones = torch.tensor(sizes, dtype=m.dtype, device=m.device).view(1, -1, 1, 1)
    msum = F.conv2d(m, ones.expand(1, len(sizes), k, k), None, stride, padding)
    valid = msum > 0
    out = feat * (k * k * sum(sizes)) / torch.clamp(msum, min=1.0)
    if b is not None:
        out = out + b.view(1, -1, 1, 1)
    return prec.store(torch.where(valid, out, torch.zeros_like(out))), valid.to(m.dtype)


class PConv(nn.Module):
    def __init__(self, cin, cout, k, stride, bias):
        super().__init__()
        self.conv = Conv(cin, cout, k, stride, bias=bias)

    def forward(self, x, m, sizes):
        c = self.conv
        return partial_conv(c.prec, x, m, sizes, c.weight, c.bias, c.stride, c.padding)


class UNet(nn.Module):
    """Encoder: stride-2 partial convs (``encoder`` rows: width, kernel, BN),
    BN where listed, ReLU. Decoder: nearest x2 of features and mask, the
    skip's features and mask concatenated (two mask groups), a 3x3 partial
    conv, BN, LeakyReLU(0.2). Head: x2, the input (image, mask)
    concatenated, a 3x3 partial conv to RGB with bias."""

    def __init__(self, cfg: dict, cin: int = 3):
        super().__init__()
        self.depth = cfg["depth"]
        rows = cfg["encoder"][: self.depth]
        self.enc_convs, self.enc_bns = nn.ModuleList(), nn.ModuleList()
        chans, c = [], cin
        for width, k, bn in rows:
            self.enc_convs.append(PConv(c, width, k, 2, bias=not bn))
            self.enc_bns.append(BN(width) if bn else nn.Identity())
            chans.append(width)
            c = width
        self.dec_convs, self.dec_bns = nn.ModuleList(), nn.ModuleList()
        for lvl in range(self.depth - 1, 0, -1):
            skip = chans[lvl - 1]
            self.dec_convs.append(PConv(c + skip, skip, 3, 1, bias=False))
            self.dec_bns.append(BN(skip))
            c = skip
        self.head = PConv(c + cin, 3, 3, 1, bias=True)

    def forward(self, x, m):
        skips = [(x, m)]
        f = x
        for pconv, bn in zip(self.enc_convs, self.enc_bns):
            f, m = pconv(f, m, [f.shape[1]])
            f = F.relu(bn(f))
            skips.append((f, m))
        up = lambda t: F.interpolate(t, scale_factor=2, mode="nearest")  # noqa: E731
        for j, (pconv, bn) in enumerate(zip(self.dec_convs, self.dec_bns)):
            sf, sm = skips[self.depth - 1 - j]
            f, m = pconv(torch.cat([up(f), sf], 1), torch.cat([up(m), sm], 1),
                         [f.shape[1], sf.shape[1]])
            f = self.prec.store(F.leaky_relu(bn(f), 0.2))
        sf, sm = skips[0]
        out, _ = self.head(torch.cat([up(f), sf], 1), torch.cat([up(m), sm], 1),
                           [f.shape[1], sf.shape[1]])
        return out


# -- VGG16 (arXiv:1409.1556) through the last tapped pool ----------------------

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class VGG(nn.Module):
    """torchvision's ``vgg16().features`` layout up to the ``taps``-th pool:
    conv (3x3, bias) + ReLU, 'M' a 2x2 max pool; returns the pooled taps of
    the ImageNet-normalised input."""

    def __init__(self, layers, taps: int):
        super().__init__()
        mods, c, pools = [], 3, 0
        for v in layers:
            if v == "M":
                mods.append(nn.MaxPool2d(2, 2))
                pools += 1
                if pools >= taps:
                    break
            else:
                mods += [Conv(c, v, 3, bias=True), nn.ReLU()]
                c = v
        self.features = nn.Sequential(*mods)
        self.requires_grad_(False)

    def forward(self, x):
        mean = torch.tensor(IMAGENET_MEAN, dtype=x.dtype, device=x.device).view(1, 3, 1, 1)
        std = torch.tensor(IMAGENET_STD, dtype=x.dtype, device=x.device).view(1, 3, 1, 1)
        y, taps = (x - mean) / std, []
        for layer in self.features:
            y = layer(y)
            if isinstance(layer, nn.MaxPool2d):
                taps.append(y)
        return taps
