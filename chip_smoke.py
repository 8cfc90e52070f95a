#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Drives ``text_segmentation_image_inpainting_tpu_torch``'s main paths
at full width: the page pipeline (segment -> dilate -> inpaint:
MobileNetV2 segmenter at width 1.0, the depth-8 partial-conv U-Net, bf16,
a batch of eight 512x512 pages), the inpainting trainer (the same
U-Net in training mode, the VGG16 perceptual/style loss with the fused
stem, Adam) and the segmentation trainer (the same segmenter in training
mode, BCE + dice, Adam, with ``ops/depthwise.py::USE_CUSTOM_WGRAD`` on so
that its depthwise weight gradients run on K6) and the page server over
the pipeline, weights from a seeded ``torch.Generator``. Phases, each printing its lines before the last:

  1. device   the card's name and power limit (nvidia-smi)
  2. build    nvcc builds csrc/*.cu into the package's _build/ directory
  3. parity   K1 and K2 against their plain PyTorch version at the eight
              shapes the U-Net gives them, on the card; K1 also at a
              ragged shape and with one mask group, on an all-hole page
              (exactly 0) and twice on the same inputs (bit-identical) at
              a split-K level, a one-pass level and a halo-form level; K2
              also at a ragged shape, with one mask group, on an all-hole
              page and twice on the head's inputs
  4. pipeline ``run`` and ``inpaint`` once each with the launch counters
              reset: K1 must run 7 times and K2 once per U-Net forward,
              BatchNorm's kernels once per BatchNorm call (``bn_counted``:
              every call on the kernels, as here in the train, seg,
              Xception and serve phases' steps and runs, 4 launches a
              training call, 3 a frozen one);
              outputs finite, masks binary, non-text pixels bit-identical
              to the input; every stride-1 partial conv's real inputs,
              caught by forward hooks, re-run through the plain version
              The depthwise kernel likewise (``dw_counted``: every
              depthwise conv of the pipeline run, seg, Xception and serve
              phases on it, its forward and, at stride 1, its dx)
  4b. bn     BatchNorm's kernels (``bn_phase``) at Xception's middle flow
              and MobileNetV2's largest BatchNorm, bf16, ReLU inside, in
              training (4 launches) and eval (1): against the plain chain,
              twice bit-identical, timed beside it, their bound (the
              function's bytes; the two-pass design's beside it) and one
              cuDNN ``F.batch_norm``
  4c. dw     the depthwise kernel (``dw_phase``) at every depthwise conv
              of the cells (``DW_SHAPES``), forward and stride-1 dx, bf16
              and f32, against the f64 truth, twice bit-identical, beside
              its plain version; its device time beside cuDNN's and the
              bound; the Xception phase names, from a profiled step with
              ``record_shapes``, the layers behind cuDNN's grouped kernels
              on the route before the kernel and on the kernel's
  5. train    K3 (the partial conv's backward: ``pconv_k3_prep`` and
              ``pconv_k3_mask`` around the two library products at the
              decoder levels, ``pconv_k2_bwd`` at the head) against
              autograd of the plain version at the 8 shapes, its ``valid``
              equal to the forward's M' bit for bit, and twice on the same
              inputs (dx, dW, db bit-identical); K4 (the VGG stem's dx) and K5
              (its pooled forward) against their plain versions at the
              train shapes (K5 at the step's 8 ground-truth pages and at
              16) and at ``STEM_EXTRA`` (one tile, ragged pages, a partial
              last wave of the persistent CTAs), each twice on the same
              inputs, bit-identical; then three train steps at depth 8, 512^2,
              batch 8, bf16, fused stem, with the launch counters reset
              before each: K1 7, K2 1, K3 8, K4 1 and K5 1 per step, every loss
              term finite, every U-Net gradient finite and the decoder's and
              head's nonzero, parameters and decoder BN statistics moved,
              and with ``freeze_bn`` (the third step) the encoder's not
  6. seg      K6 (the depthwise weight gradient) against the f64 truth,
              beside its plain version, at the segmenter's 5 shapes and at
              ``K6_RAGGED`` (odd maps, C off the channel blocks and off 16
              bytes, k 1/5/7, f32, a partial last wave, column strips),
              each launched twice (bit-identical); one backward of the
              full-width segmenter with the flag on against the flag off
              (cuDNN's wgrad), per depthwise layer; then three seg train
              steps at 512^2, batch 8, bf16, with the counter reset before
              each: K6 14 launches per step, loss terms and grad_norm
              finite, parameters and every BN statistic moved, and with
              ``freeze_encoder`` (the third step) the encoder's parameters
              not; on this path a CUDA tensor that reached K6's plain
              version would fail the phase
  7. timing   CUDA events, median after warm-up: each kernel against
              its plain version per shape, beside one cuDNN call of the
              same product as a yardstick (never called by the port) and
              the least time the card could take (``bound``),
              ``run`` in pages/s, the train steps in pages/s (the
              seg step with the flag on and off, alternating), K2, K3 and
              K6 also in device time (K3 with its device kernels per call),
              K4 and K5 in device time and TFLOP/s with and without the
              halos; then
              torch.profiler over ``run`` and over each train step: the
              device's busy share and the kernels that take the most time
  8. serve    ``PageStreamServer`` on the same pipeline over 512^2 uint8
              pages of the native page engine (``make_page_stream_u8``),
              the segmenter's head bias moved so that the dilated text
              leaves room for the sparse wire: dense ``serve()`` at depth
              2 and chunk-2 ``submit``/``collect`` with a flushed tail
              bit-identical to ``run``; the changed-tile wire at budgets 64
              (adaptive), 256 and with a forced undershoot equal to the
              dense results in the text and to the input bytes elsewhere;
              K1 7 and K2 1 per ``run`` dispatched; no blocking host call
              (``tools/host_syncs.py``) inside one profiled ``run``; then
              serve pages/s beside closed-loop ``run`` with a blocking
              read, the busy share while serving and wire bytes a page
  9. xception the Xception seg track (``TextSegmenter(backbone='xception',
              head='deeplab')``, output stride 8, 8 middle blocks, flag
              on): K6 against the f64 truth at ``XCEPTION_SHAPES`` (twice,
              bit-identical), three train steps (35 K6 launches each, at
              those shapes; every parameter with a gradient and every BN
              statistic moved; no CUDA tensor reaches K6's plain version),
              K6 per shape timed, the step flag on/off/off/on, peak memory
 10. attention three steps of the spectral-norm attention U-Net (K1 7, K2
              1, K3 8, K4 1, K5 1 each; u and v move, gamma leaves 0), an
              eval forward (u and v fixed) and one step with
              ``grad_accum=2`` (the launches twice over)
 11. graph    ``make_multi_step`` as a CUDA graph for the inpaint and seg
              steps against the same steps run eagerly (``graph_phase``),
              bit-equal in the set derived from the step's structure
              (``probe_nondeterminism``, ``derived_exact``), elsewhere
              within ``GRAPH_NOISE_RATIO`` of the eager runs' spread; ms
              per step eager and graph, device kernels per replay
 12. f32      the f32 form of K1/K2 and of their backward (``f32_phase``)
              at the U-Net's 8 shapes against the plain version in f64,
              twice bit-identical; the f32 U-Net at 512^2, batch 8 (K1F 7,
              K2F 1); the f32 stem (``f32_stem_phase``: K4F at x (16, 512,
              512, 3), K5F at z0 (8, 512, 512, 64) and both at
              ``STEM_EXTRA``, against f64, twice bit-identical); one f32
              step with the fused stem (K1F 7, K2F 1, K3F 8, K4F 1, K5F 1,
              terms and gradients finite); times beside cuDNN's f32 with
              TF32 off and the bound at the f32 peak, K1F per level with its
              tile and split count, K4F per pass (profiler) with its rate,
              K2F and its backward at the head per kernel (profiler; the
              backward also for dx only and dW only), and the resident CTAs
              an SM of every f32 kernel redesigned
 13. ddp      data-parallel training (``ddp_phase``): the inpaint and seg
              steps over a 1-rank NCCL mesh, eager and as the k = 4 graph,
              at the graph phase's gate and launch counts; 2 gloo ranks on
              cuda:0 against one process on the batch of 8 (per-rank BN
              statistics must fail the gate); ``concurrent_train2``; ms
              per step beside the plain step
 14. evaluate ``train/evaluate.py --task seg|inpaint|pipeline --batches 2``
              on the card: finite numbers under JAX's keys
 15. parallel multi-device serving on one card (``parallel_phase``): K1/K2
              with unequal padding and at the 4-band U-Net's halo-ed
              shapes (padding (0, 1)); ``spatial_inpaint_unet`` (2048^2,
              depth 8, bf16, 2 and 4 bands on cuda:0: K1 7 and K2 1 per
              band; relative L2 to an f32 plain U-Net within 1.25x the
              unsharded one's); ``pipeline2_run`` (512^2, batch 8, T 4 on
              (cuda:0, cuda:0): bit-equal to ``run``, or within two runs'
              spread); the data-parallel server on a 2-entry mesh (bit-equal
              to ``run`` on each half); ``spatial_pipeline_run``, the whole
              pipeline (width 1.0, output stride 8, depth 8, bf16) on one
              2048^2 native page in 2 and 4 bands (``spatial_pipeline_phase``:
              K1 7 and K2 1 per band; the page untouched outside the text;
              mask pixels that differ from ``run`` only near the threshold;
              relative L2 to an f32 pipeline within 1.25x ``run``'s); their
              times beside the plain paths
 16. pretrained the pretrained-weight path on torchvision-layout files
              fabricated from a seed (``pretrained_phase``): the runbook
              ``compat/verify_pretrained.py`` in-process (coverage 14/14
              and 255/255, taps against its float64 walk at 512^2, a
              200-step finetune at 128^2, batch 4, whose loss falls);
              ``run`` with the imported encoder (K1 7, K2 1, the page
              gates) timed beside random weights; ``run_inpaint
              --vgg-ckpt --fused-stem`` for 2 steps at 512^2, batch 8 (K3
              8, K4 1, K5 1 a step, finite losses, the import's report)
 17. scope    the kernels at shapes of JAX's Pallas scope beyond the U-Net's
              (``scope_phase``, ``SCOPE_CASES``): Cout 3 at Cin 200 and 300
              (k 3), Cin 67 at k 2, 9, 11 and 13 and at padding (4, 1),
              three mask groups (24, 16, 8) at Cout 16 and 3, the head's
              67 -> 3 at k 11 on 8 pages of 512^2, each forward
              and backward in bf16 and f32 through ``partial_conv2d`` and
              autograd (the counters show the kernel ran, templated or
              general form), against the f64 truth (bf16: ``check_close``
              and ``check_grads``; f32: ``check_f32`` and
              ``check_grads_f32``), M' bit-exact, twice bit-identical, each
              timed beside its plain version and cuDNN, the general forms'
              kernels one by one by profiler device time; K6's general form
              at ``SCOPE_K6`` (k 9, d 1; k 7, d 48; k 9 on block 2's map; k
              13 at C 130; k 3, d 25 past the routing cut) by ``check_wgrad``,
              its two kernels by profiler device time; an H =
              12 bf16 layer on the plain route (no counter moves); the
              general forms' three rows end the kernels line
 (Phases 9-14 run before the serve phase, 15 and 16 after it, 17 last;
 each phase prints its seconds.)
 The inpaint step also may not block the host: no blocking CUDA call in
 one profiled step (``tools/host_syncs.py``).

The last line is ``{"ok": true, "device": {...}}``; the one before it
lists the kernels. Any failed check raises: the script then exits
nonzero and prints no result. Without a CUDA device, or run away from
the repository, it exits nonzero as well.

    python3 chip_smoke.py
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import statistics
import subprocess
import sys
import threading
import time
from collections import Counter
from pathlib import Path

import numpy as np
import torch

BATCH = 8
PAGE = 512
SEED = 0
ITERS = 20
WARMUP = 3
TRAIN_ITERS = 5
# the serve phase: batches drawn, of which the gates serve the first
# SERVE_GATED (the true-text wire serves all)
SERVE_BATCHES = 20
SERVE_GATED = 6
CSRC = "text_segmentation_image_inpainting_tpu_torch/csrc/partial_conv.cu"
CSRC_STEM = "text_segmentation_image_inpainting_tpu_torch/csrc/vgg_stem.cu"
TPU_KERNEL = "text_segmentation_image_inpainting_tpu/ops/pallas/partial_conv_kernel.py"
TPU_STEM_BWD = "text_segmentation_image_inpainting_tpu/ops/pallas/vgg_stem_bwd.py"
TPU_STEM = "text_segmentation_image_inpainting_tpu/ops/pallas/vgg_stem.py"
CSRC_DW = "text_segmentation_image_inpainting_tpu_torch/csrc/depthwise_wgrad.cu"
TPU_DW = "text_segmentation_image_inpainting_tpu/ops/pallas/depthwise_wgrad.py"
CSRC_BN = "text_segmentation_image_inpainting_tpu_torch/csrc/batchnorm.cu"
CSRC_DWC = "text_segmentation_image_inpainting_tpu_torch/csrc/depthwise_conv.cu"

# Every depthwise conv of the cells' segmenters at 512^2 pages, batch 8
# (k 3, torch-'same' padding): (model, C, H = W of x, stride, dilation,
# layers). Xception's 38 (2 strided) and MobileNetV2's 17 (2 strided);
# tests/test_torch_depthwise_conv.py counts them from the models.
DW_SHAPES = (
    ("xception", 64, 256, 1, 1, 1),
    ("xception", 128, 256, 1, 1, 1),
    ("xception", 128, 256, 2, 1, 1),
    ("xception", 128, 128, 1, 1, 1),
    ("xception", 256, 128, 1, 1, 1),
    ("xception", 256, 128, 2, 1, 1),
    ("xception", 256, 64, 1, 1, 1),
    ("xception", 728, 64, 1, 1, 2),
    ("xception", 728, 64, 1, 2, 26),
    ("xception", 1024, 64, 1, 2, 1),
    ("xception", 1024, 64, 1, 4, 1),
    ("xception", 1536, 64, 1, 4, 1),
    ("mobilenet_v2", 32, 256, 1, 1, 1),
    ("mobilenet_v2", 96, 256, 2, 1, 1),
    ("mobilenet_v2", 144, 128, 1, 1, 1),
    ("mobilenet_v2", 144, 128, 2, 1, 1),
    ("mobilenet_v2", 192, 64, 1, 1, 3),
    ("mobilenet_v2", 384, 64, 1, 2, 4),
    ("mobilenet_v2", 576, 64, 1, 2, 3),
    ("mobilenet_v2", 960, 64, 1, 4, 3),
)

# BatchNorm's kernels at two shapes of the models at 512^2, batch 8, bf16:
# Xception's middle flow (24 of its 91 BatchNorms a step) and MobileNetV2's
# largest (block 1's expansion, before its stride-2 depthwise conv).
BN_SHAPES = (
    ("xception middle flow", (8, 64, 64, 728)),
    ("mobilenet_v2 block 1 expansion", (8, 256, 256, 96)),
)
# Bytes an element of a bf16 training BatchNorm: what the function needs
# (x read and y written forward; dy and x read and dx written backward)
# and what the kernels' two passes each way move (x once more forward, dy
# and x once more backward). Eval reads x and writes y: 4 either way.
BN_FN_BYTES = 10
BN_PASS_BYTES = 16

# The stride-1 depthwise convs with C >= 128 of TextSegmenter(width 1.0,
# output stride 8) at 512^2 pages, whose weight gradient is K6 with
# ops/depthwise.py::USE_CUSTOM_WGRAD on: (MobileNetV2 blocks, H = W, C,
# dilation, launches per train step). 14 launches per step, k = 3.
SEG_SHAPES = (
    ("block 2", 128, 144, 1, 1),
    ("blocks 4-6", 64, 192, 1, 3),
    ("blocks 7-10", 64, 384, 2, 4),
    ("blocks 11-13", 64, 576, 2, 3),
    ("blocks 14-16", 64, 960, 4, 3),
)
# K6 away from the train shapes: (name, N, H, W, C, k, d, dtype). Odd
# maps and C off the CTA's channel block, k = 5 and 7, f32 inputs, a 4^2
# map at d = 4 whose off-centre taps all lie in the padding, C off 16
# bytes (the ring filled by plain loads), more CTAs than fit on the card
# at once (a partial last wave), and a dilation whose rows need column
# strips (k6_plan).
K6_RAGGED = (
    ("odd 37x29, C 200, d 2", 3, 37, 29, 200, 3, 2, torch.bfloat16),
    ("k 5, 33x47, C 160", 2, 33, 47, 160, 5, 1, torch.bfloat16),
    ("f32, 45x31, C 136, d 4", 2, 45, 31, 136, 3, 4, torch.float32),
    ("f32, k 5, d 4, 19x70, C 130", 1, 19, 70, 130, 5, 4, torch.float32),
    ("4x4, d 4, C 128", 2, 4, 4, 128, 3, 4, torch.bfloat16),
    ("C 131 off 16 bytes, 9x11, d 2", 2, 9, 11, 131, 3, 2, torch.bfloat16),
    ("k 7, 21x18, C 256", 2, 21, 18, 256, 7, 1, torch.bfloat16),
    ("k 1, 16x16, C 192", 2, 16, 16, 192, 1, 1, torch.bfloat16),
    ("partial last wave: 40 pages 8x8, C 960", 40, 8, 8, 960, 3, 1, torch.bfloat16),
    ("column strips: d 20, 50x100, C 128", 1, 50, 100, 128, 3, 20, torch.bfloat16),
)

# K4 and K5 away from the train shapes: (M, H, W) pages. One 16x16 tile
# (fewer tiles than SMs), ragged M, non-square pages, partial tiles at the
# bottom and right edge, and 143 tiles: a partial last wave of the
# persistent CTAs on a card of 132 SMs.
STEM_EXTRA = ((1, 16, 16), (3, 16, 16), (2, 32, 48), (1, 48, 32), (2, 18, 26), (1, 176, 208))

# K1 away from the U-Net's shapes: (name, N, H, W, group sizes, Cout).
# Groups off the 8-channel chunk, Cin off the 64-channel K step, Cout off
# every tile and an odd map (split K); one mask group; the halo form at
# both its tile widths, ragged.
# K2 away from the head's shape: (name, N, H, W, group sizes, Cout). The
# head's 134-byte pixels on an odd map (tiles cut at both edges, rows that
# start off 16 bytes), and one mask group with a narrow Cin.
K2_EXTRA = (
    ("ragged: Cin 67 = 64 + 3, Cout 3, 37x29", 3, 37, 29, (64, 3), 3),
    ("G 1: Cin 12, Cout 5, 16x24", 2, 16, 24, (12,), 5),
)
K1_EXTRA = (
    ("ragged: Cin 200 = 123 + 77, Cout 72, 37x29", 3, 37, 29, (123, 77), 72),
    ("G 1: Cin 256, Cout 256, 16x24", 2, 16, 24, (256,), 256),
    ("halo form, width 128: Cin 200 = 123 + 77, Cout 72, 3x128", 2, 3, 128, (123, 77), 72),
    ("halo form, width 64, G 1: Cin 96, Cout 40, 6x64", 2, 6, 64, (96,), 40),
    ("halo form, BM 256: Cin 200 = 123 + 77, Cout 40, 66x256", 2, 66, 256, (123, 77), 40),
)
# The card's peak rate and memory rate (NVIDIA's H100 SXM data sheet,
# dense, at 700 W): the least time of a kernel is the larger of its
# operations over the peak of their inputs' type (bf16 for every kernel
# timed here) and its bytes over the rate.
PEAK_BF16 = 989e12
PEAK_F32 = 67e12  # FP32 without the tensor cores (the f32 form's FFMA)
HBM_BYTES_PER_S = 3.35e12

# The stride-1 partial convs of InpaintUNet(depth=8) at 512^2 pages:
# (layer, H = W, C_lo, C_skip, Cout). Decoder levels have no bias; the
# head (Cout 3) has one.
SHAPES = (
    ("dec7", 4, 512, 512, 512),
    ("dec6", 8, 512, 512, 512),
    ("dec5", 16, 512, 512, 512),
    ("dec4", 32, 512, 512, 512),
    ("dec3", 64, 512, 256, 256),
    ("dec2", 128, 256, 128, 128),
    ("dec1", 256, 128, 64, 64),
    ("head", 512, 64, 3, 3),
)
# The H-sharded U-Net (parallel/spatial.py): InpaintUNet(depth=8) on one
# 2048^2 page cut into 2 and into 4 bands of rows on one card. Each band's
# stride-1 partial convs take a halo row from either neighbour and run K1
# or K2 with padding (0, 1): at 4 bands, (layer, local H + 2, W, C_lo,
# C_skip, Cout), the local H of a level being SHAPES' H.
SPATIAL_PAGE = 2048
SPATIAL_BANDS = (2, 4)
SHARD_SHAPES = tuple((name, h + 2, 4 * h, c_lo, c_skip, cout)
                     for name, h, c_lo, c_skip, cout in SHAPES)
# K1 and K2 with unequal H and W padding: (name, N, H, W, group sizes, Cout,
# padding). Ragged maps, the halo form of K1 at (0, 1) (an output width of
# 128), the head's channel split for K2.
PAD_EXTRA = (
    ("K1 ragged (0, 1): Cin 200 = 123 + 77, Cout 72, 37x29", 3, 37, 29, (123, 77), 72, (0, 1)),
    ("K1 ragged (1, 0): Cin 200 = 123 + 77, Cout 72, 37x29", 3, 37, 29, (123, 77), 72, (1, 0)),
    ("K1 halo form (0, 1): Cin 128 = 64 + 64, Cout 64, 10x128", 2, 10, 128, (64, 64), 64, (0, 1)),
    ("K1 (1, 0): Cin 1024 = 512 + 512, Cout 512, 6x16", 1, 6, 16, (512, 512), 512, (1, 0)),
    ("K2 ragged (0, 1): Cin 67 = 64 + 3, Cout 3, 37x29", 3, 37, 29, (64, 3), 3, (0, 1)),
    ("K2 (1, 0): Cin 67 = 64 + 3, Cout 3, 34x64", 2, 34, 64, (64, 3), 3, (1, 0)),
)
# Shapes of JAX's Pallas scope (stride 1, dilation 1, square, an output
# height under 8 or a multiple of 8: partial_conv_kernel.py:532-539) that
# no model reaches: (name, N, H, W, group sizes, Cout, k, padding). Each is
# routed through ``partial_conv2d`` in bf16 and in f32, forward and
# backward.
SCOPE_CASES = (
    ("Cout 3, Cin 200, k 3", 2, 16, 40, (197, 3), 3, 3, (1, 1)),
    ("Cout 3, Cin 67, k 2", 2, 15, 40, (64, 3), 3, 2, (1, 1)),
    ("Cout 3, Cin 67, k 9", 2, 16, 40, (64, 3), 3, 9, (4, 4)),
    ("Cout 3, Cin 67, k 11", 2, 16, 40, (64, 3), 3, 11, (5, 5)),
    ("Cout 3, Cin 300, k 3", 2, 16, 40, (297, 3), 3, 3, (1, 1)),
    ("G 3 (24, 16, 8), Cout 16, k 3", 2, 16, 40, (24, 16, 8), 16, 3, (1, 1)),
    ("G 3 (24, 16, 8), Cout 3, k 3", 2, 16, 40, (24, 16, 8), 3, 3, (1, 1)),
    ("Cout 3, Cin 67, k 13", 2, 16, 40, (64, 3), 3, 13, (6, 6)),
    ("Cout 3, Cin 67, k 3, padding (4, 1)", 2, 10, 40, (64, 3), 3, 3, (4, 1)),
    # the U-Net head's layer at k 11: the general forms at a size a model
    # would give them
    ("head 67 -> 3 at k 11, 512^2, batch 8", 8, 512, 512, (64, 3), 3, 11, (5, 5)),
)
# K6 beyond its templated form: (name, N, H, W, C, k, d). k 9 also on the
# segmenter's block-2 map (a size a model would give it), k 13 at C 130
# (pixels off 16 bytes: the rings filled by plain loads), and k 3 at d 25
# on that map, which the templated form takes but the routing cut
# (K6_GEN_HALO, from tools/gen_forms.py --k6-route) gives the general form.
SCOPE_K6 = (
    ("K6 k 9, d 1", 2, 64, 64, 128, 9, 1),
    ("K6 k 7, d 48", 2, 96, 96, 128, 7, 48),
    ("K6 k 9 on block 2's map", 8, 128, 128, 144, 9, 1),
    ("K6 k 13, d 2, C 130", 2, 64, 64, 130, 13, 2),
    ("K6 k 3, d 25 on block 2's map (routing cut)", 8, 128, 128, 144, 3, 25),
)
# The two-stage pipeline: microbatches of BATCH pages PAGE^2.
STAGE_MICROBATCHES = 4


def log(msg: str) -> None:
    print(msg, flush=True)


def hole_mask(rng: np.random.Generator, n: int, h: int, w: int) -> np.ndarray:
    """(n, h, w) float32, 1 = valid: random disks and rectangles as holes."""
    m = np.ones((n, h, w), np.float32)
    yy, xx = np.mgrid[:h, :w]
    for i in range(n):
        for _ in range(int(rng.integers(2, 7))):
            cy, cx = rng.uniform(0, h), rng.uniform(0, w)
            r = rng.uniform(0.02, 0.12) * max(h, w) + 0.5
            m[i][(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = 0
        for _ in range(int(rng.integers(1, 3))):
            rh, rw = int(rng.uniform(0.05, 0.25) * h) + 1, int(rng.uniform(0.05, 0.25) * w) + 1
            y, x = int(rng.integers(0, h)), int(rng.integers(0, w))
            m[i, y : y + rh, x : x + rw] = 0
    return m


def grouped_mask(rng, n, h, w, device) -> torch.Tensor:
    """(n, h, w, 2) bf16 as the decoder sees it: group 0 the nearest-x2
    upsampled mask of the level below, group 1 the skip's own mask. Both
    are zero on a 3x3 corner of page 0, so windows with no valid tap at
    all are always present."""
    lo = hole_mask(rng, n, max(h // 2, 1), max(w // 2, 1))
    lo = lo.repeat(2, axis=1).repeat(2, axis=2)[:, :h, :w]
    m = np.stack([lo, hole_mask(rng, n, h, w)], axis=-1)
    m[0, :3, :3, :] = 0
    return torch.from_numpy(m).to(device=device, dtype=torch.bfloat16)


def check_close(name: str, got, want, *, require_empty: bool = False) -> float:
    """A kernel's (y, M') against its plain version's. M' must be equal bit
    for bit, and y exactly 0 wherever M' is 0 (with ``require_empty``,
    such windows must exist). Elsewhere both sides
    accumulate in f32 in different orders and round once to bf16, so a
    rounding boundary may fall between them: |dy| <= 2^-7 |y_plain| (one
    bf16 step) + 1e-3 max |y_plain| (the f32 order difference, scaled by
    the renormalisation). Returns max |dy|."""
    y, m = got
    y_ref, m_ref = want
    if not torch.equal(m, m_ref):
        raise AssertionError(f"{name}: M' differs in {int((m != m_ref).sum())} pixels")
    if not torch.isfinite(y).all():
        raise AssertionError(f"{name}: non-finite output")
    empty = m[..., 0] == 0
    if require_empty and int(empty.sum()) == 0:
        raise AssertionError(f"{name}: no empty window in the test input")
    if not (y[empty] == 0).all():
        raise AssertionError(f"{name}: nonzero output in an empty window")
    y, y_ref = y.float(), y_ref.float()
    err = (y - y_ref).abs()
    bound = 2.0**-7 * y_ref.abs() + 1e-3 * y_ref.abs().max()
    if not (err <= bound).all():
        raise AssertionError(
            f"{name}: |dy| up to {err.max().item():.4g} exceeds the bound "
            f"(max |y| {y_ref.abs().max().item():.4g})"
        )
    return err.max().item()


def rel_l2(a: torch.Tensor, ref: torch.Tensor) -> float:
    return ((a.float() - ref).norm() / ref.norm().clamp_min(1e-30)).item()


def bound(flop: float, nbytes: float, peak: float = PEAK_BF16) -> tuple:
    """(ms, "operations" or "bytes"): the least time the card could take
    for ``flop`` operations at ``peak`` and ``nbytes`` moved once."""
    t_op, t_mem = flop / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_op, "operations") if t_op >= t_mem else (t_mem, "bytes")


def k6_work(x, k: int, d: int) -> tuple:
    """(FLOP, bytes) of K6 on x (N, H, W, C), dilation d: a multiply-add for
    each (output pixel, tap) whose x lies inside the image, 2 N C
    sum_taps (H - |oi d|)+ (W - |oj d|)+ (separable: the rows' sum times
    the columns'); x and dy read once, dW (k k C f32) written once."""
    n, h, w, c = x.shape
    offs = [abs(o) * d for o in range(-(k // 2), k // 2 + 1)]
    rows, cols = sum(max(0, h - o) for o in offs), sum(max(0, w - o) for o in offs)
    return 2.0 * n * c * rows * cols, 2.0 * x.numel() * x.element_size() + 4.0 * k * k * c


def pconv_work(x, mask, w, p: int | None = None) -> tuple:
    """(FLOP, bytes) of one stride-1 partial conv with P output pixels (by
    default x's, a same-size conv): 2 P Cout k^2 Cin multiply-adds; x, the
    mask and the weights read once, y and M' written once, all bf16."""
    n, h, wd, cin = x.shape
    cout, _, k, _ = w.shape
    p = n * h * wd if p is None else p
    flop = 2.0 * p * cout * k * k * cin
    nbytes = 2.0 * (x.numel() + mask.numel() + w.numel() + p * cout + p)
    return flop, nbytes


def pconv_bwd_work(x, mask, w, g) -> tuple:
    """(FLOP, bytes) of that conv's backward: dx and dW are two products of
    the forward's size; x, g, the mask and the weights read once, dx and dW
    written once, all bf16."""
    flop, _ = pconv_work(x, mask, w)
    nbytes = 2.0 * (2 * x.numel() + g.numel() + mask.numel() + 2 * w.numel())
    return 2.0 * flop, nbytes


def check_grads(name, x, mask, w, b, g, kw) -> float:
    """K3: dx, dW, db of the kernel path (bf16, the weights as the U-Net
    passes them) against autograd of the plain version in f32 from the
    same bf16 values. Both sides accumulate in f32; the kernel path rounds
    dacc, dx and dW to bf16 once each, so each gradient must be within 1%
    in relative L2 and 2^-5 of its max |value| everywhere. Returns the
    largest relative L2 and the largest |error|."""
    from text_segmentation_image_inpainting_tpu_torch.ops.kernels import partial_conv as kpc

    bf = torch.bfloat16
    leaves = [x.detach().to(bf).requires_grad_(True), w.detach().to(bf).requires_grad_(True)]
    ref_leaves = [t.detach().float().requires_grad_(True) for t in leaves]
    if b is not None:
        leaves.append(b.detach().to(bf).requires_grad_(True))
        ref_leaves.append(leaves[-1].detach().float().requires_grad_(True))
    bias, ref_bias = (leaves[2], ref_leaves[2]) if b is not None else (None, None)
    y, _ = kpc.partial_conv2d_fused(leaves[0], mask, leaves[1], bias, **kw)
    got = torch.autograd.grad(y, leaves, g)
    y_ref, _ = kpc.partial_conv2d_reference(ref_leaves[0], mask.float(), ref_leaves[1], ref_bias,
                                            **kw)
    want = torch.autograd.grad(y_ref, ref_leaves, g.float())
    worst, worst_abs = 0.0, 0.0
    for what, a, r in zip(("dx", "dW", "db"), got, want):
        a = a.float()
        rel, err = rel_l2(a, r), (a - r).abs().max().item()
        if not torch.isfinite(a).all() or rel > 1e-2 or err > 2**-5 * r.abs().max().item():
            raise AssertionError(f"{name} {what}: relative L2 {rel:.3g}, max |d| {err:.4g} "
                                 f"(max |ref| {r.abs().max().item():.4g})")
        worst, worst_abs = max(worst, rel), max(worst_abs, err)
    return worst, worst_abs


def check_stem_dx(name, x, g, w0, b0, w1, b1, *, compare_max: bool = True) -> dict:
    """K4 against the f32 truth: the plain dx in f32 from the same bf16
    inputs and bf16-rounded weights. The bf16 cuDNN autograd stem is held
    to the same truth, and K4 must be no worse (as
    tests/test_vgg_stem_bwd.py holds the Pallas kernel to XLA's bf16
    backward): its relative L2 within max(1.5 x cuDNN's, 1e-3) and, with
    ``compare_max``, its max |error| within 1.5 x cuDNN's. Both bf16
    backwards route a 2x2 pool tie wherever their own rounding puts the
    max, so neither is exact; the 1.5 is the JAX test's margin for that.
    The max is a fair comparison only over many windows (the train
    shape): on a small page one tie routed differently sets it."""
    from text_segmentation_image_inpainting_tpu_torch.ops.kernels import vgg_stem as kvs

    got = kvs.stem_dx(x, g, w0, b0, w1, b1)
    plain = kvs.stem_dx_reference(x, g, w0, b0, w1, b1)
    rb = [t.to(torch.bfloat16).float() for t in (w0, b0, w1, b1)]
    truth = kvs.stem_dx_reference(x.float(), g.float(), *rb)
    torch.cuda.synchronize()
    if got.dtype != torch.float32 or got.shape != x.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{name}: dx {got.dtype} {tuple(got.shape)} or non-finite")
    res = {"rel": rel_l2(got, truth), "rel_cudnn": rel_l2(plain, truth),
           "max": (got - truth).abs().max().item(), "max_cudnn": (plain.float() - truth).abs().max().item()}
    if res["rel"] > max(1.5 * res["rel_cudnn"], 1e-3) or (
            compare_max and res["max"] > 1.5 * res["max_cudnn"]):
        raise AssertionError(f"{name}: K4 is further from the f32 truth than the bf16 cuDNN stem: {res}")
    return res


def stem_weights(gen, dev) -> tuple:
    """Random VGG stem weights (w0, b0, w1, b1) at about the scale of
    torchvision's, for the stem's checks away from the train step."""
    return (torch.randn((64, 3, 3, 3), generator=gen, device=dev) * 0.3,
            torch.randn((64,), generator=gen, device=dev) * 0.1,
            torch.randn((64, 64, 3, 3), generator=gen, device=dev) * 0.06,
            torch.randn((64,), generator=gen, device=dev) * 0.1)


def check_stem_dx_repeats(name, x, g, w0, b0, w1, b1) -> None:
    """Two K4 launches on the same inputs must be bit-identical: no
    atomics, every sum in a fixed order."""
    from text_segmentation_image_inpainting_tpu_torch.ops.kernels import vgg_stem as kvs

    first, again = kvs.stem_dx(x, g, w0, b0, w1, b1), kvs.stem_dx(x, g, w0, b0, w1, b1)
    torch.cuda.synchronize()
    if not torch.equal(first, again):
        raise AssertionError(f"{name}: two K4 launches on the same inputs differ")


def check_stem_pool(name, z0, w1, b1) -> float:
    """K5 against its plain version (``check_close``: one bf16 step of
    |y| plus 1e-3 of max |y|; both round one f32 sum, the plain version
    the conv and then the sum with the bias), then a second launch on the
    same inputs, bit-identical. Returns max |dy|."""
    from text_segmentation_image_inpainting_tpu_torch.ops.kernels import vgg_stem as kvs

    got, again = kvs.stem_pool(z0, w1, b1), kvs.stem_pool(z0, w1, b1)
    want = kvs.stem_pool_reference(z0, w1, b1)
    torch.cuda.synchronize()
    ones = torch.ones_like(want[..., :1])
    err = check_close(name, (got, ones), (want, ones))
    if not torch.equal(got, again):
        raise AssertionError(f"{name}: two K5 launches on the same inputs differ")
    return err


def wgrad_truth(x, dy, k: int, d: int):
    """The depthwise weight gradient in f64, and the sum of the magnitudes
    of its terms, Σ|x·dy|; each (k, k, 1, C)."""
    import torch.nn.functional as F

    n, h, w, c = x.shape
    p = d * (k - 1) // 2
    xp = F.pad(x.double(), (0, 0, p, p, p, p))
    dyd = dy.double()
    sums, mags = [], []
    for ki in range(k):
        for kj in range(k):
            prod = xp[:, ki * d: ki * d + h, kj * d: kj * d + w, :] * dyd
            sums.append(prod.sum(dim=(0, 1, 2)))
            mags.append(prod.abs().sum(dim=(0, 1, 2)))
    return torch.stack(sums).reshape(k, k, 1, c), torch.stack(mags).reshape(k, k, 1, c)


def check_wgrad(name, x, dy, k: int, d: int) -> dict:
    """K6 (two launches on the same inputs, bit-identical) and its plain
    version against the f64 truth on the card. A product of two bf16
    values is exact in f32 (of two f32 values, rounded once), so what
    either side can get wrong is the order of an f32 sum: each (tap,
    channel) must be within 1e-5 · Σ|x·dy| of the truth (K6's longest chain
    of f32 adds, over one band's columns and rows and then the slots, is
    about 130 at the segmenter's shapes, and its general form's, the plan's
    ``chain``, is under 167 at SCOPE_K6: 167 · 2^-24 < 1e-5). Returns the
    max |error| of each side and max |K6 - plain|."""
    from text_segmentation_image_inpainting_tpu_torch.ops.kernels import depthwise_wgrad as kdw

    before = kdw.K6_LAUNCHES
    got = kdw.depthwise_wgrad(x, dy, k, d)
    again = kdw.depthwise_wgrad(x, dy, k, d)
    torch.cuda.synchronize()
    if kdw.K6_LAUNCHES != before + 2:
        raise AssertionError(f"{name}: K6 launched {kdw.K6_LAUNCHES - before} times, want 2")
    if not torch.equal(got, again):
        raise AssertionError(f"{name}: two K6 launches on the same inputs differ in "
                             f"{int((got != again).sum())} values")
    plain = kdw.depthwise_wgrad_reference(x, dy, k, d)
    truth, mag = wgrad_truth(x, dy, k, d)
    want_shape = (k, k, 1, x.shape[-1])
    if got.dtype != torch.float32 or tuple(got.shape) != want_shape or not torch.isfinite(got).all():
        raise AssertionError(f"{name}: dW {got.dtype} {tuple(got.shape)} or non-finite")
    res = {}
    for what, a in (("K6", got), ("plain", plain)):
        err = (a.double() - truth).abs()
        over = err > 1e-5 * mag
        if over.any():
            raise AssertionError(f"{name}: {what} off the f64 truth by more than 1e-5 Σ|x·dy| at "
                                 f"{int(over.sum())} of {err.numel()} (tap, channel); max |d| "
                                 f"{err.max().item():.4g}")
        res[what] = err.max().item()
    res["vs_plain"] = (got - plain).abs().max().item()
    return res


def text_targets(rng: np.random.Generator, n: int, h: int, w: int) -> np.ndarray:
    """(n, h, w, 1) float32 in {0, 1}: lines of glyph-sized boxes, 5-15%
    of each page (the card's machine has no PIL to render text)."""
    m = np.zeros((n, h, w, 1), np.float32)
    for i in range(n):
        target = rng.uniform(0.05, 0.15)
        while m[i].mean() < target:
            gh = int(rng.integers(8, 24))
            y, x = int(rng.integers(0, h - gh)), int(rng.integers(0, w // 2))
            for gx in range(x, min(w, x + int(rng.integers(w // 8, w // 2))), gh * 4 // 5):
                m[i, y: y + gh, gx: gx + max(2, gh // 2)] = 1
    return m


def cuda_ms(fn, iters: int = ITERS, warmup: int = WARMUP) -> float:
    """Median milliseconds of ``fn`` over ``iters`` runs, after ``warmup`` runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, prefix: str = "", runs: int = 10) -> float:
    """Device time per call of ``fn`` spent in kernels named ``prefix...``
    (torch.profiler; K1's are ``pconv_k1<BN, MT>``, ``pconv_k1_halo<BN,
    MT>`` and ``pconv_k1_reduce``; every kernel for ``prefix`` ""): the
    kernels alone, without the host time that a CUDA-event measurement of
    a short call also sees."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # a profiler window now and then records no kernel at all, at times
    # three in a row; the windows it took are logged where it took more
    # than one
    for window in range(1, 11):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and (not prefix or f"::{prefix}" in e.key))
        if total > 0:
            if window > 1:
                log(f"device_ms: torch.profiler recorded {prefix or 'a kernel'} in window "
                    f"{window}, none in the {window - 1} before")
            return total / 1e3 / runs
    raise RuntimeError(f"torch.profiler recorded no {prefix or 'kernel'} in ten windows")


def main() -> int:
    # 1. device -----------------------------------------------------------
    # cuBLAS keeps its results fixed with a fixed workspace; the graph
    # phase's determinism probe needs it set before the first cuBLAS call
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from text_segmentation_image_inpainting_tpu_torch.ops.kernels import build
    from text_segmentation_image_inpainting_tpu_torch.ops.kernels import partial_conv as kpc
    from text_segmentation_image_inpainting_tpu_torch.ops.partial_conv import _partial_conv2d_plain
    from text_segmentation_image_inpainting_tpu_torch.models import PartialConv
    from text_segmentation_image_inpainting_tpu_torch.pipeline import TextRemovalPipeline

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"device: {kind}, {torch.cuda.device_count()} visible; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    # the plain side computes in true f32 (cuDNN would use TF32 by default)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    build.load_library()
    log(f"build: nvcc {build.last_build['seconds']:.1f} s, ready in "
        f"{time.perf_counter() - t0:.1f} s: {build.last_build['path']}")
    for line in build.last_build["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling entry function" in line:
            log(f"  ptxas: {line.strip()}")

    # 3. kernel parity ------------------------------------------------------
    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    cases = []
    for name, h, c_lo, c_skip, cout in SHAPES:
        cin = c_lo + c_skip
        x = torch.randn((BATCH, h, h, cin), generator=gen, device=dev).to(torch.bfloat16)
        mask = grouped_mask(rng, BATCH, h, h, dev)
        w = torch.randn((cout, cin, 3, 3), generator=gen, device=dev) * (2.0 / (9 * cin)) ** 0.5
        b = torch.randn((cout,), generator=gen, device=dev) * 0.1 if cout <= 7 else None
        kw = dict(group_sizes=(c_lo, c_skip), padding=(1, 1))
        got = kpc.partial_conv2d_fused(x, mask, w, b, **kw)
        want = kpc.partial_conv2d_reference(x, mask, w, b, **kw)
        torch.cuda.synchronize()
        err = check_close(name, got, want, require_empty=True)
        kname = "K2" if cout <= 7 else "K1"
        empty = int((got[1] == 0).sum())
        log(f"parity {kname} {name}: x {tuple(x.shape)} -> y {tuple(got[0].shape)}, "
            f"M' bit-exact, {empty} empty windows exactly 0, max|dy| {err:.4g}")
        cases.append((kname, name, x, mask, w, b, kw, err))
    k1_extra(dev, rng, gen, cases)
    k2_extra(dev, rng, gen, cases)

    # 4. pipeline -----------------------------------------------------------
    pipe = TextRemovalPipeline().init_weights(torch.Generator().manual_seed(SEED))
    pipe = pipe.to(dev).eval()
    pages = torch.from_numpy(rng.uniform(0.0, 1.0, (BATCH, PAGE, PAGE, 3)).astype(np.float32))
    pages = pages.to(dev)
    pages_c = pages.to(pipe.compute_dtype)

    calls = []

    def keep_inputs(module, args, kwargs, output):
        if module.conv.stride == (1, 1):
            calls.append((module, args[0], args[1], kwargs.get("group_sizes"), output))

    pconvs = [m for m in pipe.modules() if isinstance(m, PartialConv)]
    hooks = [m.register_forward_hook(keep_inputs, with_kwargs=True) for m in pconvs]
    kpc.K1_LAUNCHES = kpc.K2_LAUNCHES = 0
    with bn_counted("pipeline run", pipe) as bn_run, dw_counted("pipeline run", pipe):
        clean, text = pipe.run(pages)
    torch.cuda.synchronize()
    launches = {"K1": kpc.K1_LAUNCHES, "K2": kpc.K2_LAUNCHES}
    for hk in hooks:
        hk.remove()
    log(f"pipeline run: pages {tuple(pages.shape)} -> clean {tuple(clean.shape)} "
        f"{clean.dtype}, text mask {tuple(text.shape)}; launches {launches}")
    if launches != {"K1": 7, "K2": 1}:
        raise AssertionError(f"run launched {launches}, want K1 7 and K2 1")

    def check_page_out(what, out, text_mask):
        if out.shape != pages.shape or not torch.isfinite(out).all():
            raise AssertionError(f"{what}: output shape {tuple(out.shape)} or non-finite values")
        if not ((text_mask == 0) | (text_mask == 1)).all():
            raise AssertionError(f"{what}: text mask not binary")
        keep = (text_mask == 0).expand_as(out)
        if not torch.equal(out[keep], pages_c[keep]):
            raise AssertionError(f"{what}: non-text pixels differ from the input page")
        frac = text_mask.float().mean().item()
        log(f"{what}: finite, binary mask ({frac:.3%} text), non-text pixels "
            f"bit-identical ({int(keep.sum())} values)")

    check_page_out("run", clean, text)
    if len(calls) != 8:
        raise AssertionError(f"caught {len(calls)} stride-1 partial convs, want 8")
    for i, (module, x, mask, gs, (y, m)) in enumerate(calls):
        c = module.conv
        want = kpc.partial_conv2d_reference(
            x, mask, c.weight.to(module.dtype),
            None if c.bias is None else c.bias.to(module.dtype),
            group_sizes=gs, padding=c.padding,
        )
        err = check_close(f"run layer {i}", (y, m), want)
        log(f"run layer {i}: x {tuple(x.shape)} groups {gs} -> {c.out_channels}: kernel == plain "
            f"on the pipeline's own inputs, max|dy| {err:.4g}")
    del calls

    holes = torch.from_numpy(hole_mask(rng, BATCH, PAGE, PAGE)[..., None]).to(dev)
    text_in = 1.0 - holes
    kpc.K1_LAUNCHES = kpc.K2_LAUNCHES = 0
    with bn_counted("pipeline inpaint", pipe):
        inpainted = pipe.inpaint(pages, text_in)
    torch.cuda.synchronize()
    got = {"K1": kpc.K1_LAUNCHES, "K2": kpc.K2_LAUNCHES}
    if got != {"K1": 7, "K2": 1}:
        raise AssertionError(f"inpaint launched {got}, want K1 7 and K2 1")
    check_page_out("inpaint (given hole mask)", inpainted, text_in)

    phase_s = {"build, parity, pipeline": time.perf_counter() - t0}

    def timed_phase(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        phase_s[name] = time.perf_counter() - t
        log(f"phase {name}: {phase_s[name]:.1f} s")
        return out

    bn_row = timed_phase("bn", bn_phase, dev, smi)
    dw_row = timed_phase("dw", dw_phase, dev, smi)

    # 5. train --------------------------------------------------------------
    tr = timed_phase("train", train_phase, dev, rng, cases)

    # 6. seg ----------------------------------------------------------------
    sg = timed_phase("seg", seg_phase, dev, rng)
    t_timing = time.perf_counter()

    # 7. timing -------------------------------------------------------------
    from text_segmentation_image_inpainting_tpu_torch.ops.partial_conv import apply_mask

    # per kernel: ms, plain ms, max err, shapes, library ms, bound ms, bf16 twin ms
    totals = {kn: {"ms": 0.0, "plain": 0.0, "err": 0.0, "n": 0, "lib": 0.0, "bound": 0.0,
                   "twin": 0.0, "flop": 0.0} for kn in ("K1", "K2")}
    for kname, name, x, mask, w, b, kw, err in cases:
        plain = lambda: kpc.partial_conv2d_reference(x, mask, w, b, **kw)  # noqa: E731
        # the kernel as the U-Net's modules call it: bf16 weights, which the
        # wrapper re-lays in every call (K1); the re-lay also timed alone
        wb16 = w.to(torch.bfloat16)
        kern = lambda: kpc.partial_conv2d_fused(x, mask, wb16, b, **kw)  # noqa: E731
        twin = lambda: _partial_conv2d_plain(  # noqa: E731
            x, mask, w, b, kw["group_sizes"], (1, 1), kw["padding"], (1, 1)
        )
        # the yardstick: cuDNN's bf16 product alone, on x already masked,
        # channels-last (never called by the port)
        xm = apply_mask(x, mask, kw["group_sizes"]).permute(0, 3, 1, 2)
        wb = w.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
        lib = lambda: torch.nn.functional.conv2d(xm, wb, padding=kw["padding"])  # noqa: E731
        p1, k1, k2, p2 = cuda_ms(plain), cuda_ms(kern), cuda_ms(kern), cuda_ms(plain)
        t_twin, t_lib = cuda_ms(twin), cuda_ms(lib)
        k_ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
        flop, nbytes = pconv_work(x, mask, w)
        if kname == "K1":
            b_ms, b_by = bound(flop, nbytes)
            relay = device_ms(lambda: kpc.k1_weight_relayout(wb16, kw["group_sizes"]))
            plan = kpc.k1_plan(*x.shape[:3], w.shape[0], kpc.k1_channels(kw["group_sizes"])[2],
                               w.shape[2], kw["padding"][0])
            dev_ms = device_ms(kern, "pconv_k1")
            totals["K1"]["device"] = totals["K1"].get("device", 0.0) + dev_ms
            extra = (f", {plan}; device time {dev_ms:.4f} ms "
                     f"({flop / dev_ms / 1e9:.1f} TFLOP/s); the weight re-lay in each call "
                     f"{relay:.4f} ms of device time ({relay / dev_ms:.1%} of K1's)")
        else:
            b_ms, b_by = bound(flop, nbytes)
            dev_ms = device_ms(kern, "pconv_k2")
            extra = (f", {kpc.k2_plan(x.shape[3], w.shape[0], w.shape[2])}; device time "
                     f"{dev_ms:.4f} ms ({nbytes / dev_ms / 1e9:.3f} TB/s of the bytes moved once)")
        log(f"time {kname} {name}: kernel {k_ms:.4f} ms ({flop / k_ms / 1e9:.1f} TFLOP/s), "
            f"plain f32 {p_ms:.4f} ms, plain bf16 cuDNN twin {t_twin:.4f} ms, cuDNN bf16 conv "
            f"alone {t_lib:.4f} ms, bound {b_ms:.4f} ms ({b_by}){extra}")
        t = totals[kname]
        for key, v in (("ms", k_ms), ("plain", p_ms), ("lib", t_lib), ("bound", b_ms),
                       ("twin", t_twin), ("flop", flop)):
            t[key] += v
        t["err"] = max(t["err"], err)
        t["n"] += 1
        t["by"] = b_by
    # the last case's temporaries (the head's masked x: 281 MB) would count
    # in the train step's peak memory below
    del xm, wb, wb16, plain, kern, twin, lib
    t = totals["K1"]
    log(f"time K1 (sum over the {t['n']} decoder levels): kernel {t['ms']:.4f} ms "
        f"({t['flop'] / t['ms'] / 1e9:.1f} TFLOP/s), device time {t['device']:.4f} ms "
        f"({t['flop'] / t['device'] / 1e9:.1f} TFLOP/s), plain f32 {t['plain']:.4f} ms, bf16 twin "
        f"{t['twin']:.4f} ms, cuDNN bf16 conv alone {t['lib']:.4f} ms, bound {t['bound']:.4f} ms")

    def run():
        pipe.run(pages)

    run_ms = cuda_ms(run)
    seg_ms = cuda_ms(lambda: pipe.segment(pages))
    inp_ms = cuda_ms(lambda: pipe.inpaint(pages, text_in))
    log(f"time run: {run_ms:.3f} ms per batch of {BATCH} = {BATCH / run_ms * 1e3:.2f} pages/s "
        f"(segment {seg_ms:.3f} ms, inpaint {inp_ms:.3f} ms)")
    log(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    profile_run(run, "run")
    stem_times = time_train(tr)
    k6 = time_seg(sg)
    phase_s["timing"] = time.perf_counter() - t_timing
    log(f"phase timing: {phase_s['timing']:.1f} s")

    # 8. the experiment tracks, accumulation, CUDA graphs, evaluate ----------
    xk6 = timed_phase("xception", xception_phase, dev, rng, smi)
    timed_phase("attention", attention_phase, dev, rng, tr)
    gr = timed_phase("graph", graph_phase, dev, rng, tr, smi)
    f32 = timed_phase("f32", f32_phase, dev, rng, cases, smi)
    timed_phase("ddp", ddp_phase, dev, gr, smi)
    del gr
    torch.cuda.empty_cache()
    timed_phase("evaluate", evaluate_phase, smi)

    # 9. serve --------------------------------------------------------------
    timed_phase("serve", serve_phase, pipe, dev, smi)

    # 10. multi-device serving on one card ----------------------------------
    timed_phase("parallel", parallel_phase, pipe, dev, rng, smi)

    # 11. the pretrained-weight path ----------------------------------------
    timed_phase("pretrained", pretrained_phase, pipe, dev, smi)

    # 12. JAX's kernel scope beyond the models' shapes ------------------------
    scope_rows = timed_phase("scope", scope_phase, dev, rng, smi)
    log("phase seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in phase_s.items())
        + f"; total {time.perf_counter() - t0:.1f}")

    kernels = []
    for kname, line, fn in (("K1", 184, "pconv_k1"), ("K2", 415, "pconv_k2")):
        t = totals[kname]
        log(f"{kname}: {t['n']} shape(s), ms, plain_ms, library_ms and bound_ms are sums over "
            f"them (one U-Net forward); launches from the pipeline run, "
            f"{tr['launches'][kname]} per train step")
        kernels.append({
            "name": f"{kname} {fn}", "route": "cuda", "source": CSRC,
            "replaces": f"{TPU_KERNEL}:{line}", "launches": launches[kname],
            "max_abs_err": t["err"], "ms": t["ms"], "plain_ms": t["plain"],
            "bound_ms": t["bound"], "bound_by": t["by"], "library_ms": t["lib"],
        })
    t3 = stem_times["K3"]
    log("K3: 8 shape(s), ms, plain_ms, library_ms and bound_ms are sums over them (one U-Net "
        "backward); launches from the first train step, max_abs_err against autograd of the "
        "plain version in f32")
    kernels.append({
        "name": "K3 pconv_k3_prep, pconv_k3_mask, pconv_k2_bwd", "route": "cuda", "source": CSRC,
        "replaces": f"{TPU_KERNEL}:600", "launches": tr["launches"]["K3"],
        "max_abs_err": tr["err"]["K3"], "ms": t3["ms"], "plain_ms": t3["plain"],
        "bound_ms": t3["bound"], "bound_by": t3["by"], "library_ms": t3["lib"],
    })
    for kname, fn, tpu in (("K4", "stem_dx", f"{TPU_STEM_BWD}:366"),
                           ("K5", "stem_pool", f"{TPU_STEM}:191")):
        st = stem_times[kname]
        log(f"{kname}: launches from the first train step"
            + ("; timed at the step's shape, z0 of its 8 ground-truth pages" if kname == "K5" else ""))
        kernels.append({
            "name": f"{kname} {fn}", "route": "cuda", "source": CSRC_STEM, "replaces": tpu,
            "launches": tr["launches"][kname], "max_abs_err": tr["err"][kname],
            "ms": st["ms"], "plain_ms": st["plain"], "bound_ms": st["bound"],
            "bound_by": st["by"], "library_ms": st["lib"],
        })
    log("K6: 5 shape(s), ms and plain_ms are sums over one seg train step's 14 launches; "
        "launches from the first seg step, max_abs_err K6 against the plain at those shapes")
    kernels.append({
        "name": "K6 dw_wgrad_band", "route": "cuda", "source": CSRC_DW, "replaces": f"{TPU_DW}:144",
        "launches": sg["launches"], "max_abs_err": max(r["vs_plain"] for *_, r in sg["k6"]),
        "ms": k6["ms"], "plain_ms": k6["plain"], "bound_ms": k6["bound"], "bound_by": k6["by"],
        "library_ms": k6["lib"],
    })
    log("K6 (Xception): 9 shape(s), ms and plain_ms are sums over one Xception seg step's 35 "
        "launches; launches from the first Xception step, max_abs_err K6 against the plain at "
        "those shapes")
    kernels.append({
        "name": "K6 dw_wgrad_band (Xception seg step)", "route": "cuda", "source": CSRC_DW,
        "replaces": f"{TPU_DW}:144", "launches": xk6["launches"], "max_abs_err": xk6["err"],
        "ms": xk6["ms"], "plain_ms": xk6["plain"], "bound_ms": xk6["bound"],
        "bound_by": xk6["by"], "library_ms": xk6["lib"],
    })
    for kname, fn, line, tname in (("K1F", "pconv_k1f_weights, pconv_f32_mask, pconv_k1f, "
                                           "pconv_k1f_reduce (Cout >= 8)", 184, "K1F"),
                                   ("K2F", "pconv_f32_relay, pconv_k2f (Cout <= 7)", 415, "K2F"),
                                   ("K3F", "pconv_k3_prep, pconv_k3_mask, pconv_f32_relay, "
                                           "pconv_k2f_bwd, pconv_colsum (f32)", 600, "K3F")):
        t = f32["totals"][tname]
        log(f"{kname} (the f32 form): {t['n']} shape(s); ms, plain_ms, library_ms (cuDNN f32, "
            f"TF32 off) and bound_ms (f32 peak without the tensor cores) are sums over them; "
            f"launches from the f32 U-Net forward (K3F: the f32 step), max_abs_err against the "
            f"plain version in f64")
        kernels.append({
            "name": f"{kname} {fn}", "route": "cuda", "source": CSRC,
            "replaces": f"{TPU_KERNEL}:{line}", "launches": f32["launches"][kname],
            "max_abs_err": t["err"], "ms": t["ms"], "plain_ms": t["plain"],
            "bound_ms": t["bound"], "bound_by": t["by"], "library_ms": t["lib"],
        })
    hd = f32["head"]
    log("K3F head (the f32 backward at the head, 67 -> 3, hand-written): ms, plain_ms, library_ms "
        "(cuDNN f32 convolution_backward, TF32 off) and bound_ms at that shape alone; launches "
        "from the f32 step, max_abs_err against autograd of the plain version in f64")
    kernels.append({
        "name": "K3F head pconv_k3_prep, pconv_f32_relay, pconv_k2f_bwd, pconv_colsum (Cout <= 7)",
        "route": "cuda", "source": CSRC, "replaces": f"{TPU_KERNEL}:600",
        "launches": f32["launches"]["K3F_HEAD"], "max_abs_err": hd["err"], "ms": hd["ms"],
        "plain_ms": hd["plain"], "bound_ms": hd["bound"], "bound_by": hd["by"],
        "library_ms": hd["lib"],
    })
    for kname, fn in (("K4F", "stem_f32_weights, stem_f32_conv0, stem_f32_conv1<GRAD, DGRAD>, "
                              "stem_f32_dx"),
                      ("K5F", "stem_f32_weights, stem_f32_conv1<POOL>")):
        st = f32["stem"][kname]
        log(f"{kname} (the f32 stem): launches from the f32 step; library_ms cuDNN f32 (TF32 "
            f"off): " + ("its stem backward alone" if kname == "K4F" else "conv1 alone")
            + "; max_abs_err against the plain version in f64")
        kernels.append({
            "name": f"{kname} {fn}", "route": "cuda", "source": CSRC_STEM,
            "replaces": f"{TPU_STEM_BWD}:366" if kname == "K4F" else f"{TPU_STEM}:191",
            "launches": f32["launches"][kname], "max_abs_err": st["err"], "ms": st["ms"],
            "plain_ms": st["plain"], "bound_ms": st["bound"], "bound_by": st["by"],
            "library_ms": st["lib"],
        })
    log("K2/K2F, K3/K3F and K6 general forms: the scope phase's cases that take them; ms, "
        "plain_ms, library_ms (cuDNN on x * M) and bound_ms are sums over those cases; "
        "launches from the scope phase's path runs, max_abs_err the largest against the f64 "
        "truth (bf16 backward: autograd of the plain version in f32)")
    kernels.extend(scope_rows)
    bn_row["launches"] = sg["bn"]["launches"]
    log(f"BN: launches from the first seg train step, {sg['bn']['calls']} calls; the first "
        f"inpaint train step {tr['bn']['launches']} for {tr['bn']['calls']} calls, the "
        f"pipeline run {bn_run['launches']} for {bn_run['calls']} calls")
    kernels.append(bn_row)
    log("DW: 20 shapes (DW_SHAPES); launches from the first Xception train step; ms (events), "
        "plain_ms (its plain version, F.conv2d), "
        "library_ms (cuDNN's forward and dgrad, device time) and bound_ms are sums over one "
        "Xception train step's 38 forwards and 36 stride-1 dx; max_abs_err the largest in bf16 "
        "against the f64 truth")
    dw_row["launches"] = xk6["dw_launches"]
    kernels.append(dw_row)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


def k1_extra(dev, rng, gen, cases) -> None:
    """K1 where the U-Net's shapes do not reach: ``K1_EXTRA`` against the
    plain version; an all-hole page, whose output must be exactly 0 even
    with an infinite x in the holes; and two launches on the same inputs,
    bit-identical, at a split-K level (dec7), a one-pass level (dec3) and
    a level of the halo form (dec1)."""
    from text_segmentation_image_inpainting_tpu_torch.ops.kernels import partial_conv as kpc

    for name, n, h, w, groups, cout in K1_EXTRA:
        cin = sum(groups)
        x = torch.randn((n, h, w, cin), generator=gen, device=dev).to(torch.bfloat16)
        m = torch.from_numpy(rng.random((n, h, w, len(groups))) < 0.6).to(dev, torch.bfloat16)
        m[0, :3, :3] = 0
        wt = torch.randn((cout, cin, 3, 3), generator=gen, device=dev) * (2.0 / (9 * cin)) ** 0.5
        kw = dict(group_sizes=groups, padding=(1, 1))
        plan = kpc.k1_plan(n, h, w, cout, kpc.k1_channels(groups)[2], 3, 1)
        err = check_close(f"K1 {name}", kpc.partial_conv2d_fused(x, m, wt, None, **kw),
                          kpc.partial_conv2d_reference(x, m, wt, None, **kw), require_empty=True)
        log(f"parity K1 {name}: {plan}, M' bit-exact, max|dy| {err:.4g}")
    for _, name, x, mask, w, b, kw, _ in cases:
        if name not in ("dec7", "dec3", "dec1"):
            continue
        hole = torch.zeros_like(mask)
        xi = x.clone()
        xi[0, 0, 0, 0] = float("inf")
        y, m_out = kpc.partial_conv2d_fused(xi, hole, w, b, **kw)
        first = kpc.partial_conv2d_fused(x, mask, w, b, **kw)
        again = kpc.partial_conv2d_fused(x, mask, w, b, **kw)
        torch.cuda.synchronize()
        if not ((y == 0).all() and (m_out == 0).all()):
            raise AssertionError(f"K1 {name}: an all-hole page gave a nonzero output or M'")
        if not (torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])):
            raise AssertionError(f"K1 {name}: two launches on the same inputs differ")
        plan = kpc.k1_plan(*x.shape[:3], w.shape[0], x.shape[3], 3, 1)
        log(f"parity K1 {name} ({plan}): all-hole page exactly 0 (x inf in a hole), two "
            f"launches bit-identical")


def k2_extra(dev, rng, gen, cases) -> None:
    """K2 where the head's shape does not reach: ``K2_EXTRA`` against the
    plain version; on the head's inputs an all-hole page, whose output
    must be exactly 0 even with an infinite x in a hole, and two launches,
    bit-identical."""
    from text_segmentation_image_inpainting_tpu_torch.ops.kernels import partial_conv as kpc

    for name, n, h, w, groups, cout in K2_EXTRA:
        cin = sum(groups)
        x = torch.randn((n, h, w, cin), generator=gen, device=dev).to(torch.bfloat16)
        m = torch.from_numpy(rng.random((n, h, w, len(groups))) < 0.6).to(dev, torch.bfloat16)
        m[0, :3, :3] = 0
        wt = torch.randn((cout, cin, 3, 3), generator=gen, device=dev) * (2.0 / (9 * cin)) ** 0.5
        b = torch.randn((cout,), generator=gen, device=dev) * 0.1
        kw = dict(group_sizes=groups, padding=(1, 1))
        err = check_close(f"K2 {name}", kpc.partial_conv2d_fused(x, m, wt, b, **kw),
                          kpc.partial_conv2d_reference(x, m, wt, b, **kw), require_empty=True)
        log(f"parity K2 {name}: {kpc.k2_plan(cin, cout, 3)}, M' bit-exact, max|dy| {err:.4g}")
    _, name, x, mask, w, b, kw, _ = next(c for c in cases if c[0] == "K2")
    xi = x.clone()
    xi[0, 0, 0, 0] = float("inf")
    y, m_out = kpc.partial_conv2d_fused(xi, torch.zeros_like(mask), w, b, **kw)
    first = kpc.partial_conv2d_fused(x, mask, w, b, **kw)
    again = kpc.partial_conv2d_fused(x, mask, w, b, **kw)
    torch.cuda.synchronize()
    if not ((y == 0).all() and (m_out == 0).all()):
        raise AssertionError(f"K2 {name}: an all-hole page gave a nonzero output or M'")
    if not (torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])):
        raise AssertionError(f"K2 {name}: two launches on the same inputs differ")
    log(f"parity K2 {name}: all-hole page exactly 0 (x inf in a hole), two launches bit-identical")


def check_k3_valid_and_repeats(name, x, mask, w, b, g, kw) -> None:
    """K3's ``valid`` against the forward's M', bit for bit: at a decoder
    level ``pconv_k3_prep`` of a cotangent of ones is nonzero exactly where
    M' is 1; at the head, where the window count lives inside
    ``pconv_k2_bwd``, db of a cotangent of ones is the number of windows
    with M' = 1 (an integer below 2^24, exact in f32), and dx is exactly 0
    wherever every window that covers the pixel is empty. Then two
    backward launches on the same inputs: dx, dW, db bit-identical."""
    from text_segmentation_image_inpainting_tpu_torch.ops.kernels import partial_conv as kpc

    bf = torch.bfloat16
    wb, bb = w.to(bf), None if b is None else b.to(bf)
    _, m_out = kpc.partial_conv2d_fused(x, mask, wb, bb, **kw)
    ones = torch.ones_like(g)
    if w.shape[0] > 7:
        dacc, _ = kpc.k3_prep(ones, mask, x.shape[3], kw["group_sizes"], w.shape[2],
                              kw["padding"][0], need_db=False)
        same = torch.equal(dacc[..., :1] != 0, m_out != 0)
    else:
        fb = torch.zeros((w.shape[0],), device=x.device)  # an f32 bias keeps db in f32
        dx1, _, db = kpc.partial_conv2d_backward(ones, x, mask, wb, fb, kw["group_sizes"],
                                                 kw["padding"])
        same = bool((db == m_out.float().sum()).all())
        reach = torch.nn.functional.max_pool2d(m_out.float().permute(0, 3, 1, 2), w.shape[2], 1,
                                               kw["padding"][0])
        same = same and bool((dx1[reach.permute(0, 2, 3, 1).expand_as(dx1) == 0] == 0).all())
    if not same:
        raise AssertionError(f"{name}: K3's valid differs from the forward's M'")
    args = (g, x, mask, wb, bb, kw["group_sizes"], kw["padding"])
    first, again = kpc.partial_conv2d_backward(*args), kpc.partial_conv2d_backward(*args)
    torch.cuda.synchronize()
    for what, a, a2 in zip(("dx", "dW", "db"), first, again):
        if a is not None and not torch.equal(a, a2):
            raise AssertionError(f"{name}: two K3 launches on the same inputs differ in {what}")


def kernels_per_call(fn, runs: int = 3) -> float:
    """Device kernels (and memsets) launched per call of ``fn`` (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / runs


@contextlib.contextmanager
def bn_counted(what: str, *models):
    """BatchNorm's launches on the main path: ``BN_LAUNCHES`` set to 0, the
    calls of ``models``' BatchNorms seen by forward hooks while the block
    runs (the step's backward included), then the launches held to what
    those calls make (2 forward with the batch's statistics, 1 on the
    running ones; where the call takes a gradient, ``bn_bwd_reduce`` where
    the weight, the bias or, with the batch's statistics, x needs one and
    ``bn_bwd_dx`` where x does: 4 a training call, 3 a frozen one, 1 in
    eval) and every call counted as ``bn.kernel``, none as ``bn.plain``.
    Yields a dict that holds ``calls`` and ``launches`` after the block."""
    from text_segmentation_image_inpainting_tpu_torch.models.mobilenet_v2 import BatchNorm
    from text_segmentation_image_inpainting_tpu_torch.ops.kernels import batchnorm as kbn
    from text_segmentation_image_inpainting_tpu_torch.utils.profiling import counters

    seen = Counter()

    def hook(m, args, kwargs, y):
        batch = m.training and not kwargs.get("frozen", False)
        want = 2 if batch else 1
        if y.requires_grad:
            need_x = args[0].requires_grad
            want += int(m.weight.requires_grad or m.bias.requires_grad or (need_x and batch))
            want += int(need_x)
        seen[want] += 1

    hooks = [m.register_forward_hook(hook, with_kwargs=True)
             for model in models for m in model.modules() if isinstance(m, BatchNorm)]
    before = counters()
    kbn.BN_LAUNCHES = 0
    out = {}
    try:
        yield out
    finally:
        for h in hooks:
            h.remove()
    after = counters()
    calls = sum(seen.values())
    want = sum(k * n for k, n in seen.items())
    kern, plain = (after.get(f"bn.{r}", 0) - before.get(f"bn.{r}", 0) for r in ("kernel", "plain"))
    out.update(calls=calls, launches=kbn.BN_LAUNCHES)
    if calls == 0 or kbn.BN_LAUNCHES != want or kern != calls or plain:
        raise AssertionError(f"{what}: BatchNorm launched {kbn.BN_LAUNCHES} for {calls} calls "
                             f"(want {want}: calls by launches {dict(seen)}), bn.kernel {kern}, "
                             f"bn.plain {plain}")
    log(f"{what}: BatchNorm {calls} calls ({', '.join(f'{n} x {k}' for k, n in sorted(seen.items()))}"
        f" launches), {kbn.BN_LAUNCHES} launches, all bn.kernel")


@contextlib.contextmanager
def dw_counted(what: str, *models):
    """The depthwise kernel's launches on the main path: ``DW_LAUNCHES`` set
    to 0, the calls of ``models``' depthwise ``ConvBNAct``s seen by forward
    hooks while the block runs (the step's backward included), then the
    launches held to what those calls make (the forward; the flipped dx
    where the conv has stride 1 and its input takes a gradient) and every
    call counted as ``dw.kernel``, none as ``dw.plain``. Yields a dict that
    holds ``calls`` and ``launches`` after the block."""
    from text_segmentation_image_inpainting_tpu_torch.models.mobilenet_v2 import ConvBNAct
    from text_segmentation_image_inpainting_tpu_torch.ops.kernels import depthwise_conv as kdc
    from text_segmentation_image_inpainting_tpu_torch.utils.profiling import counters

    seen = Counter()

    def hook(m, args, y):
        seen[1 + int(m[0].stride[0] == 1 and y.requires_grad and args[0].requires_grad)] += 1

    hooks = [m.register_forward_hook(hook) for model in models for m in model.modules()
             if isinstance(m, ConvBNAct) and m[0].groups == m[0].in_channels
             == m[0].out_channels > 1]
    before = counters()
    kdc.DW_LAUNCHES = 0
    out = {}
    try:
        yield out
    finally:
        for h in hooks:
            h.remove()
    after = counters()
    calls = sum(seen.values())
    want = sum(k * n for k, n in seen.items())
    kern, plain = (after.get(f"dw.{r}", 0) - before.get(f"dw.{r}", 0) for r in ("kernel", "plain"))
    out.update(calls=calls, launches=kdc.DW_LAUNCHES)
    if calls == 0 or kdc.DW_LAUNCHES != want or kern != calls or plain:
        raise AssertionError(f"{what}: the depthwise kernel launched {kdc.DW_LAUNCHES} for "
                             f"{calls} depthwise convs (want {want}: calls by launches "
                             f"{dict(seen)}), dw.kernel {kern}, dw.plain {plain}")
    log(f"{what}: {calls} depthwise convs ({', '.join(f'{n} x {k}' for k, n in sorted(seen.items()))}"
        f" launches), {kdc.DW_LAUNCHES} launches, all dw.kernel")


def check_dw(name: str, x, w, s: int, d: int, pad: tuple, flip: bool = False) -> dict:
    """The depthwise kernel on x (N, H, W, C) with the f32 weight w (C, 1,
    k, k), launched twice (bit-identical), against the f64 conv of the same
    rounded operands (w cast to x's dtype; flipped with ``flip``). The
    tolerance: one rounding of the result to its dtype (2^-8 of |truth| in
    bf16, 0 in f32) plus the f32 sum of k*k terms in another order (2^-20
    of the sum of |terms| in bf16, 2^-19 in f32: nine adds at 2^-24 each,
    with room). Returns the kernel's output, its largest error and its
    largest distance to the plain version (``F.conv2d``)."""
    from text_segmentation_image_inpainting_tpu_torch.ops.kernels import depthwise_conv as kdc

    one = 2.0 ** -8 if x.dtype is torch.bfloat16 else 0.0
    acc = 2.0 ** -20 if x.dtype is torch.bfloat16 else 2.0 ** -19
    got = kdc.depthwise_conv2d_fused(x, w, s, d, pad, flip)
    again = kdc.depthwise_conv2d_fused(x, w, s, d, pad, flip)
    wq = w.to(x.dtype)
    plain = kdc.depthwise_conv2d_plain(x, wq.flip((2, 3)) if flip else wq, s, d, pad)
    wd = wq.double().flip((2, 3)) if flip else wq.double()
    xd = x.double().permute(0, 3, 1, 2)
    c = x.shape[-1]
    want = torch.nn.functional.conv2d(xd, wd, None, s, pad, d, c).permute(0, 2, 3, 1)
    absum = torch.nn.functional.conv2d(xd.abs(), wd.abs(), None, s, pad, d, c).permute(0, 2, 3, 1)
    torch.cuda.synchronize()
    excess = ((got.double() - want).abs() - one * want.abs() - acc * absum).max().item()
    err = (got.double() - want).abs().max().item()
    if excess > 0 or not torch.equal(got, again) or got.shape != want.shape:
        raise AssertionError(f"depthwise kernel {name}: max |d| to the f64 truth {err:.4g}, past "
                             f"its tolerance by {excess:.3g}, or two launches differ")
    return {"y": got, "err": err, "vs_plain": (got.float() - plain.float()).abs().max().item()}


def dw_phase(dev, smi: str) -> dict:
    """The depthwise kernel (``ops/kernels/depthwise_conv.py``) at every
    depthwise conv of the cells (``DW_SHAPES``), bf16 and f32: the forward
    and, at stride 1, the flipped dx (the data gradient) by ``check_dw``;
    in bf16 its device time beside cuDNN's forward and dgrad and the bound
    (x read and y written once, the weights once). Returns the kernel
    line's row: sums over one Xception train step's layers (38 forwards,
    36 dx)."""
    from text_segmentation_image_inpainting_tpu_torch.ops.kernels import depthwise_conv as kdc

    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    tot = {"ms": 0.0, "plain": 0.0, "lib": 0.0, "bound": 0.0, "err": 0.0, "dev": 0.0}
    per_model = Counter()
    for dt in (torch.bfloat16, torch.float32):
        for model, c, h, s, d, layers in DW_SHAPES:
            x = torch.randn((BATCH, h, h, c), generator=gen, device=dev).to(dt)
            w = torch.randn((c, 1, 3, 3), generator=gen, device=dev) * 0.3
            wq = w.to(dt)
            runs = [("fwd", x, s, False)]
            if s == 1:
                runs.append(("dx", torch.randn_like(x), 1, True))
            for what, inp, st, flip in runs:
                name = f"{model} C {c} {h}^2 s {st} d {d} x{layers} {what} {str(dt)[6:]}"
                res = check_dw(name, inp, w, st, d, (d, d), flip)
                line = (f"parity depthwise {name}: max |d| to the f64 truth {res['err']:.4g}, to "
                        f"the plain {res['vs_plain']:.4g}; two launches bit-identical")
                if dt is torch.bfloat16:
                    tot["err"] = max(tot["err"], res["err"])
                    fused = lambda: kdc.depthwise_conv2d_fused(inp, w, st, d, (d, d), flip)  # noqa: E731
                    xn, inn = x.permute(0, 3, 1, 2), inp.permute(0, 3, 1, 2)
                    if flip:
                        lib = lambda: torch.ops.aten.convolution_backward(  # noqa: E731
                            inn, xn, wq, None, [1, 1], [d, d], [d, d], False, [0, 0], c,
                            [True, False, False])
                    else:
                        lib = lambda: torch.nn.functional.conv2d(xn, wq, None, st, d, d, c)  # noqa: E731
                    k_ms, l_ms = device_ms(fused, "dw_conv"), device_ms(lib)
                    p_ms = cuda_ms(lambda: kdc.depthwise_conv2d_plain(inp, wq, st, d, (d, d)),
                                   iters=5)
                    e_ms = cuda_ms(fused, iters=10)
                    y = res["y"]
                    b_ms = (inp.numel() + y.numel() + w.numel()) * 2 / HBM_BYTES_PER_S * 1e3
                    plan = kdc.dw_plan(BATCH, y.shape[1], y.shape[2], c, 3, st, d, 2, sms)
                    line += (f"; device {k_ms * 1e3:.1f} us ({b_ms / k_ms:.1%} of the bound "
                             f"{b_ms * 1e3:.1f} us), events {e_ms * 1e3:.1f} us, cuDNN "
                             f"{'dgrad' if flip else 'forward'} {l_ms * 1e3:.1f} us; {plan}")
                    per_model[(model, what, "kernel")] += layers * k_ms
                    per_model[(model, what, "cuDNN")] += layers * l_ms
                    per_model[(model, what, "bound")] += layers * b_ms
                    if model == "xception":
                        for key, v in (("ms", e_ms), ("dev", k_ms), ("plain", p_ms),
                                       ("lib", l_ms), ("bound", b_ms)):
                            tot[key] += layers * v
                log(line)
                del res
            del x, w, wq, runs
        torch.cuda.empty_cache()
    for (model, what, kind), v in sorted(per_model.items()):
        log(f"time depthwise {model} {what} (a step's or batch's layers, device): {kind} "
            f"{v:.4f} ms")
    for line in ptxas_report(("dw_conv",)):
        log(f"  ptxas: {line}")
    log(f"depthwise kernel: one Xception step's 38 forwards and 36 dx: events {tot['ms']:.4f} ms, "
        f"device {tot['dev']:.4f} ms, plain {tot['plain']:.4f} ms, cuDNN {tot['lib']:.4f} ms, "
        f"bound {tot['bound']:.4f} ms  [{smi}]")
    return {
        "name": "DW dw_conv (forward, stride-1 dx flipped)", "route": "cuda", "source": CSRC_DWC,
        "replaces": "none: the JAX package leaves its depthwise convs to XLA",
        "launches": None, "max_abs_err": tot["err"], "ms": tot["ms"], "plain_ms": tot["plain"],
        "bound_ms": tot["bound"], "bound_by": "bytes", "library_ms": tot["lib"],
    }


def name_library_layers(step, state, batch, label: str) -> None:
    """One profiled step (record_shapes) on the depthwise kernel and one on
    the route before it (every depthwise conv on cuDNN: ``in_scope`` False):
    the device time of cuDNN's grouped kernels by name, and the input shapes
    of the convolution ops that launched them."""
    from torch.profiler import ProfilerActivity, profile

    from text_segmentation_image_inpainting_tpu_torch.ops.kernels import depthwise_conv as kdc

    real = kdc.in_scope
    for route in ("cuDNN", "kernel"):
        if route == "cuDNN":
            kdc.in_scope = lambda x, k, stride: False
        try:
            step(state, batch)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                         record_shapes=True) as prof:
                step(state, batch)
                torch.cuda.synchronize()
        finally:
            kdc.in_scope = real
        rows = Counter()
        for e in prof.events():  # a kernel is listed under the op that launched it
            shapes = tuple(tuple(v) for v in (e.input_shapes or [])[:2] if v)
            for k in e.kernels:
                name = k.name.split("(")[0].split("<")[0].split("::")[-1]
                if any(f in k.name for f in ("dgrad2d_c1_k1", "wgrad_alg1", "grouped_direct")):
                    rows[(name, e.name, shapes)] += k.duration / 1e3
        by_name = Counter()
        for (name, op, shapes), ms in sorted(rows.items(), key=lambda r: -r[1]):
            by_name[name] += ms
            log(f"{label}, {route} route: {name} {ms:.3f} ms under {op} of {shapes}")
        log(f"{label}, {route} route: " + ", ".join(f"{n} {v:.3f} ms" for n, v in by_name.items()))


def bn_phase(dev, smi: str) -> dict:
    """BatchNorm's kernels (``ops/kernels/batchnorm.py``) at ``BN_SHAPES``,
    bf16, ReLU inside: in training (batch statistics, forward and
    backward: 4 launches) and in eval (running statistics, 1 launch), each
    against the plain chain (y and dx one bf16 step plus 1e-3 of max;
    dweight, dbias and the running statistics 2^-22 plus 1e-5 of max) and
    twice bit-identical. Times: CUDA-event medians of the kernels' path
    (the module as the models call it) and of the plain chain, the
    kernels' device time (profiler), the bound (the bytes the function
    needs at 3.35 TB/s: ``BN_FN_BYTES`` an element in training, 4 in eval;
    beside it the two-pass design's ``BN_PASS_BYTES``) and, as a yardstick
    the port never calls, one cuDNN ``F.batch_norm`` on the NCHW view
    (without the ReLU). Returns the kernels line's row."""
    import torch.nn.functional as F

    from text_segmentation_image_inpainting_tpu_torch.models.mobilenet_v2 import BatchNorm
    from text_segmentation_image_inpainting_tpu_torch.ops.kernels import batchnorm as kbn
    from text_segmentation_image_inpainting_tpu_torch.utils.profiling import counters

    gen = torch.Generator(device=dev).manual_seed(SEED)
    tot = {"ms": 0.0, "plain": 0.0, "lib": 0.0, "bound": 0.0, "err": 0.0}
    launches = {}
    for name, shape in BN_SHAPES:
        c = shape[-1]
        m = BatchNorm(c).to(dev)
        with torch.no_grad():
            m.weight.copy_(1 + 0.3 * torch.randn(c, generator=gen, device=dev))
            m.bias.copy_(0.5 * torch.randn(c, generator=gen, device=dev))
        x = (torch.randn(shape, generator=gen, device=dev) * 1.7 + 0.3).to(torch.bfloat16)
        dy = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        state = {k: v.clone() for k, v in m.state_dict().items()}

        def fused(train=True):
            m.weight.grad = m.bias.grad = None
            if not train:
                with torch.no_grad():
                    return (m(x, act="relu"),)
            xr = x.clone().requires_grad_()
            y = m(xr, act="relu")
            y.backward(dy)
            return y, xr.grad, m.weight.grad, m.bias.grad

        def plain(train=True):
            m.weight.grad = m.bias.grad = None
            xr = x.clone().requires_grad_(train)
            with torch.set_grad_enabled(train):
                y = kbn.batchnorm_plain(xr, m.weight, m.bias, m.running_mean, m.running_var,
                                        m.num_batches_tracked, batch_stats=m.training,
                                        eps=m.eps, act="relu")
            if not train:
                return (y,)
            y.backward(dy)
            return y, xr.grad, m.weight.grad, m.bias.grad

        xn = x.permute(0, 3, 1, 2)
        rm, rv = m.running_mean.clone(), m.running_var.clone()

        def library(train=True):
            if not train:
                return F.batch_norm(xn, rm, rv, m.weight, m.bias, False, 0.1, m.eps)
            xr = xn.detach().requires_grad_()
            y = F.batch_norm(xr, rm, rv, m.weight, m.bias, True, 0.1, m.eps)
            y.backward(dy.permute(0, 3, 1, 2))
            return y

        for mode in ("train", "eval"):
            train = mode == "train"
            m.load_state_dict(state)
            m.train(train)
            n0, k0 = kbn.BN_LAUNCHES, counters().get("bn.kernel", 0)
            got = [t.detach().clone() for t in fused(train)]
            torch.cuda.synchronize()
            launches[(name, mode)] = kbn.BN_LAUNCHES - n0
            if launches[(name, mode)] != (4 if train else 1):
                raise AssertionError(f"BN {name} {mode}: {launches[(name, mode)]} launches")
            if counters().get("bn.kernel", 0) - k0 != 1:
                raise AssertionError(f"BN {name} {mode}: bn.kernel did not count the call")
            moved = {k: v.clone() for k, v in m.state_dict().items()}
            m.load_state_dict(state)
            want = plain(train)
            for k, v in m.state_dict().items():
                if not torch.allclose(moved[k].double(), v.double(), rtol=2.0 ** -22, atol=1e-6):
                    raise AssertionError(f"BN {name} {mode}: {k} differs from the plain chain")
            errs = []
            for what, g, w in zip(("y", "dx", "dweight", "dbias"), got, want):
                g, w = g.float(), w.detach().float()
                bf = what in ("y", "dx")
                step, floor = (2.0 ** -7, 1e-3) if bf else (2.0 ** -22, 1e-5)
                err = (g - w).abs()
                if not (err <= step * w.abs() + floor * w.abs().max() + 1e-6).all():
                    raise AssertionError(f"BN {name} {mode}: {what} off by up to "
                                         f"{err.max().item():.4g} (max |want| "
                                         f"{w.abs().max().item():.4g})")
                errs.append(err.max().item())
            m.load_state_dict(state)
            again = [t.detach().clone() for t in fused(train)]
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"BN {name} {mode}: two launches differ")
            del got, again, want
            # times (the running statistics move with every training call)
            elems = x.numel()
            b_ms = elems * (BN_FN_BYTES if train else 4) / HBM_BYTES_PER_S * 1e3
            b2_ms = elems * (BN_PASS_BYTES if train else 4) / HBM_BYTES_PER_S * 1e3
            k1, p1 = cuda_ms(lambda: fused(train)), cuda_ms(lambda: plain(train))
            k2, p2 = cuda_ms(lambda: fused(train)), cuda_ms(lambda: plain(train))
            lib = cuda_ms(lambda: library(train))
            dev_ms = device_ms(lambda: fused(train), "bn_")
            per = kernel_ms(lambda: fused(train))
            k_ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
            log(f"time BN {name} {tuple(shape)} {mode}: kernels {k_ms:.4f} ms (device "
                f"{dev_ms:.4f} ms, {b_ms / dev_ms:.1%} of the bound, {b2_ms / dev_ms:.1%} of the "
                f"two-pass design's; "
                + ", ".join(f"{k} {v:.4f}" for k, v in sorted(per.items()) if "bn_" in k)
                + f"), bound {b_ms:.4f} ms (bytes the function needs; the two-pass design's "
                f"{b2_ms:.4f} ms), plain chain {p_ms:.4f} ms, cuDNN "
                f"F.batch_norm {lib:.4f} ms; max err y/dx/dw/db "
                + "/".join(f"{e:.3g}" for e in errs))
            tot["ms"] += k_ms
            tot["plain"] += p_ms
            tot["lib"] += lib
            tot["bound"] += b_ms
            tot["err"] = max(tot["err"], errs[0])
        del x, dy, xn, m
        torch.cuda.empty_cache()
    for line in ptxas_report(("bn_stats", "bn_apply", "bn_bwd_reduce", "bn_bwd_dx")):
        log(f"  ptxas: {line}")
    log(f"BN: {len(BN_SHAPES)} shape(s) in train and eval; ms, plain_ms, library_ms and "
        f"bound_ms (the function's bytes) are sums over them; launches per call {launches}; "
        f"the row's launches from the first seg train step; {smi}")
    return {
        "name": "BN bn_stats, bn_apply, bn_bwd_reduce, bn_bwd_dx", "route": "cuda",
        "source": CSRC_BN, "replaces": "none: flax's BatchNorm runs under XLA",
        "launches": None, "max_abs_err": tot["err"], "ms": tot["ms"],
        "plain_ms": tot["plain"], "bound_ms": tot["bound"], "bound_by": "bytes",
        "library_ms": tot["lib"],
    }


def train_phase(dev, rng, cases) -> dict:
    """Phase 5: K3, K4 and K5 against their plain versions at the train
    shapes, then three full-width train steps (the third with
    ``freeze_bn``), each checked. Returns what the timing phase needs."""
    import dataclasses

    from text_segmentation_image_inpainting_tpu_torch.losses.inpainting import (
        InpaintLossConfig,
        make_vgg,
    )
    from text_segmentation_image_inpainting_tpu_torch.models import InpaintUNet
    from text_segmentation_image_inpainting_tpu_torch.models.mobilenet_v2 import BatchNorm
    from text_segmentation_image_inpainting_tpu_torch.ops.conv import conv2d
    from text_segmentation_image_inpainting_tpu_torch.ops.kernels import partial_conv as kpc
    from text_segmentation_image_inpainting_tpu_torch.ops.kernels import vgg_stem as kvs
    from text_segmentation_image_inpainting_tpu_torch.train.config import InpaintTrainConfig
    from text_segmentation_image_inpainting_tpu_torch.train.inpaint import make_inpaint_train_step
    from text_segmentation_image_inpainting_tpu_torch.train.state import create_train_state

    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    k3, err3 = [], 0.0
    for _, name, x, mask, w, b, kw, _ in cases:
        g = torch.randn((*x.shape[:3], w.shape[0]), generator=gen, device=dev).to(bf)
        rel, err = check_grads(f"K3 {name}", x, mask, w, b, g, kw)
        check_k3_valid_and_repeats(f"K3 {name}", x, mask, w, b, g, kw)
        log(f"parity K3 {name}: dx, dW{', db' if b is not None else ''} against autograd of the "
            f"plain version in f32, largest relative L2 {rel:.3g}, max |d| {err:.4g}; valid == "
            f"M' bit for bit; two launches bit-identical")
        k3.append((name, x, mask, w, b, kw, g))
        err3 = max(err3, err)

    torch.manual_seed(SEED)  # the VGG trunk's default init
    loss_cfg = InpaintLossConfig(vgg_dtype="bfloat16", fused_stem=True)
    vgg = make_vgg(loss_cfg).to(dev)
    w0, b0 = vgg.features[0].weight, vgg.features[0].bias
    w1, b1 = vgg.features[2].weight, vgg.features[2].bias
    pages = torch.from_numpy(rng.uniform(0.0, 1.0, (BATCH, PAGE, PAGE, 3)).astype(np.float32))
    pages = pages.to(dev)
    holes = torch.from_numpy(hole_mask(rng, BATCH, PAGE, PAGE)[..., None]).to(dev)
    # the stem's input in the step: [out, comp], 2N pages, normalised, bf16
    xs = vgg.normalize_input(torch.cat([pages, pages * holes])).to(bf).contiguous()
    gs = torch.randn((2 * BATCH, PAGE // 2, PAGE // 2, 64), generator=gen, device=dev).to(bf)
    res = check_stem_dx("K4 train shape", xs, gs, w0, b0, w1, b1)
    check_stem_dx_repeats("K4 train shape", xs, gs, w0, b0, w1, b1)
    log(f"parity K4 x {tuple(xs.shape)} g {tuple(gs.shape)}: relative L2 to the f32 plain "
        f"{res['rel']:.4g} (bf16 cuDNN autograd {res['rel_cudnn']:.4g}), max |d| "
        f"{res['max']:.4g} (cuDNN {res['max_cudnn']:.4g}); two launches bit-identical")
    z0 = conv2d(xs, w0, b0, padding=1).contiguous()
    # the step launches K5 on the ground-truth branch alone: conv0 of the
    # first BATCH pages of xs
    z0_gt = z0[:BATCH]
    err5 = {}  # by pages
    for z in (z0_gt, z0):
        err5[len(z)] = check_stem_pool(f"K5 {tuple(z.shape)}", z, w1, b1)
        log(f"parity K5 z0 {tuple(z.shape)}: max |d| {err5[len(z)]:.4g}, two launches "
            f"bit-identical")
    sgen = torch.Generator(device=dev).manual_seed(SEED + 3)
    for m, h, w in STEM_EXTRA:
        ws = stem_weights(sgen, dev)
        x = torch.randn((m, h, w, 3), generator=sgen, device=dev).to(bf)
        g = torch.randn((m, h // 2, w // 2, 64), generator=sgen, device=dev).to(bf)
        r = check_stem_dx(f"K4 {m}x{h}x{w}", x, g, *ws, compare_max=False)
        check_stem_dx_repeats(f"K4 {m}x{h}x{w}", x, g, *ws)
        z = torch.randn((m, h, w, 64), generator=sgen, device=dev).to(bf)
        e = check_stem_pool(f"K5 {m}x{h}x{w}", z, ws[2], ws[3])
        log(f"parity K4/K5 {m}x{h}x{w} ({kvs.stem_tiles(m, h, w)} tiles): K4 relative L2 "
            f"{r['rel']:.4g} (cuDNN {r['rel_cudnn']:.4g}); K5 max |d| {e:.4g}")

    model = InpaintUNet(depth=8, dtype=bf).init_weights(torch.Generator().manual_seed(SEED)).to(dev)
    cfg = InpaintTrainConfig(loss=loss_cfg)
    state = create_train_state(model, cfg.optimizer)
    steps = {f: make_inpaint_train_step(model, dataclasses.replace(cfg, freeze_bn=f), vgg)
             for f in (False, True)}
    batch = {"image": pages, "mask": holes}
    grads = {}

    def keep_grads(opt, args, kwargs):
        for name, p in model.named_parameters():
            grads[name] = (p.grad is not None and bool(torch.isfinite(p.grad).all()),
                           0.0 if p.grad is None else p.grad.abs().max().item())

    hook = state.optimizer.register_step_pre_hook(keep_grads)
    enc_bns = [m for m in model.enc_bns if isinstance(m, BatchNorm)]
    stats = lambda bns: [torch.cat([m.running_mean, m.running_var]).clone() for m in bns]  # noqa: E731
    first = first_bn = None
    for i, freeze in enumerate((False, False, True)):
        params = {n: p.detach().clone() for n, p in model.named_parameters()}
        enc0, dec0 = stats(enc_bns), stats(model.dec_bns)
        kpc.K1_LAUNCHES = kpc.K2_LAUNCHES = kpc.K3_LAUNCHES = 0
        kvs.K4_LAUNCHES = kvs.K5_LAUNCHES = 0
        with bn_counted(f"train step {i} (freeze_bn={freeze})", model) as bn:
            state, terms = steps[freeze](state, batch)
        torch.cuda.synchronize()
        first_bn = first_bn or bn
        got = {"K1": kpc.K1_LAUNCHES, "K2": kpc.K2_LAUNCHES, "K3": kpc.K3_LAUNCHES,
               "K4": kvs.K4_LAUNCHES, "K5": kvs.K5_LAUNCHES}
        first = first or got
        if got != {"K1": 7, "K2": 1, "K3": 8, "K4": 1, "K5": 1}:
            raise AssertionError(f"train step {i} launched {got}, want K1 7, K2 1, K3 8, K4 1, "
                                 f"K5 1")
        bad = [k for k, v in terms.items() if not torch.isfinite(v)]
        not_finite = [n for n, (fin, _) in grads.items() if not fin]
        zero = [n for n, (_, mx) in grads.items() if n.startswith(("dec_", "head")) and mx == 0]
        still = [n for n, p in model.named_parameters()
                 if grads[n][1] > 0 and torch.equal(p, params[n])]
        dec_same = [j for j, (a, b) in enumerate(zip(dec0, stats(model.dec_bns))) if torch.equal(a, b)]
        enc_moved = [j for j, (a, b) in enumerate(zip(enc0, stats(enc_bns))) if not torch.equal(a, b)]
        if bad or not_finite or zero or still or dec_same or (freeze and enc_moved) or (
                not freeze and len(enc_moved) != len(enc_bns)):
            raise AssertionError(f"train step {i}: non-finite terms {bad}, grads {not_finite}, "
                                 f"zero decoder/head grads {zero}, unmoved params {still}, "
                                 f"unmoved decoder BN {dec_same}, encoder BN moved {enc_moved}")
        log(f"train step {i} (freeze_bn={freeze}): launches {got}; terms "
            + ", ".join(f"{k} {v.item():.5g}" for k, v in terms.items())
            + f"; {len(grads)} grads finite, decoder/head nonzero, params moved, decoder BN "
            f"moved, encoder BN {'unchanged' if freeze else 'moved'}")
    hook.remove()
    return {"launches": first, "bn": first_bn, "err": {"K3": err3, "K4": res["max"], "K5": err5[BATCH]}, "k3": k3,
            "stem": (xs, gs, w0, b0, w1, b1, z0, z0_gt), "step": steps[False], "state": state,
            "batch": batch, "vgg": vgg, "loss_cfg": loss_cfg}


def time_train(tr) -> dict:
    """Phase 6, train part: K3 per shape, K4, K5 and the train step.
    Returns {kernel: {ms, plain, lib, bound, by}} for K3, K4 and K5."""
    from text_segmentation_image_inpainting_tpu_torch.ops.kernels import partial_conv as kpc
    from text_segmentation_image_inpainting_tpu_torch.ops.kernels import vgg_stem as kvs
    from text_segmentation_image_inpainting_tpu_torch.ops.partial_conv import (
        _partial_conv2d_plain,
        apply_mask,
    )

    bf = torch.bfloat16
    # K3, its plain version, autograd of the plain f32 forward, of the bf16
    # twin, cuDNN's backward alone, the bound, device kernels per call
    tot = [0.0] * 7
    by_kind = {"operations": 0.0, "bytes": 0.0}  # the bound, split by what sets it per layer
    for name, x, mask, w, b, kw, g in tr["k3"]:
        wb = w.to(bf)
        bb = None if b is None else b.to(bf)
        # the yardstick: cuDNN's dgrad and wgrad of the bf16 product in one
        # call, on x already masked and g as the scaled cotangent would be
        xm = apply_mask(x, mask, kw["group_sizes"]).permute(0, 3, 1, 2)
        pad = list(kw["padding"])
        lib = lambda: torch.ops.aten.convolution_backward(  # noqa: E731
            g.permute(0, 3, 1, 2), xm, wb, None, [1, 1], pad, [1, 1], False, [0, 0], 1,
            [True, True, False])
        b_ms, b_by = bound(*pconv_bwd_work(x, mask, w, g))

        def grad_of(fn):
            """Autograd of ``fn(x, w, b)`` with the graph built once."""
            leaves = [t.detach().requires_grad_(True) for t in (x, wb, bb) if t is not None]
            y, _ = fn(leaves[0], leaves[1], leaves[2] if bb is not None else None)
            return lambda: torch.autograd.grad(y, leaves, g, retain_graph=True)

        kern = lambda: kpc.partial_conv2d_backward(  # noqa: E731
            g, x, mask, wb, bb, kw["group_sizes"], kw["padding"])
        ref = lambda: kpc.partial_conv2d_backward_reference(  # noqa: E731
            g, x, mask, wb, bb, kw["group_sizes"], kw["padding"])
        plain = grad_of(lambda xx, ww, bbb: kpc.partial_conv2d_reference(xx, mask, ww, bbb, **kw))
        twin = grad_of(lambda xx, ww, bbb: _partial_conv2d_plain(
            xx, mask, ww, bbb, kw["group_sizes"], (1, 1), kw["padding"], (1, 1)))
        p1, k1, k2, p2 = cuda_ms(plain), cuda_ms(kern), cuda_ms(kern), cuda_ms(plain)
        t_twin, t_lib, t_ref = cuda_ms(twin), cuda_ms(lib), cuda_ms(ref)
        k_ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
        dev_ms, n_kern = device_ms(kern), kernels_per_call(kern)
        log(f"time K3 {name}: backward {k_ms:.4f} ms (device time {dev_ms:.4f} ms in "
            f"{n_kern:.0f} kernels), its plain version {t_ref:.4f} ms, autograd of the plain f32 "
            f"forward {p_ms:.4f} ms, autograd of the bf16 cuDNN twin {t_twin:.4f} ms, cuDNN's "
            f"bf16 backward alone {t_lib:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
        for i, t in enumerate((k_ms, t_ref, p_ms, t_twin, t_lib, b_ms, n_kern)):
            tot[i] += t
        by_kind[b_by] += b_ms
    del xm, lib  # the head's masked x (281 MB) would count in the step's peak below
    log(f"time K3 (sum over the 8 shapes, one U-Net backward): {tot[0]:.4f} ms in "
        f"{tot[6]:.0f} device kernels, its plain version {tot[1]:.4f} ms, autograd of the plain "
        f"f32 forward {tot[2]:.4f} ms, of the bf16 cuDNN twin {tot[3]:.4f} ms, cuDNN's bf16 "
        f"backward alone {tot[4]:.4f} ms, bound {tot[5]:.4f} ms (per layer the larger of "
        f"operations and bytes)")
    k3_times = {"ms": tot[0], "plain": tot[1], "lib": tot[4], "bound": tot[5],
                "by": max(by_kind, key=by_kind.get)}  # what sets most of the summed bound

    xs, gs, w0, b0, w1, b1, z0, z0_gt = tr["stem"]
    rb = [t.to(bf).float() for t in (w0, b0, w1, b1)]
    xf, gf = xs.float(), gs.float()
    kern = lambda: kvs.stem_dx(xs, gs, w0, b0, w1, b1)  # noqa: E731
    plain = lambda: kvs.stem_dx_reference(xs, gs, w0, b0, w1, b1)  # noqa: E731
    xr = xs.detach().requires_grad_(True)
    out = kvs.stem_forward(xr, w0, b0, w1, b1, bf)
    bwd_only = lambda: torch.autograd.grad(out, xr, gs, retain_graph=True)  # noqa: E731
    p1, k1, k2, p2 = cuda_ms(plain), cuda_ms(kern), cuda_ms(kern), cuda_ms(plain)
    t_bwd = cuda_ms(bwd_only)
    t_f32 = cuda_ms(lambda: kvs.stem_dx_reference(xf, gf, *rb), iters=5, warmup=1)
    k4 = {"ms": (k1 + k2) / 2, "plain": (p1 + p2) / 2, "lib": t_bwd}
    dev4 = device_ms(kern, "stem_dx_kernel")
    m, h, w = xs.shape[:3]
    px = m * h * w
    flop = 2.0 * px * 64 * 64 * 9 * 2
    # what the tensor cores execute, per 16x16 tile (csrc/vgg_stem.cu): conv1
    # forward over 2 x 224 pixel rows and its dgrad over 2 x 200, conv0 over
    # 496 rows with K 32, the last dgrad's product over 400 rows with M 64
    done = 2.0 * kvs.stem_tiles(m, h, w) * (64 * 64 * 9 * (448 + 400) + 496 * 64 * 32
                                            + 64 * 400 * 64)
    # the bound counts all four products: conv1's forward and dgrad (flop)
    # and conv0's, 2 * 2 * px * 64 * 27; bytes: x, g and the weights read
    # once, dx (f32) written once
    k4["bound"], k4["by"] = bound(flop + 4.0 * px * 64 * 27,
                                  2.0 * (xs.numel() + gs.numel() + w0.numel() + w1.numel())
                                  + 4.0 * xs.numel())
    log(f"time K4 x {tuple(xs.shape)}: kernel {k4['ms']:.4f} ms, device time {dev4:.4f} ms "
        f"({flop / dev4 / 1e9:.1f} TFLOP/s of the two useful 64->64 products; "
        f"{done / dev4 / 1e9:.1f} TFLOP/s of the {done / 1e12:.4f} TFLOP executed with the "
        f"halos), plain bf16 cuDNN forward+backward "
        f"{k4['plain']:.4f} ms, its backward alone {t_bwd:.4f} ms, plain f32 forward+backward "
        f"{t_f32:.4f} ms, bound {k4['bound']:.4f} ms ({k4['by']})")
    del out, xr
    w1b = w1.to(bf).contiguous(memory_format=torch.channels_last)
    k5 = {}  # by pages
    for z in (z0_gt, z0):
        kern = lambda: kvs.stem_pool(z, w1, b1)  # noqa: E731
        plain = lambda: kvs.stem_pool_reference(z, w1, b1)  # noqa: E731
        p1, k1, k2, p2 = cuda_ms(plain), cuda_ms(kern), cuda_ms(kern), cuda_ms(plain)
        zn = z.permute(0, 3, 1, 2)  # channels-last view
        t_conv = cuda_ms(lambda: torch.nn.functional.conv2d(zn, w1b, padding=1))
        t = {"ms": (k1 + k2) / 2, "plain": (p1 + p2) / 2, "lib": t_conv}
        dev5 = device_ms(kern, "stem_pool_kernel")
        m, h, w = z.shape[:3]
        flop = 2.0 * m * h * w * 64 * 64 * 9
        done = 2.0 * kvs.stem_tiles(m, h, w) * 288 * 64 * 64 * 9  # 2 x 144 rows per tile
        t["bound"], t["by"] = bound(flop, 2.0 * (z.numel() * 5 / 4 + w1.numel()))
        log(f"time K5 z0 {tuple(z.shape)}: kernel {t['ms']:.4f} ms, device time {dev5:.4f} ms "
            f"({flop / dev5 / 1e9:.1f} TFLOP/s useful, {done / dev5 / 1e9:.1f} TFLOP/s executed "
            f"with the halo), plain "
            f"bf16 cuDNN {t['plain']:.4f} ms, cuDNN bf16 conv1 alone {t_conv:.4f} ms, bound "
            f"{t['bound']:.4f} ms ({t['by']})" + ("; the step's shape" if z is z0_gt else ""))
        k5[len(z)] = t

    step, state, batch = tr["step"], tr["state"], tr["batch"]
    # the peak counts what is held before the step too: the model, Adam's
    # state, the batch, and this script's own test tensors (``before``)
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step_ms = cuda_ms(lambda: step(state, batch), iters=TRAIN_ITERS, warmup=2)
    peak = torch.cuda.max_memory_allocated()
    log(f"time train step: {step_ms:.3f} ms per batch of {BATCH} (median of {TRAIN_ITERS}) = "
        f"{BATCH / step_ms * 1e3:.2f} training pages/s; peak device memory "
        f"{peak / 2**30:.2f} GiB, of which {before / 2**30:.3f} GiB held before the step "
        f"({(peak - before) / 2**30:.3f} GiB above it)")
    busy = profile_run(lambda: step(state, batch), "train step", runs=2)
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tools"))
    from host_syncs import blocking_calls

    calls = blocking_calls(lambda: step(state, batch))
    log(f"inpaint step: blocking host calls in one profiled step: {sum(calls.values())} "
        f"{dict(calls)}")
    if calls:
        raise AssertionError(f"the inpaint step blocks the host: {dict(calls)}")
    log(f"inpaint step: device busy {busy:.3f} ms per step, peak device memory "
        f"{peak / 2**30:.2f} GiB")
    return {"K3": k3_times, "K4": k4, "K5": k5[BATCH]}  # K5 at the step's shape


def seg_phase(dev, rng) -> dict:
    """Phase 6: K6 against the f64 truth at the segmenter's 5 shapes and
    the ragged cases; one full-width backward with the flag on against
    the flag off, per depthwise layer; then three seg train steps (the
    third with ``freeze_encoder``), each checked. Returns what the timing
    phase needs."""
    from text_segmentation_image_inpainting_tpu_torch.losses.segmentation import (
        segmentation_loss,
    )
    from text_segmentation_image_inpainting_tpu_torch.models import TextSegmenter
    from text_segmentation_image_inpainting_tpu_torch.models.mobilenet_v2 import (
        BatchNorm,
        ConvBNAct,
    )
    from text_segmentation_image_inpainting_tpu_torch.ops import depthwise
    from text_segmentation_image_inpainting_tpu_torch.ops.kernels import depthwise_wgrad as kdw
    from text_segmentation_image_inpainting_tpu_torch.train.config import SegTrainConfig
    from text_segmentation_image_inpainting_tpu_torch.train.seg import make_seg_train_step
    from text_segmentation_image_inpainting_tpu_torch.train.state import (
        create_train_state,
        freeze_mask_for,
    )

    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    k6 = []
    for name, h, c, d, count in SEG_SHAPES:
        x = torch.randn((BATCH, h, h, c), generator=gen, device=dev).to(bf)
        dy = torch.randn((BATCH, h, h, c), generator=gen, device=dev).to(bf)
        res = check_wgrad(f"K6 {name}", x, dy, 3, d)
        log(f"parity K6 {name}: x, dy {tuple(x.shape)} bf16, d {d} -> dW (3, 3, 1, {c}) f32; max "
            f"|d| to the f64 truth {res['K6']:.4g} (plain {res['plain']:.4g}), to the plain "
            f"{res['vs_plain']:.4g}; two launches bit-identical; "
            f"{kdw.k6_plan(*x.shape, 3, d, x.element_size(), kdw._sm_count(0))}")
        k6.append((name, x, dy, d, count, res))
    for name, n, h, w, c, k, d, dt in K6_RAGGED:
        x = torch.randn((n, h, w, c), generator=gen, device=dev).to(dt)
        dy = torch.randn((n, h, w, c), generator=gen, device=dev).to(dt)
        res = check_wgrad(f"K6 {name}", x, dy, k, d)
        log(f"parity K6 {name}: ({n}, {h}, {w}, {c}) {str(dt)[6:]}, k {k}, d {d}: max |d| to the "
            f"f64 truth {res['K6']:.4g} (plain {res['plain']:.4g}); two launches bit-identical")

    cfg = SegTrainConfig()  # run_seg's defaults: 512^2, batch 8, bf16, Adam 2e-4, pos_weight 3
    model = TextSegmenter(dtype=bf).init_weights(torch.Generator().manual_seed(SEED)).to(dev)
    pages = rng.uniform(0.6, 1.0, (BATCH, PAGE, PAGE, 3)).astype(np.float32)
    masks = text_targets(rng, BATCH, PAGE, PAGE)
    pages = np.where(masks > 0, rng.uniform(0.0, 0.3, pages.shape), pages).astype(np.float32)
    batch = {"image": torch.from_numpy(pages).to(dev), "mask": torch.from_numpy(masks).to(dev)}
    depthwise.USE_CUSTOM_WGRAD = True
    dw_layers = [(n, m[0]) for n, m in model.named_modules() if isinstance(m, ConvBNAct)
                 and depthwise.supports(m[0].out_channels, m[0].groups, m[0].in_channels,
                                        m[0].kernel_size[0], m[0].stride[0])]
    if len(dw_layers) != 14:
        raise AssertionError(f"{len(dw_layers)} depthwise layers in K6's scope, want 14")

    real_wgrad, caught = depthwise.depthwise_wgrad, []

    def catch(x, dy, k, d):
        """Keep each K6 call's real inputs and output (for the checks below)."""
        dw = real_wgrad(x, dy, k, d)
        caught.append((x, dy.contiguous(), k, d, dw))
        return dw

    def dw_grads(flag: bool):
        depthwise.USE_CUSTOM_WGRAD = flag
        model.zero_grad(set_to_none=True)
        kdw.K6_LAUNCHES = 0
        logits = model(batch["image"])
        segmentation_loss(logits, batch["mask"], pos_weight=cfg.pos_weight)[0].backward()
        torch.cuda.synchronize()
        return kdw.K6_LAUNCHES, {n: conv.weight.grad.clone() for n, conv in dw_layers}

    real_plain = kdw.depthwise_wgrad_reference

    def no_plain(x, *args):
        """On the main path a CUDA tensor must launch K6, never reach its plain version."""
        if x.is_cuda:
            raise AssertionError("a CUDA tensor reached K6's plain version on the main path")
        return real_plain(x, *args)

    model.train()
    depthwise.depthwise_wgrad, kdw.depthwise_wgrad_reference = catch, no_plain
    try:
        n_on, on = dw_grads(True)
    finally:
        depthwise.depthwise_wgrad, kdw.depthwise_wgrad_reference = real_wgrad, real_plain
    n_off, off = dw_grads(False)
    _, off2 = dw_grads(False)
    model.zero_grad(set_to_none=True)
    if (n_on, n_off, len(caught)) != (14, 0, 14):
        raise AssertionError(f"one backward launched K6 {n_on} times with the flag on and "
                             f"{n_off} with it off, want 14 and 0")
    # (1) each layer's K6 dW on the backward's own x and dy: against the f64
    # truth (check_wgrad), and against cuDNN's bf16 wgrad of the same x and
    # dy, which must agree to relative L2 1e-2: both end in one bf16 rounding
    own = {}
    for (name, conv), (x, dy, k, d, dw) in zip(reversed(dw_layers), caught):
        # autograd reaches the layers in the reverse of their forward order
        if (x.shape[-1], d) != (conv.out_channels, conv.dilation[0]):
            raise AssertionError(f"{name}: caught a K6 call on C {x.shape[-1]}, d {d}")
        res = check_wgrad(f"K6 in the backward, {name}", x, dy, k, d)
        c = x.shape[-1]
        cudnn = torch.ops.aten.convolution_backward(
            dy.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2), torch.zeros((c, 1, k, k), dtype=bf,
                                                                       device=dev),
            None, [1, 1], [d, d], [d, d], False, [0, 0], c, [False, True, False])[1]
        own[name] = rel_l2(dw.permute(3, 2, 0, 1).to(bf), cudnn.float())
        if own[name] > 1e-2:
            raise AssertionError(f"{name}: K6 against cuDNN's bf16 wgrad on the same x, dy: "
                                 f"relative L2 {own[name]:.3g}")
        log(f"grads {name}: x, dy {tuple(x.shape)}, d {d}: K6 to the f64 truth max |d| "
            f"{res['K6']:.4g}; to cuDNN's bf16 wgrad of the same x, dy, relative L2 "
            f"{own[name]:.3g}")
    del caught
    # (2) the whole backward with the flag on against the flag off. Both
    # take dx from the depthwise kernel, and each layer's own dW agrees to about
    # 3e-4 in (1); but the two backwards also differ upstream of each layer,
    # as two flag-off backwards of the same batch do (printed beside), and
    # BatchNorm's backward amplifies that toward the input. The card put
    # flag on against off at 0.004 to 0.020 per layer, with the dx as the
    # flipped-kernel conv and as the dgrad alike (NVIDIA H100 80GB HBM3,
    # 700 W); 4e-2 leaves twice that and still fails a wrong tap or layout
    # (about 100%).
    rels = {n: rel_l2(on[n], off[n].float()) for n in on}
    noise = {n: rel_l2(off2[n], off[n].float()) for n in on}
    worst = max(rels, key=rels.get)
    if rels[worst] > 4e-2 or not all(torch.isfinite(g).all() for g in on.values()):
        raise AssertionError(f"dW with the flag on against off: relative L2 {rels}")
    log("grads: one backward at 512^2, batch 8, bf16: dW of the 14 layers, flag on (K6, the "
        "kernel's dx) against flag off (cuDNN wgrad, the kernel's dx), relative L2 by layer "
        "from the output: "
        + ", ".join(f"{rels[n]:.3g}" for n, _ in reversed(dw_layers))
        + "; two flag-off backwards against each other: "
        + ", ".join(f"{noise[n]:.3g}" for n, _ in reversed(dw_layers)))

    depthwise.USE_CUSTOM_WGRAD = True
    step = make_seg_train_step(model, cfg)
    states = {False: create_train_state(model, cfg.optimizer),
              True: create_train_state(model, cfg.optimizer,
                                       frozen=freeze_mask_for(model, "encoder"))}
    grads = {}

    def keep_grads(opt, args, kwargs):
        for name, p in model.named_parameters():
            grads[name] = (p.grad is not None and bool(torch.isfinite(p.grad).all()),
                           0.0 if p.grad is None else p.grad.abs().max().item())

    hooks = [st.optimizer.register_step_pre_hook(keep_grads) for st in states.values()]
    bns = [(n, m) for n, m in model.named_modules() if isinstance(m, BatchNorm)]
    stats = lambda: [torch.cat([m.running_mean, m.running_var]).clone() for _, m in bns]  # noqa: E731
    first = first_bn = None
    kdw.depthwise_wgrad_reference = no_plain
    for i, freeze in enumerate((False, False, True)):
        params = {n: p.detach().clone() for n, p in model.named_parameters()}
        bn0 = stats()
        kdw.K6_LAUNCHES = 0
        with (bn_counted(f"seg step {i} (freeze_encoder={freeze})", model) as bn,
              dw_counted(f"seg step {i} (freeze_encoder={freeze})", model)):
            _, metrics = step(states[freeze], batch)
        torch.cuda.synchronize()
        launches = kdw.K6_LAUNCHES
        first = first or launches
        first_bn = first_bn or bn
        bad = [k for k, v in metrics.items() if not torch.isfinite(v)]
        not_finite = [n for n, (fin, _) in grads.items() if not fin]
        zero = [n for n, (_, mx) in grads.items() if mx == 0]
        moved = {n: not torch.equal(p, params[n]) for n, p in model.named_parameters()}
        enc_moved = [n for n, m in moved.items() if n.startswith("encoder.") and m]
        # Adam moves a parameter by about lr whenever its gradient is not 0
        unmoved = [n for n, m in moved.items() if not m and n not in zero
                   and not (freeze and n.startswith("encoder."))]
        bn_same = [bns[j][0] for j, (a, b) in enumerate(zip(bn0, stats())) if torch.equal(a, b)]
        if launches != 14 or bad or not_finite or unmoved or bn_same or (freeze and enc_moved):
            raise AssertionError(
                f"seg step {i}: K6 launched {launches} (want 14), non-finite metrics {bad}, "
                f"grads {not_finite}, unmoved params {unmoved}, unmoved BN statistics "
                f"{bn_same}, encoder moved under freeze_encoder {enc_moved}")
        log(f"seg step {i} (freeze_encoder={freeze}): K6 {launches} launches; "
            + ", ".join(f"{k} {v.item():.5g}" for k, v in metrics.items())
            + f"; {len(grads)} grads finite ({len(zero)} exactly 0: {zero[:4]}), "
            + ("encoder unchanged, decoder moved" if freeze else
               f"{sum(moved.values())} of {len(moved)} parameters moved")
            + f", all {len(bns)} BN statistics moved")
    kdw.depthwise_wgrad_reference = real_plain
    for hk in hooks:
        hk.remove()
    return {"k6": k6, "launches": first, "bn": first_bn, "step": step, "state": states[False], "batch": batch}


def time_seg(sg) -> dict:
    """Phase 7, seg part: K6 per shape against its plain version and
    cuDNN's bf16 wgrad alone, and two library ways to the same layer's dx (the
    flipped-kernel conv, and cuDNN's dgrad, the Function's before the depthwise
    kernel); the seg train step
    with the flag on and off (on, off, off, on); torch.profiler over one
    step each way. Returns K6's {ms, plain, lib, bound, by}, times summed
    over one step's 14 launches."""
    from text_segmentation_image_inpainting_tpu_torch.ops import depthwise
    from text_segmentation_image_inpainting_tpu_torch.ops.conv import conv2d
    from text_segmentation_image_inpainting_tpu_torch.ops.kernels import depthwise_wgrad as kdw

    tot = [0.0] * 6
    for name, x, dy, d, count, _ in sg["k6"]:
        c = x.shape[-1]
        w = torch.randn((c, 1, 3, 3), device=x.device).to(x.dtype)
        xn, dyn = x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)  # channels_last NCHW views
        kern = lambda: kdw.depthwise_wgrad(x, dy, 3, d)  # noqa: E731
        plain = lambda: kdw.depthwise_wgrad_reference(x, dy, 3, d)  # noqa: E731
        cudnn = lambda: torch.ops.aten.convolution_backward(  # noqa: E731
            dyn, xn, w, None, [1, 1], [d, d], [d, d], False, [0, 0], c, [False, True, False])
        p1, k1, k2, p2 = cuda_ms(plain), cuda_ms(kern), cuda_ms(kern), cuda_ms(plain)
        t_cudnn = cuda_ms(cudnn)
        dx_flip = cuda_ms(lambda: conv2d(dy, w.flip((2, 3)), padding=d, dilation=d, groups=c))
        dx_dgrad = cuda_ms(lambda: torch.ops.aten.convolution_backward(
            dyn, xn, w, None, [1, 1], [d, d], [d, d], False, [0, 0], c, [True, False, False]))
        k_ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
        dev_ms = device_ms(kern, "dw_wgrad")
        gbytes = 2 * x.numel() * x.element_size() / 1e9
        log(f"time K6 {name} {tuple(x.shape)} d {d}: kernel {k_ms:.4f} ms, device time "
            f"{dev_ms:.4f} ms ({gbytes / dev_ms * 1e3:.0f} GB/s of x and dy), plain f32 "
            f"{p_ms:.4f} ms, cuDNN bf16 wgrad {t_cudnn:.4f} ms; dx as the flipped-kernel conv "
            f"{dx_flip:.4f} ms, as cuDNN's dgrad {dx_dgrad:.4f} ms; "
            f"{count} per step")
        for i, t in enumerate((k_ms, p_ms, t_cudnn, dx_flip, dx_dgrad, dev_ms)):
            tot[i] += count * t
    flop = sum(count * k6_work(x, 3, d)[0] for _, x, _, d, count, _ in sg["k6"])
    nbytes = sum(count * k6_work(x, 3, d)[1] for _, x, _, d, count, _ in sg["k6"])
    k6 = {"ms": tot[0], "plain": tot[1], "lib": tot[2]}
    k6["bound"], k6["by"] = bound(flop, nbytes)
    log(f"time K6 (one step's 14 launches): {tot[0]:.4f} ms, device time {tot[5]:.4f} ms, plain "
        f"f32 {tot[1]:.4f} ms, cuDNN bf16 wgrad {tot[2]:.4f} ms, bound {k6['bound']:.4f} ms "
        f"({k6['by']}); their dx on cuDNN: flipped-kernel conv {tot[3]:.4f} ms, dgrad "
        f"{tot[4]:.4f} ms")

    step, state, batch = sg["step"], sg["state"], sg["batch"]
    runs = []
    for flag in (True, False, False, True):
        depthwise.USE_CUSTOM_WGRAD = flag
        before = torch.cuda.memory_allocated() / 2**30  # as in time_train
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(lambda: step(state, batch), iters=TRAIN_ITERS, warmup=2)
        runs.append((flag, ms, torch.cuda.max_memory_allocated() / 2**30, before))
    for flag in (True, False):
        ms = [m for f, m, *_ in runs if f == flag]
        peak, before = max((g, b) for f, _, g, b in runs if f == flag)
        log(f"time seg step, flag {'on (K6)' if flag else 'off (cuDNN wgrad)'}: "
            + ", ".join(f"{m:.3f}" for m in ms) + f" ms per batch of {BATCH} (medians of "
            f"{TRAIN_ITERS}, order on/off/off/on) = {2 * BATCH / sum(ms) * 1e3:.2f} training "
            f"pages/s; peak device memory {peak:.2f} GiB, of which {before:.3f} GiB held before "
            f"the step")
    for flag in (True, False):
        depthwise.USE_CUSTOM_WGRAD = flag
        profile_run(lambda: step(state, batch), f"seg step, flag {'on' if flag else 'off'}",
                    runs=1)
    return k6


class TrueText(torch.nn.Module):
    """A segmenter that runs in full and then answers with the pages' own
    text masks (logit +1 on text, -1 elsewhere): serving traffic with the
    tile structure of real text at the same device work. The batch is
    found by comparing the pages on the device, so nothing syncs."""

    def __init__(self, seg, pages: torch.Tensor, masks: torch.Tensor):
        super().__init__()
        self.seg = seg
        self.pages = pages  # (batches, N, H, W, 3), the pipeline's input
        self.logits = masks * 2.0 - 1.0  # (batches, N, H, W, 1)

    def forward(self, x):
        logits = self.seg(x)
        hit = (self.pages == x).flatten(1).all(dim=1).int().argmax()
        return torch.index_select(self.logits, 0, hit.view(1))[0].to(logits.dtype)


def serve_phase(pipe, dev, smi: str) -> None:
    """``PageStreamServer`` on the default pipeline at 512^2, batch 8, bf16,
    over pages of the native engine (``make_page_stream_u8``) and their
    text masks. The segmenter's head bias is moved so that the first
    batch's predicted text covers as many pixels as its true text. Gates:
    dense ``serve()`` at depth 2 and chunk-2 ``submit``/``collect`` with a
    flushed odd tail bit-identical to ``run`` on the same pages and uint8
    conversion, in order; the sparse wire at budgets 64 (adaptive) and 256
    and with a forced undershoot (the budget set to 16) against the dense
    results; K1 7 and K2 1 per ``run`` dispatched; no blocking host call
    inside one profiled ``run``. Random weights scatter their text over the
    page, so the wire is also served the true text (``TrueText``), its
    masks checked against the dilated truth. Then serve pages/s beside
    closed-loop ``run`` with a blocking read, the host's paste time on the
    sparse wire, the device's busy share while serving, and wire bytes per
    page."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tools"))
    from host_syncs import blocking_calls

    from text_segmentation_image_inpainting_tpu_torch.data import native_pages
    from text_segmentation_image_inpainting_tpu_torch.data.pipeline import make_page_stream_u8
    from text_segmentation_image_inpainting_tpu_torch.ops.kernels import partial_conv as kpc
    from text_segmentation_image_inpainting_tpu_torch.ops.morphology import dilate_mask
    from text_segmentation_image_inpainting_tpu_torch.pipeline import PageStreamServer
    from text_segmentation_image_inpainting_tpu_torch.pipeline import serve as serve_mod
    from text_segmentation_image_inpainting_tpu_torch.pipeline.serve import to_compute
    from text_segmentation_image_inpainting_tpu_torch.pipeline.sparse import to_uint8

    t0 = time.perf_counter()
    stream = make_page_stream_u8(BATCH, (PAGE, PAGE), seed=SEED)
    batches = [next(stream)["image"] for _ in range(SERVE_BATCHES)]
    log(f"serve: {SERVE_BATCHES} batches of {BATCH} uint8 pages {PAGE}^2 from the native page "
        f"engine in {time.perf_counter() - t0:.2f} s")
    # the same pages' text masks, from the seeds make_page_stream_u8 draws
    # batch i from (the pages must come out equal)
    truth = []
    for i, b in enumerate(batches):
        seeds = [((SEED + 1) << 40) ^ (i * BATCH + j) for j in range(BATCH)]
        img, m = native_pages.synth_pages_u8(seeds, (PAGE, PAGE), mode="seg")
        if not np.array_equal(img, b):
            raise AssertionError(f"serve: batch {i} is not the pages of its seeds")
        truth.append(m)
    cd = pipe.compute_dtype
    truth_dev = torch.from_numpy(np.stack(truth)).to(dev, cd)  # (batches, N, H, W, 1)
    truth_dil = torch.stack([dilate_mask(t, pipe.dilate_radius) for t in truth_dev])

    def tile_counts(masks) -> np.ndarray:
        """Changed 32^2 tiles of each page of (..., N, H, W, 1) masks."""
        m = np.asarray(masks)[..., 0]
        t = m.reshape(*m.shape[:-2], PAGE // 32, 32, PAGE // 32, 32).max(axis=(-3, -1)) > 0
        return t.sum(axis=(-2, -1))

    def show(counts: np.ndarray) -> str:
        return "; ".join(" ".join(str(c) for c in row) for row in counts)

    true_tiles = tile_counts(truth_dil.cpu().float().numpy())
    log(f"serve: true text {truth_dev.float().mean().item():.2%} of the pixels, "
        f"{truth_dil.float().mean().item():.2%} after dilation by {pipe.dilate_radius}; median "
        f"{np.median(true_tiles):.0f} changed 32^2 tiles a page (of {(PAGE // 32) ** 2}): "
        + show(true_tiles))

    first = to_compute(torch.from_numpy(batches[0]).to(dev), cd)
    bias = pipe.seg.decoder.head.bias
    with torch.no_grad():
        logits = pipe.seg(first)[..., 0].float()
        share = truth_dev[0].float().mean()
        q = torch.quantile(logits.flatten(), 1.0 - share)
        bias.sub_(q)
        text = pipe.segment(first, dilate=False)
    log(f"serve: head bias moved by {-q.item():+.4f}, the {1 - share.item():.2%} quantile of the "
        f"first batch's logits: {text.float().mean().item():.2%} of its pixels predicted text "
        f"before dilation, {truth_dev[0].float().mean().item():.2%} truly")

    runs = [0]
    plain_run = pipe.run

    def counted_run(pages):
        runs[0] += 1
        return plain_run(pages)

    def direct(pages: np.ndarray):
        clean, mask = plain_run(to_compute(torch.from_numpy(pages).to(dev), cd))
        return to_uint8(clean).cpu().numpy(), mask.to(torch.uint8).cpu().numpy()

    want = [direct(b) for b in batches]
    tiles = tile_counts(np.stack([m for _, m in want]))  # (batches, pages)
    text = np.mean([m.mean() for _, m in want])
    log(f"serve: {text:.2%} of the pixels predicted text after dilation; median "
        f"{np.median(tiles):.0f} changed 32^2 tiles a page: " + show(tiles))

    def check_launches(what: str) -> None:
        got = (kpc.K1_LAUNCHES, kpc.K2_LAUNCHES)
        if runs[0] == 0 or got != (7 * runs[0], runs[0]):
            raise AssertionError(f"serve {what}: K1/K2 launched {got} for {runs[0]} runs, want "
                                 f"7 and 1 per run")
        log(f"serve {what}: {runs[0]} runs dispatched, K1 {got[0]}, K2 {got[1]} launches")

    def gated(what: str, server, feed) -> list:
        runs[0] = 0
        kpc.K1_LAUNCHES = kpc.K2_LAUNCHES = 0
        with bn_counted(f"serve {what}", pipe) as bn, dw_counted(f"serve {what}", pipe):
            out = feed(server)
        check_launches(what)
        if bn["calls"] % runs[0]:
            raise AssertionError(f"serve {what}: {bn['calls']} BatchNorm calls in {runs[0]} runs")
        return out

    def check_dense(what: str, got, ref) -> None:
        if len(got) != len(ref):
            raise AssertionError(f"serve {what}: {len(got)} results for {len(ref)} batches")
        for i, ((gc, gm), (wc, wm)) in enumerate(zip(got, ref)):
            if gc.dtype != np.uint8 or not (np.array_equal(gc, wc) and np.array_equal(gm, wm)):
                raise AssertionError(f"serve {what}: batch {i} differs from run")
        log(f"serve {what}: {len(got)} batches bit-identical to run, in order")

    def check_sparse(what: str, got, pages, ref, over) -> None:
        """Masks equal; the clean page equals the dense one inside changed
        tiles and the input bytes outside, but on a page over the largest
        budget (``over``), which is redone densely: there it equals the
        dense page throughout (in bf16, u8 -> x/255 -> u8 moves some bytes
        by 1, so a dense page is not the input outside its text)."""
        if len(got) != len(ref):
            raise AssertionError(f"serve {what}: {len(got)} results for {len(ref)} batches")
        for i, ((sc, sm), (dc, dm), p) in enumerate(zip(got, ref, pages)):
            flags = dm[..., 0].reshape(BATCH, PAGE // 32, 32, PAGE // 32, 32).max(axis=(2, 4)) > 0
            region = np.repeat(np.repeat(flags, 32, axis=1), 32, axis=2)
            region[over[i]] = True
            if not (np.array_equal(sm, dm) and np.array_equal(sc[region], dc[region])
                    and np.array_equal(sc[~region], p[~region])):
                raise AssertionError(f"serve {what}: batch {i} differs from the dense result")

    def sparse_gate(label: str, k: int, k_first, n: int, ref, counted) -> float:
        server = PageStreamServer(pipe, depth=2, sparse_tiles=k)
        if k_first is not None:
            server._k_next = k_first
        got = gated(label, server, lambda sv: list(sv.serve(iter(batches[:n]))))
        check_sparse(label, got, batches, ref[:n], counted[:n] > k)
        over = int((counted[:n] > k).sum())
        first_over = int((counted[0] > (k_first or k)).sum())
        per_page = server.wire_bytes / (n * BATCH)
        log(f"serve {label}: {n} batches match the dense results (masks; clean inside changed "
            f"tiles, input bytes outside, a page over the budget dense throughout); {over} of "
            f"{counted[:n].size} pages over the budget went dense; {first_over} pages of the "
            f"first batch over its budget; budget now "
            f"{server._k_next}; {per_page:.0f} wire bytes a page")
        return per_page

    real_seg = pipe.seg
    oracle = TrueText(real_seg, torch.stack([to_compute(torch.from_numpy(b).to(dev), cd)
                                             for b in batches]), truth_dev)
    pipe.run = counted_run
    try:
        dense = gated("dense, depth 2", PageStreamServer(pipe, depth=2),
                      lambda sv: list(sv.serve(iter(batches[:SERVE_GATED]))))
        check_dense("dense, depth 2", dense, want[:SERVE_GATED])

        def chunked_feed(sv):
            for b in batches[:5]:
                sv.submit(b)
            return list(sv.drain())

        check_dense("submit/collect, chunk 2, 5 batches (a flushed tail of 1)",
                    gated("submit/collect, chunk 2", PageStreamServer(pipe, chunk=2), chunked_feed),
                    want[:5])
        wire = {}
        for label, k, k_first in (("sparse 64, adaptive", 64, None), ("sparse 256", 256, None),
                                  ("sparse 64, forced undershoot to 16", 64, 16)):
            wire[label] = sparse_gate(label, k, k_first, SERVE_GATED, want, tiles)

        # the true text: the wire at the tile counts of real text
        pipe.seg = oracle
        truth_out = gated("true text, dense, depth 2", PageStreamServer(pipe, depth=2),
                          lambda sv: list(sv.serve(iter(batches))))
        want_truth = truth_dil.to(torch.uint8).cpu().numpy()
        for i, (_, m) in enumerate(truth_out):
            if not np.array_equal(m, want_truth[i]):
                raise AssertionError(f"serve true text: batch {i}'s mask is not the dilated truth")
        log(f"serve true text, dense: {SERVE_BATCHES} batches' masks equal the dilated truth")
        for k in (64, 256):
            label = f"true text, sparse {k}, adaptive"
            wire[label] = sparse_gate(label, k, None, SERVE_BATCHES, truth_out, true_tiles)
    finally:
        del pipe.run  # the instance attribute: the method again
        pipe.seg = real_seg

    x = to_compute(torch.from_numpy(batches[0]).to(dev), cd)
    control = blocking_calls(lambda: torch.tensor(0.5, device=dev))
    calls = blocking_calls(lambda: pipe.run(x))
    log(f"serve: blocking host calls in one profiled run: {sum(calls.values())} {dict(calls)} "
        f"(a blocking torch.tensor(..., device=cuda) shows {dict(control)}, an empty window "
        f"{dict(blocking_calls(lambda: None))})")
    if not control:
        raise AssertionError("the profiler recorded no blocking call for a blocking copy")
    if calls:
        raise AssertionError(f"run blocks the host: {dict(calls)}")

    # the host's paste on the sparse wire, timed inside the served runs
    paste = [0.0]

    def timed(fn):
        def wrapped(*args, **kwargs):
            t = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                paste[0] += time.perf_counter() - t
        return wrapped

    def served(server) -> None:
        for _ in server.serve(iter(batches)):
            pass

    def with_truth(fn):
        def run_it():
            pipe.seg = oracle
            try:
                fn()
            finally:
                pipe.seg = real_seg
        return run_it

    served(PageStreamServer(pipe, depth=2))  # warm the pinned host blocks
    times = {}
    unflatten, recompose = serve_mod.sparse_unflatten, serve_mod.sparse_recompose
    serve_mod.sparse_unflatten, serve_mod.sparse_recompose = timed(unflatten), timed(recompose)
    try:
        for label, fn in (
                ("closed-loop run + blocking .cpu()", lambda: [direct(b) for b in batches]),
                ("serve dense, depth 2", lambda: served(PageStreamServer(pipe, depth=2))),
                ("serve sparse 64, depth 2",
                 lambda: served(PageStreamServer(pipe, depth=2, sparse_tiles=64))),
                ("true text, serve dense, depth 2",
                 with_truth(lambda: served(PageStreamServer(pipe, depth=2)))),
                ("true text, serve sparse 64, depth 2",
                 with_truth(lambda: served(PageStreamServer(pipe, depth=2, sparse_tiles=64)))),
                ("true text, serve sparse 256, depth 2",
                 with_truth(lambda: served(PageStreamServer(pipe, depth=2, sparse_tiles=256)))),
                ("closed-loop run + blocking .cpu() (again)",
                 lambda: [direct(b) for b in batches])):
            paste[0] = 0.0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times[label] = time.perf_counter() - t0
            host = (f"; host paste (sparse_unflatten + sparse_recompose) {paste[0] * 1e3:.1f} ms "
                    f"= {paste[0] * 1e3 / SERVE_BATCHES:.2f} ms a batch" if paste[0] else "")
            log(f"time {label}: {SERVE_BATCHES} batches of {BATCH} in {times[label]:.3f} s = "
                f"{SERVE_BATCHES * BATCH / times[label]:.2f} pages/s{host}  [{smi}]")
    finally:
        serve_mod.sparse_unflatten, serve_mod.sparse_recompose = unflatten, recompose
    profile_run(lambda: served(PageStreamServer(pipe, depth=2)), "serve dense, depth 2, "
                f"{SERVE_BATCHES} batches", runs=1)
    dense_bytes = PAGE * PAGE * 4
    log(f"serve wire bytes a page: dense {dense_bytes} (clean 3 + mask 1 byte a pixel), "
        + ", ".join(f"{k} {v:.0f} ({v / dense_bytes:.1%})" for k, v in wire.items())
        + f"  [{smi}]")



# The stride-1 depthwise convs with C >= 128 of TextSegmenter(backbone=
# 'xception', head='deeplab', output_stride=8, middle_repeats=8) at 512^2
# pages, whose weight gradient is K6 with USE_CUSTOM_WGRAD on: (blocks,
# H = W, C, dilation, launches per train step); 35 launches, k = 3. The
# phase checks the list against the K6 calls of one backward.
XCEPTION_SHAPES = (
    ("entry0", 256, 128, 1, 1),
    ("entry1 sep0", 128, 128, 1, 1),
    ("entry1 sep1", 128, 256, 1, 1),
    ("entry2 sep0", 64, 256, 1, 1),
    ("entry2 sep1-2", 64, 728, 1, 2),
    ("mid0-7, exit0 sep0-1", 64, 728, 2, 26),
    ("exit0 sep2", 64, 1024, 2, 1),
    ("exit1", 64, 1024, 4, 1),
    ("exit2", 64, 1536, 4, 1),
)
XCEPTION_ITERS = 3


def changed(before: dict, after: dict) -> list:
    """Names whose tensors differ between two {name: tensor} snapshots."""
    return [n for n in before if not torch.equal(before[n], after[n])]


def xception_phase(dev, rng, smi: str) -> dict:
    """The Xception seg track: K6 against the f64 truth at the
    ``XCEPTION_SHAPES`` (each launched twice, bit-identical), the shapes
    and count of one backward's K6 calls, three train steps at 512^2,
    batch 8, bf16 with ``USE_CUSTOM_WGRAD`` on (35 K6 launches each; every
    parameter with a gradient and every BN statistic moved; no CUDA tensor
    reaches K6's plain version), then K6 per shape against its plain
    version and cuDNN's wgrad, and the step timed flag on/off/off/on with
    its peak memory and a profile. Returns K6's kernel-line numbers."""
    from text_segmentation_image_inpainting_tpu_torch.models import TextSegmenter
    from text_segmentation_image_inpainting_tpu_torch.ops import depthwise
    from text_segmentation_image_inpainting_tpu_torch.ops.kernels import depthwise_wgrad as kdw
    from text_segmentation_image_inpainting_tpu_torch.train.config import SegTrainConfig
    from text_segmentation_image_inpainting_tpu_torch.train.seg import make_seg_train_step
    from text_segmentation_image_inpainting_tpu_torch.train.state import create_train_state

    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    shapes = []
    for name, h, c, d, count in XCEPTION_SHAPES:
        x = torch.randn((BATCH, h, h, c), generator=gen, device=dev).to(bf)
        dy = torch.randn((BATCH, h, h, c), generator=gen, device=dev).to(bf)
        res = check_wgrad(f"K6 xception {name}", x, dy, 3, d)
        log(f"parity K6 xception {name}: x, dy {tuple(x.shape)} bf16, d {d}: max |d| to the f64 "
            f"truth {res['K6']:.4g} (plain {res['plain']:.4g}), to the plain "
            f"{res['vs_plain']:.4g}; two launches bit-identical; "
            f"{kdw.k6_plan(*x.shape, 3, d, x.element_size(), kdw._sm_count(0))}; {count} per step")
        shapes.append((name, x, dy, d, count, res))
    del x, dy

    cfg = SegTrainConfig(backbone="xception", head="deeplab")
    model = TextSegmenter(backbone="xception", head="deeplab", output_stride=8, middle_repeats=8,
                          dtype=bf).init_weights(torch.Generator().manual_seed(SEED)).to(dev)
    pages = rng.uniform(0.6, 1.0, (BATCH, PAGE, PAGE, 3)).astype(np.float32)
    masks = text_targets(rng, BATCH, PAGE, PAGE)
    pages = np.where(masks > 0, rng.uniform(0.0, 0.3, pages.shape), pages).astype(np.float32)
    batch = {"image": torch.from_numpy(pages).to(dev), "mask": torch.from_numpy(masks).to(dev)}
    depthwise.USE_CUSTOM_WGRAD = True
    real_wgrad, real_plain, seen = depthwise.depthwise_wgrad, kdw.depthwise_wgrad_reference, []

    def catch(x, dy, k, d):
        seen.append((x.shape[1], x.shape[3], d))
        return real_wgrad(x, dy, k, d)

    def no_plain(x, *args):
        if x.is_cuda:
            raise AssertionError("a CUDA tensor reached K6's plain version on the Xception path")
        return real_plain(x, *args)

    step = make_seg_train_step(model, cfg)
    state = create_train_state(model, cfg.optimizer)
    grads = {}

    def keep_grads(opt, args, kwargs):
        for name, p in model.named_parameters():
            grads[name] = 0.0 if p.grad is None else p.grad.abs().max().item()

    hook = state.optimizer.register_step_pre_hook(keep_grads)
    depthwise.depthwise_wgrad, kdw.depthwise_wgrad_reference = catch, no_plain
    launches, dw_launches = [], 0
    try:
        for i in range(3):
            params = {n: p.detach().clone() for n, p in model.named_parameters()}
            stats = {n: b.clone() for n, b in model.named_buffers() if "running" in n}
            seen.clear()
            kdw.K6_LAUNCHES = 0
            with (bn_counted(f"xception step {i}", model),
                  dw_counted(f"xception step {i}", model) as dwc):
                _, metrics = step(state, batch)
            torch.cuda.synchronize()
            launches.append(kdw.K6_LAUNCHES)
            dw_launches = dw_launches or dwc["launches"]
            bad = [k for k, v in metrics.items() if not torch.isfinite(v)]
            unmoved = [n for n, p in model.named_parameters()
                       if grads[n] > 0 and torch.equal(p, params[n])]
            zero = [n for n, g in grads.items() if g == 0]
            moved = set(changed(stats, dict(model.named_buffers())))
            still = [n for n in stats if n not in moved]
            want = sorted(Counter({(h, c, d): n for _, h, c, d, n in XCEPTION_SHAPES}).elements())
            if (kdw.K6_LAUNCHES != 35 or sorted(seen) != want or bad or unmoved or still
                    or not all(np.isfinite(g) for g in grads.values())):
                raise AssertionError(
                    f"xception step {i}: K6 launched {kdw.K6_LAUNCHES} (want 35) at "
                    f"{sorted(Counter(seen).items())}, non-finite metrics {bad}, unmoved params "
                    f"{unmoved}, unmoved BN statistics {still}")
            log(f"xception seg step {i}: K6 {kdw.K6_LAUNCHES} launches at the "
                f"{len(set(seen))} shapes of XCEPTION_SHAPES; "
                + ", ".join(f"{k} {v.item():.5g}" for k, v in metrics.items())
                + f"; {len(grads)} grads finite ({len(zero)} exactly 0: {zero[:4]}), the others' "
                f"parameters moved, all {len(stats) // 2} BN statistics moved")
    finally:
        depthwise.depthwise_wgrad, kdw.depthwise_wgrad_reference = real_wgrad, real_plain
        hook.remove()

    tot = [0.0] * 4
    for name, x, dy, d, count, _ in shapes:
        c = x.shape[-1]
        w = torch.randn((c, 1, 3, 3), device=dev).to(bf)
        xn, dyn = x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)
        kern = lambda: kdw.depthwise_wgrad(x, dy, 3, d)  # noqa: E731
        plain = lambda: kdw.depthwise_wgrad_reference(x, dy, 3, d)  # noqa: E731
        cudnn = lambda: torch.ops.aten.convolution_backward(  # noqa: E731
            dyn, xn, w, None, [1, 1], [d, d], [d, d], False, [0, 0], c, [False, True, False])
        k_ms = (cuda_ms(kern, iters=10) + cuda_ms(kern, iters=10)) / 2
        p_ms, t_cudnn = cuda_ms(plain, iters=3, warmup=1), cuda_ms(cudnn, iters=10)
        dev_ms = device_ms(kern, "dw_wgrad")
        log(f"time K6 xception {name} {tuple(x.shape)} d {d}: kernel {k_ms:.4f} ms, device time "
            f"{dev_ms:.4f} ms ({2 * x.numel() * 2 / dev_ms / 1e6:.0f} GB/s of x and dy), plain f32 "
            f"{p_ms:.4f} ms, cuDNN bf16 wgrad {t_cudnn:.4f} ms; {count} per step")
        for i, t in enumerate((k_ms, p_ms, t_cudnn, dev_ms)):
            tot[i] += count * t
    flop = sum(count * k6_work(x, 3, d)[0] for _, x, _, d, count, _ in shapes)
    nbytes = sum(count * k6_work(x, 3, d)[1] for _, x, _, d, count, _ in shapes)
    k6 = {"ms": tot[0], "plain": tot[1], "lib": tot[2], "launches": launches[0],
          "err": max(r["vs_plain"] for *_, r in shapes), "dw_launches": dw_launches}
    k6["bound"], k6["by"] = bound(flop, nbytes)
    log(f"time K6 xception (one step's 35 launches): {tot[0]:.4f} ms, device time {tot[3]:.4f} "
        f"ms, plain f32 {tot[1]:.4f} ms, cuDNN bf16 wgrad {tot[2]:.4f} ms, bound "
        f"{k6['bound']:.4f} ms ({k6['by']})  [{smi}]")
    del shapes

    runs = []
    for flag in (True, False, False, True):
        depthwise.USE_CUSTOM_WGRAD = flag
        before = torch.cuda.memory_allocated() / 2**30
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(lambda: step(state, batch), iters=XCEPTION_ITERS, warmup=1)
        runs.append((flag, ms, torch.cuda.max_memory_allocated() / 2**30, before))
    for flag in (True, False):
        ms = [m for f, m, *_ in runs if f == flag]
        peak, before = max((g, b) for f, _, g, b in runs if f == flag)
        log(f"time xception seg step, flag {'on (K6)' if flag else 'off (cuDNN wgrad)'}: "
            + ", ".join(f"{m:.3f}" for m in ms) + f" ms per batch of {BATCH} (medians of "
            f"{XCEPTION_ITERS}, order on/off/off/on) = {2 * BATCH / sum(ms) * 1e3:.2f} training "
            f"pages/s; peak device memory {peak:.2f} GiB, of which {before:.3f} GiB held before "
            f"the step  [{smi}]")
    depthwise.USE_CUSTOM_WGRAD = True
    profile_run(lambda: step(state, batch), "xception seg step, flag on", runs=1)
    name_library_layers(step, state, batch, "xception seg step, flag on")
    return k6


def attention_phase(dev, rng, tr) -> None:
    """The attention U-Net (``InpaintUNet(attention=True, attention_sn=
    True)``, depth 8, 512^2, batch 8, bf16, fused stem): three train steps
    with K1 7, K2 1, K3 8, K4 1, K5 1 launches each, finite terms, u and v
    of the four spectral-norm projections moved in each, ``gamma`` off 0
    after the first; an eval forward leaves u and v as they are; one step
    with ``grad_accum=2``: the launches twice over (once per microbatch),
    finite terms."""
    import dataclasses

    from text_segmentation_image_inpainting_tpu_torch.models import InpaintUNet
    from text_segmentation_image_inpainting_tpu_torch.ops.kernels import partial_conv as kpc
    from text_segmentation_image_inpainting_tpu_torch.ops.kernels import vgg_stem as kvs
    from text_segmentation_image_inpainting_tpu_torch.train.config import InpaintTrainConfig
    from text_segmentation_image_inpainting_tpu_torch.train.inpaint import make_inpaint_train_step
    from text_segmentation_image_inpainting_tpu_torch.train.state import create_train_state

    bf = torch.bfloat16
    model = InpaintUNet(depth=8, attention=True, attention_sn=True, dtype=bf).init_weights(
        torch.Generator().manual_seed(SEED + 6)).to(dev)
    cfg = InpaintTrainConfig(attention=True, attention_sn=True, loss=tr["loss_cfg"])
    state = create_train_state(model, cfg.optimizer)
    batch, vgg = tr["batch"], tr["vgg"]
    spectral = lambda: {n: b.clone() for n, b in model.named_buffers()  # noqa: E731
                        if n.endswith((".u", ".v"))}

    def counts():
        return {"K1": kpc.K1_LAUNCHES, "K2": kpc.K2_LAUNCHES, "K3": kpc.K3_LAUNCHES,
                "K4": kvs.K4_LAUNCHES, "K5": kvs.K5_LAUNCHES}

    def reset():
        kpc.K1_LAUNCHES = kpc.K2_LAUNCHES = kpc.K3_LAUNCHES = 0
        kvs.K4_LAUNCHES = kvs.K5_LAUNCHES = 0

    one = {"K1": 7, "K2": 1, "K3": 8, "K4": 1, "K5": 1}
    for accum in (1, 1, 1, 2):
        step = make_inpaint_train_step(model, dataclasses.replace(cfg, grad_accum=accum), vgg)
        uv = spectral()
        reset()
        _, terms = step(state, batch)
        torch.cuda.synchronize()
        got, want = counts(), {k: accum * v for k, v in one.items()}
        bad = [k for k, v in terms.items() if not torch.isfinite(v)]
        moved = set(changed(uv, spectral()))
        still = [n for n in uv if n not in moved]
        gamma = model.attn.gamma.item()
        if got != want or bad or still or len(uv) != 8 or gamma == 0.0:
            raise AssertionError(f"attention step (grad_accum {accum}): launches {got} (want "
                                 f"{want}), non-finite terms {bad}, u/v unmoved {still}, gamma "
                                 f"{gamma}")
        log(f"attention step, grad_accum {accum}: launches {got}; terms "
            + ", ".join(f"{k} {v.item():.5g}" for k, v in terms.items())
            + f"; u and v of the 4 spectral-norm projections moved; gamma {gamma:.4g}")
    model.eval()
    uv = spectral()
    with torch.no_grad():
        out = model(batch["image"] * batch["mask"], batch["mask"])
    torch.cuda.synchronize()
    if changed(uv, spectral()) or not torch.isfinite(out).all():
        raise AssertionError("attention eval forward moved u/v or gave non-finite output")
    log(f"attention eval forward: out {tuple(out.shape)} finite; u and v unchanged")


def state_snapshot(state, adam: bool = True) -> dict:
    """Every tensor a train step moves: parameters, buffers (BN
    statistics, u/v), the optimizer's state (without ``adam``: none) and
    the device lr."""
    snap = {f"param {n}": p.detach().clone() for n, p in state.model.named_parameters()}
    snap.update({f"buffer {n}": b.clone() for n, b in state.model.named_buffers()})
    names = {id(p): n for n, p in state.model.named_parameters()}
    if adam:
        for p, st in state.optimizer.state.items():
            for k, v in st.items():
                snap[f"adam {k} {names[id(p)]}"] = v.clone()
    if state.capturable:
        snap["lr"] = state.lr.clone()
    return snap


def add_metrics(snap: dict, metrics: list) -> dict:
    """``snap`` with each step's metrics as ``metric <name> @<step>``."""
    for i, m in enumerate(metrics):
        snap.update({f"metric {n} @{i}": v.detach().clone() for n, v in m.items()})
    return snap


def run_distance(a: dict, b: dict, names) -> float:
    """Root mean square over ``names`` of each tensor's relative L2
    distance between two runs' snapshots."""
    rel = [rel_l2(a[n].double(), b[n].double()) if b[n].abs().max() > 0
           else (a[n].double() - b[n].double()).norm().item() for n in names]
    return float(np.sqrt(np.mean(np.square(rel)))) if rel else 0.0


GRAPH_EAGER_RUNS = 3
# the graph run against the eager runs' own spread, where they are not
# bit-equal: an average over hundreds of tensors of the same kind of noise
# lands near 1, a replay that went wrong orders of magnitude off
GRAPH_NOISE_RATIO = 1.5


def _graph_nodes(root) -> list:
    """Every node of the autograd graph below ``root``, with its next nodes."""
    seen, out, todo = set(), [], [root]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        nxt = [f for f, _ in node.next_functions if f is not None]
        out.append((node, nxt))
        todo.extend(nxt)
    return out


def _op_key(name: str) -> str:
    return name.lower().replace("_", "")


# Backward nodes whose CUDA kernels add with atomics outside torch's
# deterministic mode: the ops with a backward in the lists of
# normally-nondeterministic CUDA operations of
# ``torch.use_deterministic_algorithms``. On the card's torch the
# bilinear resize's backward no longer says so under that mode (nothing
# warns, nothing raises), yet two runs of it differ: so the graph is
# read for these nodes, besides the mode's warnings.
ATOMIC_BACKWARD = frozenset((
    "UpsampleLinear1DBackward", "UpsampleBilinear2DBackward", "UpsampleBicubic2DBackward",
    "UpsampleTrilinear3DBackward", "AdaptiveAvgPool2DBackward", "AdaptiveAvgPool3DBackward",
    "AdaptiveMaxPool2DBackward", "AvgPool3DBackward", "MaxPool3DWithIndicesBackward",
    "FractionalMaxPool2DBackward", "FractionalMaxPool3DBackward", "ReflectionPad1DBackward",
    "ReflectionPad2DBackward", "ReflectionPad3DBackward", "ReplicationPad1DBackward",
    "ReplicationPad2DBackward", "ReplicationPad3DBackward", "IndexSelectBackward",
    "GatherBackward", "IndexBackward", "EmbeddingBackward", "EmbeddingBagBackward",
    "GridSampler2DBackward", "GridSampler3DBackward", "NllLoss2DBackward", "CtcLossBackward",
    "CumsumBackward", "RepeatInterleaveBackward",
))


def probe_nondeterminism(step, fresh, batch, model) -> tuple:
    """The nondeterministic ops of one run of ``step`` and the parameters
    whose gradient crosses one: (ops, params). The step runs twice from
    ``fresh()``: as it is, its own autograd graph caught at its
    ``backward``, and under ``torch.use_deterministic_algorithms(True,
    warn_only=True)`` (cuDNN deterministic; CUBLAS_WORKSPACE_CONFIG set in
    ``main``; the backward on the calling thread, so that its warnings
    reach Python). The ops are those that warn and the graph's nodes in
    ``ATOMIC_BACKWARD`` (with their counts); the params are found by
    walking the graph from each such node down to the leaves. ``params``
    is None when a warning names no backward node of the graph (a
    nondeterministic forward, or an op inside a custom Function): then
    nothing after the first forward can be called exact. (Under the mode
    the card's torch swaps the bilinear resize for another implementation,
    so the graph is read from the run as it is.)"""
    import re
    import warnings

    graphs = []
    orig = torch.Tensor.backward

    def backward(self, *args, **kwargs):
        graphs.append(_graph_nodes(self.grad_fn))
        return orig(self, *args, **kwargs)

    torch.Tensor.backward = backward
    try:
        step(fresh(), batch)
    finally:
        torch.Tensor.backward = orig
    fill = torch.utils.deterministic.fill_uninitialized_memory
    with warnings.catch_warnings(record=True) as caught, \
            torch.autograd.set_multithreading_enabled(False):
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        torch.utils.deterministic.fill_uninitialized_memory = False
        try:
            step(fresh(), batch)
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
            torch.utils.deterministic.fill_uninitialized_memory = fill
    warned = set()
    for w in caught:
        msg = str(w.message)
        m = re.match(r"(\w+) does not have a deterministic implementation", msg)
        if m:
            warned.add(m.group(1))
        elif "determinis" in msg:
            warned.add(msg[:160])
    names = {id(p): n for n, p in model.named_parameters()}
    params, matched, found = set(), set(), Counter()
    for nodes in graphs:
        below = dict(nodes)
        for node, _ in nodes:
            name = re.sub(r"\d+$", "", node.name())
            hits = {op for op in warned if _op_key(op).startswith(_op_key(name))}
            if "Backward" not in name or not (hits or name in ATOMIC_BACKWARD):
                continue
            matched |= hits
            found[node.name()] += 1
            todo, seen = [node], set()
            while todo:
                cur = todo.pop()
                if cur in seen:
                    continue
                seen.add(cur)
                var = getattr(cur, "variable", None)
                if var is not None and id(var) in names:
                    params.add(names[id(var)])
                todo.extend(below.get(cur, []))
    ops = warned | {f"{n} x{c}" for n, c in found.items()}
    return ops, (None if warned - matched else params)


def derived_exact(names, noisy_params, steps: int) -> set:
    """The tensors of a ``steps``-step snapshot that no gradient crossing a
    nondeterministic op can reach, so that every run must give them bit
    for bit: everything when no parameter's gradient crosses one; else the
    counts (the lr, Adam's step, ``num_batches_tracked``) and the first
    step's forward metrics (not its ``grad_norm``), plus after one step the
    parameters (and their Adam moments) whose gradient crosses none and the
    BN statistics (the first forward's). From the second step on, the
    parameters that moved by a noisy gradient feed every later forward,
    so every other tensor is noisy."""
    if noisy_params is not None and not noisy_params:
        return set(names)

    def counter(n):
        return n == "lr" or n.startswith("adam step ") or n.endswith("num_batches_tracked")

    def first_forward(n):
        return n.startswith("metric ") and n.endswith(" @0") and not n.startswith("metric grad_norm")

    exact = {n for n in names if counter(n) or first_forward(n)}
    if steps == 1 and noisy_params is not None:
        for n in names:
            kind, _, rest = n.partition(" ")
            param = rest.split(" ", 1)[1] if kind == "adam" else rest
            if kind == "buffer" or (kind in ("param", "adam") and param not in noisy_params):
                exact.add(n)
    return exact


def check_against_runs(label: str, got: dict, runs: list, exact: set) -> float:
    """``got`` against reference ``runs`` of the same steps: bit-equal in
    ``exact`` (which every reference run must be too), and elsewhere no
    farther from them (the RMS over those tensors of the relative L2
    distance, averaged over the runs) than ``GRAPH_NOISE_RATIO`` times
    their own spread. Returns the distance."""
    names = list(runs[0])
    if sorted(got) != sorted(names):
        raise AssertionError(f"{label}: the snapshots name different tensors")
    moved = [n for n in exact if any(not torch.equal(runs[0][n], r[n]) for r in runs[1:])]
    if moved:
        raise AssertionError(f"{label}: {len(moved)} tensors of the derived exact set differ "
                             f"between the reference runs ({moved[:6]}): a nondeterministic "
                             f"op was missed")
    noisy = [n for n in names if n not in exact]
    off = [n for n in exact if not torch.equal(got[n], runs[0][n])]
    pairs = [(i, j) for i in range(len(runs)) for j in range(i + 1, len(runs))]
    d_ref = float(np.mean([run_distance(runs[i], runs[j], noisy) for i, j in pairs])) if pairs \
        else 0.0
    d_got = float(np.mean([run_distance(got, r, noisy) for r in runs]))
    for group in ("param", "buffer", "adam", "lr", "metric"):
        grp = [n for n in names if n.split(" ")[0] == group]
        if not grp:
            continue
        g_max = max((got[n].double() - runs[0][n].double()).abs().max().item() for n in grp)
        log(f"{label} {group}: {len(grp)} tensors, {sum(n in exact for n in grp)} in the exact "
            f"set, of them bit-equal {sum(n in exact and n not in off for n in grp)}; max |d| to "
            f"reference run 1 {g_max:.4g}")
    log(f"{label}: {len(exact)} of {len(names)} tensors exact, {len(noisy)} noisy; RMS relative "
        f"L2 distance among the references {d_ref:.4g}, to them {d_got:.4g} (ratio "
        f"{d_got / d_ref if d_ref else 0:.3f})")
    if off or d_got > GRAPH_NOISE_RATIO * d_ref:
        raise AssertionError(f"{label}: off the reference runs: {len(off)} tensors of the exact "
                             f"set differ ({off[:6]}), distance {d_got:.4g} against their "
                             f"{d_ref:.4g}")
    return d_got


def launch_counters() -> dict:
    from text_segmentation_image_inpainting_tpu_torch.ops.kernels import depthwise_wgrad as kdw
    from text_segmentation_image_inpainting_tpu_torch.ops.kernels import partial_conv as kpc
    from text_segmentation_image_inpainting_tpu_torch.ops.kernels import vgg_stem as kvs

    return {"K1": kpc.K1_LAUNCHES, "K2": kpc.K2_LAUNCHES, "K3": kpc.K3_LAUNCHES,
            "K4": kvs.K4_LAUNCHES, "K5": kvs.K5_LAUNCHES, "K6": kdw.K6_LAUNCHES,
            "K1F": kpc.K1F_LAUNCHES, "K2F": kpc.K2F_LAUNCHES, "K3F": kpc.K3F_LAUNCHES,
            "K3F_HEAD": kpc.K3F_HEAD_LAUNCHES, "K4F": kvs.K4F_LAUNCHES, "K5F": kvs.K5F_LAUNCHES}


def zero_launch_counters() -> None:
    from text_segmentation_image_inpainting_tpu_torch.ops.kernels import depthwise_wgrad as kdw
    from text_segmentation_image_inpainting_tpu_torch.ops.kernels import partial_conv as kpc
    from text_segmentation_image_inpainting_tpu_torch.ops.kernels import vgg_stem as kvs

    for mod, names in ((kpc, ("K1", "K2", "K3", "K1F", "K2F", "K3F", "K3F_HEAD")),
                       (kvs, ("K4", "K5", "K4F", "K5F")), (kdw, ("K6",))):
        for n in names:
            setattr(mod, f"{n}_LAUNCHES", 0)


def graph_cases(dev, rng, tr) -> list:
    """The steps of ``graph_phase`` (and ``ddp_phase``): (label, model, opt,
    make_step(model, mesh=None), batches stacked (2k, ...)). The inpaint
    step (fused stem) starts in warm-up (``warmup_steps=3``: lr 0 at step
    0); the seg step runs with ``USE_CUSTOM_WGRAD`` on."""
    from text_segmentation_image_inpainting_tpu_torch.models import InpaintUNet, TextSegmenter
    from text_segmentation_image_inpainting_tpu_torch.train.config import (
        InpaintTrainConfig,
        OptimizerConfig,
        SegTrainConfig,
    )
    from text_segmentation_image_inpainting_tpu_torch.train.inpaint import make_inpaint_train_step
    from text_segmentation_image_inpainting_tpu_torch.train.seg import make_seg_train_step

    bf, k = torch.bfloat16, GRAPH_K
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    opt = OptimizerConfig(warmup_steps=3)
    icfg = InpaintTrainConfig(loss=tr["loss_cfg"], optimizer=opt)
    unet = InpaintUNet(depth=8, dtype=bf).init_weights(torch.Generator().manual_seed(SEED + 8))
    holes = torch.from_numpy(np.stack([hole_mask(rng, BATCH, PAGE, PAGE)[..., None]
                                       for _ in range(2 * k)])).to(dev)
    pages = torch.rand((2 * k, BATCH, PAGE, PAGE, 3), generator=gen, device=dev)
    inpaint = ("inpaint step", unet.to(dev), opt,
               lambda m, mesh=None: make_inpaint_train_step(m, icfg, tr["vgg"], mesh=mesh),
               {"image": pages, "mask": holes})
    scfg = SegTrainConfig()
    seg = TextSegmenter(dtype=bf).init_weights(torch.Generator().manual_seed(SEED + 9)).to(dev)
    masks = torch.from_numpy(np.stack([text_targets(rng, BATCH, PAGE, PAGE)
                                       for _ in range(2 * k)])).to(dev)
    pages = torch.rand((2 * k, BATCH, PAGE, PAGE, 3), generator=gen, device=dev)
    pages = torch.where(masks > 0, pages * 0.3, 0.6 + 0.4 * pages)
    segc = ("seg step, flag on", seg, scfg.optimizer,
            lambda m, mesh=None: make_seg_train_step(m, scfg, mesh=mesh),
            {"image": pages, "mask": masks})
    return [inpaint, segc]


GRAPH_K = 4


def eager_snapshot(state, step, batches, opt, label: str) -> tuple:
    """Run ``step`` over every batch of ``batches`` (stacked) eagerly,
    checking the device lr against the schedule; (snapshot, launches)."""
    from text_segmentation_image_inpainting_tpu_torch.train.state import learning_rate_at

    metrics = []
    zero_launch_counters()
    for i in range(next(iter(batches.values())).shape[0]):
        state, m = step(state, {n: v[i] for n, v in batches.items()})
        metrics.append(m)
        want_lr = learning_rate_at(opt, i + 1)
        if abs(state.lr.item() - want_lr) > 1e-6 * want_lr:
            raise AssertionError(f"{label}: lr {state.lr.item()} after step {i}, the "
                                 f"schedule's {want_lr}")
    torch.cuda.synchronize()
    return add_metrics(state_snapshot(state), metrics), launch_counters()


def graph_phase(dev, rng, tr, smi: str) -> dict:
    """``make_multi_step`` on the card: k = 4 steps of the inpaint step
    (fused stem) and of the seg step (``USE_CUSTOM_WGRAD`` on), each as a
    CUDA graph, against the same 8 steps (two dispatches: a warm-up step,
    the capture, 7 replays) run eagerly from the same state and batches,
    ``GRAPH_EAGER_RUNS`` times, cuDNN deterministic in all runs. The
    tensors that must be bit-equal (parameters, buffers, optimizer state,
    lr, each step's metrics) are derived from the step's structure
    (``probe_nondeterminism``, ``derived_exact``), not sampled: the seg
    step's bilinear resizes add their backward with atomics, so every
    parameter whose gradient crosses one, and from the second step on
    every tensor but the counts and the first forward's metrics, is noisy;
    the inpaint step has no such op, so all of it is exact. Noisy tensors
    may be no farther from the eager runs than ``GRAPH_NOISE_RATIO`` times
    the eager runs' own spread (``check_against_runs``): a replay that went
    wrong (a stale lr or batch, gradients that pile up) moves them by
    orders of magnitude. The inpaint run's device lr must follow the warm-up
    schedule, eagerly and across the replays. Then ms per step, eager and
    graph, and the device kernels per replay. Returns, per step, what
    ``ddp_phase`` holds its data-parallel runs against."""
    from text_segmentation_image_inpainting_tpu_torch.ops import depthwise
    from text_segmentation_image_inpainting_tpu_torch.train.multistep import make_multi_step
    from text_segmentation_image_inpainting_tpu_torch.train.state import (
        create_train_state,
        learning_rate_at,
    )

    k = GRAPH_K
    depthwise.USE_CUSTOM_WGRAD = True
    torch.backends.cudnn.deterministic = True  # in every run alike: less eager-to-eager noise
    out = {}
    for label, model, opt, make_step, batches in graph_cases(dev, rng, tr):
        init = {n: t.clone() for n, t in model.state_dict().items()}

        def fresh(model=model, init=init, opt=opt):
            model.load_state_dict(init)
            return create_train_state(model, opt, capturable=True)

        ops, noisy_params = probe_nondeterminism(make_step(model), fresh,
                                                 {n: v[0] for n, v in batches.items()}, model)
        n_params = sum(1 for _ in model.parameters())
        log(f"graph {label}: nondeterministic ops in one step (deterministic mode's warnings, "
            f"the graph's atomic backward nodes) {sorted(ops) or 'none'}; parameters whose "
            f"gradient crosses one: "
            + ("unknown (an op outside the backward graph): all noisy" if noisy_params is None
               else f"{len(noisy_params)} of {n_params}"
               + (f" (e.g. {sorted(noisy_params)[:4]})" if noisy_params else "")))
        eager, counts = [], None
        for run in range(GRAPH_EAGER_RUNS):
            snap, c = eager_snapshot(fresh(), make_step(model), batches, opt,
                                     f"{label}, eager run {run}")
            eager.append(snap)
            counts = counts or c
        exact = derived_exact(list(eager[0]), noisy_params, 2 * k)
        log(f"graph {label}: the derived exact set: {len(exact)} of {len(eager[0])} tensors "
            f"({', '.join(sorted(exact)[:6])}{', ...' if len(exact) > 6 else ''})")
        state = fresh()
        multi = make_multi_step(make_step(model))
        zero_launch_counters()
        metrics, lrs = [], []
        for half in range(2):
            state, m = multi(state, {n: v[half * k:(half + 1) * k] for n, v in batches.items()})
            metrics.append(m)
            lrs.append(state.lr.item())
        torch.cuda.synchronize()
        counted = {n: c for n, c in launch_counters().items() if n in ("K1", "K6")}
        graph = add_metrics(state_snapshot(state), [
            {n: v[i] for n, v in m.items()} for m in metrics for i in range(k)])
        want_lrs = [learning_rate_at(opt, k), learning_rate_at(opt, 2 * k)]
        if state.step != 2 * k or any(abs(a - b) > 1e-6 * b for a, b in zip(lrs, want_lrs)):
            raise AssertionError(f"{label} graph: step {state.step}, lr {lrs} after the two "
                                 f"dispatches, the schedule's {want_lrs}")
        check_against_runs(f"graph {label}", graph, eager, exact)
        log(f"graph {label}: {2 * k} steps as 2 dispatches of {k} (a warm-up step, the capture, "
            f"7 replays); lr after each dispatch {lrs} = the schedule's; launch counters over "
            f"both dispatches {counted} (the warm-up and the capture)")
        step = make_step(model)
        one = {n: v[0] for n, v in batches.items()}
        four = {n: v[:k] for n, v in batches.items()}
        times = []
        for how in ("eager", "graph", "graph", "eager"):
            if how == "eager":
                times.append(cuda_ms(lambda: step(state, one), iters=2 * k, warmup=1))
            else:
                times.append(cuda_ms(lambda: multi(state, four), iters=2, warmup=1) / k)
        per_replay = kernels_per_call(lambda: multi(state, four), runs=1) / k
        log(f"time {label}: ms per step eager / graph / graph / eager "
            + " / ".join(f"{t:.3f}" for t in times)
            + f"; device kernels per replay (profiler, the batch copies included) "
            f"{per_replay:.0f}  [{smi}]")
        out[label] = {"model": model, "opt": opt, "make_step": make_step, "batches": batches,
                      "fresh": fresh, "eager": eager, "exact": exact, "counts": counts,
                      "noisy_params": noisy_params, "times": times}
        del graph, multi, state, step
        torch.cuda.empty_cache()
    torch.backends.cudnn.deterministic = False
    return out


def check_f32(name, got, x, mask, w, b, kw) -> float:
    """The f32 form's (y, M') against the plain version in f64 on the same
    values: M' bit-exact, y within 1e-5 (|y| + max |y|), exactly 0 in
    empty windows. Returns the largest |error|."""
    from text_segmentation_image_inpainting_tpu_torch.ops.kernels import partial_conv as kpc

    y, m = got
    ref_y, ref_m = kpc.partial_conv2d_reference(
        x.double(), mask.double(), w.double(), None if b is None else b.double(), **kw)
    if y.dtype != torch.float32 or not torch.equal(m.double(), ref_m):
        raise AssertionError(f"{name}: y {y.dtype}, or M' differs from the f64 plain version")
    err = (y.double() - ref_y).abs()
    if not (err <= 1e-5 * (ref_y.abs() + ref_y.abs().max())).all() or (y[ref_m[..., 0] == 0] != 0).any():
        raise AssertionError(f"{name}: |dy| up to {err.max().item():.4g} against the f64 plain "
                             f"version (max |y| {ref_y.abs().max().item():.4g})")
    return err.max().item()


def check_grads_f32(name, x, mask, w, b, g, kw) -> tuple:
    """The f32 backward (K3F) against autograd of the plain version in f64:
    each gradient within ``check_grads``' gate (1% relative L2, 2^-5 of
    its max |value|); two launches bit-identical with cuDNN deterministic
    (its f32 products otherwise pick atomic algorithms at some layers).
    Returns (largest relative L2, largest |error|)."""
    from text_segmentation_image_inpainting_tpu_torch.ops.kernels import partial_conv as kpc

    gs, pad = kw["group_sizes"], kw["padding"]
    needs = (True, True, b is not None)
    # the library products pick atomic algorithms unless told to be deterministic
    torch.backends.cudnn.deterministic = True
    try:
        got = kpc.partial_conv2d_backward(g, x, mask, w, b, gs, pad, needs)
        again = kpc.partial_conv2d_backward(g, x, mask, w, b, gs, pad, needs)
    finally:
        torch.backends.cudnn.deterministic = False
    ref = [t.detach().double().requires_grad_(True) for t in (x, w, b) if t is not None]
    y_ref, _ = kpc.partial_conv2d_reference(ref[0], mask.double(), ref[1],
                                            ref[2] if b is not None else None, **kw)
    want = torch.autograd.grad(y_ref, ref, g.double())
    worst = worst_abs = 0.0
    for what, a, a2, r in zip(("dx", "dW", "db"), got, again, want):
        if a.dtype != torch.float32 or not torch.equal(a, a2):
            raise AssertionError(f"{name} {what}: {a.dtype}, or two launches differ")
        rel, err = rel_l2(a.double(), r), (a.double() - r).abs().max().item()
        if not torch.isfinite(a).all() or rel > 1e-2 or err > 2**-5 * r.abs().max().item():
            raise AssertionError(f"{name} {what}: relative L2 {rel:.3g}, max |d| {err:.4g}")
        worst, worst_abs = max(worst, rel), max(worst_abs, err)
    return worst, worst_abs


def f32_phase(dev, rng, cases, smi: str) -> dict:
    """The f32 form of K1/K2 (K1F ``pconv_k1f``, K2F ``pconv_k2f``) and of
    their backward (K3F:
    ``pconv_k3_prep`` and ``pconv_k3_mask`` in f32 around one f32
    ``convolution_backward``, TF32 off, at the decoder levels; at the head
    ``pconv_k3_prep``, ``pconv_k2f_bwd`` and ``pconv_colsum``), as
    an f32 U-Net runs them: at the
    U-Net's 8 stride-1 shapes against the plain version in f64 (M'
    bit-exact, y within 1e-5 (|y| + max |y|); the gradients within
    ``check_grads``' gate), each launched twice (bit-identical); the f32
    U-Net forward at 512^2, batch 8, depth 8 (K1F 7, K2F 1; every layer's
    own inputs re-run through the f64 plain version) and one f32 inpaint
    step (K3F 8, terms finite). Times per layer with CUDA events beside the
    plain version in f32, cuDNN's f32 conv on the masked input with TF32
    off (the library column, never called by the port) and the bound at
    the card's f32 peak without the tensor cores; at the head also each
    kernel's device time (torch.profiler) in K2F, in its backward and in
    the backward asked for dx only and for dW only, with the head kernels'
    resident CTAs an SM and ptxas's registers and spills. Returns the sums
    per form, the head backward's own numbers ("head", the kernels line's
    "K3F head"), the stem's and the launches."""
    from text_segmentation_image_inpainting_tpu_torch.losses.inpainting import (
        InpaintLossConfig,
        make_vgg,
    )
    from text_segmentation_image_inpainting_tpu_torch.models import InpaintUNet, PartialConv
    from text_segmentation_image_inpainting_tpu_torch.ops.kernels import partial_conv as kpc
    from text_segmentation_image_inpainting_tpu_torch.ops.partial_conv import apply_mask
    from text_segmentation_image_inpainting_tpu_torch.train.config import InpaintTrainConfig
    from text_segmentation_image_inpainting_tpu_torch.train.inpaint import make_inpaint_train_step
    from text_segmentation_image_inpainting_tpu_torch.train.state import create_train_state

    from text_segmentation_image_inpainting_tpu_torch.ops.kernels.build import load_library

    f32 = torch.float32
    lib = load_library()
    log("resident CTAs an SM (occupancy calculator): K1F pconv_k1f<128, 128> "
        f"{lib.tsii_k1f_occupancy(128)}, <256, 64> {lib.tsii_k1f_occupancy(256)}; "
        + ", ".join(f"{name} {lib.tsii_stem_f32_occupancy(i)}" for i, name in enumerate(
            ("stem_f32_conv1<POOL>", "<GRAD>", "<DGRAD>", "stem_f32_dx"))))
    _, hh, c_lo, c_skip, _ = SHAPES[-1]
    head_bwd = kpc.k2f_bwd_plan(BATCH, hh, hh, c_lo + c_skip, 3, 3)
    log(f"resident CTAs an SM (occupancy calculator), the head's kernels at Cin {c_lo + c_skip}: "
        f"K2F pconv_k2f<3, 3> {lib.tsii_k2f_occupancy(0, c_lo + c_skip, 1)}, its backward "
        f"pconv_k2f_bwd<3, 3> ({head_bwd.threads} threads, {head_bwd.nseg} segments) "
        f"{lib.tsii_k2f_occupancy(1, c_lo + c_skip, head_bwd.nseg)}")
    for line in ptxas_report(("pconv_k2fILi3ELi3E", "pconv_k2f_bwdILi3ELi3E")):
        log(f"  ptxas (the head's kernels): {line}")
    head = None
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    tot = {n: {"ms": 0.0, "plain": 0.0, "lib": 0.0, "bound": 0.0, "err": 0.0, "n": 0,
               "operations": 0.0, "bytes": 0.0} for n in ("K1F", "K2F", "K3F")}
    for kname, name, x, mask, w, b, kw, _ in cases:
        x32, m32, w32 = x.float(), mask.float(), w.float()
        b32 = None if b is None else b.float()
        fname = "K2F" if kname == "K2" else "K1F"
        got = kpc.partial_conv2d_fused(x32, m32, w32, b32, **kw)
        again = kpc.partial_conv2d_fused(x32, m32, w32, b32, **kw)
        if not all(torch.equal(a, c) for a, c in zip(got, again)):
            raise AssertionError(f"{fname} {name}: two launches differ")
        err = check_f32(f"{fname} {name}", got, x32, m32, w32, b32, kw)
        g = torch.randn(got[0].shape, generator=gen, device=dev)
        rel3, err3 = check_grads_f32(f"K3F {name}", x32, m32, w32, b32, g, kw)
        gs, pad = kw["group_sizes"], kw["padding"]
        xm = apply_mask(x32, m32, gs).permute(0, 3, 1, 2)  # channels-last NCHW view
        wcl = w32.contiguous(memory_format=torch.channels_last)
        gcl = g.permute(0, 3, 1, 2)
        fwd = {"ms": lambda: kpc.partial_conv2d_fused(x32, m32, w32, b32, **kw),
               "plain": lambda: kpc.partial_conv2d_reference(x32, m32, w32, b32, **kw),
               "lib": lambda: torch.nn.functional.conv2d(xm, wcl, padding=pad)}
        bwd = {"ms": lambda: kpc.partial_conv2d_backward(g, x32, m32, w32, b32, gs, pad),
               "plain": lambda: kpc.partial_conv2d_backward_reference(g, x32, m32, w32, b32, gs,
                                                                     pad),
               "lib": lambda: torch.ops.aten.convolution_backward(
                   gcl, xm, wcl, None, [1, 1], list(pad), [1, 1], False, [0, 0], 1,
                   [True, True, False])}
        flop, nbytes = pconv_work(x, mask, w)
        bflop, bbytes = pconv_bwd_work(x, mask, w, g)
        plan, times = "", {}
        if fname == "K1F":
            n_, h_, w_, cin_ = x.shape
            kp = kpc.k1f_plan(n_, h_, w_, cin_, w.shape[0], w.shape[2], kw["padding"])
            plan = (f", tile {kp.bm}x{kp.bn}, splits {kp.splits}, "
                    f"{kp.grid(n_, h_, w_, w.shape[0])} CTAs")
        for tname, fns, work, e in ((fname, fwd, (flop, 2 * nbytes), err),
                                    ("K3F", bwd, (bflop, 2 * bbytes), err3)):
            t = {key: cuda_ms(fn) for key, fn in fns.items()}
            b_ms, b_by = bound(*work, peak=PEAK_F32)
            times[tname] = dict(t, bound=b_ms, by=b_by)
            log(f"time {tname} {name}: kernel {t['ms']:.4f} ms ({work[0] / t['ms'] / 1e9:.1f} "
                f"TFLOP/s{plan if tname == 'K1F' else ''}), plain f32 {t['plain']:.4f} ms, "
                f"cuDNN f32 (TF32 off) {t['lib']:.4f} ms, bound {b_ms:.4f} ms ({b_by}; f32 peak "
                f"{PEAK_F32 / 1e12:.0f} TFLOP/s)  [{smi}]")
            acc = tot[tname]
            for key in ("ms", "plain", "lib"):
                acc[key] += t[key]
            acc["bound"] += b_ms
            acc[b_by] += b_ms  # what bounds the sum: the kind that bounds most of it
            acc["by"] = max(("operations", "bytes"), key=lambda kind: acc[kind])
            acc["err"], acc["n"] = max(acc["err"], e), acc["n"] + 1
        log(f"parity {fname} {name}: x {tuple(x32.shape)} f32 -> y {tuple(got[0].shape)}, M' "
            f"bit-exact, max |dy| to the f64 plain {err:.4g}; K3F relative L2 {rel3:.3g}, max "
            f"|d| {err3:.4g}; two launches bit-identical")
        if fname == "K2F":  # the head: each kernel's device time
            head = dict(times["K3F"], err=err3)
            part = {"K2F": fwd["ms"], "K3F head": bwd["ms"],
                    "K3F head, dx only": lambda: kpc.partial_conv2d_backward(
                        g, x32, m32, w32, b32, gs, pad, (True, False, False)),
                    "K3F head, dW only": lambda: kpc.partial_conv2d_backward(
                        g, x32, m32, w32, b32, gs, pad, (False, True, False))}
            for what, fn in part.items():
                log(f"time {what} (device, ms a launch): " + ", ".join(
                    f"{k} {v:.4f}" for k, v in sorted(kernel_ms(fn).items())) + f"  [{smi}]")
    del xm, wcl, gcl, fwd, bwd

    # the f32 U-Net forward at full width, every layer's inputs re-run in f64
    unet = InpaintUNet(depth=8, dtype=f32).init_weights(
        torch.Generator().manual_seed(SEED + 12)).to(dev).eval()
    pages = torch.rand((BATCH, PAGE, PAGE, 3), generator=gen, device=dev)
    holes = torch.from_numpy(hole_mask(rng, BATCH, PAGE, PAGE)[..., None]).to(dev)
    calls = []

    def keep(module, args, kwargs, output):
        if module.conv.stride == (1, 1):
            calls.append((module, args[0], args[1], kwargs.get("group_sizes"), output))

    hooks = [m.register_forward_hook(keep, with_kwargs=True) for m in unet.modules()
             if isinstance(m, PartialConv)]
    zero_launch_counters()
    with torch.no_grad():
        out = unet(pages * holes, holes)
    torch.cuda.synchronize()
    fwd_launches = launch_counters()
    for hk in hooks:
        hk.remove()
    if (fwd_launches["K1F"], fwd_launches["K2F"], fwd_launches["K1"], fwd_launches["K2"]) != (
            7, 1, 0, 0) or not torch.isfinite(out).all() or out.dtype != f32:
        raise AssertionError(f"f32 U-Net: launches {fwd_launches}, output {out.dtype}, finite "
                             f"{bool(torch.isfinite(out).all())}")
    for i, (module, x, m, gs, (y, mo)) in enumerate(calls):
        c = module.conv
        e = check_f32(f"f32 U-Net layer {i}", (y, mo), x, m, c.weight, c.bias,
                      dict(group_sizes=gs, padding=c.padding))
        log(f"f32 U-Net layer {i}: x {tuple(x.shape)} -> {c.out_channels}: the f32 form == the "
            f"f64 plain on the U-Net's own inputs, max |dy| {e:.4g}")
    del calls, out

    # one f32 inpaint step, the VGG trunk in f32 with the fused stem (K4F, K5F)
    torch.manual_seed(SEED)
    loss_cfg = InpaintLossConfig(vgg_dtype="float32", fused_stem=True)
    vgg = make_vgg(loss_cfg).to(dev)
    stem = f32_stem_phase(dev, vgg, pages, holes, smi)
    unet.train()
    state = create_train_state(unet, InpaintTrainConfig().optimizer)
    step = make_inpaint_train_step(unet, InpaintTrainConfig(loss=loss_cfg), vgg)
    batch = {"image": pages, "mask": holes}
    grads = {}

    def keep_grads(opt, args, kwargs):
        for name, prm in unet.named_parameters():
            grads[name] = prm.grad is not None and bool(torch.isfinite(prm.grad).all())

    hook = state.optimizer.register_step_pre_hook(keep_grads)
    zero_launch_counters()
    state, terms = step(state, batch)
    torch.cuda.synchronize()
    step_launches = launch_counters()
    hook.remove()
    want = {"K1F": 7, "K2F": 1, "K3F": 8, "K3F_HEAD": 1, "K4F": 1, "K5F": 1, "K3": 0, "K4": 0,
            "K5": 0}
    bad_grads = [n for n, ok in grads.items() if not ok]
    if {k: step_launches[k] for k in want} != want or not all(
            torch.isfinite(v) for v in terms.values()) or not grads or bad_grads:
        raise AssertionError(f"f32 step: launches {step_launches}, terms {terms}, gradients "
                             f"missing or non-finite {bad_grads}")
    step_ms = cuda_ms(lambda: step(state, batch), iters=3, warmup=1)
    log(f"f32 inpaint step (512^2, batch {BATCH}, depth 8, VGG f32, fused stem): launches "
        f"{ {k: v for k, v in step_launches.items() if v} }; terms "
        + ", ".join(f"{k} {v.item():.5g}" for k, v in terms.items())
        + f"; {len(grads)} gradients finite; {step_ms:.3f} ms per step  [{smi}]")
    for n, acc in tot.items():
        log(f"{n}: {acc['n']} shape(s); ms, plain_ms, library_ms and bound_ms summed over them")
    del unet, state, step, vgg, batch, pages, holes
    torch.cuda.empty_cache()
    return {"totals": tot, "stem": stem, "head": head,
            "launches": {"K1F": fwd_launches["K1F"], "K2F": fwd_launches["K2F"],
                         "K3F": step_launches["K3F"], "K3F_HEAD": step_launches["K3F_HEAD"],
                         "K4F": step_launches["K4F"], "K5F": step_launches["K5F"]}}


def check_stem_f32(name, x, g, w0, b0, w1, b1, z0) -> dict:
    """K4F and K5F against the f64 truth (the plain versions in f64), each
    launched twice on the same inputs (bit-identical). K4F: relative L2 no
    more than 1.25 x that of the plain f32 version (cuDNN f32, TF32 off):
    at a near-tie in a 2x2 pool f32 and f64 may route the gradient to
    different pixels, which no f32 stem avoids (the bf16 gate's reason).
    K5F: within 1e-5 (|y| + max |y|) of f64."""
    from text_segmentation_image_inpainting_tpu_torch.ops.kernels import vgg_stem as kvs

    got, again = kvs.stem_dx(x, g, w0, b0, w1, b1), kvs.stem_dx(x, g, w0, b0, w1, b1)
    plain = kvs.stem_dx_reference(x, g, w0, b0, w1, b1)
    truth = kvs.stem_dx_reference(*(t.double() for t in (x, g, w0, b0, w1, b1)))
    torch.cuda.synchronize()
    if got.dtype != torch.float32 or got.shape != x.shape or not torch.equal(got, again):
        raise AssertionError(f"K4F {name}: dx {got.dtype} {tuple(got.shape)}, or two launches differ")
    res = {"rel": rel_l2(got.double(), truth), "rel_plain": rel_l2(plain.double(), truth),
           "max": (got.double() - truth).abs().max().item()}
    del got, again, plain, truth
    if not res["rel"] <= 1.25 * res["rel_plain"]:
        raise AssertionError(f"K4F {name}: relative L2 to f64 {res['rel']:.4g}, more than 1.25 x "
                             f"the f32 cuDNN stem's {res['rel_plain']:.4g}")
    y, y2 = kvs.stem_pool(z0, w1, b1), kvs.stem_pool(z0, w1, b1)
    want = kvs.stem_pool_reference(z0.double(), w1.double(), b1.double())
    torch.cuda.synchronize()
    err = (y.double() - want).abs()
    if y.dtype != torch.float32 or not torch.equal(y, y2) or not (
            err <= 1e-5 * (want.abs() + want.abs().max())).all():
        raise AssertionError(f"K5F {name}: {y.dtype}, two launches differ, or |dy| up to "
                             f"{err.max().item():.4g} (max |y| {want.abs().max().item():.4g})")
    res["max5"] = err.max().item()
    return res


def f32_stem_phase(dev, vgg, pages, holes, smi: str) -> dict:
    """K4F and K5F (the f32 stem, ``csrc/vgg_stem.cu``): gates
    (``check_stem_f32``) at the f32 step's shapes (x of its 16 pages, z0 of
    its 8 ground-truth pages) and at ``STEM_EXTRA``; then times with CUDA
    events beside the plain f32 versions, cuDNN's f32 stem backward alone
    and cuDNN's f32 conv1 alone (TF32 off; yardsticks the port never
    calls), the bound at the f32 peak, and a profile of K4F's four passes
    (each pass's device time and rate). Returns {K4F, K5F: {ms, plain, lib,
    bound, by, err}}, K4F also with its passes' ms."""
    from text_segmentation_image_inpainting_tpu_torch.ops.conv import conv2d
    from text_segmentation_image_inpainting_tpu_torch.ops.kernels import vgg_stem as kvs

    w0, b0 = vgg.features[0].weight, vgg.features[0].bias
    w1, b1 = vgg.features[2].weight, vgg.features[2].bias
    xs = vgg.normalize_input(torch.cat([pages, pages * holes])).contiguous()
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    gs = torch.randn((2 * BATCH, PAGE // 2, PAGE // 2, 64), generator=gen, device=dev)
    z0 = conv2d(xs[:BATCH], w0, b0, padding=1).contiguous()
    res = check_stem_f32("step shapes", xs, gs, w0, b0, w1, b1, z0)
    log(f"parity K4F x {tuple(xs.shape)}: relative L2 to f64 {res['rel']:.4g} (cuDNN f32 "
        f"{res['rel_plain']:.4g}, gate 1.25x), max |d| {res['max']:.4g}; K5F z0 {tuple(z0.shape)} "
        f"max |d| {res['max5']:.4g}; each twice bit-identical")
    for m, h, w in STEM_EXTRA:
        ws = stem_weights(gen, dev)
        x = torch.randn((m, h, w, 3), generator=gen, device=dev)
        g = torch.randn((m, h // 2, w // 2, 64), generator=gen, device=dev)
        z = torch.randn((m, h, w, 64), generator=gen, device=dev)
        r = check_stem_f32(f"{m}x{h}x{w}", x, g, *ws, z)
        log(f"parity K4F/K5F {m}x{h}x{w}: K4F relative L2 {r['rel']:.4g} (cuDNN f32 "
            f"{r['rel_plain']:.4g}); K5F max |d| {r['max5']:.4g}; each twice bit-identical")

    kern = lambda: kvs.stem_dx(xs, gs, w0, b0, w1, b1)  # noqa: E731
    plain = lambda: kvs.stem_dx_reference(xs, gs, w0, b0, w1, b1)  # noqa: E731
    xr = xs.detach().requires_grad_(True)
    out = kvs.stem_forward(xr, w0, b0, w1, b1, torch.float32)
    lib = lambda: torch.autograd.grad(out, xr, gs, retain_graph=True)  # noqa: E731
    p1, k1, k2, p2 = (cuda_ms(f, iters=5, warmup=1) for f in (plain, kern, kern, plain))
    t_lib = cuda_ms(lib, iters=5, warmup=1)
    del out, xr
    px = xs.shape[0] * PAGE * PAGE
    flop = 2.0 * px * 64 * 64 * 9 * 2 + 4.0 * px * 64 * 27
    k4 = {"ms": (k1 + k2) / 2, "plain": (p1 + p2) / 2, "lib": t_lib, "err": res["max"]}
    k4["bound"], k4["by"] = bound(flop, 4.0 * (2 * xs.numel() + gs.numel() + w0.numel()
                                               + w1.numel()), peak=PEAK_F32)
    log(f"time K4F x {tuple(xs.shape)}: kernel {k1:.3f} / {k2:.3f} ms ({flop / k4['ms'] / 1e9:.1f} "
        f"TFLOP/s), plain f32 forward+backward {p1:.3f} / {p2:.3f} ms, cuDNN's f32 stem backward "
        f"alone {t_lib:.3f} ms, bound {k4['bound']:.3f} ms ({k4['by']}; f32 peak "
        f"{PEAK_F32 / 1e12:.0f} TFLOP/s)  [{smi}]")
    profile_run(kern, "K4F (its four passes: stem_f32_conv0, stem_f32_conv1<GRAD>, "
                "stem_f32_conv1<DGRAD>, stem_f32_dx)", runs=2)
    conv1_flop = 2.0 * px * 64 * 64 * 9
    passes = {"stem_f32_conv0": ("1, conv0", 2.0 * px * 64 * 27),
              "stem_f32_conv1<1>": ("2, conv1 with the pool gradient (GRAD)", conv1_flop),
              "stem_f32_conv1<2>": ("3, conv1's dgrad (DGRAD)", conv1_flop),
              "stem_f32_dx": ("4, conv0's dgrad", 2.0 * px * 64 * 27)}
    k4["passes"] = kernel_ms(kern)
    for key, (what, pflop) in {"stem_f32_weights": ("0, the weights' re-lay", 0.0),
                               **passes}.items():
        ms = k4["passes"].get(key)
        if ms is None:
            log(f"K4F pass {what}: {key} not recorded by the profiler")
            continue
        log(f"K4F pass {what}: {key} {ms:.3f} ms (device"
            + (f", {pflop / ms / 1e9:.1f} TFLOP/s)" if pflop else ")") + f"  [{smi}]")
    kern = lambda: kvs.stem_pool(z0, w1, b1)  # noqa: E731
    plain = lambda: kvs.stem_pool_reference(z0, w1, b1)  # noqa: E731
    zn, w1cl = z0.permute(0, 3, 1, 2), w1.contiguous(memory_format=torch.channels_last)
    lib = lambda: torch.nn.functional.conv2d(zn, w1cl, padding=1)  # noqa: E731
    p1, k1, k2, p2 = (cuda_ms(f) for f in (plain, kern, kern, plain))
    t_lib = cuda_ms(lib)
    flop = 2.0 * z0.shape[0] * PAGE * PAGE * 64 * 64 * 9
    k5 = {"ms": (k1 + k2) / 2, "plain": (p1 + p2) / 2, "lib": t_lib, "err": res["max5"]}
    k5["bound"], k5["by"] = bound(flop, 4.0 * (z0.numel() * 5 / 4 + w1.numel()), peak=PEAK_F32)
    log(f"time K5F z0 {tuple(z0.shape)}: kernel {k1:.3f} / {k2:.3f} ms ({flop / k5['ms'] / 1e9:.1f} "
        f"TFLOP/s), plain f32 {p1:.3f} / {p2:.3f} ms, cuDNN's f32 conv1 alone {t_lib:.3f} ms, bound "
        f"{k5['bound']:.3f} ms ({k5['by']})  [{smi}]")
    del xs, gs, z0, zn, w1cl
    torch.cuda.empty_cache()
    return {"K4F": k4, "K5F": k5}


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


DP2_LABELS = ("inpaint step", "seg step, flag on")


def dp2_case(label: str, dev, dtype=torch.bfloat16) -> tuple:
    """The 2-rank runs' step, built alike in every process from seeds:
    (model, opt, make_step(model, mesh=None), global batch of BATCH pages
    whose halves differ: darker pages and fewer holes or less text in the
    first). SGD, as the CPU step tests: Adam's first step is lr * sign(g)
    wherever |g| is large beside its epsilon, so it turns rounding noise in
    small gradients into whole steps. ``dtype`` float32 is the truth the
    bf16 runs are held to (the VGG trunk then on cuDNN: K4/K5 take bf16)."""
    from text_segmentation_image_inpainting_tpu_torch.losses.inpainting import (
        InpaintLossConfig,
        make_vgg,
    )
    from text_segmentation_image_inpainting_tpu_torch.models import InpaintUNet, TextSegmenter
    from text_segmentation_image_inpainting_tpu_torch.train.config import (
        InpaintTrainConfig,
        OptimizerConfig,
        SegTrainConfig,
    )
    from text_segmentation_image_inpainting_tpu_torch.train.inpaint import make_inpaint_train_step
    from text_segmentation_image_inpainting_tpu_torch.train.seg import make_seg_train_step

    bf, half = dtype, BATCH // 2
    sgd = OptimizerConfig(kind="sgd", learning_rate=0.01)
    gen = torch.Generator(device=dev).manual_seed(SEED + 21)
    nrng = np.random.default_rng(SEED + 22)
    pages = torch.rand((BATCH, PAGE, PAGE, 3), generator=gen, device=dev)
    pages[:half] *= 0.5
    if label == "inpaint step":
        torch.manual_seed(SEED)  # the VGG trunk's default init, as the train phase's
        f32 = dtype == torch.float32
        loss_cfg = InpaintLossConfig(vgg_dtype="float32" if f32 else "bfloat16", fused_stem=not f32)
        vgg = make_vgg(loss_cfg).to(dev)
        cfg = InpaintTrainConfig(loss=loss_cfg, optimizer=sgd)
        model = InpaintUNet(depth=8, dtype=bf).init_weights(
            torch.Generator().manual_seed(SEED + 20)).to(dev)
        holes = hole_mask(nrng, BATCH, PAGE, PAGE)
        holes[half:] *= hole_mask(nrng, half, PAGE, PAGE)  # more holes in the second half
        batch = {"image": pages, "mask": torch.from_numpy(holes[..., None]).to(dev)}
        return model, cfg.optimizer, lambda m, mesh=None: make_inpaint_train_step(
            m, cfg, vgg, mesh=mesh), batch
    cfg = SegTrainConfig(optimizer=sgd)
    model = TextSegmenter(dtype=bf).init_weights(torch.Generator().manual_seed(SEED + 23)).to(dev)
    text = text_targets(nrng, BATCH, PAGE, PAGE)
    text[half:] = np.maximum(text[half:], text_targets(nrng, half, PAGE, PAGE))  # more text
    masks = torch.from_numpy(text).to(dev)
    pages = torch.where(masks > 0, pages * 0.3, 0.6 + 0.4 * pages)
    return model, cfg.optimizer, lambda m, mesh=None: make_seg_train_step(m, cfg, mesh=mesh), {
        "image": pages, "mask": masks}


@contextlib.contextmanager
def per_rank_statistics():
    """BatchNorm with each rank's own statistics: the cross-rank sum of
    ``ops/collectives.py`` undone (a check that the gate has teeth; the
    port has no such switch)."""
    from text_segmentation_image_inpainting_tpu_torch.ops import collectives

    summed = collectives.all_reduce_stats
    collectives.all_reduce_stats = lambda x: x * collectives.dp_world()
    try:
        yield
    finally:
        collectives.all_reduce_stats = summed


def dp2_orders(n: int) -> list:
    """Orders of a global batch of ``n`` pages in which one process's step
    is the same function of the batch while its f32 sums (BatchNorm's row
    blocks, the loss's reductions) round otherwise, as the 2-rank step's
    do: reversed, halves swapped, evens then odds."""
    i = torch.arange(n)
    return [i.flip(0), i.roll(n // 2), torch.cat([i[0::2], i[1::2]])]


def dp2_references(dev) -> tuple:
    """The 1-process references of the 2-rank runs, per label of
    ``DP2_LABELS``: the same step in bf16, three times on the batch as it
    is and once in each of ``dp2_orders``, then in f32, the truth; with
    each label's initial state dict. ({label: [snapshots]}, {label: init})."""
    from text_segmentation_image_inpainting_tpu_torch.train.state import create_train_state

    refs, inits = {}, {}
    for label in DP2_LABELS:
        runs = []
        for dtype, order in ([(torch.bfloat16, None)] * 3
                             + [(torch.bfloat16, o) for o in dp2_orders(BATCH)]
                             + [(torch.float32, None)]):
            model, opt, make_step, batch = dp2_case(label, dev, dtype)
            if order is not None:
                batch = {n: v[order.to(v.device)] for n, v in batch.items()}
            inits[label] = {n: t.detach().cpu().clone() for n, t in model.state_dict().items()}
            state = create_train_state(model, opt)
            state, m = make_step(model)(state, batch)
            runs.append(cpu_snapshot(state, m))
            del model, state, batch
            torch.cuda.empty_cache()
        refs[label] = runs
    return refs, inits


def dp2_distances(label: str, got: dict, per_rank: dict, refs: dict, inits: dict) -> tuple:
    """Per kind (``pooled_distances``), the distance to the f32 1-process
    step of the 2-rank step ``got``, the floor (the farthest of the bf16
    1-process steps of ``dp2_references``: bf16 noise, as rounded by
    reductions that differ) and the 2-rank step with each rank's own
    BatchNorm statistics ``per_rank``: (d, d_ref, d_bad)."""
    init = inits[label]
    truth = moves(refs[label][-1], init)
    names = [n for n in truth if not n.endswith("num_batches_tracked")]
    runs_d = [pooled_distances(moves(r, init), truth, names) for r in refs[label][:-1]]
    d_ref = {k: max(d[k] for d in runs_d) for k in runs_d[0]}
    return (pooled_distances(moves(got, init), truth, names), d_ref,
            pooled_distances(moves(per_rank, init), truth, names))


def moves(snap: dict, init: dict) -> dict:
    """A 1-step snapshot as what the step did: each parameter's and float
    buffer's move from ``init`` (the state dict it started from), and the
    metrics."""
    out = {}
    for n, t in snap.items():
        kind, _, key = n.partition(" ")
        if kind in ("param", "buffer") and t.is_floating_point():
            out[n] = t.double() - init[key].double()
        else:
            out[n] = t
    return out


def pooled_distances(a: dict, b: dict, names) -> dict:
    """Per kind (parameters, buffers, metrics), the relative L2 distance of
    all of the kind's ``names`` taken as one vector: the large moves weigh
    as they are, and a tensor whose true move is rounding noise (a BN bias
    that the next BN cancels) cannot swamp the rest as it would in a mean
    of per-tensor ratios."""
    out = {}
    for kind in ("param", "buffer", "metric"):
        grp = [n for n in names if n.split(" ")[0] == kind]
        if grp:
            va = torch.cat([a[n].double().reshape(-1) for n in grp])
            vb = torch.cat([b[n].double().reshape(-1) for n in grp])
            out[kind] = ((va - vb).norm() / vb.norm().clamp_min(1e-30)).item()
    return out


def cpu_snapshot(state, metrics) -> dict:
    snap = add_metrics(state_snapshot(state, adam=False), [metrics])
    return {n: t.cpu() for n, t in snap.items()}


def dp2_worker(rank: int, port: int, out_dir: str) -> None:
    """One of two ranks on one card (gloo, which takes CUDA tensors and two
    ranks on one card; NCCL refuses): each step of ``DP2_LABELS`` over the
    2-rank mesh on this rank's 4 pages of the global batch, with the
    cross-rank BatchNorm statistics and without, its ms per step; then
    ``concurrent_train2`` over ``make_group_meshes`` (rank 0 the seg
    group, rank 1 the inpaint group), one step each on the whole batch.
    Writes what it found to ``out_dir/rank<r>.pt``."""
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import torch.distributed as dist

    from text_segmentation_image_inpainting_tpu_torch.ops import depthwise
    from text_segmentation_image_inpainting_tpu_torch.parallel import (
        concurrent_train2,
        initialize_distributed,
        make_group_meshes,
        make_rank_mesh,
        shard_batch,
    )
    from text_segmentation_image_inpainting_tpu_torch.train.state import create_train_state

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    depthwise.USE_CUSTOM_WGRAD = True
    dev = initialize_distributed(f"127.0.0.1:{port}", num_processes=2, process_id=rank,
                                 local_device_ids=[0], backend="gloo")
    mesh = make_rank_mesh()
    out = {"position": mesh.position(), "backend": mesh.backend}
    for label in DP2_LABELS:
        model, opt, make_step, batch = dp2_case(label, dev)
        init = {n: t.clone() for n, t in model.state_dict().items()}
        step, shard = make_step(model, mesh=mesh), shard_batch(mesh, batch)
        state = create_train_state(model, opt)
        zero_launch_counters()
        state, m = step(state, shard)
        torch.cuda.synchronize()
        out[label] = (cpu_snapshot(state, m), launch_counters())
        out[f"{label} ms"] = cuda_ms(lambda: step(state, shard), iters=5, warmup=1)
        model.load_state_dict(init)
        state = create_train_state(model, opt)
        with per_rank_statistics():
            state, m = step(state, shard)
        out[f"{label} per-rank"] = cpu_snapshot(state, m)
        del model, state, step, shard, batch
        torch.cuda.empty_cache()
    seg_mesh, inp_mesh = make_group_meshes()
    mine = DP2_LABELS[1] if seg_mesh.position() is not None else DP2_LABELS[0]
    model, opt, make_step, batch = dp2_case(mine, dev)
    state = create_train_state(model, opt)
    if mine == DP2_LABELS[1]:
        step = concurrent_train2(make_step(model, mesh=seg_mesh), make_step(None, mesh=inp_mesh))
        state, m, _, _ = step(state, shard_batch(seg_mesh, batch), None, None)
    else:
        step = concurrent_train2(make_step(None, mesh=seg_mesh), make_step(model, mesh=inp_mesh))
        _, _, state, m = step(None, None, state, shard_batch(inp_mesh, batch))
    torch.cuda.synchronize()
    out["concurrent"] = (mine, seg_mesh.ranks.ravel().tolist(), inp_mesh.ranks.ravel().tolist(),
                         cpu_snapshot(state, m))
    torch.save(out, Path(out_dir) / f"rank{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()


def ddp_phase(dev, gr, smi: str) -> dict:
    """The data-parallel steps (``parallel/mesh.py`` rank meshes,
    ``ops/collectives.py``) on the card, at the slice's full width (512^2,
    batch 8, bf16, depth 8, width 1.0).

    World 1 (NCCL, this process on cuda:0): the inpaint step (fused stem:
    K1 7, K2 1, K3 8, K4 1, K5 1 a step) and the seg step (flag on: K6 14)
    over the rank mesh, eagerly and as the k = 4 CUDA graph with the
    all-reduces captured, against the graph phase's plain eager runs of the
    same 8 steps with its gate (``check_against_runs``: the derived exact
    set bit-equal, the rest within ``GRAPH_NOISE_RATIO`` of the eager
    spread) and the same launch counts; ms per step beside the plain step.

    Two ranks on the card (gloo; ``dp2_worker``): one SGD step of each on
    4 pages a rank of a global batch of 8 whose halves differ. A rank's
    kernels see 4 pages where one process's see 8, so their plans and
    cuDNN's algorithms differ and the bf16 activations round differently:
    BatchNorm's kernels sum a rank's rows in other row blocks, and one
    changed rounding makes another bf16 step (the seg step's atomics alone
    do not: three runs on one batch differ by a few percent of the 2-rank step's
    distance). So the 2-rank step is held to the same step of one process
    in f32, the truth: in each kind (the parameters' moves, the BN
    statistics' moves, the metrics; ``pooled_distances``) no farther from
    it than ``GRAPH_NOISE_RATIO`` times the farthest of the 1-process bf16
    steps, on the batch as it is and in ``dp2_orders``, whose sums round
    otherwise as the 2-rank step's do (``dp2_references``,
    ``dp2_distances``). The metrics are a few scalars, so one bf16 step's
    distance is a single draw of that noise and the floor takes the
    farthest of four. The run with each rank's own
    BatchNorm statistics must fail that gate in some kind (the BN
    statistics: bf16 noise barely touches them); both ranks end
    bit-equal, with the plain step's launches.
    ``concurrent_train2`` (a group of one rank each): each group's step
    equals its step run alone at the graph phase's gate."""
    import tempfile

    import torch.distributed as dist
    import torch.multiprocessing as mp

    from text_segmentation_image_inpainting_tpu_torch.parallel import (
        initialize_distributed,
        make_rank_mesh,
    )
    from text_segmentation_image_inpainting_tpu_torch.train.multistep import make_multi_step

    from text_segmentation_image_inpainting_tpu_torch.ops import collectives, depthwise

    k = GRAPH_K
    depthwise.USE_CUSTOM_WGRAD = True
    torch.backends.cudnn.deterministic = True
    initialize_distributed(f"127.0.0.1:{free_port()}", num_processes=1, process_id=0,
                           local_device_ids=[dev.index or 0])
    mesh = make_rank_mesh()
    if (mesh.backend, mesh.size, mesh.position()) != ("nccl", 1, 0):
        raise AssertionError(f"world 1: backend {mesh.backend}, size {mesh.size}")
    times = {}
    for label, c in gr.items():
        model, fresh, batches, opt = c["model"], c["fresh"], c["batches"], c["opt"]
        make_step = c["make_step"]
        snap, counts = eager_snapshot(fresh(), make_step(model, mesh=mesh), batches, opt,
                                      f"ddp {label}, world 1, eager")
        if counts != c["counts"]:
            raise AssertionError(f"ddp {label}: launches {counts}, the plain step's {c['counts']}")
        check_against_runs(f"ddp {label}, world 1, eager", snap, c["eager"], c["exact"])
        state = fresh()
        multi = make_multi_step(make_step(model, mesh=mesh))
        metrics = []
        for half in range(2):
            state, m = multi(state, {n: v[half * k:(half + 1) * k] for n, v in batches.items()})
            metrics.append(m)
        graph = add_metrics(state_snapshot(state), [
            {n: v[i] for n, v in m.items()} for m in metrics for i in range(k)])
        check_against_runs(f"ddp {label}, world 1, graph", graph, c["eager"], c["exact"])
        log(f"ddp {label}, world 1: launches over 8 eager steps {counts} = the plain step's")
        plain, dp = make_step(model), make_step(model, mesh=mesh)
        one = {n: v[0] for n, v in batches.items()}
        four = {n: v[:k] for n, v in batches.items()}
        t = [cuda_ms(lambda: f(state, one), iters=2 * k, warmup=1) for f in (plain, dp, dp, plain)]
        t_graph = cuda_ms(lambda: multi(state, four), iters=2, warmup=1) / k
        times[label] = {"plain": t, "graph": t_graph}
        log(f"time ddp {label}: ms per step plain / DP world 1 / DP world 1 / plain "
            + " / ".join(f"{x:.3f}" for x in t)
            + f"; DP world 1 as the k = {k} graph {t_graph:.3f} (the graph phase's plain graph "
            f"{c['times'][1]:.3f} / {c['times'][2]:.3f})  [{smi}]")
        del graph, multi, state, plain, dp
        torch.cuda.empty_cache()
    # what one eager collective costs: a BatchNorm's (E[x], E[x^2]) of 512 channels
    stats = torch.ones(1024, device=dev)
    with mesh.data_parallel():
        per_call = cuda_ms(lambda: [collectives.all_reduce_stats(stats) for _ in range(100)],
                           iters=5, warmup=1) / 100
        t0 = time.perf_counter()
        for _ in range(100):
            collectives.all_reduce_stats(stats)
        host = (time.perf_counter() - t0) / 100 * 1e3
        torch.cuda.synchronize()
    times["all_reduce"] = per_call
    log(f"ddp world 1: one eager all-reduce of 1024 floats {per_call:.4f} ms (events), "
        f"{host:.4f} ms of host time per call  [{smi}]")
    dist.destroy_process_group()

    refs, inits = dp2_references(dev)
    out_dir = tempfile.mkdtemp(prefix="ddp2_")
    t0 = time.perf_counter()
    mp.spawn(dp2_worker, args=(free_port(), out_dir), nprocs=2, join=True)
    ranks = [torch.load(Path(out_dir) / f"rank{r}.pt", weights_only=False) for r in (0, 1)]
    log(f"ddp 2 ranks on cuda:0 (gloo): {time.perf_counter() - t0:.1f} s for both processes, "
        f"positions {[r['position'] for r in ranks]}, backend {ranks[0]['backend']}")
    for label in DP2_LABELS:
        (got, counts), (got1, _) = ranks[0][label], ranks[1][label]
        if any(not torch.equal(got[n], got1[n]) for n in got):
            raise AssertionError(f"ddp {label}, 2 ranks: the ranks' states differ")
        if {n: v * 2 * GRAPH_K for n, v in counts.items()} != gr[label]["counts"]:
            raise AssertionError(f"ddp {label}, 2 ranks: launches {counts} a step, the plain "
                                 f"step's {gr[label]['counts']} over {2 * GRAPH_K}")
        d, d_ref, d_bad = dp2_distances(label, got, ranks[0][f"{label} per-rank"], refs, inits)
        log(f"ddp {label}, 2 ranks x 4 pages against 1 process x 8 (SGD; relative L2 to the "
            f"f32 1-process step of the parameters' moves, the BN statistics' moves and the "
            f"metrics, each kind pooled; the floor the farthest 1-process bf16 step, the batch "
            f"as it is and in {len(dp2_orders(BATCH))} other orders): "
            + "; ".join(f"{k}: 2 ranks {d[k]:.4g}, 1 process bf16 {d_ref[k]:.4g} (ratio "
                        f"{d[k] / d_ref[k]:.3f}), per-rank BN statistics {d_bad[k]:.4g} (ratio "
                        f"{d_bad[k] / d_ref[k]:.2f})" for k in d_ref)
            + f"; launches per rank { {n: v for n, v in counts.items() if v} }; "
            f"{ranks[0][label + ' ms']:.3f} ms per step  [{smi}]")
        far = [k for k in d_ref if d[k] > GRAPH_NOISE_RATIO * d_ref[k]]
        if far:
            raise AssertionError(f"ddp {label}, 2 ranks: farther from the f32 step than "
                                 f"{GRAPH_NOISE_RATIO} x the 1-process bf16 step in {far}")
        if not any(d_bad[k] > GRAPH_NOISE_RATIO * d_ref[k] for k in d_ref):
            raise AssertionError(f"ddp {label}: per-rank statistics pass the gate in every kind "
                                 f"({d_bad} against {d_ref}): it has no teeth")
        times[f"{label} 2 ranks"] = ranks[0][f"{label} ms"]
    for rank in ranks:
        mine, seg_ranks, inp_ranks, snap = rank["concurrent"]
        if (seg_ranks, inp_ranks) != ([0], [1]):
            raise AssertionError(f"group meshes {seg_ranks}, {inp_ranks}")
        runs = refs[mine][:3]
        exact = derived_exact(list(runs[0]), gr[mine]["noisy_params"], 1)
        check_against_runs(f"concurrent_train2 {mine} (rank {rank['position']})", snap, runs,
                           exact)
    torch.backends.cudnn.deterministic = False
    return times


def evaluate_phase(smi: str) -> None:
    """``train/evaluate.py`` on the card at 512^2, batch 8, 2 batches per
    task: finite numbers under JAX's keys."""
    from text_segmentation_image_inpainting_tpu_torch.train import evaluate

    keys = {"seg": {"iou", "precision", "recall"}, "inpaint": {"psnr", "ssim", "l1"},
            "pipeline": {"mask_iou"}}
    for task, want in keys.items():
        t0 = time.perf_counter()
        res = evaluate.main(["--task", task, "--batches", "2"])
        got = {k for k in res if k not in ("task", "batches", "batch_size")}
        if got != want or not all(np.isfinite(res[k]) for k in want):
            raise AssertionError(f"evaluate --task {task}: {res}")
        log(f"evaluate --task {task} --batches 2: {json.dumps(res)} in "
            f"{time.perf_counter() - t0:.1f} s")


@contextlib.contextmanager
def plain_stride1():
    """The stride-1 partial convs on their plain version, so that an f32
    U-Net runs on the card (the kernels take bf16 only): the reference of
    the sharded U-Net's gate."""
    from text_segmentation_image_inpainting_tpu_torch.ops.kernels import partial_conv as kpc

    fused = kpc.partial_conv2d_fused

    def plain(x, mask, weight, bias=None, *, group_sizes, padding):
        return kpc.partial_conv2d_reference(x, mask, weight, bias, group_sizes=tuple(group_sizes),
                                            padding=tuple(padding))

    kpc.partial_conv2d_fused = plain
    try:
        yield
    finally:
        kpc.partial_conv2d_fused = fused


@contextlib.contextmanager
def recorded_stride1(calls: list):
    """Every stride-1 partial conv's inputs and kernel outputs appended to
    ``calls`` with the name of the host thread (the band) that ran it."""
    from text_segmentation_image_inpainting_tpu_torch.ops.kernels import partial_conv as kpc

    fused = kpc.partial_conv2d_fused

    def record(x, mask, weight, bias=None, *, group_sizes, padding):
        out = fused(x, mask, weight, bias, group_sizes=group_sizes, padding=padding)
        calls.append((threading.current_thread().name, x, mask, weight, bias,
                      tuple(group_sizes), tuple(padding), out))
        return out

    kpc.partial_conv2d_fused = record
    try:
        yield
    finally:
        kpc.partial_conv2d_fused = fused


def launch_counts() -> tuple:
    from text_segmentation_image_inpainting_tpu_torch.ops.kernels import partial_conv as kpc

    return kpc.K1_LAUNCHES, kpc.K2_LAUNCHES


def reset_launches() -> None:
    from text_segmentation_image_inpainting_tpu_torch.ops.kernels import partial_conv as kpc

    kpc.K1_LAUNCHES = kpc.K2_LAUNCHES = 0


def pad_gates(dev, rng, gen) -> None:
    """K1 and K2 with unequal H and W padding (``PAD_EXTRA``), reached
    through ``partial_conv2d`` (the routing: a kernel launches where JAX's
    rule, ``in_kernel_scope``, takes the output height, and none where it
    does not; nothing raises), and called directly: against the plain
    version (M' bit-exact), twice on the same inputs (bit-identical), and
    the backward (K3) by ``check_grads``."""
    from text_segmentation_image_inpainting_tpu_torch.ops.kernels import partial_conv as kpc
    from text_segmentation_image_inpainting_tpu_torch.ops.partial_conv import (
        in_kernel_scope, partial_conv2d)

    for name, n, h, w, groups, cout, pad in PAD_EXTRA:
        cin = sum(groups)
        x = torch.randn((n, h, w, cin), generator=gen, device=dev).to(torch.bfloat16)
        m = torch.from_numpy(rng.random((n, h, w, len(groups))) < 0.6).to(dev, torch.bfloat16)
        m[0, :4, :4] = 0
        wt = torch.randn((cout, cin, 3, 3), generator=gen, device=dev) * (2.0 / (9 * cin)) ** 0.5
        b = torch.randn((cout,), generator=gen, device=dev) * 0.1 if cout <= 7 else None
        kw = dict(group_sizes=groups, padding=pad)
        wb = wt.to(torch.bfloat16)
        bb = None if b is None else b.to(torch.bfloat16)
        hout, wout = h + 2 * pad[0] - 2, w + 2 * pad[1] - 2
        routed = in_kernel_scope((1, 1), (1, 1), wb.shape, hout)
        before = launch_counts()
        partial_conv2d(x, m, wb, bb, **kw)
        after = launch_counts()
        want = ((0, 1) if cout <= 7 else (1, 0)) if routed else (0, 0)
        if (after[0] - before[0], after[1] - before[1]) != want:
            raise AssertionError(f"{name}: partial_conv2d launched "
                                 f"{(after[0] - before[0], after[1] - before[1])}, want {want}")
        first = kpc.partial_conv2d_fused(x, m, wb, bb, **kw)
        again = kpc.partial_conv2d_fused(x, m, wb, bb, **kw)
        torch.cuda.synchronize()
        if first[0].shape != (n, hout, wout, cout):
            raise AssertionError(f"{name}: output {tuple(first[0].shape)}")
        err = check_close(name, first, kpc.partial_conv2d_reference(x, m, wb, bb, **kw),
                          require_empty=True)
        if not (torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])):
            raise AssertionError(f"{name}: two launches on the same inputs differ")
        g = torch.randn(first[0].shape, generator=gen, device=dev).to(torch.bfloat16)
        grel, gabs = check_grads(name, x, m, wt, b, g, kw)
        plan = (kpc.k2_plan(cin, cout, 3) if cout <= 7 else
                kpc.k1_plan(n, h, w, cout, kpc.k1_channels(groups)[2], 3, pad))
        route = ("routed by partial_conv2d" if routed else
                 "partial_conv2d on the plain route (JAX's rule), the kernel called directly")
        log(f"padding {name}: {plan}; {route}, M' bit-exact, max|dy| "
            f"{err:.4g}, two launches bit-identical; K3 relative L2 {grel:.3g}")


def parallel_phase(pipe, dev, rng, smi: str) -> dict:
    """Multi-device serving on one card (``parallel/``). Gates: K1 and K2
    with unequal padding (``pad_gates``) and at the 4-band U-Net's halo-ed
    shapes (``SHARD_SHAPES``, padding (0, 1): against the plain version,
    twice bit-identical); ``spatial_inpaint_unet`` on a 2048^2 page, depth
    8, bf16, over 2 and 4 bands on cuda:0 (K1 7 and K2 1 launches per
    band, every stride-1 layer at padding (0, 1) on a band with its halo
    and equal to the plain version on its inputs; relative L2 to an f32
    plain U-Net no more than 1.25 x the unsharded bf16 U-Net's);
    ``pipeline2_run`` at 512^2, batch 8, T 4 on (cuda:0, cuda:0) (K1 7T,
    K2 T; bit-equal to ``run`` per microbatch, else no further from it than
    two runs are from each other); ``PageStreamServer(mesh=)`` over 20
    uint8 batches on a 2-entry mesh (K1 7 and K2 1 per half; bit-equal to
    ``run`` on each half). Then the times: K1/K2 at the shard shapes,
    the sharded U-Net beside the unsharded one, the stage pipeline beside
    closed-loop ``run``, the DP server beside the plain one, each with the
    device's kernel time over the wall time."""
    from text_segmentation_image_inpainting_tpu_torch.data.pipeline import make_page_stream_u8
    from text_segmentation_image_inpainting_tpu_torch.models import InpaintUNet
    from text_segmentation_image_inpainting_tpu_torch.ops.kernels import partial_conv as kpc
    from text_segmentation_image_inpainting_tpu_torch.ops.partial_conv import apply_mask
    from text_segmentation_image_inpainting_tpu_torch.parallel import (
        make_mesh,
        make_stage_mesh,
        pipeline2_run,
        pipeline2_throughput_model,
        spatial_inpaint_unet,
    )
    from text_segmentation_image_inpainting_tpu_torch.pipeline import PageStreamServer
    from text_segmentation_image_inpainting_tpu_torch.pipeline.serve import to_compute
    from text_segmentation_image_inpainting_tpu_torch.pipeline.sparse import to_uint8

    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    pad_gates(dev, rng, gen)

    # K1/K2 at the 4-band U-Net's shapes: gates, then times
    shard_times = {}
    for name, h, w, c_lo, c_skip, cout in SHARD_SHAPES:
        cin = c_lo + c_skip
        x = torch.randn((1, h, w, cin), generator=gen, device=dev).to(bf)
        mask = grouped_mask(rng, 1, h, w, dev)
        wt = (torch.randn((cout, cin, 3, 3), generator=gen, device=dev)
              * (2.0 / (9 * cin)) ** 0.5).to(bf)
        b = (torch.randn((cout,), generator=gen, device=dev) * 0.1).to(bf) if cout <= 7 else None
        kw = dict(group_sizes=(c_lo, c_skip), padding=(0, 1))
        kern = lambda: kpc.partial_conv2d_fused(x, mask, wt, b, **kw)  # noqa: E731
        plain = lambda: kpc.partial_conv2d_reference(x, mask, wt, b, **kw)  # noqa: E731
        first, again = kern(), kern()
        torch.cuda.synchronize()
        err = check_close(f"shard {name}", first, plain())
        if not (torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])):
            raise AssertionError(f"shard {name}: two launches on the same inputs differ")
        kname = "K2" if cout <= 7 else "K1"
        flop, nbytes = pconv_work(x, mask, wt, p=first[0].shape[1] * w)
        b_ms, b_by = bound(flop, nbytes)
        k_ms = device_ms(kern, "pconv_k2" if cout <= 7 else "pconv_k1")
        ev_ms, p_ms = cuda_ms(kern), cuda_ms(plain)
        xm = apply_mask(x, mask, kw["group_sizes"]).permute(0, 3, 1, 2)
        wl = wt.contiguous(memory_format=torch.channels_last)
        lib_ms = cuda_ms(lambda: torch.nn.functional.conv2d(xm, wl, padding=(0, 1)))
        plan = (kpc.k2_plan(cin, cout, 3) if cout <= 7 else
                kpc.k1_plan(1, h, w, cout, kpc.k1_channels(kw["group_sizes"])[2], 3, (0, 1)))
        shard_times[name] = (kname, k_ms, p_ms, b_ms, ev_ms, lib_ms)
        log(f"shard {kname} {name}: x {tuple(x.shape)} padding (0, 1) -> y "
            f"{tuple(first[0].shape)}, {plan}; M' bit-exact, max|dy| {err:.4g}, two launches "
            f"bit-identical; kernel {ev_ms:.4f} ms (device time {k_ms:.4f}), plain f32 "
            f"{p_ms:.4f} ms, cuDNN bf16 conv alone {lib_ms:.4f} ms, bound {b_ms:.4f} ms "
            f"({b_by})  [{smi}]")
        del first, again, x, mask, kern, plain, xm, wl
    for kname in ("K1", "K2"):
        rows = [v for v in shard_times.values() if v[0] == kname]
        log(f"shard {kname} over the {len(rows)} layer(s) of one band: kernel "
            f"{sum(r[4] for r in rows):.4f} ms (device time {sum(r[1] for r in rows):.4f}), "
            f"plain f32 {sum(r[2] for r in rows):.4f} ms, cuDNN bf16 conv alone "
            f"{sum(r[5] for r in rows):.4f} ms, bound {sum(r[3] for r in rows):.4f} ms  [{smi}]")

    # the H-sharded U-Net
    unet = pipe.unet
    size = SPATIAL_PAGE
    page = torch.from_numpy(rng.uniform(0.0, 1.0, (1, size, size, 3)).astype(np.float32)).to(dev)
    valid = torch.from_numpy(hole_mask(rng, 1, size, size)[..., None]).to(dev)
    x, m = (page * valid).to(bf), valid.to(bf)
    ref_net = InpaintUNet(depth=unet.depth, dtype=torch.float32)
    ref_net.load_state_dict(unet.state_dict())
    ref_net = ref_net.to(dev).eval()
    with torch.no_grad():
        whole = unet(x, m)
        with plain_stride1():
            ref = ref_net(x.float(), m.float())
    del ref_net
    whole_err = rel_l2(whole, ref)
    log(f"spatial: InpaintUNet(depth={unet.depth}) bf16 on a {size}^2 page, unsharded: "
        f"relative L2 {whole_err:.4g} to the f32 plain U-Net")
    meshes = {bands: make_mesh(devices=[dev] * bands) for bands in SPATIAL_BANDS}
    for bands, mesh in meshes.items():
        calls = []
        reset_launches()
        with recorded_stride1(calls):
            got = spatial_inpaint_unet(mesh, unet, x, m)
        torch.cuda.synchronize()
        launches = launch_counts()
        if launches != (7 * bands, bands):
            raise AssertionError(f"spatial {bands} bands: K1/K2 launched {launches}, want "
                                 f"{(7 * bands, bands)}")
        per_band = Counter((c[0], "K2" if c[3].shape[0] <= 7 else "K1") for c in calls)
        if sorted(per_band.values()) != sorted([7, 1] * bands) or len(per_band) != 2 * bands:
            raise AssertionError(f"spatial {bands} bands: per band {dict(per_band)}, want K1 7 "
                                 f"and K2 1 in each")
        worst = 0.0
        for thread, xi, mi, wi, bi, gs, pad, out in calls:
            if pad != (0, 1) or out[0].shape[1] != xi.shape[1] - 2 or out[0].shape[2] != xi.shape[2]:
                raise AssertionError(f"spatial {bands} bands: a layer ran at padding {pad} on "
                                     f"{tuple(xi.shape)} -> {tuple(out[0].shape)}")
            worst = max(worst, check_close(f"spatial {thread}", out, kpc.partial_conv2d_reference(
                xi, mi, wi, bi, group_sizes=gs, padding=pad)))
        del calls
        err = rel_l2(got, ref)
        if not (got.shape == x.shape and torch.isfinite(got).all() and err <= 1.25 * whole_err):
            raise AssertionError(f"spatial {bands} bands: relative L2 {err:.4g} to the f32 plain "
                                 f"U-Net, more than 1.25 x the unsharded {whole_err:.4g}")
        log(f"spatial {bands} bands (local H {size // bands}): K1 {launches[0]}, K2 {launches[1]} "
            f"(7 and 1 in each band), every layer at padding (0, 1) on its band + halo equal to "
            f"the plain version (max|dy| {worst:.4g}); relative L2 {err:.4g} to the f32 plain "
            f"U-Net (unsharded bf16 {whole_err:.4g}, gate 1.25x); vs the unsharded bf16 output "
            f"{rel_l2(got, whole.float()):.4g}, bit-equal {torch.equal(got, whole)}")
    del got, ref
    out = spatial_pipeline_phase(pipe, dev, meshes, smi)

    # the two-stage pipeline on (cuda:0, cuda:0)
    stage = make_stage_mesh([dev, dev])
    pages_mb = torch.from_numpy(rng.uniform(0.0, 1.0, (STAGE_MICROBATCHES, BATCH, PAGE, PAGE, 3))
                                .astype(np.float32)).to(dev)
    reset_launches()
    piped = pipeline2_run(stage, pipe, pages_mb)
    torch.cuda.synchronize()
    launches = launch_counts()
    t_mb = STAGE_MICROBATCHES
    if launches != (7 * t_mb, t_mb):
        raise AssertionError(f"pipeline2 launched {launches}, want {(7 * t_mb, t_mb)}")
    runs = [[pipe.run(p)[0] for p in pages_mb] for _ in range(2)]
    torch.cuda.synchronize()
    if piped.shape != pages_mb.shape or not torch.isfinite(piped).all():
        raise AssertionError(f"pipeline2: output {tuple(piped.shape)} or non-finite values")
    if all(torch.equal(piped[t], runs[0][t]) for t in range(t_mb)):
        held = "bit-equal to run in every microbatch"
    else:
        d_pipe = max(rel_l2(piped[t], runs[0][t].float()) for t in range(t_mb))
        d_runs = max(rel_l2(runs[1][t], runs[0][t].float()) for t in range(t_mb))
        if d_pipe > d_runs:
            raise AssertionError(f"pipeline2: relative L2 {d_pipe:.4g} to run, two runs "
                                 f"{d_runs:.4g} apart")
        held = (f"not bit-equal; relative L2 {d_pipe:.4g} to run, within two runs' spread "
                f"{d_runs:.4g}")
    log(f"pipeline2 on (cuda:0, cuda:0): {t_mb} microbatches of {BATCH} pages {PAGE}^2, K1 "
        f"{launches[0]}, K2 {launches[1]}; {held}")
    del runs

    # the data-parallel server on a 2-entry mesh of cuda:0
    cd = pipe.compute_dtype
    stream = make_page_stream_u8(BATCH, (PAGE, PAGE), seed=SEED + 1)
    batches = [next(stream)["image"] for _ in range(SERVE_BATCHES)]

    def halves(pages: np.ndarray):
        outs = [pipe.run(to_compute(torch.from_numpy(p).to(dev), cd)) for p in np.split(pages, 2)]
        return (np.concatenate([to_uint8(c).cpu().numpy() for c, _ in outs]),
                np.concatenate([mk.to(torch.uint8).cpu().numpy() for _, mk in outs]))

    want = [halves(b) for b in batches]
    mesh2 = meshes[2]
    reset_launches()
    served = list(PageStreamServer(pipe, depth=2, mesh=mesh2).serve(iter(batches)))
    launches = launch_counts()
    if launches != (7 * 2 * SERVE_BATCHES, 2 * SERVE_BATCHES):
        raise AssertionError(f"DP serve launched {launches}, want K1 7 and K2 1 per half")
    if len(served) != len(want):
        raise AssertionError(f"DP serve: {len(served)} results for {len(want)} batches")
    for i, ((gc, gm), (wc, wm)) in enumerate(zip(served, want)):
        if not (np.array_equal(gc, wc) and np.array_equal(gm, wm)):
            raise AssertionError(f"DP serve: batch {i} differs from run on its halves")
    log(f"DP serve, 2-entry mesh of cuda:0, depth 2: {SERVE_BATCHES} batches of {BATCH} uint8 "
        f"pages bit-equal to run on each half, in order; K1 {launches[0]}, K2 {launches[1]}")

    # times
    with torch.no_grad():
        t_whole = cuda_ms(lambda: unet(x, m), iters=5, warmup=2)
    line = [f"unsharded {t_whole:.3f} ms"]
    for bands, mesh in meshes.items():
        t_b = cuda_ms(lambda: spatial_inpaint_unet(mesh, unet, x, m), iters=5, warmup=2)
        out[f"spatial {bands}"] = t_b
        line.append(f"{bands} bands {t_b:.3f} ms ({t_b / t_whole - 1:+.1%})")
    log(f"time spatial U-Net, one {size}^2 page, depth {unet.depth}, bf16: " + ", ".join(line)
        + f"  [{smi}]")
    profile_run(lambda: spatial_inpaint_unet(meshes[4], unet, x, m), "spatial U-Net, 4 bands")
    profile_run(lambda: unet(x, m), "U-Net unsharded, the same page")
    p = pages_mb[0].to(cd)
    with torch.no_grad():
        v2 = pipe._segment2d(p)
        t_seg = cuda_ms(lambda: pipe._segment2d(p), iters=5, warmup=2)
        t_inp = cuda_ms(lambda: pipe._inpaint2d(p, v2), iters=5, warmup=2)
    t_pipe = cuda_ms(lambda: pipeline2_run(stage, pipe, pages_mb), iters=5, warmup=2)
    t_loop = cuda_ms(lambda: [pipe.run(q) for q in pages_mb], iters=5, warmup=2)
    fused, model = pipeline2_throughput_model(t_seg, t_inp, t_mb)
    log(f"time pipeline2, {t_mb} x {BATCH} pages {PAGE}^2 on (cuda:0, cuda:0): {t_pipe:.3f} ms = "
        f"{t_mb * BATCH / t_pipe * 1e3:.2f} pages/s; closed-loop run {t_loop:.3f} ms = "
        f"{t_mb * BATCH / t_loop * 1e3:.2f} pages/s ({t_pipe / t_loop - 1:+.1%}); stages: "
        f"segment {t_seg:.3f} ms, inpaint {t_inp:.3f} ms, so the two-device model gives "
        f"{model:.3f} ms against {fused:.3f} ms on one  [{smi}]")
    profile_run(lambda: pipeline2_run(stage, pipe, pages_mb), "pipeline2", runs=2)

    def served_all(server) -> None:
        for _ in server.serve(iter(batches)):
            pass

    served_all(PageStreamServer(pipe, depth=2, mesh=mesh2))  # warm the pinned host blocks
    for label, make in (("serve dense, depth 2", lambda: PageStreamServer(pipe, depth=2)),
                        ("DP serve, 2-entry mesh of cuda:0, depth 2",
                         lambda: PageStreamServer(pipe, depth=2, mesh=mesh2)),
                        ("serve dense, depth 2 (again)", lambda: PageStreamServer(pipe, depth=2))):
        server = make()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        served_all(server)
        torch.cuda.synchronize()
        t = time.perf_counter() - t0
        out[label] = t
        log(f"time {label}: {SERVE_BATCHES} batches of {BATCH} in {t:.3f} s = "
            f"{SERVE_BATCHES * BATCH / t:.2f} pages/s  [{smi}]")
    profile_run(lambda: served_all(PageStreamServer(pipe, depth=2, mesh=mesh2)),
                f"DP serve, 2-entry mesh, {SERVE_BATCHES} batches", runs=1)
    return out


def spatial_pipeline_phase(pipe, dev, meshes: dict, smi: str) -> dict:
    """``spatial_pipeline_run``: the whole pipeline (the segmenter at width
    1.0, output stride 8, the depth-8 U-Net, bf16: ``pipe``) on one 2048^2
    native-engine page in 2 and 4 bands of cuda:0. Gates, against the
    unbanded ``run`` on the same page (cuDNN may pick other algorithms for
    a band's shape, so not bit for bit): K1 7 and K2 1 per band; (a) the
    page bit-identical to the input outside the banded text mask, the
    masks binary; (b) the banded mask differs from ``run``'s only within
    the dilation radius of pixels whose f32 segmenter logit lies within
    1.25 x the bf16 segmenter's largest logit error of the threshold; (c)
    where the masks agree, the clean page's relative L2 to an f32 unbanded
    pipeline (the f32 U-Net on its plain version, inpainting the same
    holes: the banded mask's for the banded page, ``run``'s for ``run``'s)
    at most 1.25 x ``run``'s. Then ms per page beside ``run`` and a
    profile of the 4-band call. Returns the times."""
    from text_segmentation_image_inpainting_tpu_torch.data.pipeline import make_page_stream_u8
    from text_segmentation_image_inpainting_tpu_torch.models import InpaintUNet, TextSegmenter
    from text_segmentation_image_inpainting_tpu_torch.ops.morphology import dilate_mask
    from text_segmentation_image_inpainting_tpu_torch.parallel import spatial_pipeline_run
    from text_segmentation_image_inpainting_tpu_torch.pipeline import TextRemovalPipeline
    from text_segmentation_image_inpainting_tpu_torch.pipeline.serve import to_compute

    size, cd, f32 = SPATIAL_PAGE, pipe.compute_dtype, torch.float32
    u8 = next(make_page_stream_u8(1, (size, size), seed=SEED + 7))["image"]
    page = to_compute(torch.from_numpy(u8).to(dev), f32)
    page_c = page.to(cd)
    want_clean, want_mask = pipe.run(page)
    seg32 = TextSegmenter(dtype=f32)
    seg32.load_state_dict(pipe.seg.state_dict())
    unet32 = InpaintUNet(depth=pipe.unet.depth, dtype=f32)
    unet32.load_state_dict(pipe.unet.state_dict())
    ref_pipe = TextRemovalPipeline(seg32, unet32, threshold=pipe.threshold,
                                   dilate_radius=pipe.dilate_radius, compute_dtype=f32)
    ref_pipe = ref_pipe.to(dev).eval()
    logit_t = float(np.log(pipe.threshold / (1.0 - pipe.threshold)))
    with torch.no_grad():
        lg16 = pipe.seg(page_c)[..., 0].float()
        lg32 = ref_pipe.seg(page)[..., 0]
        seg_err = (lg16 - lg32).abs().max().item()
        near = ((lg32 - logit_t).abs() <= 1.25 * seg_err).to(f32)
        allowed = dilate_mask(near, pipe.dilate_radius)[..., None] > 0
    del lg16, lg32, near

    def f32_inpaint(text):
        """The f32 U-Net (its plain version) inpainting ``text``'s holes."""
        with torch.no_grad(), plain_stride1():
            return ref_pipe._inpaint2d(page, 1.0 - text[..., 0].to(f32))

    ref_run = f32_inpaint(want_mask)
    log(f"spatial pipeline: one {size}^2 native page, {float(want_mask.float().mean()):.3%} text "
        f"in run; the bf16 segmenter's logits within {seg_err:.4g} of the f32 one's, "
        f"{int(allowed.sum())} pixels near the threshold after dilation")
    for bands, mesh in meshes.items():
        calls = []
        reset_launches()
        with recorded_stride1(calls):
            clean, mask = spatial_pipeline_run(mesh, pipe, page)
        torch.cuda.synchronize()
        launches = launch_counts()
        per_band = Counter((c[0], "K2" if c[3].shape[0] <= 7 else "K1") for c in calls)
        del calls
        if launches != (7 * bands, bands) or sorted(per_band.values()) != sorted([7, 1] * bands) \
                or len(per_band) != 2 * bands:
            raise AssertionError(f"spatial pipeline {bands} bands: K1/K2 launched {launches}, per "
                                 f"band {dict(per_band)}, want K1 7 and K2 1 in each")
        if (clean.shape, mask.shape) != (want_clean.shape, want_mask.shape) or (
                clean.dtype, mask.dtype) != (want_clean.dtype, want_mask.dtype):
            raise AssertionError(f"spatial pipeline {bands} bands: {tuple(clean.shape)} "
                                 f"{clean.dtype}, {tuple(mask.shape)} {mask.dtype}")
        keep = (mask == 0).expand_as(clean)
        if not ((mask == 0) | (mask == 1)).all() or not torch.isfinite(clean).all() or \
                not torch.equal(clean[keep], page_c[keep]):  # (a)
            raise AssertionError(f"spatial pipeline {bands} bands: mask not binary, clean not "
                                 f"finite, or non-text pixels differ from the page")
        differ = mask != want_mask
        stray = int((differ & ~allowed).sum())
        if stray:  # (b)
            raise AssertionError(f"spatial pipeline {bands} bands: {stray} mask pixels differ from "
                                 f"run away from the threshold ({int(differ.sum())} in all)")
        agree = (~differ).expand_as(clean)
        ref = f32_inpaint(mask)
        err, err_run = rel_l2(clean[agree], ref[agree]), rel_l2(want_clean[agree], ref_run[agree])
        if not err <= 1.25 * err_run:  # (c)
            raise AssertionError(f"spatial pipeline {bands} bands: relative L2 {err:.4g} to the "
                                 f"f32 pipeline, more than 1.25 x run's {err_run:.4g}")
        same = torch.equal(clean, want_clean) and torch.equal(mask, want_mask)
        log(f"spatial pipeline {bands} bands (local H {size // bands}): K1 {launches[0]}, K2 "
            f"{launches[1]} (7 and 1 in each band); (a) non-text pixels bit-identical, masks "
            f"binary; (b) {int(differ.sum())} mask pixels differ from run, all near the threshold; "
            f"(c) relative L2 {err:.4g} to the f32 pipeline (run {err_run:.4g}, gate 1.25x); "
            + ("bit-equal to run" if same else
               f"not bit-equal to run (clean: max |d| "
               f"{(clean.float() - want_clean.float()).abs().max().item():.4g})"))
        del clean, mask, keep, differ, agree, ref
    del ref_run, ref_pipe, allowed
    torch.cuda.empty_cache()
    times = {"run": cuda_ms(lambda: pipe.run(page), iters=5, warmup=2)}
    for bands, mesh in meshes.items():
        times[bands] = cuda_ms(lambda: spatial_pipeline_run(mesh, pipe, page), iters=5, warmup=2)
    times["run again"] = cuda_ms(lambda: pipe.run(page), iters=5, warmup=2)
    log(f"time spatial pipeline, one {size}^2 page, bf16, width 1.0, depth {pipe.unet.depth}: run "
        f"{times['run']:.3f} / {times['run again']:.3f} ms; "
        + ", ".join(f"{b} bands {times[b]:.3f} ms ({times[b] / times['run'] - 1:+.1%})"
                    for b in meshes) + f"  [{smi}]")
    profile_run(lambda: spatial_pipeline_run(meshes[4], pipe, page), "spatial pipeline, 4 bands",
                runs=2)
    profile_run(lambda: pipe.run(page), "run, the same page", runs=2)
    return {f"spatial pipeline {b}": times[b] for b in meshes}


class _KeepLog(logging.Handler):
    """The messages a logger emits, kept in order."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


@contextlib.contextmanager
def kept_log(name: str):
    """Logger ``name`` at INFO into a ``_KeepLog`` for the block."""
    logger, keep = logging.getLogger(name), _KeepLog()
    level = logger.level
    logger.setLevel(logging.INFO)
    logger.addHandler(keep)
    try:
        yield keep
    finally:
        logger.removeHandler(keep)
        logger.setLevel(level)


def pretrained_phase(pipe, dev, smi: str) -> dict:
    """Phase 16: the pretrained-weight path on fabricated torchvision files
    (no real file is in the repository). (a) The runbook
    (``compat/verify_pretrained.py``) in-process, as JAX's recorded
    command: ``--fabricate``, parity at 512^2 and a 200-step finetune at
    128^2, batch 4; every gate must pass. (b) ``run`` at full width (width
    1.0, output stride 8, depth 8, bf16, 8 pages 512^2) with the imported
    encoder: K1 7, K2 1, binary masks, non-text pixels bit-identical; its
    time beside the random-weight ``pipe`` in turns. (c) ``run_inpaint``'s
    entry point with ``--vgg-ckpt`` (the fabricated vgg16.pth, imported
    tolerantly) and ``--fused-stem``, 2 steps at 512^2, batch 8, bf16: K3
    8, K4 1, K5 1 a step, finite losses, the import's report line."""
    import io
    import tempfile

    from text_segmentation_image_inpainting_tpu_torch.compat import verify_pretrained as vp
    from text_segmentation_image_inpainting_tpu_torch.compat.torchvision import (
        load_torch_file,
        tolerant_import,
        torchvision_mobilenet_v2_state_dict,
    )
    from text_segmentation_image_inpainting_tpu_torch.models import InpaintUNet, TextSegmenter
    from text_segmentation_image_inpainting_tpu_torch.ops.kernels import partial_conv as kpc
    from text_segmentation_image_inpainting_tpu_torch.ops.kernels import vgg_stem as kvs
    from text_segmentation_image_inpainting_tpu_torch.pipeline import TextRemovalPipeline
    from text_segmentation_image_inpainting_tpu_torch.train import run_inpaint

    torch.cuda.empty_cache()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        # (a) the runbook, its verdict line kept off this script's output
        buf, t = io.StringIO(), time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = vp.main(["--fabricate", tmp, "--device", "cuda", "--size", str(PAGE),
                          "--finetune", "200", "--finetune-size", "128", "--finetune-batch", "4"])
        verdict = json.loads(buf.getvalue().strip().splitlines()[-1])
        if rc != 0 or not verdict["ok"]:
            raise AssertionError(f"pretrained runbook: exit {rc}, verdict {verdict}")
        vg, mb, ft = verdict["vgg16"], verdict["mobilenet_v2"], verdict["finetune_smoke"]
        log(f"pretrained runbook ({time.perf_counter() - t:.1f} s, {verdict['device']}): vgg16 "
            f"coverage {vg['coverage']}, tap max |err| {vg['tap_max_abs_err']}, max |truth| "
            f"{vg['tap_max_abs_truth']} (tol {vg['tol']} x max(1, max|truth|)); mobilenet_v2 "
            f"coverage {mb['coverage']}, segmenter encoder unfilled "
            f"{len(mb['segmenter_encoder_unfilled'])}, taps {mb['tap_max_abs_err']}, max |truth| "
            f"{mb['tap_max_abs_truth']} (tol {mb['tol']})")
        log(f"pretrained finetune ({smi}): {ft['steps']} steps at {ft['size']}^2, batch "
            f"{ft['batch']}: loss first quarter {ft['loss_first_quarter']}, last quarter "
            f"{ft['loss_last_quarter']}, final {ft['loss_final']}; {ft['ms_per_step']} ms per "
            f"step (host clock over steps 2-{ft['steps']}), of which the batch's draw and upload "
            f"{ft['draw_ms_per_step']} ms")
        out["finetune_ms"] = ft["ms_per_step"]

        # (b) the page pipeline with the imported encoder
        bf = torch.bfloat16
        imported = TextRemovalPipeline(TextSegmenter(width_mult=1.0, output_stride=8, dtype=bf),
                                       InpaintUNet(depth=8, dtype=bf))
        imported.init_weights(torch.Generator().manual_seed(SEED))
        report = tolerant_import(imported.seg, torchvision_mobilenet_v2_state_dict(
            load_torch_file(str(Path(tmp) / "mobilenet_v2.pth")), prefix="encoder."))
        counts, enc_unfilled = vp.coverage_counts(report), vp.encoder_unfilled(report)
        if counts["used"] != 255 or counts["skipped_shape"] or enc_unfilled:
            raise AssertionError(f"imported encoder: {counts}, encoder unfilled {enc_unfilled[:5]}")
        imported = imported.to(dev).eval()
        rng = np.random.default_rng(SEED + 15)
        pages = torch.from_numpy(rng.uniform(0.0, 1.0, (BATCH, PAGE, PAGE, 3)).astype(np.float32))
        pages = pages.to(dev)
        kpc.K1_LAUNCHES = kpc.K2_LAUNCHES = 0
        clean, text = imported.run(pages)
        torch.cuda.synchronize()
        launches = {"K1": kpc.K1_LAUNCHES, "K2": kpc.K2_LAUNCHES}
        if launches != {"K1": 7, "K2": 1}:
            raise AssertionError(f"run with the imported encoder launched {launches}, want K1 7, "
                                 f"K2 1")
        if clean.shape != pages.shape or not torch.isfinite(clean).all():
            raise AssertionError("run with the imported encoder: wrong shape or non-finite")
        if not ((text == 0) | (text == 1)).all():
            raise AssertionError("run with the imported encoder: text mask not binary")
        keep = (text == 0).expand_as(clean)
        if not torch.equal(clean[keep], pages.to(bf)[keep]):
            raise AssertionError("run with the imported encoder: non-text pixels differ")
        r1 = cuda_ms(lambda: pipe.run(pages))
        i1 = cuda_ms(lambda: imported.run(pages))
        i2 = cuda_ms(lambda: imported.run(pages))
        r2 = cuda_ms(lambda: pipe.run(pages))
        out["run_ms"], out["run_random_ms"] = (i1 + i2) / 2, (r1 + r2) / 2
        log(f"pretrained run ({smi}): imported encoder {counts['used']}/255 keys, launches "
            f"{launches}, binary mask ({text.float().mean().item():.3%} text), non-text pixels "
            f"bit-identical; {i1:.3f} / {i2:.3f} ms per batch of {BATCH} at {PAGE}^2 against "
            f"random weights {r1:.3f} / {r2:.3f} ms (median of {ITERS}, in turns)")
        del imported, clean, text, keep, pages
        torch.cuda.empty_cache()

        # (c) the inpaint CLI with the fabricated vgg16.pth
        steps, cwd = 2, os.getcwd()
        kpc.K1_LAUNCHES = kpc.K2_LAUNCHES = kpc.K3_LAUNCHES = 0
        kvs.K4_LAUNCHES = kvs.K5_LAUNCHES = 0
        os.chdir(tmp)  # the loop logs to logs/inpaint.jsonl in the working directory
        try:
            with kept_log("text_segmentation_image_inpainting_tpu_torch.compat.torchvision") as kl:
                state = run_inpaint.main([
                    "--vgg-ckpt", str(Path(tmp) / "vgg16.pth"), "--fused-stem", "--steps",
                    str(steps), "--batch-size", str(BATCH), "--image-size", str(PAGE),
                    "--log-every", "1", "--val-batches", "1", "--ckpt-every", "1000",
                    "--ckpt-dir", str(Path(tmp) / "ckpt"), "--device", "cuda"])
            torch.cuda.synchronize()
            with open("logs/inpaint.jsonl") as f:
                records = [json.loads(line) for line in f]
        finally:
            os.chdir(cwd)
        got = {"K1": kpc.K1_LAUNCHES, "K2": kpc.K2_LAUNCHES, "K3": kpc.K3_LAUNCHES,
               "K4": kvs.K4_LAUNCHES, "K5": kvs.K5_LAUNCHES}
        want_report = "tolerant_import: used 14, skipped 0 (missing) / 0 (shape), unfilled 0"
        if kl.lines != [want_report]:
            raise AssertionError(f"run_inpaint --vgg-ckpt logged {kl.lines}, want [{want_report!r}]")
        if (got["K3"], got["K4"], got["K5"]) != (8 * steps, steps, steps):
            raise AssertionError(f"run_inpaint --vgg-ckpt: {steps} steps launched {got}, want K3 "
                                 f"8, K4 1, K5 1 a step")
        bad = [(r["step"], k) for r in records for k, v in r.items()
               if isinstance(v, float) and not np.isfinite(v)]
        if state.step != steps or len(records) != steps or bad:
            raise AssertionError(f"run_inpaint --vgg-ckpt: step {state.step}, {len(records)} "
                                 f"records, non-finite {bad}")
        out["cli_ms"] = BATCH / records[-1]["pages_per_sec"] * 1e3
        log(f"pretrained run_inpaint --vgg-ckpt --fused-stem ({smi}): {kl.lines[0]}; launches over "
            f"{steps} steps and {steps} val forwards {got}; losses "
            + ", ".join(f"{k} {records[-1][k]:.5g}" for k in ("total", "valid", "hole", "perceptual",
                                                               "style_out", "style_comp", "tv"))
            + f"; step 2 {out['cli_ms']:.3f} ms ({records[-1]['pages_per_sec']:.2f} pages/s, the "
            f"loop's host clock)")
        del state
    torch.cuda.empty_cache()
    return out


def scope_case_inputs(gen, rng, dev, n, h, w, groups, cout, k):
    """x, a grouped binary mask with a block of empty windows, OIHW weights
    and a bias, in f32 on ``dev``."""
    cin = sum(groups)
    x = torch.randn((n, h, w, cin), generator=gen, device=dev)
    m = torch.from_numpy(rng.random((n, h, w, len(groups))) < 0.6).to(dev, torch.float32)
    m[0, :k + 4, :k + 4] = 0
    wt = torch.randn((cout, cin, k, k), generator=gen, device=dev) * (2.0 / (k * k * cin)) ** 0.5
    b = torch.randn((cout,), generator=gen, device=dev) * 0.1
    return x, m, wt, b


def scope_phase(dev, rng, smi: str) -> dict:
    """The kernels at ``SCOPE_CASES`` and ``SCOPE_K6``: shapes of JAX's
    Pallas scope that no model of the repo reaches, which the hand-written
    kernels take in their templated form or, past it, in their general
    form. The general forms' counters are set to 0 first. Each case runs
    as a user runs it, ``partial_conv2d`` and autograd's backward, in bf16
    and in f32: the forward moves its kernel's counter alone (K1 or K2, K1F
    or K2F), the backward K3, or K3F and at Cout <= 7 K3F_HEAD; these runs'
    general-form launches are the kernels line's ``launches``. Then the
    checks: the forward against the f64 truth (bf16 ``check_close`` on the
    plain version of the same bf16 values in f64, f32 ``check_f32``), M'
    bit-exact, two launches bit-identical; the backward by ``check_grads``
    (bf16) and ``check_grads_f32`` (f32, twice bit-identical), the bf16
    backward also twice bit-identical. K6 at ``SCOPE_K6`` by
    ``check_wgrad`` (f64 truth, twice bit-identical, the counter). Last an
    H = 12 bf16 layer, outside JAX's scope: no counter moves and y is
    ``_partial_conv2d_plain``'s bit for bit. Each case's CUDA-event median,
    forward and backward, beside the plain version's and the library's
    (cuDNN on x * M), and its bound. Returns the general forms' rows of the
    kernels line."""
    import torch.nn.functional as F

    from text_segmentation_image_inpainting_tpu_torch.ops.conv import to_nchw
    from text_segmentation_image_inpainting_tpu_torch.ops.kernels import depthwise_wgrad as kdw
    from text_segmentation_image_inpainting_tpu_torch.ops.kernels import partial_conv as kpc
    from text_segmentation_image_inpainting_tpu_torch.ops.partial_conv import (
        _partial_conv2d_plain, apply_mask, partial_conv2d)

    gen = torch.Generator(device=dev).manual_seed(SEED + 16)
    log(f"scope: {smi}")
    kpc.GEN_LAUNCHES = kpc.GEN_BWD_LAUNCHES = kdw.K6_GEN_LAUNCHES = 0
    path = {"fwd": 0, "bwd": 0, "k6": 0}
    tot = {key: {"ms": 0.0, "plain": 0.0, "lib": 0.0, "bound": 0.0, "err": 0.0, "flop": 0.0,
                 "bytes": 0.0, "peak": None}
           for key in ("fwd", "bwd", "k6")}

    def add(key, ms, plain, lib, flop, nbytes, peak, err):
        t = tot[key]
        b_ms, _ = bound(flop, nbytes, peak)
        for name, v in (("ms", ms), ("plain", plain), ("lib", lib), ("bound", b_ms),
                        ("flop", flop), ("bytes", nbytes)):
            t[name] += v
        t["err"] = max(t["err"], err)
        t["peak"] = peak

    for name, n, h, w, groups, cout, k, pad in SCOPE_CASES:
        cin = sum(groups)
        x, m, wt, b = scope_case_inputs(gen, rng, dev, n, h, w, groups, cout, k)
        kw = dict(group_sizes=groups, padding=pad)
        needs = (True, True, True)
        for dt in (torch.bfloat16, torch.float32):
            f32 = dt == torch.float32
            label = f"scope {name} {'f32' if f32 else 'bf16'}"
            xd, md, wd, bd = (t.to(dt) for t in (x, m, wt, b))
            fwd_key = ("K2" if cout <= 7 else "K1") + ("F" if f32 else "")
            bwd_want = ({"K3F": 1} | ({"K3F_HEAD": 1} if cout <= 7 else {})) if f32 else {"K3": 1}
            gen_f = cout <= 7 and (kpc.k2f_plan(n, h, w, cin, cout, k, pad, len(groups)).general
                                   if f32 else kpc.k2_general(cin, cout, k, len(groups)))
            gen_b = cout <= 7 and (kpc.k2f_bwd_plan(n, h, w, cin, cout, k, len(groups)).general
                                   if f32 else kpc.k2_general(cin, cout, k, len(groups), pad, True))
            # the path, as a user runs it: partial_conv2d, then autograd
            leaves = [t.detach().clone().requires_grad_(True) for t in (xd, wd, bd)]
            g = torch.randn((n, h + 2 * pad[0] - k + 1, w + 2 * pad[1] - k + 1, cout),
                            generator=gen, device=dev).to(dt)
            before, gen0 = launch_counters(), (kpc.GEN_LAUNCHES, kpc.GEN_BWD_LAUNCHES)
            y, _ = partial_conv2d(leaves[0], md, leaves[1], leaves[2], **kw)
            mid = launch_counters()
            torch.autograd.grad(y, leaves, g)
            torch.cuda.synchronize()
            after = launch_counters()
            moved_f = {c: v - before[c] for c, v in mid.items() if v != before[c]}
            moved_b = {c: v - mid[c] for c, v in after.items() if v != mid[c]}
            if moved_f != {fwd_key: 1} or moved_b != bwd_want:
                raise AssertionError(f"{label}: partial_conv2d launched {moved_f} and its "
                                     f"backward {moved_b}, want {fwd_key} 1 and {bwd_want}")
            dgen = (kpc.GEN_LAUNCHES - gen0[0], kpc.GEN_BWD_LAUNCHES - gen0[1])
            if dgen != (int(gen_f), int(gen_b)):
                raise AssertionError(f"{label}: general forms launched {dgen}, the plans say "
                                     f"{(int(gen_f), int(gen_b))}")
            path["fwd"] += dgen[0]
            path["bwd"] += dgen[1]
            # the checks
            first = kpc.partial_conv2d_fused(xd, md, wd, bd, **kw)
            again = kpc.partial_conv2d_fused(xd, md, wd, bd, **kw)
            torch.cuda.synchronize()
            if not (torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])):
                raise AssertionError(f"{label}: two launches on the same inputs differ")
            if not torch.equal(first[0], y.detach()):
                raise AssertionError(f"{label}: partial_conv2d differs from the kernel's call")
            if f32:
                err = check_f32(label, first, xd, md, wd, bd, kw)
                grel, gabs = check_grads_f32(label, xd, md, wd, bd, g, kw)
            else:
                y64, m64 = kpc.partial_conv2d_reference(xd.double(), md.double(), wd.double(),
                                                        bd.double(), **kw)
                err = check_close(label, first, (y64, m64.to(dt)), require_empty=True)
                grel, gabs = check_grads(label, xd, md, wt, b, g, kw)
                d1 = kpc.partial_conv2d_backward(g, xd, md, wd, bd, groups, pad, needs)
                d2 = kpc.partial_conv2d_backward(g, xd, md, wd, bd, groups, pad, needs)
                torch.cuda.synchronize()
                if not all(torch.equal(a1, a2) for a1, a2 in zip(d1, d2)):
                    raise AssertionError(f"{label}: two backward launches differ")
            # the times: kernel, plain version, cuDNN on x * M (never called by the port)
            fwd = lambda: kpc.partial_conv2d_fused(xd, md, wd, bd, **kw)  # noqa: E731
            bwd = lambda: kpc.partial_conv2d_backward(g, xd, md, wd, bd, groups, pad,  # noqa: E731
                                                      needs)
            pfwd = lambda: kpc.partial_conv2d_reference(xd, md, wd, bd, **kw)  # noqa: E731
            pbwd = lambda: kpc.partial_conv2d_backward_reference(  # noqa: E731
                g, xd, md, wd, bd, groups, pad, needs)
            xm = to_nchw(apply_mask(xd, md, groups))
            wl = wd.contiguous(memory_format=torch.channels_last)
            gl = to_nchw(g)
            lfwd = lambda: F.conv2d(xm, wl, padding=pad)  # noqa: E731
            lbwd = lambda: torch.ops.aten.convolution_backward(  # noqa: E731
                gl, xm, wl, None, [1, 1], list(pad), [1, 1], False, [0, 0], 1,
                [True, True, False])
            t_f, t_b = cuda_ms(fwd, iters=10), cuda_ms(bwd, iters=10)
            p_f, p_b = cuda_ms(pfwd, iters=10), cuda_ms(pbwd, iters=10)
            l_f, l_b = cuda_ms(lfwd, iters=10), cuda_ms(lbwd, iters=10)
            elem, peak = xd.element_size(), PEAK_F32 if f32 else PEAK_BF16
            p_out = g.shape[0] * g.shape[1] * g.shape[2]
            flop = 2.0 * p_out * cout * k * k * cin
            fbytes = elem * (xd.numel() + md.numel() + wd.numel() + p_out * cout + p_out)
            bbytes = elem * (2 * xd.numel() + g.numel() + md.numel() + 2 * wd.numel())
            if gen_f:
                add("fwd", t_f, p_f, l_f, flop, fbytes, peak, err)
            if gen_b:
                add("bwd", t_b, p_b, l_b, 2 * flop, bbytes, peak, gabs)
            form = "general" if gen_f else "templated" if cout <= 7 else f"G {len(groups)} table"
            bform = "general" if gen_b else "templated" if cout <= 7 else f"G {len(groups)} table"
            for on, what, fn in ((gen_f, "forward", fwd), (gen_b, "backward", bwd)):
                if on:  # the general forms' kernels one by one (device time per call)
                    dev_ms = kernel_ms(fn)
                    log(f"{label}: general {what}, device ms per call: " + ", ".join(
                        f"{k_} {v:.4f}" for k_, v in sorted(dev_ms.items(), key=lambda kv: -kv[1])
                        if "pconv" in k_))
            log(f"{label}: x {tuple(xd.shape)} -> y {tuple(first[0].shape)}; {fwd_key} ({form}) "
                f"{t_f:.4f} ms, plain {p_f:.4f} ms, cuDNN on x*M {l_f:.4f} ms, bound "
                f"{bound(flop, fbytes, peak)[0]:.4f} ms; backward ({bform}) {t_b:.4f} ms, plain "
                f"{p_b:.4f} ms, cuDNN {l_b:.4f} ms, bound {bound(2 * flop, bbytes, peak)[0]:.4f} "
                f"ms (CUDA events, medians of 10); M' bit-exact, max|dy| {err:.4g} vs the f64 "
                f"truth, twice bit-identical; gradients relative L2 {grel:.3g}, max |d| "
                f"{gabs:.4g}; the path's counters {moved_f} {moved_b}")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for name, n, h, w, c, k, d in SCOPE_K6:
        for dt in (torch.bfloat16, torch.float32):
            label = f"scope {name} {'bf16' if dt == torch.bfloat16 else 'f32'}"
            x = torch.randn((n, h, w, c), generator=gen, device=dev).to(dt)
            dy = torch.randn((n, h, w, c), generator=gen, device=dev).to(dt)
            before = kdw.K6_GEN_LAUNCHES
            kdw.depthwise_wgrad(x, dy, k, d)  # the path
            path["k6"] += kdw.K6_GEN_LAUNCHES - before
            res = check_wgrad(label, x, dy, k, d)
            plan = kdw.k6_plan(n, h, w, c, k, d, x.element_size(), sms)
            if not plan.general or kdw.K6_GEN_LAUNCHES - before != 3:
                raise AssertionError(f"{label}: the general form did not run ({plan})")
            p = d * (k - 1) // 2
            wdw = torch.zeros((c, 1, k, k), device=dev, dtype=dt)
            xc, dyc = to_nchw(x), to_nchw(dy)
            t = cuda_ms(lambda: kdw.depthwise_wgrad(x, dy, k, d), iters=10)
            t_p = cuda_ms(lambda: kdw.depthwise_wgrad_reference(x, dy, k, d), iters=10)
            t_l = cuda_ms(lambda: torch.ops.aten.convolution_backward(
                dyc, xc, wdw, None, [1, 1], [p, p], [d, d], False, [0, 0], c,
                [False, True, False]), iters=10)
            peak = PEAK_F32 if dt == torch.float32 else PEAK_BF16
            flop, nbytes = k6_work(x, k, d)
            add("k6", t, t_p, t_l, flop, nbytes, peak, res["K6"])
            dev_ms = kernel_ms(lambda: kdw.depthwise_wgrad(x, dy, k, d))
            log(f"{label}: x {tuple(x.shape)}, general form {plan.gen}, {t:.4f} ms (device: "
                + ", ".join(f"{k_} {v:.4f}" for k_, v in dev_ms.items() if "dw_wgrad" in k_)
                + f"), plain {t_p:.4f} ms, cuDNN's depthwise wgrad {t_l:.4f} ms, bound "
                f"{bound(flop, nbytes, peak)[0]:.4f} ms (CUDA events, medians of 10); K6 max "
                f"|err| {res['K6']:.4g} vs the f64 truth, twice bit-identical")
    # outside JAX's scope: an output height of 12 takes the plain route
    x, m, wt, b = scope_case_inputs(gen, rng, dev, 2, 12, 40, (64, 3), 16, 3)
    xd, md, wd = x.to(torch.bfloat16), m.to(torch.bfloat16), wt.to(torch.bfloat16)
    before = launch_counters()
    y, m_out = partial_conv2d(xd, md, wd, None, group_sizes=(64, 3), padding=1)
    torch.cuda.synchronize()
    if launch_counters() != before:
        raise AssertionError("scope H 12: a kernel counter moved on the plain route")
    y_p, m_p = _partial_conv2d_plain(xd, md, wd, None, (64, 3), (1, 1), (1, 1), (1, 1))
    if not (torch.equal(y, y_p) and torch.equal(m_out, m_p)):
        raise AssertionError("scope H 12: partial_conv2d differs from the plain route")
    log("scope H 12, bf16, Cin 67 -> 16, k 3: the plain route (JAX's _partial_conv2d_xla's "
        "counterpart), no kernel counter moved, y bit-equal to _partial_conv2d_plain")
    if min(path.values()) < 1:
        raise AssertionError(f"scope: a general form never ran on the path: {path}")
    log(f"scope: the general forms' launches on the path {path}")
    rows = []
    for key, fn, src, tpu in (
            ("fwd", "K2/K2F general form pconv_gen_relay, pconv_gen_rowsum, pconv_gen_fwd_bf16 "
                    "(mma.sync) / pconv_gen_fwd_f32 (Cout <= 7 past the templated forms)",
             CSRC, f"{TPU_KERNEL}:480"),
            ("bwd", "K3/K3F general form pconv_k3_prep, pconv_gen_relay, pconv_gen_dx_bf16 / "
                    "pconv_gen_dx_f32, pconv_gen_dw_bf16 / pconv_gen_dw_f32, pconv_colsum "
                    "(Cout <= 7 past the templated forms)", CSRC, f"{TPU_KERNEL}:600"),
            ("k6", "K6 general form dw_wgrad_gen_tiles (tiles of taps over staged rows), "
                   "dw_wgrad_gen_fold", CSRC_DW, f"{TPU_DW}:144")):
        t = tot[key]
        _, by = bound(t["flop"], t["bytes"], t["peak"])
        rows.append({"name": fn, "route": "cuda", "source": src, "replaces": tpu,
                     "launches": path[key], "max_abs_err": t["err"], "ms": t["ms"],
                     "plain_ms": t["plain"], "bound_ms": t["bound"], "bound_by": by,
                     "library_ms": t["lib"]})
    return rows


def kernel_ms(fn, windows: int = 3, calls: int = 2) -> dict:
    """Device milliseconds per launch of each kernel that ``fn`` launches
    (torch.profiler), by the kernel's short name (``stem_f32_conv1<1>``):
    each window profiles ``calls`` calls, a kernel's time is its total over
    its recorded launches (the profiler now and then drops some), and the
    result is the median over the windows that recorded it."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    seen = {}
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if (e.device_type == torch.autograd.DeviceType.CUDA and e.count > 0
                    and e.self_device_time_total > 0):
                name = e.key.split("::", 1)[-1].split("(")[0]
                seen.setdefault(name, []).append(e.self_device_time_total / 1e3 / e.count)
    return {k: statistics.median(v) for k, v in seen.items()}


def ptxas_report(fragments) -> list:
    """ptxas's register and spill lines (``-Xptxas -v``, from this run's
    build) of each kernel whose mangled name holds one of ``fragments``."""
    from text_segmentation_image_inpainting_tpu_torch.ops.kernels import build

    out, name = [], None
    for line in build.last_build["log"].splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "'" in line else None
        elif name and any(f in name for f in fragments) and (
                "registers" in line or "spill" in line):
            out.append(f"{name}: {line.strip()}")
    return out


def profile_run(fn, label: str, runs: int = 3) -> float:
    """torch.profiler over ``runs`` calls of ``fn``: the device's busy share
    (kernel time over the window's wall time) and the kernels that take
    the most device time, per call. Returns the busy ms per call."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / runs
    # kernel rows only: an aten op's row repeats the time of its kernels
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / runs
    log(f"profile {label}: wall {wall_ms:.3f} ms per call with the profiler on, device busy "
        f"{busy_ms:.3f} ms = {busy_ms / wall_ms:.1%}")
    for e in kernels[:15]:
        log(f"  profile: {e.self_device_time_total / 1e3 / runs:8.3f} ms {e.count / runs:5.0f}x "
            f"{e.key[:90]}")
    return busy_ms


if __name__ == "__main__":
    sys.exit(main())
