"""The depthwise-conv weight gradient: kernel K6 and its plain version.

Counterpart of ``text_segmentation_image_inpainting_tpu/ops/pallas/depthwise_wgrad.py``
(``depthwise_wgrad``). For a stride-1 depthwise conv with dilation d and
torch-'same' padding p = d*(k-1)/2:

    dW[ki, kj, 0, c] = sum_{n, oh, ow} x[n, oh + ki*d - p, ow + kj*d - p, c] * dy[n, oh, ow, c]

with x zero outside the image, summed in f32. The CUDA source is
``csrc/depthwise_wgrad.cu``. ``depthwise_wgrad`` takes the plain version
only for a tensor on the CPU; on a CUDA tensor it launches K6 or raises,
nothing falls back. ``K6_LAUNCHES`` counts the launches.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

K6_LAUNCHES = 0
# the kernel sizes K6 is compiled for (one template instance each)
K6_KERNEL_SIZES = (1, 3, 5, 7)


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
    autograd hands it over with any strides), the plain version on the CPU."""
    if x.device.type == "cpu":
        return depthwise_wgrad_reference(x, dy, k, d)
    return _launch_k6(x.contiguous(), dy.contiguous(), k, d)


def _launch_k6(x: torch.Tensor, dy: torch.Tensor, k: int, d: int) -> torch.Tensor:
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
    if k not in K6_KERNEL_SIZES or d < 1:
        raise ValueError(f"K6 is built for k in {K6_KERNEL_SIZES} and d >= 1, got k={k}, d={d}")
    n, h, w, c = x.shape
    lib = load_library()
    partial = torch.empty(lib.tsii_dw_wgrad_scratch(n, h, w, c, k), dtype=torch.float32,
                          device=x.device)
    dw = torch.empty((k, k, 1, c), dtype=torch.float32, device=x.device)
    code = lib.tsii_dw_wgrad(x.data_ptr(), dy.data_ptr(), partial.data_ptr(), dw.data_ptr(),
                             n, h, w, c, k, d, int(x.dtype == torch.bfloat16),
                             torch.cuda.current_stream().cuda_stream)
    check(lib, code, "K6 (depthwise wgrad)")
    K6_LAUNCHES += 1
    return dw
