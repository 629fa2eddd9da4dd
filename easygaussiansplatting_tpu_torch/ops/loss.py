"""Training loss: L1 + DSSIM.

Port of easygaussiansplatting_tpu/ops/loss.py: SSIM with an 11x11 sigma=1.5
Gaussian window, depthwise SAME (zero-padded) blur, C1 = 0.01^2, C2 =
0.03^2; gau_loss = (1-lambda) L1 + lambda (1-SSIM). The separable blur is
the JAX form, two band-matrix products per blur. On a CUDA device a float32
``torch.matmul`` runs in full float32 by default, where an ``F.conv2d`` blur
would go through cuDNN in TF32 (about three decimal digits); the JAX loss
pins full precision too.
"""

import functools

import numpy as np
import torch


def _gaussian_window(window_size=11, sigma=1.5):
    xs = np.arange(window_size) - window_size // 2
    g = np.exp(-(xs**2) / (2.0 * sigma**2))
    return (g / g.sum()).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _blur_matrix(n, device, window_size=11):
    """[n,n] band matrix B with B[i, i+o] = window[o + ws//2]; rows truncate
    at the borders, which is exactly SAME zero-padded convolution. Cached per
    size and device: a training step then copies nothing to the device."""
    w = torch.from_numpy(_gaussian_window(window_size)).to(device)
    half = window_size // 2
    idx = torch.arange(n, device=device)
    d = idx[None, :] - idx[:, None]
    return torch.where(d.abs() <= half, w[torch.clamp(d + half, 0, window_size - 1)], 0.0)


def _depthwise_blur(img, window_size=11):
    """Separable depthwise SAME blur of img [C,H,W]."""
    bh = _blur_matrix(img.shape[1], img.device, window_size)
    bw = _blur_matrix(img.shape[2], img.device, window_size)
    return torch.matmul(torch.matmul(bh, img), bw.T)


def ssim(img1, img2, window_size=11):
    """Mean SSIM over a [C,H,W] image pair."""
    mu1 = _depthwise_blur(img1, window_size)
    mu2 = _depthwise_blur(img2, window_size)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = _depthwise_blur(img1 * img1, window_size) - mu1_sq
    sigma2_sq = _depthwise_blur(img2 * img2, window_size) - mu2_sq
    sigma12 = _depthwise_blur(img1 * img2, window_size) - mu1_mu2
    c1, c2 = 0.01**2, 0.03**2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2)
    )
    return torch.mean(ssim_map)


def gau_loss(image, gt_image, loss_lambda=0.2):
    """(1-lambda) L1 + lambda DSSIM, the reference training loss."""
    loss_l1 = torch.mean(torch.abs(image - gt_image))
    loss_ssim = 1.0 - ssim(image, gt_image)
    return (1.0 - loss_lambda) * loss_l1 + loss_lambda * loss_ssim
