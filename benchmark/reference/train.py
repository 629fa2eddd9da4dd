"""Plain PyTorch reference of the first training steps: the loss, Adam with
the reference recipe's per-group learning rates, and the comparison's
numbers.

The recipe (Kerbl et al. 2023 and the reference trainer): raw parameters
positions, SH degree 0 and degrees 1..3, logit opacity, log scales and
unnormalised wxyz rotations; loss 0.8 L1 + 0.2 (1 - SSIM) with an 11x11
Gaussian window (sigma 1.5, zero padding, C1 = 0.01^2, C2 = 0.03^2); Adam
(b1 0.9, b2 0.999, eps 1e-15 outside the square root, bias-corrected) with
learning rates SH DC 1e-3, SH rest 5e-5, opacity 0.05, scales 5e-3,
rotations 1e-3 and positions 1e-4 x scene size decaying log-linearly to
1e-6 x scene size over the schedule's steps. Imports nothing of the program.
"""

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import render as ref_render

GROUPS = ("pws", "low_shs", "high_shs", "alphas_raw", "scales_raw", "rots_raw")
B1, B2, EPS = 0.9, 0.999, 1e-15


def raw_params(init, device, dtype=torch.float32):
    """The raw parameters of activated init arrays (numpy): the inverse
    activations, worked out in float64 as a trainer stores them, and SH
    degrees 1..3 at the reference's 1e-3."""
    n = len(init["pws"])
    a = np.clip(np.asarray(init["alphas"], np.float64).reshape(n), 1e-6, 1 - 1e-6)
    raw = {
        "pws": np.asarray(init["pws"], np.float32),
        "low_shs": np.asarray(init["shs"], np.float32).reshape(n, -1)[:, :3],
        "high_shs": np.full((n, 45), 1e-3, np.float32),
        "alphas_raw": np.log(a / (1.0 - a)).astype(np.float32),
        "scales_raw": np.log(np.maximum(np.asarray(init["scales"], np.float64), 1e-12)
                             ).astype(np.float32),
        "rots_raw": np.asarray(init["rots"], np.float32),
    }
    return {k: torch.tensor(v, device=device, dtype=dtype) for k, v in raw.items()}


def activated(raw):
    return {"pws": raw["pws"], "shs": torch.cat([raw["low_shs"], raw["high_shs"]], dim=1),
            "alphas": torch.sigmoid(raw["alphas_raw"]), "scales": torch.exp(raw["scales_raw"]),
            "rots": raw["rots_raw"] / torch.linalg.vector_norm(raw["rots_raw"], dim=1,
                                                               keepdim=True)}


def _window(device, dtype, size=11, sigma=1.5):
    x = torch.arange(size, dtype=torch.float64) - size // 2
    g = torch.exp(-(x * x) / (2 * sigma * sigma))
    return (g / g.sum()).to(device=device, dtype=dtype)


def _blur(img):
    """Depthwise separable 11x11 Gaussian blur of [C, H, W], zero padded."""
    c = img.shape[0]
    w = _window(img.device, img.dtype)
    x = F.conv2d(img[None], w.view(1, 1, 1, -1).expand(c, 1, 1, -1), padding=(0, 5), groups=c)
    return F.conv2d(x, w.view(1, 1, -1, 1).expand(c, 1, -1, 1), padding=(5, 0), groups=c)[0]


def ssim(a, b):
    mu1, mu2 = _blur(a), _blur(b)
    s11 = _blur(a * a) - mu1 * mu1
    s22 = _blur(b * b) - mu2 * mu2
    s12 = _blur(a * b) - mu1 * mu2
    c1, c2 = 0.01**2, 0.03**2
    return (((2 * mu1 * mu2 + c1) * (2 * s12 + c2))
            / ((mu1 * mu1 + mu2 * mu2 + c1) * (s11 + s22 + c2))).mean()


def loss_fn(image, gt, lam=0.2):
    return (1 - lam) * (image - gt).abs().mean() + lam * (1 - ssim(image, gt))


def psnr(image, gt):
    mse = ((image.clamp(0, 1) - gt.clamp(0, 1)) ** 2).mean()
    return float(10.0 * torch.log10(1.0 / mse))


def position_lr(step, scene_size, max_steps, lr_init=1e-4, lr_final=1e-6):
    """The positions' learning rate at ``step`` (no warm-up delay)."""
    t = min(max(step / max_steps, 0.0), 1.0)
    return float(np.exp(np.log(lr_init * scene_size) * (1 - t)
                        + np.log(lr_final * scene_size) * t))


LR = {"low_shs": 1e-3, "high_shs": 1e-3 / 20.0, "alphas_raw": 0.05, "scales_raw": 5e-3,
      "rots_raw": 1e-3}


def steps(init, views, scene_size, max_steps, device, dtype=torch.float32):
    """Run the reference trainer over ``views`` (a list of (camera dict,
    ground-truth image [3,H,W])) from ``init``. Returns {"losses": [float],
    "grad1": {group: first gradient}, "start": raw params, "end": raw params
    after the last step}."""
    raw = raw_params(init, device, dtype)
    start = {k: v.clone() for k, v in raw.items()}
    mu = {k: torch.zeros_like(v) for k, v in raw.items()}
    nu = {k: torch.zeros_like(v) for k, v in raw.items()}
    losses, grad1 = [], None
    for i, (cam, gt) in enumerate(views):
        leaves = {k: v.detach().requires_grad_(True) for k, v in raw.items()}
        loss, _ = ref_render.render_grad(activated(leaves), cam,
                                         lambda img, gt=gt: loss_fn(img, gt.to(img.dtype)))
        grads = {k: (v.grad if v.grad is not None else torch.zeros_like(v))
                 for k, v in leaves.items()}
        if grad1 is None:
            grad1 = {k: g.clone() for k, g in grads.items()}
        losses.append(float(loss))
        bc1, bc2 = 1 - B1 ** (i + 1), 1 - B2 ** (i + 1)
        with torch.no_grad():
            for k in GROUPS:
                mu[k].mul_(B1).add_((1 - B1) * grads[k])
                nu[k].mul_(B2).add_((1 - B2) * grads[k] * grads[k])
                lr = position_lr(i, scene_size, max_steps) if k == "pws" else LR[k]
                raw[k] = raw[k] - lr * (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + EPS)
    return {"losses": losses, "grad1": grad1, "start": start, "end": raw}


def norm_gap(got, want, median_norm):
    """|‖got‖ - ‖want‖| over max(‖want‖, the median leaf's ‖want‖)."""
    g, w = float(torch.linalg.vector_norm(got.double())), float(torch.linalg.vector_norm(
        want.double()))
    return abs(g - w) / max(w, median_norm, 1e-30)


def moving_leaves(grad):
    """The groups whose reference gradient norm is at least a thousandth of
    the median group's; the others (a gradient that is nought to rounding,
    as the rotations' of isotropic gaussians) move under Adam by round-off
    alone."""
    norms = {k: float(torch.linalg.vector_norm(v.double())) for k, v in grad.items()}
    med = float(np.median(list(norms.values())))
    return [k for k in grad if norms[k] >= 1e-3 * med]


def leaf_gaps(got, want):
    """The worst leaf's norm gap of ``got`` against ``want`` (dicts of
    tensors by group; only norms are compared, so the shapes may differ)
    and the gap of every leaf."""
    norms = {k: float(torch.linalg.vector_norm(want[k].double())) for k in want}
    med = float(np.median(list(norms.values())))
    gaps = {k: norm_gap(got[k], want[k], med) for k in want}
    return max(gaps.values()), gaps
