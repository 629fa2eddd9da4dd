"""Chunked front-to-back alpha blending math on [..., K, P] blocks.

Port of the forward half of easygaussiansplatting_tpu/ops/blend.py
(``chunk_alpha``, ``blend_chunk_fwd`` and the constants). With
ops/rasterize_tiled.py it is the plain version of kernel K4
(csrc/rasterize_fwd.cu). The per-pixel sequential recurrence of the
reference's draw kernel is re-expressed over a chunk of K depth-ordered
entries at once:

  tau_ex[k] = tau_in * prod_{j<k} (1 - alpha'_j)
  color    += sum_k contribute_k * tau_ex[k] * alpha'_k * c_k

with the exact decision rules (alpha' clamp 0.99, skip < 0.002, contribute
iff the running tau >= 1e-4). Leading dimensions batch independent tiles.
"""

import torch

ALPHA_CLAMP = 0.99
ALPHA_SKIP = 0.002
TAU_STOP = 1e-4


def chunk_alpha(us_k, cinv_k, alpha_k, mask_k, px, py):
    """alpha' [..., K, P] for chunks of K entries against P pixels.

    us_k [..., K, 2], cinv_k [..., K, 3], alpha_k [..., K], mask_k [..., K]
    bool; px, py [P]. Returns (alpha_prime, (dx, dy, maha_raw)).
    """
    dx = us_k[..., 0:1] - px
    dy = us_k[..., 1:2] - py
    a = cinv_k[..., 0:1]
    b = cinv_k[..., 1:2]
    c = cinv_k[..., 2:3]
    maha_raw = a * dx * dx + c * dy * dy + 2.0 * b * dx * dy
    maha = torch.clamp(maha_raw, min=0.0)
    ap = alpha_k[..., None] * torch.exp(-0.5 * maha)
    ap = torch.clamp(ap, max=ALPHA_CLAMP)
    ap = torch.where(mask_k[..., None], ap, 0.0)
    return ap, (dx, dy, maha_raw)


def blend_chunk_fwd(tau_in, us_k, cinv_k, alpha_k, color_k, mask_k, px, py):
    """One forward chunk.

    tau_in [..., P]: transmittance entering the chunk; color_k [..., K, 3];
    the rest as in :func:`chunk_alpha`.

    Returns (color_add [..., P, 3], tau_out [..., P], cont_local [..., P]
    int32), where cont_local is the 1-based within-chunk index of the last
    contributing entry (0 if none).
    """
    ap, _ = chunk_alpha(us_k, cinv_k, alpha_k, mask_k, px, py)
    m1 = ap >= ALPHA_SKIP
    # cumulative products, not exp/log sums: near-opaque entries would
    # amplify log-space rounding by 1/(1 - alpha')
    one_m = torch.where(m1, 1.0 - ap, 1.0)
    cum = torch.cumprod(one_m, dim=-2)
    excl = torch.cat([torch.ones_like(cum[..., :1, :]), cum[..., :-1, :]], dim=-2)
    tau_ex = tau_in[..., None, :] * excl
    contribute = m1 & (tau_ex >= TAU_STOP)
    wgt = torch.where(contribute, tau_ex * ap, 0.0)  # [..., K, P]
    color_add = torch.matmul(wgt.transpose(-1, -2), color_k)  # [..., P, 3]
    tau_out = tau_in * torch.prod(torch.where(contribute, 1.0 - ap, 1.0), dim=-2)
    k_idx = torch.arange(1, ap.shape[-2] + 1, dtype=torch.int32, device=ap.device)[:, None]
    cont_local = torch.amax(torch.where(contribute, k_idx, 0), dim=-2)
    return color_add, tau_out, cont_local.to(torch.int32)
