"""Chunked alpha blending math on [..., K, P] blocks, forward and backward.

Port of easygaussiansplatting_tpu/ops/blend.py (``chunk_alpha``,
``blend_chunk_fwd``, ``blend_chunk_bwd`` and the constants). With
ops/rasterize_tiled.py it is the plain version of kernels K4
(csrc/rasterize_fwd.cu) and K5 (csrc/rasterize_bwd.cu). The per-pixel
sequential recurrence of the reference's draw kernel is re-expressed over a
chunk of K depth-ordered entries at once:

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
    # Where the stop fell inside the chunk, leave with the tau its test saw
    # (the largest tau_ex it excluded, the first): the product above rounds
    # apart from the cumulative one and could climb back to TAU_STOP, and a
    # later chunk would then contribute behind entries this one excluded,
    # which the backward's replay (every live entry below contrib) cannot
    # represent.
    stopped = m1 & (tau_ex < TAU_STOP)
    tau_out = torch.where(stopped.any(dim=-2),
                          torch.amax(torch.where(stopped, tau_ex, 0.0), dim=-2), tau_out)
    k_idx = torch.arange(1, ap.shape[-2] + 1, dtype=torch.int32, device=ap.device)[:, None]
    cont_local = torch.amax(torch.where(contribute, k_idx, 0), dim=-2)
    return color_add, tau_out, cont_local.to(torch.int32)


def _suffix(x, op):
    """Inclusive suffix ``op`` (cumsum / cumprod) along the entry axis."""
    return torch.flip(op(torch.flip(x, [-2]), dim=-2), [-2])


def blend_chunk_bwd(tau_end, gag, g, offset, contrib, us_k, cinv_k, alpha_k, color_k,
                    mask_k, px, py):
    """One backward chunk; chunks are visited back to front (docs/backward.md
    B.1-B.4, as the Pallas ``backward_kernel`` evaluates them).

    tau_end [..., P]: transmittance after this chunk's last entry; gag
    [..., P]: g . (blended colour of every later entry); g [..., 3, P]:
    dL/dpixel; offset: the tile-list position of the chunk's first entry;
    contrib [..., P] int32: the forward's contributor counts; the rest as in
    :func:`chunk_alpha`, with the means in tile-local coordinates.

    Returns (grads [..., K, 9]: d ux, uy, conic a, b, c, alpha, r, g, b;
    tau_start [..., P], gag_start [..., P]) for the next (shallower) chunk.
    """
    k = us_k.shape[-2]
    ap, (dx, dy, maha_raw) = chunk_alpha(us_k, cinv_k, alpha_k, mask_k, px, py)
    idx = offset + torch.arange(k, device=ap.device)[:, None]  # [K,1]
    m = (idx < contrib[..., None, :]) & (ap >= ALPHA_SKIP)
    # transmittance in front of each entry, by division (B.2.1)
    sfx = _suffix(torch.where(m, 1.0 - ap, 1.0), torch.cumprod)
    tau_ex = tau_end[..., None, :] / sfx
    contr = torch.where(m, tau_ex * ap, 0.0)  # blend weights
    cg = (color_k[..., 0:1] * g[..., None, 0, :] + color_k[..., 1:2] * g[..., None, 1, :]
          + color_k[..., 2:3] * g[..., None, 2, :])  # g . c per (entry, pixel)
    cgw = contr * cg
    behind = _suffix(cgw, torch.cumsum)
    gg = behind - cgw + gag[..., None, :]  # g . G, the colour behind (B.2.2)
    dap = torch.where(m, tau_ex * cg - gg / torch.clamp(1.0 - ap, min=1e-6), 0.0)  # B.1.2
    live = m & (ap < ALPHA_CLAMP)  # the 0.99 clamp passes no gradient (B.3)
    dap_ap = torch.where(live, dap * ap, 0.0)
    dalpha = dap_ap.sum(-1) / torch.clamp(alpha_k, min=1e-12)
    dm = torch.where(live & (maha_raw > 0.0), -0.5 * dap_ap, 0.0)  # d loss / d maha
    ex, ey = (dm * dx).sum(-1), (dm * dy).sum(-1)
    a, b, c = cinv_k[..., 0], cinv_k[..., 1], cinv_k[..., 2]
    grads = torch.stack([
        2.0 * a * ex + 2.0 * b * ey,
        2.0 * c * ey + 2.0 * b * ex,
        (dm * dx * dx).sum(-1),
        2.0 * (dm * dx * dy).sum(-1),
        (dm * dy * dy).sum(-1),
        dalpha,
    ], dim=-1)
    dcolor = torch.matmul(contr, g.transpose(-1, -2))  # [..., K, 3] (B.5.1)
    return (torch.cat([grads, dcolor], dim=-1), tau_end / sfx[..., 0, :],
            gag + behind[..., 0, :])
