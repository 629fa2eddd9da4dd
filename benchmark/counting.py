"""The yardstick's arithmetic: the chip's peaks, what a kernel's work needs
in operations and bytes, and its least time.

Frozen copies of the program's counting (``chip_smoke.py``: ``bound``,
``k1_bound``, ``blend_work``, ``k4_bound``, ``k5_bound``, ``jpeg_tokens``,
``jpeg_bound`` and the K4 walk; ``ops/blend.py``'s ``chunk_alpha``, which
``blend_work`` evaluates), with each constant the program read from its
sources written out here; plus the count of the training loss and of Adam
that the step's share of the peak needs. Operations are counted for what
the data needs, never for what an implementation happens to do, so a share
reads the same work whatever computes it.
"""

import torch

# Published H100 SXM peaks (NVIDIA data sheet): device memory and FP32
# outside the tensor cores. INT32 adds at half the FP32 rate (64 INT32
# lanes per SM against 128 FP32); exp at 16 MUFU results per SM per clock.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
INT32_OP_PER_S = FP32_FLOP_PER_S / 2
MUFU_PER_SM_CLK = 16

TILE = 16
K_CHUNK = 64
TABLE_COLS = 12  # the preprocess table's columns a gaussian
ALPHA_CLAMP = 0.99
ALPHA_SKIP = 0.002
CUTOFF_MARGIN = 1e-3  # csrc/blend.cuh: pairs below ALPHA_SKIP * 2^-CUTOFF_MARGIN take no exp

# Bound of K11 (JPEG), counted per libjpeg stage (chip_smoke.py's
# derivation): colour 21 a pixel, downsampling 10 a chroma cell, the islow
# DCT 8 * 58 + 8 * 60 a real block, quantising 7 a coefficient, the zero
# test 1 a coefficient of any block, 18 a Huffman token, 2 a scan byte.
JPEG_OPS_PIXEL, JPEG_OPS_CELL, JPEG_OPS_BLOCK = 21, 10, 8 * 58 + 8 * 60
JPEG_OPS_COEF, JPEG_OPS_TEST, JPEG_OPS_TOKEN, JPEG_OPS_BYTE = 7, 1, 18, 2

# K2, the preprocess VJP: about 600 FP32 operations a gaussian (the
# program's estimate; bytes bound it more than tenfold over that).
K2_OPS_GAUSSIAN = 600
# Adam on one parameter element: the two moments (4), the bias-corrected
# ratio with its square root (4), the learning-rate product and the update
# (2).
ADAM_OPS_ELEMENT = 10
PARAM_COLS = 3 + 3 + 45 + 1 + 3 + 4  # a gaussian's raw parameters


def bound(nbytes, fp32_ops, exps, clock_mhz, n_sm, int_ops=0):
    """The least time of a kernel: its bytes at the memory's peak, or its
    operations at the peak of the unit that bounds them."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(fp32_ops / FP32_FLOP_PER_S, int_ops / INT32_OP_PER_S,
                exps / (MUFU_PER_SM_CLK * n_sm * clock_mhz * 1e6))
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def k1_ops(n, deg=3):
    return n * (200 + 8 * (deg + 1) ** 2)


def k1_bound(n, deg, clock_mhz, n_sm):
    """K1 for n gaussians: the parameters read once, the table written once."""
    nbytes = n * 4 * (3 + 3 * (deg + 1) ** 2 + 1 + 3 + 4) + n * 4 * TABLE_COLS
    return bound(nbytes, k1_ops(n, deg), 0, clock_mhz, n_sm)


def chunk_alpha(us_k, cinv_k, alpha_k, mask_k, px, py):
    """alpha' [..., K, P] of chunks of K entries against P pixels, and the
    raw Mahalanobis distance."""
    dx = us_k[..., 0:1] - px
    dy = us_k[..., 1:2] - py
    a, b, c = cinv_k[..., 0:1], cinv_k[..., 1:2], cinv_k[..., 2:3]
    maha_raw = a * dx * dx + c * dy * dy + 2.0 * b * dx * dy
    ap = alpha_k[..., None] * torch.exp(-0.5 * torch.clamp(maha_raw, min=0.0))
    ap = torch.clamp(ap, max=ALPHA_CLAMP)
    return torch.where(mask_k[..., None], ap, 0.0), maha_raw


def k4_walk(tile_cnt, final_tau, contrib, width, height):
    """Each pixel's walked length in the forward blend [H, W]: a pixel that
    saturated stops at its last contributor, any other walks its tile list."""
    gx = -(-width // TILE)
    ty = torch.arange(height, device=contrib.device)[:, None] // TILE
    tx = torch.arange(width, device=contrib.device)[None, :] // TILE
    return torch.where(final_tau < 1e-4, contrib.long(), tile_cnt.long()[ty * gx + tx])


def blend_work(table, patch_gsid, tile_start, tile_cnt, walk, width, height):
    """What the blend's walk does on this data, counted with the plain
    alpha'. ``walk`` [H, W] is each pixel's walked length; the pairs at
    positions below it are evaluated. Counts: ``evaluated`` pairs; of those
    ``passed`` the exp cutoff, ``live`` (alpha' >= ALPHA_SKIP),
    ``unclamped`` (and alpha' < ALPHA_CLAMP), ``moments`` (and maha > 0);
    ``entry_tile``: positions below each tile's largest walk; per half-tile
    warp (16x8 pixels) ``warp_iters`` and ``warp_live``."""
    dev = table.device
    gx, gy = -(-width // TILE), -(-height // TILE)
    walk_t = torch.zeros((gy * TILE, gx * TILE), dtype=torch.int64, device=dev)
    walk_t[:height, :width] = walk
    walk_t = walk_t.reshape(gy, TILE, gx, TILE).transpose(1, 2).reshape(gx * gy, TILE * TILE)
    maxc = torch.minimum(walk_t.amax(1), tile_cnt.long())
    t = torch.arange(gx * gy, device=dev)
    origin = torch.stack([(t % gx) * TILE, (t // gx) * TILE], dim=1).float()
    lin = torch.arange(TILE * TILE, device=dev)
    px, py = (lin % TILE).float(), (lin // TILE).float()
    k_off = torch.arange(K_CHUNK, device=dev)
    edge = ALPHA_SKIP * 2.0 ** -CUTOFF_MARGIN
    names = ("evaluated", "passed", "live", "unclamped", "moments", "warp_live")
    counts = torch.zeros(len(names), dtype=torch.int64, device=dev)
    for c in range(-(-int(maxc.max()) // K_CHUNK)):
        pos = c * K_CHUNK + k_off[None, :]
        idx = torch.clamp(tile_start[:, None].long() + pos, 0, patch_gsid.numel() - 1)
        ok = (pos < maxc[:, None]) & (patch_gsid[idx] >= 0)
        row = table[patch_gsid[idx].clamp(min=0).long()]
        ap, maha = chunk_alpha(row[..., 0:2] - origin[:, None, :], row[..., 2:5], row[..., 5],
                               ok, px, py)
        evaluated = pos[..., None] < walk_t[:, None, :]
        live = evaluated & (ap >= ALPHA_SKIP)
        unclamped = live & (ap < ALPHA_CLAMP)
        tk = live.shape[:2]
        counts += torch.stack([evaluated.sum(), (evaluated & (ap >= edge)).sum(), live.sum(),
                               unclamped.sum(), (unclamped & (maha > 0)).sum(),
                               live.reshape(*tk, 2, -1).any(-1).sum()])
    work = dict(zip(names, (int(v) for v in counts)))
    work["entry_tile"] = int(maxc.sum())
    work["warp_iters"] = int(torch.minimum(walk_t.reshape(gx * gy, 2, -1).amax(-1),
                                           tile_cnt.long()[:, None]).sum())
    return work


def k4_ops(work):
    """evaluated: the offsets 1, the exponent 5, the stop and skip compares
    2; passed: min(e, 0), * alpha, the 0.99 clamp 3 (and one exp); live: tau
    * alpha' 1, the colours 3, 1 - alpha' and the tau product 2."""
    return work["evaluated"] * 8 + work["passed"] * 3 + work["live"] * 6


def k4_bytes(kept, n_tiles, n_distinct, n_pix):
    return kept * 4 + n_tiles * 8 + n_distinct * 9 * 4 + n_pix * 5 * 4


def k4_bound(nbytes, work, clock_mhz, n_sm):
    return bound(nbytes, k4_ops(work), work["passed"], clock_mhz, n_sm)


def k5_ops(work):
    """evaluated 8 and passed 3 as K4; live 14 (1 - alpha' and its clamp 2,
    the tau product 1, tau * alpha' 1, g.c 3, d alpha' 2, the behind sum 1,
    the clamp compare 1, the colour terms 3); unclamped 3; maha > 0 8; an
    (entry, warp) with a live pair 12 (the reduce-scatter's adds); an
    (entry, tile) 21."""
    return (work["evaluated"] * 8 + work["passed"] * 3 + work["live"] * 14
            + work["unclamped"] * 3 + work["moments"] * 8 + work["warp_live"] * 12
            + work["entry_tile"] * 21)


def k5_bytes(kept, n_tiles, n_distinct, n_pix, m):
    return k4_bytes(kept, n_tiles, n_distinct, n_pix) + 9 * 4 * m


def k5_bound(nbytes, work, clock_mhz, n_sm):
    mufu = work["passed"] + work["live"] + work["entry_tile"]
    return bound(nbytes, k5_ops(work), mufu, clock_mhz, n_sm)


def blur_ops(n_pix, taps=11):
    """A separable blur of one channel: two passes of ``taps`` multiply-adds."""
    return n_pix * 2 * 2 * taps


def loss_ops(n_pix, channels=3):
    """The least the loss 0.8 L1 + 0.2 (1 - SSIM) needs, forward and
    backward, for an image of ``n_pix`` pixels: five separable blurs forward
    (the two means, the two second moments, the cross moment) and the three
    that depend on the rendered image backward; per pixel and channel the
    SSIM map's arithmetic (25 forward, 40 backward) and L1 (3 forward, 2
    backward)."""
    per_channel = blur_ops(n_pix) * (5 + 3) + n_pix * (25 + 40 + 3 + 2)
    return channels * per_channel


def adam_ops(capacity):
    return capacity * PARAM_COLS * ADAM_OPS_ELEMENT


def jpeg_tokens(coef):
    """The Huffman tokens of zigzag ``coef`` [n_mcu, 6, 64]: a DC a block,
    each nonzero AC, a ZRL for each 16 zeros before a nonzero AC, and an
    EOB a block that ends in zeros."""
    z = coef.reshape(-1, 64) != 0
    ac = z[:, 1:]
    k = torch.arange(1, 64, device=coef.device)
    last = torch.cummax(torch.where(ac, k, 0), dim=1).values
    prev = torch.cat([last.new_zeros(last.shape[0], 1), last[:, :-1]], dim=1)
    zrl = int((((k - prev - 1) >> 4) * ac).sum())
    return z.shape[0] + int(ac.sum()) + zrl + int((~z[:, 63]).sum())


def jpeg_bound(height, width, coef, scan_bytes, clock_mhz, n_sm):
    """K11's bound on a frame of this size with these coefficients (bytes:
    the frame and the stuffed scan; operations: as JPEG_OPS_* count them)."""
    n_mcu = coef.shape[0]
    real_blocks = -(-height // 8) * -(-width // 8) + 2 * n_mcu
    ops = (JPEG_OPS_PIXEL * height * width + JPEG_OPS_CELL * n_mcu * 64
           + real_blocks * (JPEG_OPS_BLOCK + 64 * JPEG_OPS_COEF)
           + JPEG_OPS_TEST * n_mcu * 6 * 64 + JPEG_OPS_TOKEN * jpeg_tokens(coef)
           + JPEG_OPS_BYTE * scan_bytes)
    return bound(3 * height * width + scan_bytes, 0, 0, clock_mhz, n_sm, int_ops=ops)
