"""Canonical smoke-test fixtures.

Port of easygaussiansplatting_tpu/data/fixtures.py (numpy on both sides, so
the arrays are bit-equal): the reference's 4-Gaussian scene and its 32x16
test camera. Also the kernels' edge cases (below), the JPEG encoder's
frames (:func:`jpeg_frame`), and a COLMAP scene writer
(:func:`write_colmap_scene`) for the tests and chip_smoke.py.
"""

from pathlib import Path

import numpy as np

from easygaussiansplatting_tpu_torch.data import colmap
from easygaussiansplatting_tpu_torch.utils.image import save_png


def example_gaussians(dtype=np.float64):
    """Four axis-aligned Gaussians at the origin and unit points.

    Returns dict with pws [4,3], rots [4,4] (wxyz), scales [4,3], alphas [4],
    shs [4,3] (degree-0 RGB coefficients only).
    """
    c = 1.772484  # +-0.5 / SH_C0 in the reference fixture
    pws = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], dtype=dtype)
    rots = np.array([[1, 0, 0, 0]] * 4, dtype=dtype)
    scales = np.array(
        [[0.05, 0.05, 0.05], [0.2, 0.05, 0.05], [0.05, 0.2, 0.05], [0.05, 0.05, 0.2]],
        dtype=dtype,
    )
    alphas = np.ones(4, dtype=dtype)
    shs = np.array(
        [[c, -c, c], [c, -c, -c], [-c, c, -c], [-c, -c, c]],
        dtype=dtype,
    )
    return {"pws": pws, "rots": rots, "scales": scales, "alphas": alphas, "shs": shs}


def example_camera(dtype=np.float64):
    """The fixed 32x16 test camera of the verification harness."""
    tcw = np.array([1.03796196, 0.42017467, 4.67804612], dtype=dtype)
    Rcw = np.array(
        [
            [0.89699204, 0.06525223, 0.43720409],
            [-0.04508268, 0.99739184, -0.05636552],
            [-0.43974177, 0.03084909, 0.89759429],
        ],
        dtype=dtype,
    ).T
    width, height = 32, 16
    fx = fy = 16.0
    cx, cy = width / 2.0, height / 2.0
    return {
        "Rcw": Rcw,
        "tcw": tcw,
        "width": width,
        "height": height,
        "fx": fx,
        "fy": fy,
        "cx": cx,
        "cy": cy,
    }


STACK_SLOTS = 640  # patch slots of stacked_tile: the largest list, 513, rounded up to 128


def stacked_tile(n, seed=0):
    """One 16x16 tile whose list holds ``n`` entries, for the stage-6 blend
    at the edges of its kernels' batches (test sizes such as 63/64/65 and
    511/512/513). Not in the JAX package: a fixture of the port's tests.

    Entry j is gaussian j, so each gaussian has one patch and its table
    cotangent row is its patch's gradient row. The kinds, drawn per entry:
    opaque ones in the top-left quarter (its pixels saturate), faint ones
    on the right (its pixels walk the whole list), ones with alpha 0.002 or
    0.0021 (alpha' on the skip threshold near their centre), ones with alpha
    0.99, 0.995 or 1 at the top left (alpha' clamped at 0.99 near their
    centre), and patch ids of -1 (dropped entries). The last entry is a wide
    faint one on the right, so some pixel's last contributor is entry n.
    Entries before the last are the same for every n.

    Returns float32 numpy arrays us [S,2], cinv2ds [S,3] (conic a, b, c),
    alphas [S], colors [S,3] for S = STACK_SLOTS gaussians (rows past n
    unused), and int32 patch_gsid [S] (-1 past n), tile_start [1] = 0 and
    tile_cnt [1] = n.
    """
    if not 0 < n <= STACK_SLOTS:
        raise ValueError(f"n must be in [1, {STACK_SLOTS}], got {n}")
    rng = np.random.default_rng(seed)
    s = STACK_SLOTS
    kind = rng.choice(5, size=s, p=[0.3, 0.45, 0.1, 0.05, 0.1])
    left = (kind == 0) | (kind == 3)
    us = np.where(left[:, None], rng.uniform(-1.0, 7.0, (s, 2)),
                  np.stack([rng.uniform(6.0, 18.0, s), rng.uniform(-2.0, 18.0, s)], axis=1))
    sigma = np.where(kind[:, None] == 3, rng.uniform(0.8, 1.5, (s, 2)),
                     rng.uniform(1.0, 5.0, (s, 2)))
    theta = rng.uniform(0.0, np.pi, s)
    alphas = np.select([kind == 0, kind == 1, kind == 2, kind == 3],
                       [rng.uniform(0.6, 0.98, s), rng.uniform(0.003, 0.03, s),
                        rng.choice([0.002, 0.0021], s), rng.choice([0.99, 0.995, 1.0], s)],
                       rng.uniform(0.05, 0.5, s))
    us[n - 1], sigma[n - 1], theta[n - 1], alphas[n - 1] = (13.0, 12.0), (6.0, 5.0), 0.3, 0.05
    c, si = np.cos(theta), np.sin(theta)
    va, vb = sigma[:, 0] ** 2, sigma[:, 1] ** 2
    # covariance R diag(va, vb) R^T, inverted: conic (a, b, c) with
    # maha = a dx^2 + 2 b dx dy + c dy^2
    cxx, cxy, cyy = c * c * va + si * si * vb, c * si * (va - vb), si * si * va + c * c * vb
    det = cxx * cyy - cxy * cxy
    cinv2ds = np.stack([cyy / det, -cxy / det, cxx / det], axis=1)
    gsid = np.where((kind == 4) & (np.arange(s) < n - 1), -1, np.arange(s))
    gsid[n:] = -1
    return {"us": us.astype(np.float32), "cinv2ds": cinv2ds.astype(np.float32),
            "alphas": alphas.astype(np.float32),
            "colors": rng.uniform(0.0, 1.0, (s, 3)).astype(np.float32),
            "patch_gsid": gsid.astype(np.int32), "tile_start": np.zeros(1, np.int32),
            "tile_cnt": np.full(1, n, np.int32)}


def chunked_frame(lengths, width, height, saturated=(), seed=0):
    """A frame of 16x16 tiles whose lists run long, for K4's chunks: tile t
    (row-major) holds ``lengths[t]`` entries (0: an empty tile), drawn per
    entry as kinds of :func:`stacked_tile` over the whole tile: faint ones
    (alpha 0.002-0.006, sigma 1-3 px, so that a pixel walks thousands of
    entries before it stops), opaque ones (alpha 0.6-0.98; one in twenty),
    ones on the skip and clamp thresholds, and patch ids of -1. A tile in
    ``saturated`` starts with three wide entries of alpha 1 (alpha' about
    0.99 over the whole tile), so that every pixel stops within them and
    the rest of its list lies behind. ``width`` and ``height`` need not be
    multiples of 16 (ragged edge tiles). Not in the JAX package: a fixture
    of the port's tests.

    Entry j of the frame is gaussian j, its mean in frame pixels. Returns
    float32 numpy arrays us [S,2], cinv2ds [S,3], alphas [S], colors [S,3]
    and int32 patch_gsid [S], tile_start [T], tile_cnt [T], S the sum of
    ``lengths`` (at least 1; a frame of empty tiles keeps one unused row).
    """
    gx, gy = -(-width // 16), -(-height // 16)
    if len(lengths) != gx * gy:
        raise ValueError(f"lengths must have {gx * gy} entries, got {len(lengths)}")
    rng = np.random.default_rng(seed)
    cnt = np.asarray(lengths, np.int64)
    s = max(1, int(cnt.sum()))
    tile = np.repeat(np.arange(gx * gy), cnt)
    tile = np.concatenate([tile, np.zeros(s - len(tile), np.int64)])
    origin = np.stack([tile % gx, tile // gx], axis=1) * 16.0
    kind = rng.choice(5, size=s, p=[0.05, 0.75, 0.08, 0.04, 0.08])
    us = origin + rng.uniform(-2.0, 18.0, (s, 2))
    sigma = np.where(kind[:, None] == 0, rng.uniform(1.0, 5.0, (s, 2)),
                     np.where(kind[:, None] == 3, rng.uniform(0.8, 1.5, (s, 2)),
                              rng.uniform(1.0, 3.0, (s, 2))))
    theta = rng.uniform(0.0, np.pi, s)
    alphas = np.select([kind == 0, kind == 1, kind == 2, kind == 3],
                       [rng.uniform(0.6, 0.98, s), rng.uniform(0.002, 0.006, s),
                        rng.choice([0.002, 0.0021], s), rng.choice([0.99, 0.995, 1.0], s)],
                       rng.uniform(0.002, 0.006, s))
    start = np.concatenate([[0], np.cumsum(cnt)[:-1]])
    for t in saturated:
        if cnt[t] < 3:
            raise ValueError(f"saturated tile {t} needs 3 entries, has {cnt[t]}")
        j = slice(start[t], start[t] + 3)
        us[j] = origin[start[t]] + 8.0
        sigma[j], alphas[j] = 50.0, 1.0
    c, si = np.cos(theta), np.sin(theta)
    va, vb = sigma[:, 0] ** 2, sigma[:, 1] ** 2
    cxx, cxy, cyy = c * c * va + si * si * vb, c * si * (va - vb), si * si * va + c * c * vb
    det = cxx * cyy - cxy * cxy
    cinv2ds = np.stack([cyy / det, -cxy / det, cxx / det], axis=1)
    gsid = np.where(kind == 4, -1, np.arange(s))
    gsid[cnt.sum():] = -1
    for t in saturated:
        gsid[start[t]:start[t] + 3] = np.arange(start[t], start[t] + 3)
    return {"us": us.astype(np.float32), "cinv2ds": cinv2ds.astype(np.float32),
            "alphas": alphas.astype(np.float32),
            "colors": rng.uniform(0.0, 1.0, (s, 3)).astype(np.float32),
            "patch_gsid": gsid.astype(np.int32), "tile_start": start.astype(np.int32),
            "tile_cnt": cnt.astype(np.int32)}


SEG_TILE = 1024  # positions a block of csrc/seg_scan.cu (its plan's tile)
SEG_CASES = ("tile", "tile_minus_1", "tile_plus_1", "three_tile_segment", "startless_tile",
             "tile_edges", "one_segment", "every_position")


def segment_case(kind, rows=9, seed=0):
    """Rows [rows, m] float32 and segment-start flags [m] int32 (element 0
    flagged) at the edges of K6's tiles of SEG_TILE positions: m at the tile
    and one off it (random starts); a segment over positions 100 to 4 tiles
    + 50; a tile (the second of four) with no start; starts at every tile's
    first and last positions; one segment over everything; a start at every
    position."""
    t = SEG_TILE
    m = {"tile": t, "tile_minus_1": t - 1, "tile_plus_1": t + 1, "three_tile_segment": 5 * t + 4,
         "startless_tile": 4 * t, "tile_edges": 3 * t + 17, "one_segment": 3 * t + 5,
         "every_position": 2 * t + 2}[kind]
    rng = np.random.default_rng(seed)
    vals = rng.normal(size=(rows, m)).astype(np.float32)
    flags = np.zeros(m, np.int32)
    if kind in ("tile", "tile_minus_1", "tile_plus_1"):
        flags[:] = rng.random(m) < 0.1
    elif kind == "three_tile_segment":
        flags[[100, 4 * t + 50, 4 * t + 51]] = 1
    elif kind == "startless_tile":
        flags[:] = rng.random(m) < 0.05
        flags[t:2 * t] = 0
    elif kind == "tile_edges":
        edges = np.arange(0, m, t)
        flags[edges] = 1
        flags[np.minimum(edges + t - 1, m - 1)] = 1
    elif kind == "every_position":
        flags[:] = 1
    flags[0] = 1
    return vals, flags


SCAN_TILE = 4096  # positions a block of csrc/scan.cu (its plan's tile)
SCAN_CASES = ("tile", "tile_minus_1", "tile_plus_1", "many_tiles", "wrap", "unaligned")


def scan_case(kind, rows=2, dtype=np.int32, seed=0):
    """Rows [rows, m] of int32 or float32 at the edges of K3's tiles of
    SCAN_TILE positions: m at the tile and one off it; m over three tiles
    and a part; int32 values near 2^20, whose sums wrap past 2^31 within
    the first tile and across the tile boundaries after it; and m = 2 tiles
    + 2, so that row 1 starts 8 bytes past a 16-byte boundary (m % 4 != 0:
    the kernel's striped 4-byte path)."""
    t = SCAN_TILE
    m = {"tile": t, "tile_minus_1": t - 1, "tile_plus_1": t + 1, "many_tiles": 3 * t + 17,
         "wrap": 2 * t + 5, "unaligned": 2 * t + 2}[kind]
    rng = np.random.default_rng(seed)
    if kind == "wrap":
        if dtype != np.int32:
            raise ValueError("the wrap case is int32")
        return rng.integers(2**19, 2**21, size=(rows, m)).astype(np.int32)
    if dtype == np.int32:
        return rng.integers(-50, 50, size=(rows, m)).astype(np.int32)
    return rng.normal(size=(rows, m)).astype(np.float32)


PRE_BLOCK = 128  # gaussians a block of csrc/preprocess.cu and csrc/preprocess_bwd.cu
PRE_EDGES = (PRE_BLOCK - 1, PRE_BLOCK, PRE_BLOCK + 1, 2 * PRE_BLOCK - 1, 2 * PRE_BLOCK + 1)


def preprocess_case(n, deg, seed=0):
    """n random gaussians with SH degree ``deg`` in front of and around
    example_camera(), a fifth of them behind it (camera depth below 0.2),
    as float32 arrays pws [n,3], shs [n, 3(deg+1)^2], alphas [n], scales
    [n,3], rots [n,4] (unit quaternions): K1's block edges at n =
    PRE_EDGES."""
    rng = np.random.default_rng(seed)
    pws = rng.normal(size=(n, 3)) * np.array([1.5, 1.0, 1.5])
    # the camera sits near z = -3.8 looking along +z
    pws[: n // 5, 2] = rng.uniform(-10.0, -8.0, size=n // 5)
    rots = rng.normal(size=(n, 4))
    rots /= np.linalg.norm(rots, axis=1, keepdims=True)
    arrays = {"pws": pws, "shs": rng.normal(size=(n, 3 * (deg + 1) ** 2)) * 0.5,
              "alphas": 1 / (1 + np.exp(-rng.normal(size=n))),
              "scales": np.exp(rng.normal(size=(n, 3)) * 0.4 - 2.2), "rots": rots}
    return {k: v.astype(np.float32) for k, v in arrays.items()}


def degenerate_scene():
    """The five gaussians of the JAX package's tests/test_robustness.py, as
    float32 (pws, shs [5,3], alphas, scales, rots): a singular conic
    (scales 1e-12, alpha 1), one far behind the camera, a giant splat near
    it (scales 50, alpha 0.9999), an extremely anisotropic one (alpha
    1e-8) and a plain one (alpha 0.99)."""
    pws = np.array([
        [0.0, 0.0, 0.0],
        [0.0, 0.0, -100.0],
        [1.03796196, 0.42017467, 4.87804612 - 4.67804612 + 0.0],
        [0.2, 0.1, 0.3],
        [0.5, -0.2, 0.1],
    ], np.float32)
    rots = np.tile(np.array([[1.0, 0, 0, 0]], np.float32), (5, 1))
    scales = np.array([
        [1e-12, 1e-12, 1e-12],
        [0.1, 0.1, 0.1],
        [50.0, 50.0, 50.0],
        [1e-6, 10.0, 1e-6],
        [0.05, 0.05, 0.05],
    ], np.float32)
    alphas = np.array([1.0, 0.5, 0.9999, 1e-8, 0.99], np.float32)
    shs = np.zeros((5, 3), np.float32)
    shs[:, 0] = 1.0
    return pws, shs, alphas, scales, rots


def culled_scene(n=8):
    """``n`` gaussians all behind the camera (tests/test_robustness.py's
    all-culled training scene), as float32 (pws, shs, alphas, scales, rots)."""
    rots = np.tile(np.array([[1.0, 0, 0, 0]], np.float32), (n, 1))
    return (np.full((n, 3), -50.0, np.float32), np.ones((n, 3), np.float32),
            np.full(n, 0.5, np.float32), np.full((n, 3), 0.1, np.float32), rots)


# K11's frame sizes as (height, width): a lone pixel, one block, odd edges
# that leave dummy blocks (15 wide x 17 high: a dummy Y row; 17 x 9: a dummy
# Y column), one MCU, and the served sizes (the viewer's drag preview
# 244 x 136 and full frame 979 x 546, which has both, 640 x 480, the SH
# demo's 960 x 192 strip)
JPEG_SIZES = ((1, 1), (8, 8), (17, 15), (16, 16), (9, 17), (64, 96), (136, 244), (480, 640),
              (192, 960), (546, 979))
JPEG_KINDS = ("noise", "flat0", "flat255", "gradient", "checker")


def jpeg_frame(kind, height, width, seed=0):
    """An [H,W,3] uint8 frame of ``kind``: uniform noise (long AC codes, many
    0xFF bytes in the scan), flat 0 or 255 (the quantiser's and the DC's
    extremes), a gradient in each channel, or 8x8 squares of 0 and 255 in
    turn (DC differences of category 11 at quality 100)."""
    if kind == "noise":
        return np.random.default_rng(seed).integers(0, 256, (height, width, 3), dtype=np.uint8)
    if kind in ("flat0", "flat255"):
        return np.full((height, width, 3), 0 if kind == "flat0" else 255, np.uint8)
    yy, xx = np.mgrid[0:height, 0:width]
    if kind == "checker":
        return np.repeat((((yy >> 3) + (xx >> 3)) % 2 * 255).astype(np.uint8)[..., None], 3, -1)
    if kind != "gradient":
        raise ValueError(f"unknown frame kind {kind!r}")
    return np.stack([xx * 255 // max(width - 1, 1), yy * 255 // max(height - 1, 1),
                     (3 * xx + 5 * yy) % 256], -1).astype(np.uint8)


def rotmat2qvec(R):
    """Rotation matrix -> wxyz unit quaternion with w >= 0, the inverse of
    ``colmap.qvec2rotmat`` (the symmetric-eigenvector method of COLMAP's
    own scripts)."""
    (rxx, ryx, rzx), (rxy, ryy, rzy), (rxz, ryz, rzz) = np.asarray(R, np.float64)
    k = np.array([
        [rxx - ryy - rzz, 0, 0, 0],
        [ryx + rxy, ryy - rxx - rzz, 0, 0],
        [rzx + rxz, rzy + ryz, rzz - rxx - ryy, 0],
        [ryz - rzy, rzx - rxz, rxy - ryx, rxx + ryy + rzz]]) / 3.0
    vals, vecs = np.linalg.eigh(k)
    q = vecs[[3, 0, 1, 2], np.argmax(vals)]
    return -q if q[0] < 0 else q


def write_colmap_scene(root, cameras, images, xyz, rgb, photos=None):
    """Write a COLMAP scene under ``root``: ``sparse/0/{cameras,images,
    points3D}.bin`` from dicts of ``colmap.ColmapCamera`` and
    ``colmap.ColmapImage`` and the points (xyz [N,3], rgb [N,3] uint8),
    and ``images/<name>`` for each uint8 [H,W,3] array of ``photos`` (name
    -> array) as an 8-bit RGB PNG (utils/image.py's ``save_png``)."""
    root = Path(root)
    sparse = root / "sparse" / "0"
    sparse.mkdir(parents=True, exist_ok=True)
    (root / "images").mkdir(exist_ok=True)
    colmap.write_cameras_binary(sparse / "cameras.bin", cameras)
    colmap.write_images_binary(sparse / "images.bin", images)
    colmap.write_points3d_binary(sparse / "points3D.bin", xyz, rgb)
    for name, rgb8 in (photos or {}).items():
        save_png(root / "images" / name, rgb8)
    return root
