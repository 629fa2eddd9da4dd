"""Gaussian-set I/O: official-3DGS .ply and the reference's .npy recarray.

Port of easygaussiansplatting_tpu/data/gau_io.py, load and save sides
(numpy on both sides, so files written by either package load in the other). Conventions: alphas/scales are stored *activated* in .npy
records; .ply stores raw values (logit opacity, log scales) with the official
field names; quaternions are wxyz; SH coefficients are interleaved
RGB-per-basis ([K,3] flattened), whereas .ply f_rest is planar [3,K-1].
"""

import numpy as np

from easygaussiansplatting_tpu_torch.models.gaussians import pool_from_arrays

SH_C0 = 0.28209479177387814  # Y_0^0


def gs_dtype(sh_dim):
    """The reference's record dtype for .npy interop."""
    return [
        ("pw", "<f4", (3,)),
        ("rot", "<f4", (4,)),
        ("scale", "<f4", (3,)),
        ("alpha", "<f4"),
        ("sh", "<f4", (sh_dim,)),
    ]


def arrays_to_recarray(pws, rots, scales, alphas, shs):
    shs = np.asarray(shs, np.float32).reshape(len(pws), -1)
    return np.rec.fromarrays(
        [
            np.asarray(pws, np.float32),
            np.asarray(rots, np.float32),
            np.asarray(scales, np.float32),
            np.asarray(alphas, np.float32).reshape(-1),
            shs,
        ],
        dtype=gs_dtype(shs.shape[1]),
    )


def recarray_to_arrays(gs):
    return {
        "pws": np.asarray(gs["pw"], np.float32),
        "rots": np.asarray(gs["rot"], np.float32),
        "scales": np.asarray(gs["scale"], np.float32),
        "alphas": np.asarray(gs["alpha"], np.float32),
        "shs": np.asarray(gs["sh"], np.float32),
    }


def _parse_ply_header(f):
    """Returns (vertex_count, [(name, numpy dtype str)], format)."""
    magic = f.readline().strip()
    if magic != b"ply":
        raise ValueError("not a PLY file")
    fmt = None
    props = []
    count = 0
    type_map = {
        b"float": "<f4", b"float32": "<f4", b"double": "<f8", b"float64": "<f8",
        b"uchar": "u1", b"uint8": "u1", b"char": "i1", b"int8": "i1",
        b"short": "<i2", b"ushort": "<u2", b"int": "<i4", b"int32": "<i4",
        b"uint": "<u4", b"uint32": "<u4",
    }
    in_vertex = False
    while True:
        line = f.readline()
        if not line:
            raise ValueError("unterminated PLY header")
        tok = line.split()
        if not tok:
            continue
        if tok[0] == b"format":
            fmt = tok[1].decode()
        elif tok[0] == b"element":
            in_vertex = tok[1] == b"vertex"
            if in_vertex:
                count = int(tok[2])
        elif tok[0] == b"property" and in_vertex:
            if tok[1] == b"list":
                raise ValueError("list properties unsupported in vertex element")
            props.append((tok[2].decode(), type_map[tok[1]]))
        elif tok[0] == b"end_header":
            break
    return count, props, fmt


def load_ply(path):
    """Load an official-3DGS .ply into the recarray format: sigmoid(opacity),
    exp(scales), normalised wxyz quaternion, f_rest re-interleaved from
    planar [3,K] to [K,3]."""
    with open(path, "rb") as f:
        count, props, fmt = _parse_ply_header(f)
        names = [n for n, _ in props]
        dtype = np.dtype(props)
        if fmt == "binary_little_endian":
            data = np.fromfile(f, dtype=dtype, count=count)
        elif fmt == "ascii":
            # ndmin=2: a single-vertex file would otherwise come back 1-D
            data = np.loadtxt(f, dtype=np.float64, max_rows=count, ndmin=2)
            data = data.reshape(count, len(names))
            rec = np.zeros(count, dtype=dtype)
            for i, n in enumerate(names):
                rec[n] = data[:, i]
            data = rec
        else:
            raise ValueError(f"unsupported PLY format {fmt}")

    pws = np.stack([data["x"], data["y"], data["z"]], axis=1).astype(np.float32)
    alphas = 1.0 / (1.0 + np.exp(-data["opacity"].astype(np.float64)))
    scales = np.exp(
        np.stack([data["scale_0"], data["scale_1"], data["scale_2"]], axis=1).astype(np.float64)
    )
    rots = np.stack([data[f"rot_{i}"] for i in range(4)], axis=1).astype(np.float64)
    rots /= np.linalg.norm(rots, axis=1, keepdims=True)

    n_rest = sum(1 for n in names if n.startswith("f_rest_"))
    shs = np.zeros((count, 3 + n_rest), np.float32)
    for i in range(3):
        shs[:, i] = data[f"f_dc_{i}"]
    if n_rest:
        rest = np.stack([data[f"f_rest_{i}"] for i in range(n_rest)], axis=1)
        # planar [3, K] -> interleaved [K, 3]
        shs[:, 3:] = rest.reshape(count, 3, n_rest // 3).transpose(0, 2, 1).reshape(count, n_rest)

    return arrays_to_recarray(
        pws, rots.astype(np.float32), scales.astype(np.float32),
        alphas.astype(np.float32), shs,
    )


def load_gs(path):
    """Load a .ply or .npy gaussian file as a recarray."""
    p = str(path)
    if p.endswith(".ply"):
        return load_ply(p)
    if p.endswith(".npy"):
        return np.load(p)
    raise ValueError(f"unsupported gaussian file: {p}")


def save_ply(path, gs):
    """Write a recarray as an official-3DGS binary .ply (inverse activations)."""
    gs = np.asarray(gs)
    n = len(gs)
    sh = np.asarray(gs["sh"], np.float32).reshape(n, -1)
    n_rest = sh.shape[1] - 3
    alphas = np.clip(np.asarray(gs["alpha"], np.float64), 1e-6, 1 - 1e-6)
    opacity = np.log(alphas / (1 - alphas)).astype(np.float32)
    log_scales = np.log(np.maximum(np.asarray(gs["scale"], np.float64), 1e-12)).astype(np.float32)
    # interleaved [K,3] -> planar [3,K]
    rest = sh[:, 3:].reshape(n, n_rest // 3, 3).transpose(0, 2, 1).reshape(n, n_rest)

    names = (
        ["x", "y", "z", "nx", "ny", "nz", "f_dc_0", "f_dc_1", "f_dc_2"]
        + [f"f_rest_{i}" for i in range(n_rest)]
        + ["opacity", "scale_0", "scale_1", "scale_2", "rot_0", "rot_1", "rot_2", "rot_3"]
    )
    out = np.zeros(n, dtype=[(nm, "<f4") for nm in names])
    pw = np.asarray(gs["pw"], np.float32)
    out["x"], out["y"], out["z"] = pw[:, 0], pw[:, 1], pw[:, 2]
    for i in range(3):
        out[f"f_dc_{i}"] = sh[:, i]
    for i in range(n_rest):
        out[f"f_rest_{i}"] = rest[:, i]
    out["opacity"] = opacity
    for i in range(3):
        out[f"scale_{i}"] = log_scales[:, i]
    rot = np.asarray(gs["rot"], np.float32)
    for i in range(4):
        out[f"rot_{i}"] = rot[:, i]

    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {n}\n"
        + "".join(f"property float {nm}\n" for nm in names)
        + "end_header\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode())
        out.tofile(f)


def save_gs(path, gs):
    """Save a recarray as .ply (by extension) or .npy."""
    p = str(path)
    if p.endswith(".ply"):
        save_ply(p, gs)
    else:
        np.save(p, gs)


def save_pool(path, pool):
    """Save a pool's alive gaussians, activated: the .npy record format, or
    an official-3DGS .ply by extension."""
    pws, shs, alphas, scales, rots, alive = (x.detach().cpu().numpy()
                                             for x in pool.activated())
    keep = alive.astype(bool)
    save_gs(path, arrays_to_recarray(pws[keep], rots[keep], scales[keep], alphas[keep],
                                     shs[keep]))


def load_pool(path, capacity=None, device="cuda"):
    """Load a gaussian file into a fresh pool on ``device``."""
    a = recarray_to_arrays(load_gs(path))
    return pool_from_arrays(a["pws"], a["rots"], a["scales"], a["alphas"], a["shs"],
                            capacity=capacity, device=device)


# ---------------------------------------------------------------- transforms
# Port of the JAX module's transforms (numpy and scipy's Rotation on both
# sides, so they are bit-equal).


def matrix_to_quaternion(R):
    """Batched rotation matrices [N,3,3] -> wxyz quaternions [N,4]."""
    from scipy.spatial.transform import Rotation

    q = Rotation.from_matrix(np.asarray(R, np.float64)).as_quat()  # xyzw
    return np.concatenate([q[:, 3:4], q[:, :3]], axis=1).astype(np.float32)


def quaternion_to_matrix(q):
    """Batched wxyz quaternions [N,4] -> rotation matrices [N,3,3]."""
    from scipy.spatial.transform import Rotation

    q = np.asarray(q, np.float64)
    xyzw = np.concatenate([q[:, 1:], q[:, :1]], axis=1)
    return Rotation.from_quat(xyzw).as_matrix().astype(np.float32)


def rotate_gaussians(T, gs):
    """A copy of the gaussian recarray ``gs`` rigidly rotated by the [3,3]
    matrix ``T``: positions and orientations."""
    T = np.asarray(T, np.float64)
    gs = gs.copy()
    gs["pw"] = (T @ np.asarray(gs["pw"], np.float64).T).T.astype(np.float32)
    R = quaternion_to_matrix(gs["rot"]).astype(np.float64)
    gs["rot"] = matrix_to_quaternion(T[None] @ R)
    return gs
