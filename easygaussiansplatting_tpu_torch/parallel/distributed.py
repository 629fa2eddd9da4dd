"""Multi-process runs: start-up, the multi-host mesh, and moving state
between full rows and this rank's rows.

Port of easygaussiansplatting_tpu/parallel/distributed.py
(``init_distributed``, ``make_multihost_mesh``, ``process_batch_rows``,
``put_replicated``, ``put_batch``, ``fetch_to_host``) onto
``torch.distributed``: one process a rank, one card a rank.

* ``init_distributed`` joins the default process group (NCCL for CUDA
  ranks, gloo for CPU ranks) from its arguments or from
  ``EGS_COORDINATOR`` / ``EGS_NUM_PROCESSES`` / ``EGS_PROCESS_ID``; with
  neither it does nothing, as in JAX.
* ``make_multihost_mesh`` puts ``gs`` over the ranks of one host (NVLink:
  the per-camera table all-gather) and ``data`` across hosts (the per-step
  gradient all-reduce), as JAX puts ``gs`` inside a process (ICI) and
  ``data`` across processes (DCN).
* ``put_replicated`` / ``put_batch`` slice this rank's pool rows / camera
  rows out of full host data; ``fetch_to_host`` is the reverse, and, where
  JAX's is free of collectives (its gs shards share a process), it is an
  all-gather over ``gs`` here: **every rank must call it**, or the run
  hangs. JAX's ``reshard_like`` has no counterpart: state gathered for a
  densify goes back to its rows through ``put_replicated``.

``launch_ranks`` starts the ranks of a one-host run as child processes,
each under a time limit.
"""

import dataclasses
import datetime
import os
import socket
import subprocess
import tempfile
import time

import torch
import torch.distributed as dist

from easygaussiansplatting_tpu_torch.models.gaussians import GROUPS, GaussianPool
from easygaussiansplatting_tpu_torch.parallel.collectives import gather_rows
from easygaussiansplatting_tpu_torch.parallel.mesh import make_mesh
from easygaussiansplatting_tpu_torch.train.density import DensityStats
from easygaussiansplatting_tpu_torch.train.optimizer import AdamState
from easygaussiansplatting_tpu_torch.utils.device import resolve_device


def _bind(dev, rank):
    """Rank r's card is r % device_count unless ``dev`` names one."""
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return dev


def init_distributed(coordinator=None, num_processes=None, process_id=None, device="cuda",
                     backend=None, timeout_s=600):
    """Join the default process group; returns this rank's device.

    Explicit arguments win; otherwise ``EGS_COORDINATOR`` (host:port of rank
    0), ``EGS_NUM_PROCESSES`` and ``EGS_PROCESS_ID`` are read; with neither
    this is a no-op that returns ``device``. A CUDA rank r takes card r %
    ``torch.cuda.device_count()`` unless ``device`` names one. ``backend``
    defaults to NCCL for CUDA ranks and gloo for CPU ranks; a failure to
    join raises (there is no single-process fallback). ``timeout_s`` bounds
    every collective."""
    dev = resolve_device(device)
    if dist.is_initialized():
        return _bind(dev, dist.get_rank())
    coordinator = coordinator or os.environ.get("EGS_COORDINATOR")
    if num_processes is None and "EGS_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["EGS_NUM_PROCESSES"])
    if process_id is None and "EGS_PROCESS_ID" in os.environ:
        process_id = int(os.environ["EGS_PROCESS_ID"])
    if coordinator is None and num_processes is None:
        return dev
    if coordinator is None or num_processes is None or process_id is None:
        raise ValueError("a multi-process run needs the coordinator (host:port), the number of "
                         "processes and this process's id (arguments or EGS_COORDINATOR, "
                         "EGS_NUM_PROCESSES, EGS_PROCESS_ID)")
    dev = _bind(dev, process_id)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return dev


def make_multihost_mesh(data=None, host=None):
    """(data, gs) mesh whose gs rows lie within a host. Ranks of one host
    must be contiguous and every host must hold as many. ``data`` defaults
    to the number of hosts and must be a multiple of it; the ranks of a
    host split into data // hosts rows. ``host`` is this rank's host key
    (default its hostname), gathered once over all ranks."""
    host = host or socket.gethostname()
    world = dist.get_world_size() if dist.is_initialized() else 1
    names = [host] * world
    if world > 1:
        dist.all_gather_object(names, host)
    order = list(dict.fromkeys(names))
    procs = len(order)
    local = world // procs
    if names != [h for h in order for _ in range(local)]:
        raise ValueError(f"ranks must lie host by host, as many on each host: {names}")
    if data is None:
        data = procs
    if data % procs != 0:
        raise ValueError(f"data axis {data} must be a multiple of {procs} hosts")
    per = data // procs  # data rows per host
    if local % per != 0:
        raise ValueError(f"{per} data rows/host does not divide {local} ranks on a host")
    return dataclasses.replace(make_mesh(world, data=data), hosts=procs)


def process_batch_rows(mesh, batch, axis_name="data"):
    """Global rows of a [batch, ...] camera batch this rank feeds: its data
    row's, data-row-major as in JAX."""
    return list(range(batch))[rank_rows(mesh, batch, axis_name)]


def tree_map(fn, tree):
    """``fn`` on every row-indexed leaf of ``tree``: tensors and arrays, and
    those of the port's GaussianPool, AdamState and DensityStats, inside
    tuples, lists and dicts. Adam's step count is kept."""
    if isinstance(tree, GaussianPool):
        return GaussianPool(*(fn(getattr(tree, k).detach()) for k in GROUPS),
                            alive=fn(tree.alive))
    if isinstance(tree, AdamState):
        return AdamState(count=tree.count, mu={k: fn(v) for k, v in tree.mu.items()},
                         nu={k: fn(v) for k, v in tree.nu.items()})
    if isinstance(tree, DensityStats):
        return DensityStats(grad_accum=fn(tree.grad_accum), cunt=fn(tree.cunt))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, t) for t in tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def rank_rows(mesh, n, axis_name="gs"):
    """This rank's block of ``n`` rows split over ``axis_name`` (a slice)."""
    size = mesh.shape[axis_name]
    if n % size != 0:
        raise ValueError(f"{n} rows not divisible by the {axis_name} axis {size}")
    i = mesh.index(axis_name)
    return slice(i * (n // size), (i + 1) * (n // size))


def put_replicated(mesh, tree, axis_name="gs"):
    """Full state (the same on every rank) -> this rank's copy of its rows
    along ``axis_name``."""
    def put(x):
        rows = rank_rows(mesh, len(x), axis_name)
        return x[rows].clone() if torch.is_tensor(x) else x[rows].copy()

    return tree_map(put, tree)


def put_batch(mesh, batch, axis_name="data"):
    """A global batch (a sequence of cameras, or images along the leading
    axis) -> this rank's rows, data-row major (:func:`process_batch_rows`)."""
    return batch[rank_rows(mesh, len(batch), axis_name)]


def fetch_to_host(mesh, tree, device=None):
    """This rank's rows -> the full state, gathered over ``gs``: a
    collective that every rank must join. Returns the port's types on
    ``device`` (default: the shards' device)."""
    def get(x):
        if x.dtype == torch.bool:  # gloo gathers no bool tensors
            full = gather_rows(x.to(torch.uint8), mesh, "gs", "fetch").bool()
        else:
            full = gather_rows(x, mesh, "gs", "fetch")
        return full if device is None else full.to(device)

    return tree_map(get, tree)


def free_port():
    """A free TCP port on localhost for a run's coordinator."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch_ranks(argv_for_rank, n, timeout, env=None, cwd=None):
    """Run ``argv_for_rank(r)`` for r in range(n) as child processes and
    wait for all of them. Returns their standard outputs. A rank that exits
    non-zero, or a run that outlives ``timeout`` seconds, kills every rank
    still running and raises RuntimeError with each failed rank's last
    lines of standard error."""
    files = [(tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")) for _ in range(n)]
    procs = [subprocess.Popen(argv_for_rank(r), stdout=o, stderr=e, env=env, cwd=cwd, text=True)
             for r, (o, e) in enumerate(files)]
    deadline = time.monotonic() + timeout
    timed_out = False
    try:
        while True:
            codes = [p.poll() for p in procs]
            if any(c not in (None, 0) for c in codes) or all(c == 0 for c in codes):
                break
            if time.monotonic() > deadline:
                timed_out = True
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    texts = []
    for o, e in files:
        o.seek(0)
        e.seek(0)
        texts.append((o.read(), e.read()))
        o.close()
        e.close()
    failed = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode != 0]
    if timed_out or failed:
        what = f"timed out after {timeout} s" if timed_out else "failed"
        tails = "\n".join(f"--- rank {r} (exit {c}):\n{texts[r][1][-3000:]}" for r, c in failed)
        raise RuntimeError(f"a run of {n} ranks {what}\n{tails}")
    return [t[0] for t in texts]
