"""Multi-process execution helpers: the port of
``lanczos_tpu/parallel/multihost.py``.

The design rule is the reference's: the ``rows`` axis (a halo exchange
every step, latency-sensitive) stays within a host's local devices, where
on an NVIDIA node it rides NVLink; the ``data`` axis (a batch of frames,
no exchange between steps) spans hosts, where only the input scatter and
the output gather cross the network (InfiniBand).

A process of one host needs no initialization (``Mesh.local``); call
:func:`initialize` only in a job of several processes, one per rank.  On
CUDA the ranks talk through NCCL, on the CPU through gloo.

The analytic models take their link figures as parameters.  Their
defaults are vendor specifications, not measurements: NVLink 4 on an H100
SXM node (900 GB/s per GPU, 450 GB/s each way, NVIDIA's data sheet) for
the halo ring, one 400 Gb/s InfiniBand NDR port (50 GB/s) a host for the
network.  Feed them the frame time measured on the card
(``chip_smoke.py`` prints both).
"""

from __future__ import annotations

import datetime
import time
from typing import Optional, Sequence

import torch

from lanczos_torch.parallel.mesh import Mesh, ring_shift

NVLINK4_BYTES_S = 4.5e11  # each way, H100 SXM: NVIDIA's specification, not a measurement
NDR_BYTES_S = 5.0e10  # one 400 Gb/s InfiniBand NDR port: a specification, not a measurement
LINK_LATENCY_S = 1.0e-6  # an assumed latency a halo hop, not a measurement
NETWORK_LATENCY_S = 1.0e-5  # an assumed latency a network step, not a measurement


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    timeout_s: float = 60.0,
) -> None:
    """``torch.distributed.init_process_group``, a no-op if a group is
    already initialized.

    ``coordinator_address`` is ``"host:port"`` of rank 0's TCP store
    (``init_method="tcp://host:port"``; with none, ``env://`` reads
    ``MASTER_ADDR`` / ``MASTER_PORT``), ``num_processes`` the world size,
    ``process_id`` this rank.  ``backend`` defaults to NCCL where CUDA is
    available, else gloo.  ``timeout_s`` bounds every collective, so a rank
    that died cannot hang the others forever."""
    import torch.distributed as dist

    if dist.is_initialized():
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    init = f"tcp://{coordinator_address}" if coordinator_address else "env://"
    dist.init_process_group(
        backend, init_method=init, world_size=num_processes if num_processes else -1,
        rank=process_id if process_id is not None else -1,
        timeout=datetime.timedelta(seconds=timeout_s),
    )


def _local_devices() -> list:
    if torch.cuda.is_available():
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def dcn_aware_mesh(
    rows_per_host: Optional[int] = None,
    data_axis: str = "data",
    rows_axis: str = "rows",
    devices: Optional[Sequence] = None,
) -> Mesh:
    """(data × rows) mesh with the rows axis contained in one process.

    ``devices`` are this process's (default: its CUDA devices, else the
    CPU), ``rows_per_host`` defaults to their count, so every halo hop stays
    within the process (NVLink); the data axis spans the ranks of the
    process group, where only input scatter and output gather cross.  With
    no process group the mesh is this process's alone."""
    import torch.distributed as dist

    devices = list(devices) if devices is not None else _local_devices()
    local = len(devices)
    world = dist.get_world_size() if dist.is_initialized() else 1
    rows_n = rows_per_host or local
    if (world * local) % rows_n:
        raise ValueError(
            f"device count {world * local} not divisible by rows axis {rows_n}"
        )
    if local % rows_n:
        # rows_n > local (even as an exact multiple) would put one halo
        # ring across processes: the network hop this function prevents
        raise ValueError(
            f"rows_per_host {rows_n} must divide the local device count "
            f"{local} to stay within the process"
        )
    shape = (world * local // rows_n, rows_n)
    if dist.is_initialized():
        return Mesh.distributed(shape, devices, (data_axis, rows_axis))
    return Mesh.local(devices, shape, (data_axis, rows_axis))


def scaling_efficiency(
    total_mpix_s: float, single_device_mpix_s: float, n_devices: int
) -> float:
    """Fraction of linear scaling achieved."""
    return total_mpix_s / (single_device_mpix_s * n_devices)


def ici_halo_model(
    cfg,
    rows_n: int,
    frame_s: float,
    *,
    channels: int = 3,
    dtype_bytes: int = 1,
    halo_bytes: Optional[int] = None,
    ici_bw: float = NVLINK4_BYTES_S,
    latency_s: float = LINK_LATENCY_S,
    boundary_fraction: Optional[float] = None,
) -> dict:
    """Analytic cost of the row-sharded halo exchange between the cards of
    one node (the reference's ICI model, its formulas and names kept).

    Given one card's measured frame time ``frame_s``, predicts the
    exchange's cost a step and the scaling efficiency: bytes on the wire
    against the interior compute available to hide them under (the gather
    path's interior/boundary split and the fused path's channel groups
    start the exchange before the work that needs no strip).  ``ici_bw``
    defaults to NVLink 4's 450 GB/s each way, a vendor specification, not
    a measurement; pass a measured one (:func:`measure_ici_bw`).  The
    default byte model is the fused path's uint8 input-row exchange; pass
    ``halo_bytes`` from ``ShardedUpscaler.halo_spec`` for the path actually
    run.  Returns ``halo_rows``, ``halo_bytes`` (a direction a shard),
    ``t_halo_s`` (wire time, both directions at once on a ring),
    ``t_shard_s``, ``t_hidden_s``, ``exposed_s`` and ``efficiency``."""
    n, d = cfg.scale_h
    halo = -(-cfg.a * d // n) if n < d else cfg.a
    w = cfg.in_shape[1]
    if halo_bytes is None:
        halo_bytes = halo * w * channels * dtype_bytes
    t_halo = latency_s + halo_bytes / ici_bw
    t_shard = frame_s / rows_n
    if boundary_fraction is None:
        # boundary rows per side ≈ output rows whose tap window leaves
        # the local slab: ceil(a·N/D) at scale N/D
        out_local = cfg.out_shape[0] / rows_n
        boundary_fraction = min(1.0, 2 * -(-cfg.a * n // d) / out_local)
    t_hidden = t_shard * (1.0 - boundary_fraction)
    exposed = max(0.0, t_halo - t_hidden)
    return {
        "halo_rows": halo,
        "halo_bytes": halo_bytes,
        "t_halo_s": t_halo,
        "t_shard_s": t_shard,
        "t_hidden_s": t_hidden,
        "exposed_s": exposed,
        "efficiency": t_shard / (t_shard + exposed),
    }


def dcn_model(
    cfg,
    step_s: float,
    *,
    hosts: int = 2,
    frames_per_step: int = 1,
    channels: int = 3,
    in_bytes: int = 1,
    out_bytes: int = 1,
    dcn_bw: float = NDR_BYTES_S,
    latency_s: float = NETWORK_LATENCY_S,
    remote_fraction: Optional[float] = None,
) -> dict:
    """Analytic cost of the host boundary (input scatter and output gather
    over the network), the reference's DCN model with its formulas and
    names.

    With a central source and sink (one host reads the video, one collects
    it: the default), ``(hosts-1)/hosts`` of every step's input bytes cross
    the network out and the same share of its output bytes back; with
    host-local striped I/O pass ``remote_fraction=0.0`` and the term
    vanishes.  ``step_s`` is one step's compute a host; one step is
    available to hide the wire under: ``exposed = max(0, t_dcn - step_s)``.
    ``dcn_bw`` defaults to one 400 Gb/s InfiniBand NDR port, 50 GB/s, a
    vendor specification, not a measurement."""
    in_b = frames_per_step * cfg.in_shape[0] * cfg.in_shape[1] * channels * in_bytes
    out_b = frames_per_step * cfg.out_shape[0] * cfg.out_shape[1] * channels * out_bytes
    if remote_fraction is None:
        remote_fraction = (hosts - 1) / hosts
    t_dcn = latency_s + remote_fraction * (in_b + out_b) / dcn_bw
    exposed = max(0.0, t_dcn - step_s)
    return {
        "in_bytes": in_b,
        "out_bytes": out_b,
        "remote_fraction": remote_fraction,
        "t_dcn_s": t_dcn,
        "t_hidden_s": step_s,
        "exposed_s": exposed,
        "efficiency": step_s / (step_s + exposed),
    }


def measure_ici_bw(
    mesh: Mesh,
    axis: str = "rows",
    nbytes: int = 8 << 20,
    iters: int = 10,
) -> float:
    """Measured bandwidth a direction (bytes/s) of a ring shift of
    ``nbytes`` a position along ``axis``: the measured number for
    :func:`ici_halo_model`'s ``ici_bw``.

    Needs a ring of at least two distinct devices (a device of another rank
    counts as another): on one device the shift is a self-copy, and the
    number would be device-memory and dispatch noise, not a link
    (``ValueError``; callers keep the specification then).  Each shift is
    timed to its end (every CUDA device of the ring synchronized); the
    median of ``iters`` is returned."""
    mine = mesh.local_positions()
    if not mine or mesh.distinct_on(axis, mine[0]) < 2:
        raise ValueError(
            f"measure_ici_bw needs >= 2 distinct devices on axis {axis!r}: a ring "
            "on one device is a self-copy, not a link"
        )
    blocks = {p: torch.zeros(nbytes, dtype=torch.uint8, device=mesh.device(p)) for p in mine}
    cuda = sorted({str(mesh.device(p)) for p in mine if mesh.device(p).type == "cuda"})

    def shift() -> None:
        _, wait = ring_shift(mesh, blocks, axis)
        wait()
        for d in cuda:
            torch.cuda.synchronize(d)

    shift()  # connect
    times = []
    for _ in range(max(3, iters)):
        t0 = time.perf_counter()
        shift()
        times.append(time.perf_counter() - t0)
    times.sort()
    return nbytes / times[len(times) // 2]
