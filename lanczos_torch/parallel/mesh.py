"""The device mesh of the port's row and batch sharding, and the ring halo
exchange on it: the counterparts of ``jax.sharding.Mesh`` as
``lanczos_tpu/parallel`` uses it and of ``halo_permutes`` /
``halo_exchange_rows`` (``lanczos_tpu/parallel/sharded.py:65-102``).

A :class:`Mesh` is a grid of positions with named axes, each position a
``(rank, torch.device)``: the process (``torch.distributed`` rank) that
computes it and the device it runs on.  JAX runs one program over every
position at once (``shard_map``); here each process runs its own positions
one after another, and the exchange moves rows between them:

- between two positions of one process, a device copy (no copy at all
  where both are one device: the strip is a view);
- between processes, ``torch.distributed.batch_isend_irecv``: NCCL for
  CUDA tensors, gloo for CPU tensors.

``Mesh.local(devices, shape)`` is a mesh of one process, and a device may
repeat: ``Mesh.local(["cuda:0"] * 8, (2, 4))`` is the virtual mesh one
H100 runs, as the JAX tests' conftest makes 8 CPU devices.
``Mesh.distributed(shape)`` lays the grid over the ranks of an initialized
process group (``multihost.initialize``), each rank owning
``len(devices)`` consecutive positions, as ``jax.devices()`` orders
devices by process.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch


def choose_mesh_shape(n_devices: int) -> Tuple[int, int]:
    """Factor n into (data, rows): keep a real rows axis whenever possible."""
    for rows in (4, 2):
        if n_devices % rows == 0 and n_devices > rows:
            return n_devices // rows, rows
    if n_devices % 2 == 0:
        return n_devices // 2, 2
    return n_devices, 1


def _device(d) -> torch.device:
    """``d`` as a ``torch.device``, a CUDA device with its index."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """Positions in a grid with named axes: ``ranks`` (int, the grid's
    shape) names the process of each, ``devices`` (object, the same shape)
    the ``torch.device`` of each of this process's positions (None for
    another process's); ``rank`` is this process.  ``shape`` maps each
    axis name to its size, as ``jax.sharding.Mesh.shape`` does."""

    def __init__(self, ranks: np.ndarray, devices: np.ndarray,
                 axis_names: Sequence[str] = ("data", "rows"), rank: int = 0):
        ranks = np.asarray(ranks, np.int64)
        if ranks.shape != devices.shape or ranks.ndim != len(axis_names):
            raise ValueError(f"a {ranks.ndim}-axis grid of ranks {ranks.shape}, devices "
                             f"{devices.shape} and axis names {tuple(axis_names)} disagree")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"axis names {tuple(axis_names)} repeat")
        self.ranks, self.devices = ranks, devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, ranks.shape))
        self.rank = rank

    @classmethod
    def local(cls, devices: Sequence, shape: Sequence[int],
              axis_names: Sequence[str] = ("data", "rows")) -> "Mesh":
        """A mesh of this process alone over ``devices`` (row-major into
        ``shape``); a device may repeat."""
        devs = [_device(d) for d in devices]
        shape = tuple(int(s) for s in shape)
        if len(devs) != math.prod(shape):
            raise ValueError(f"{len(devs)} devices cannot fill a {shape} mesh")
        grid = np.empty(len(devs), object)
        grid[:] = devs
        return cls(np.zeros(shape, np.int64), grid.reshape(shape), axis_names)

    @classmethod
    def distributed(cls, shape: Sequence[int], devices: Optional[Sequence] = None,
                    axis_names: Sequence[str] = ("data", "rows")) -> "Mesh":
        """The grid over the ranks of the initialized default process group:
        rank ``q`` owns positions ``[q·k, (q+1)·k)`` in row-major order and
        runs them on its ``devices`` (``k`` of them; default one, this
        process's current CUDA device under NCCL, else the CPU)."""
        import torch.distributed as dist

        if not dist.is_initialized():
            raise RuntimeError("no process group: call multihost.initialize first")
        world, rank = dist.get_world_size(), dist.get_rank()
        if devices is None:
            devices = ["cuda" if dist.get_backend() == "nccl" else "cpu"]
        devs = [_device(d) for d in devices]
        shape = tuple(int(s) for s in shape)
        total, k = math.prod(shape), len(devs)
        if total != world * k:
            raise ValueError(f"a {shape} mesh holds {total} positions, not {world} ranks "
                             f"x {k} devices")
        ranks = np.arange(total) // k
        grid = np.empty(total, object)
        grid[rank * k : (rank + 1) * k] = devs
        return cls(ranks.reshape(shape), grid.reshape(shape), axis_names, rank)

    def axis(self, name: str) -> int:
        if name not in self.axis_names:
            raise ValueError(f"no axis {name!r} in the mesh's {self.axis_names}")
        return self.axis_names.index(name)

    def positions(self) -> list:
        """Every position, in row-major order (the same on every rank)."""
        return list(np.ndindex(self.ranks.shape))

    def local_positions(self) -> list:
        """This process's positions, in row-major order."""
        return [p for p in self.positions() if self.ranks[p] == self.rank]

    @property
    def is_local(self) -> bool:
        """Whether this process holds every position."""
        return bool((self.ranks == self.rank).all())

    def device(self, pos: tuple) -> torch.device:
        return self.devices[pos]

    def neighbor(self, pos: tuple, axis_name: str, step: int) -> tuple:
        """The position ``step`` along the ring of ``axis_name``."""
        k = self.axis(axis_name)
        pos = list(pos)
        pos[k] = (pos[k] + step) % self.ranks.shape[k]
        return tuple(pos)

    def distinct_on(self, axis_name: str, pos: tuple) -> int:
        """Distinct ``(rank, device)`` pairs on the ring of ``axis_name``
        through ``pos`` (a device of another rank is another device)."""
        ring = [self.neighbor(pos, axis_name, s) for s in range(self.shape[axis_name])]
        return len({(int(self.ranks[p]), str(self.devices[p])) for p in ring})

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank {self.rank} of {int(self.ranks.max()) + 1})"


def _no_wait() -> None:
    pass


def _exchange(mesh: Mesh, blocks: dict, moves: list, shape: tuple,
              dtype: torch.dtype) -> tuple:
    """Carry out ``moves``, ``(key, src, dst, part)`` in an order every rank
    builds alike (``part(block)`` cuts what ``src`` sends), between the
    positions whose blocks this process holds.  Returns ``(received,
    wait)``: ``received[(dst, key)]`` for this process's destinations, each
    of ``shape`` and ``dtype`` on its destination's device, and ``wait()``,
    which returns once what another process sends has arrived; the buffers
    sent stay referenced until then."""
    received, ops, sent = {}, [], []
    for tag, (key, src, dst, part) in enumerate(moves):
        src_here, dst_here = mesh.ranks[src] == mesh.rank, mesh.ranks[dst] == mesh.rank
        if src_here and dst_here:
            received[(dst, key)] = part(blocks[src]).to(mesh.device(dst))
        elif src_here or dst_here:
            import torch.distributed as dist

            if src_here:
                buf = part(blocks[src]).contiguous()
                sent.append(buf)
                ops.append(dist.P2POp(dist.isend, buf, int(mesh.ranks[dst]), tag=tag))
            else:
                buf = torch.empty(shape, dtype=dtype, device=mesh.device(dst))
                received[(dst, key)] = buf
                ops.append(dist.P2POp(dist.irecv, buf, int(mesh.ranks[src]), tag=tag))
    if not ops:
        return received, _no_wait
    import torch.distributed as dist

    works = dist.batch_isend_irecv(ops)

    def wait() -> None:
        for w in works:
            w.wait()
        sent.clear()

    return received, wait


def halo_permutes(mesh: Mesh, blocks: dict, halo: int, axis_name: str = "rows",
                  axis: int = 1) -> tuple:
    """Start the two ring exchanges of ``halo`` rows (along tensor dim
    ``axis``) between the blocks of this process's positions (``blocks[pos]``,
    one shape) and return ``(strips, wait)``: ``strips[pos] = (top, bot)``,
    ``top`` the last ``halo`` rows of the previous position on ``axis_name``
    (my tail goes to the next's top), ``bot`` the first ``halo`` rows of the
    next.  The ring wraps: the first and last positions receive each other's
    rows, which a correct caller never reads.  A strip from another process
    is to be read only after ``wait()``, so work that needs no strip can run
    between.  On an axis of size 1, or with ``halo == 0``, both strips are
    zeros, as in the reference."""
    some = next(iter(blocks.values()), None)
    if some is None:
        return {}, _no_wait
    shape = list(some.shape)
    shape[axis] = halo
    if mesh.shape[axis_name] == 1 or halo == 0:
        return {p: (x.new_zeros(shape),) * 2 for p, x in blocks.items()}, _no_wait
    size = some.shape[axis]

    def tail(x):
        return x.narrow(axis, size - halo, halo)

    def head(x):
        return x.narrow(axis, 0, halo)

    moves = []
    for pos in mesh.positions():
        moves.append(("top", mesh.neighbor(pos, axis_name, -1), pos, tail))
        moves.append(("bot", mesh.neighbor(pos, axis_name, 1), pos, head))
    got, wait = _exchange(mesh, blocks, moves, tuple(shape), some.dtype)
    return {p: (got[(p, "top")], got[(p, "bot")]) for p in blocks}, wait


def halo_exchange_rows(mesh: Mesh, blocks: dict, halo: int, axis_name: str = "rows",
                       axis: int = 1) -> dict:
    """Each local block with ``halo`` rows of its ring neighbours on either
    side along ``axis``: ``{pos: cat([top, block, bot])}``, ``halo + size +
    halo`` rows long.  The wrap-around rows the first and last positions
    receive are garbage by construction and never read (gather indices are
    edge-resolved before they are rebased)."""
    strips, wait = halo_permutes(mesh, blocks, halo, axis_name, axis)
    wait()
    return {p: torch.cat([top, blocks[p], bot], dim=axis) for p, (top, bot) in strips.items()}


def ring_shift(mesh: Mesh, blocks: dict, axis_name: str) -> tuple:
    """Send each local block whole to the next position on ``axis_name``:
    ``(received, wait)`` as :func:`halo_permutes` gives (the measurement
    of :func:`lanczos_torch.parallel.multihost.measure_ici_bw`)."""
    some = next(iter(blocks.values()))
    moves = [("prev", mesh.neighbor(p, axis_name, -1), p, lambda x: x)
             for p in mesh.positions()]
    got, wait = _exchange(mesh, blocks, moves, tuple(some.shape), some.dtype)
    return {p: got[(p, "prev")] for p in blocks}, wait


def gather(mesh: Mesh, blocks: dict, device: Optional[torch.device] = None) -> dict:
    """Every position's block on every rank: ``blocks`` as they are on a
    mesh of one process (moved to ``device`` where given), else one
    ``all_gather`` of each rank's stacked blocks (one shape and count a
    rank), landing on ``device`` (default: this process's first position's
    device)."""
    if mesh.is_local:
        return {p: (b if device is None else b.to(device)) for p, b in blocks.items()}
    import torch.distributed as dist

    mine = mesh.local_positions()
    device = device or mesh.device(mine[0])
    stack = torch.stack([blocks[p].to(device) for p in mine])
    parts = [torch.empty_like(stack) for _ in range(int(mesh.ranks.max()) + 1)]
    dist.all_gather(parts, stack)
    out = {}
    for p in mesh.positions():
        q = int(mesh.ranks[p])
        out[p] = parts[q][[r for r in mesh.positions() if mesh.ranks[r] == q].index(p)]
    return out
