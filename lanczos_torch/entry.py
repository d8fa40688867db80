"""Entry points for compile-and-run checks of the port (the counterpart of
``__graft_entry__.py``).

``entry()`` returns the flagship model (a 4K→8K Lanczos-3 ``precise``
:class:`Upscaler`, the fused kernel) and a zero uint8 4K frame on the card.

``dryrun_multichip(n, devices)`` builds an ``n``-position (data × rows)
:class:`Mesh` over the given devices (a device may repeat) and runs one
step of each sharded path at tiny shapes: the gather and fused paths,
``hls``, ``c_oracle``, video over the mesh, and one tall frame streamed as
rows-sharded chunk groups.  It never falls back to the CPU: the tests pass
CPU devices, ``chip_smoke.py`` ``cuda:0`` eight times.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from lanczos_torch.core.config import Profile, ResampleConfig


def _flagship_cfg(in_shape=(2160, 3840), out_shape=(4320, 7680)):
    return ResampleConfig.from_profile(
        Profile.PRECISE, in_shape, out_shape=out_shape, a=3
    )


def entry(device="cuda"):
    """(model, example_args): the single-card forward on the flagship model
    at the 4K→8K benchmark shape, ``model(*example_args)`` a (4320, 7680, 3)
    uint8 frame on ``device``."""
    from lanczos_torch.models._pipeline import require_device
    from lanczos_torch.models.upscaler import Upscaler

    device = require_device(device)
    model = Upscaler(_flagship_cfg(), backend="auto", device=device)
    img = torch.zeros((2160, 3840, 3), dtype=torch.uint8, device=device)
    return model, (img,)


def _check(name: str, got, want: tuple) -> None:
    if tuple(got) != want:
        raise AssertionError(f"{name}: shape {tuple(got)}, expected {want}")


def dryrun_multichip(n_devices: int, devices: Sequence) -> None:
    """One step of every sharded path over ``devices`` (``n_devices`` of
    them) as a (data × rows) mesh: batch (data parallel) × image rows (halo
    exchange between neighbours)."""
    from lanczos_torch.models.streaming import ShardedStreamingUpscaler
    from lanczos_torch.models.video import VideoUpscaler
    from lanczos_torch.parallel.mesh import Mesh, choose_mesh_shape
    from lanczos_torch.parallel.sharded import ShardedUpscaler

    if len(devices) != n_devices:
        raise ValueError(f"{len(devices)} devices for a mesh of {n_devices}")
    data_n, rows_n = choose_mesh_shape(n_devices)
    mesh = Mesh.local(devices, (data_n, rows_n))

    # tiny shapes: rows per shard must cover the a-row halo comfortably
    in_h = 16 * rows_n
    batch = 2 * data_n
    img = np.random.default_rng(0).integers(
        0, 256, size=(batch, in_h, 32, 3), dtype=np.uint8
    )
    cfg = ResampleConfig.from_profile(Profile.PRECISE, (in_h, 32), scale=(2, 1), a=2)
    oh, ow = cfg.out_shape
    want = (batch, oh, ow, 3)

    # 1) the float gather path (halo exchange + rebased banded gather)
    _check("gather", ShardedUpscaler(cfg, mesh, backend="gather")(img).shape, want)
    # 2) the fused kernel on per-shard vertical tables: the uint8 path
    _check("mxu", ShardedUpscaler(cfg, mesh, backend="mxu")(img).shape, want)
    # 3) the HLS fixed-point stream path (drift-aware halo, int32 MACs)
    cfg_hls = ResampleConfig.from_profile(Profile.HLS, (in_h, 32), scale=(2, 1), a=2)
    _check("hls", ShardedUpscaler(cfg_hls, mesh)(img).shape, want)
    # 4) the c_faithful branch (int64-lattice exact pass + cross-shard
    #    fix-row recomputation)
    cfg_c = ResampleConfig.from_profile(Profile.C_ORACLE, (in_h, 32), scale=(2, 1), a=2)
    _check("c_oracle", ShardedUpscaler(cfg_c, mesh)(img).shape, want)

    # 5) video over the mesh: a short frame stream, the padded tail stack too
    vu = VideoUpscaler(cfg, mesh=mesh, batch=data_n, depth=2)
    n_frames = 2 * data_n + 1
    outs = list(vu.frames(iter(img[i % batch] for i in range(n_frames))))
    if len(outs) != n_frames:
        raise AssertionError(f"video: {len(outs)} frames out of {n_frames}")
    _check("video frame", outs[0].shape, (oh, ow, 3))

    # 6) one tall frame through a rows-only mesh, chunk windows per shard
    rmesh = Mesh.local(devices, (n_devices,), ("rows",))
    tall_h = 8 * n_devices * 2
    cfg_t = ResampleConfig.from_profile(Profile.PRECISE, (tall_h, 32), scale=(2, 1), a=2)
    tall = np.random.default_rng(1).integers(0, 256, size=(tall_h, 32, 3), dtype=np.uint8)
    sm = ShardedStreamingUpscaler(cfg_t, rmesh, chunk_rows=8, chunk_backend="gather")
    _check("sharded stream", sm(tall).shape, (2 * tall_h, 64, 3))
    for d in {torch.device(x) for x in devices}:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


if __name__ == "__main__":
    fn, args = entry()
    print("entry ok:", tuple(fn(*args).shape))
    dryrun_multichip(8, ["cuda:0"] * 8)
    print("dryrun_multichip(8) ok")
