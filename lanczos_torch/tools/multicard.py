"""Row sharding across processes, one rank a device: ``ShardedUpscaler`` on
a ``Mesh.distributed`` whose rows axis spans the ranks, so every halo
between neighbouring shards crosses processes (NCCL between CUDA ranks,
gloo between CPU ranks).

    python -m lanczos_torch.tools.multicard [--ranks 4] [--cpu] [--shape 2160x3840]

Rank ``r`` computes output rows ``[r·OH/R, (r+1)·OH/R)`` of one frame
(``--shape``, seeded noise, 2× Lanczos-3) on its own device, for the fused
kernel (fp32, bf16, dering), the gather and shift paths, ``hls`` and
``c_oracle``; its shard must equal the same rows of the single-device
result on its device, and the gathered frame the whole.  Then, on the
``--ranks`` devices: the time of a sharded frame (host clock around ten
frames between barriers, the slowest rank), of the halo exchange alone,
and the ring bandwidth (``measure_ici_bw``, 8 MiB a hop).  Each rank writes
``rank<r>.json`` under ``--out``; the launcher prints them and a summary,
and exits non-zero if any rank failed.  ``--cpu`` runs gloo ranks on the
CPU (the kernels' plain versions: keep ``--shape`` small there).
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

CASES = (  # name, profile, overrides, sharded backend, single-device backend
    ("fused fp32", "precise", {"a": 3}, "mxu", "auto"),
    ("fused bf16", "precise", {"a": 3, "precision": "bf16"}, "mxu", "auto"),
    ("fused dering", "precise", {"a": 3, "dering": True}, "mxu", "auto"),
    ("gather (drop edges)", "precise", {"a": 3, "edge_mode": "drop"}, "gather", "xla"),
    ("shift", "precise", {"a": 3}, "gather", "xla"),
    ("hls a=2", "hls", {"a": 2}, "auto", "auto"),
    ("c_oracle a=3", "c_oracle", {"a": 3}, "auto", "auto"),
)


def rank_main(rank: int, world: int, port: int, shape: tuple, cpu: bool, out: Path) -> None:
    import torch
    import torch.distributed as dist

    import lanczos_torch
    from lanczos_torch.ops import resample_cuda as rc
    from lanczos_torch.parallel import multihost
    from lanczos_torch.parallel.mesh import Mesh, halo_permutes

    if cpu:
        dev = torch.device("cpu")
    else:
        torch.cuda.set_device(rank)
        dev = torch.device("cuda", rank)
    multihost.initialize(f"127.0.0.1:{port}", world, rank, backend="gloo" if cpu else "nccl",
                         timeout_s=300)
    result = {"rank": rank, "device": str(dev) if cpu else torch.cuda.get_device_name(dev),
              "cases": {}}

    def sync():
        if not cpu:
            torch.cuda.synchronize(dev)
        dist.barrier()

    try:
        mesh = Mesh.distributed((1, world), [dev])
        img = torch.from_numpy(np.random.default_rng(0).integers(
            0, 256, (1,) + shape + (3,), dtype=np.uint8)).to(dev)
        for name, profile, kw, backend, single in CASES:
            cfg = lanczos_torch.ResampleConfig.from_profile(profile, shape, scale=(2, 1), **kw)
            sh = lanczos_torch.ShardedUpscaler(cfg, mesh, backend=backend)
            before = dict(rc.launches)
            (pos, part), = sh.shards(img).items()
            sync()
            launched = {k: n - before[k] for k, n in rc.launches.items() if n != before[k]}
            want = lanczos_torch.Upscaler(cfg, backend=single, device=dev)(img)
            ol = sh.out_h_local
            ok = torch.equal(part, want[:, rank * ol : (rank + 1) * ol])
            ok = ok and torch.equal(sh(img), want)
            sync()
            t0 = time.perf_counter()
            for _ in range(10):
                sh.shards(img)
            sync()
            ms = (time.perf_counter() - t0) * 100
            result["cases"][name] = dict(ok=bool(ok), launches=launched, ms_a_frame=ms,
                                         fused=sh.use_mxu, shift=sh.use_shift, halo=sh.halo)
        # the halo exchange alone: 3 rows of the 4K frame's uint8 input each way
        blocks = {pos: img[:, : shape[0] // world]}
        sync()
        t0 = time.perf_counter()
        for _ in range(20):
            _, wait = halo_permutes(mesh, blocks, 3)
            wait()
        sync()
        result["halo_exchange_ms"] = (time.perf_counter() - t0) * 1e3 / 20
        result["ring_bytes_s"] = multihost.measure_ici_bw(mesh, nbytes=8 << 20, iters=10)
    except Exception as e:  # reported by the launcher, which exits non-zero
        result["error"] = f"{type(e).__name__}: {e}"
        raise
    finally:
        (out / f"rank{rank}.json").write_text(json.dumps(result))
        dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--shape", default="2160x3840")
    ap.add_argument("--out", default=None)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    shape = tuple(int(v) for v in args.shape.split("x"))
    if args.rank is not None:
        rank_main(args.rank, args.ranks, args.port, shape, args.cpu, Path(args.out))
        return 0
    if not args.cpu:
        import torch

        if torch.cuda.device_count() < args.ranks:
            print(f"multicard: {args.ranks} ranks need {args.ranks} CUDA devices, "
                  f"{torch.cuda.device_count()} found", flush=True)
            return 1
        from lanczos_torch.ops import _build

        _build.library()  # build once, before the ranks load it
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out = Path(args.out or tempfile.mkdtemp(prefix="multicard-"))
    out.mkdir(parents=True, exist_ok=True)
    cmd = [sys.executable, "-m", "lanczos_torch.tools.multicard", "--ranks", str(args.ranks),
           "--shape", args.shape, "--out", str(out), "--port", str(port)] + (
        ["--cpu"] if args.cpu else [])
    env = dict(os.environ, OMP_NUM_THREADS="1") if args.cpu else dict(os.environ)
    procs = [subprocess.Popen(cmd + ["--rank", str(r)], env=env) for r in range(args.ranks)]
    codes = []
    try:
        for p in procs:
            codes.append(p.wait(timeout=600))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for r in range(args.ranks):
        f = out / f"rank{r}.json"
        results.append(json.loads(f.read_text()) if f.exists() else {"rank": r, "error": "none"})
    for res in results:
        print(json.dumps(res), flush=True)
    ok = all(c == 0 for c in codes) and all(
        "error" not in res and all(c["ok"] for c in res["cases"].values()) for res in results)
    if ok:
        for name in results[0]["cases"]:
            print(f"  {name}: every shard identical to the single-device rows; a sharded "
                  f"frame {max(res['cases'][name]['ms_a_frame'] for res in results):.3f} ms "
                  f"(slowest rank, wall)", flush=True)
        print(f"  halo exchange alone (3 rows each way): "
              f"{max(res['halo_exchange_ms'] for res in results):.4f} ms; ring bandwidth "
              f"{min(res['ring_bytes_s'] for res in results) / 1e9:.1f} GB/s a direction "
              f"(slowest rank)", flush=True)
    print(json.dumps({"ok": ok, "ranks": args.ranks, "exit_codes": codes}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
