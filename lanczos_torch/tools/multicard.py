"""Row and batch sharding across cards, in the two forms a user runs:
``ShardedUpscaler`` on one process's ``Mesh.local`` over N cards, and on a
``Mesh.distributed`` whose rows axis spans N processes, one a card.

    python -m lanczos_torch.tools.multicard --local [--ranks 4] [--cpu] [--shape 2160x3840]
    python -m lanczos_torch.tools.multicard [--ranks 4] [--cpu] [--shape 2160x3840]

``--local``: one process over ``Mesh.local(["cuda:0", ..., "cuda:N-1"], (D, R))``
for every split of the N = ``--ranks`` cards into D·R ((1, 4), (2, 2) and
(4, 1) for four), so every halo between rows shards on different cards is
a copy between them.  Every case of :data:`CASES` and of
:data:`LOCAL_CASES` (the quantized intermediate, uint16 on the float path,
channel groups off, a batch of 4 frames on the data axis) runs on D frames
(4 for the batch); each position's shard must be identical bytes to
``Upscaler(cfg, backend=single, device=<its card>)`` on the same rows, and
the gathered frame to the whole.  Then, on each mesh: the wall time of a
sharded frame (host clock around ten calls between synchronizing every
card, against one card's ``Upscaler`` on the same frames), of the halo
exchange alone, the ring bandwidth (``measure_ici_bw``, 8 and 256 MiB a
hop, where the rows axis spans two cards or more) and 16 frames of video
through ``VideoUpscaler(mesh=)`` (frames/s, the median of 5 calls and
their band), each frame identical to one card's; and one frame sharded by
rows over 1, 2, ... N of the cards.  First come the card-to-card peer
access matrix and the rate of a 256 MiB copy between every pair (events
on the source card): an NVLink pair reads hundreds of GB/s, PCIe or a
copy staged through the host tens.  One JSON line a mesh, a summary, and
a last JSON line with ``ok`` and both matrices.

Without ``--local``, ``--ranks`` processes under ``torch.distributed``
(NCCL between CUDA ranks, gloo between CPU ranks), rank ``r`` on card
``r``: rank ``r`` computes output rows ``[r·OH/R, (r+1)·OH/R)`` of one
frame for :data:`CASES` (the fused kernel in fp32, bf16 and with dering,
the gather and shift paths, ``hls`` and ``c_oracle``); its shard must
equal the same rows of the single-device result on its card, and the
gathered frame the whole.  Then the time of a sharded frame (host clock
around ten frames between barriers, the slowest rank), of the halo
exchange alone, and the ring bandwidth.  Each rank writes ``rank<r>.json``
under ``--out``; the launcher prints them, a summary and the last line.

Both forms exit 1 on any difference or failure, and where the machine has
fewer cards than asked (never repeating a card).  ``--cpu`` runs either
form on the CPU (the kernels' plain versions; positions, or gloo ranks,
on the one CPU): keep ``--shape`` small there.  Input: ``--shape``, seeded
noise, 2x Lanczos-3.
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

from lanczos_torch.utils.timing import sync_cards

CASES = (  # name, profile, overrides, sharded backend, single-device backend
    ("fused fp32", "precise", {"a": 3}, "mxu", "auto"),
    ("fused bf16", "precise", {"a": 3, "precision": "bf16"}, "mxu", "auto"),
    ("fused dering", "precise", {"a": 3, "dering": True}, "mxu", "auto"),
    ("gather (drop edges)", "precise", {"a": 3, "edge_mode": "drop"}, "gather", "xla"),
    ("shift", "precise", {"a": 3}, "gather", "xla"),
    ("hls a=2", "hls", {"a": 2}, "auto", "auto"),
    ("c_oracle a=3", "c_oracle", {"a": 3}, "auto", "auto"),
)
# --local runs CASES and these; the last field: "batch" (frames, else one a data
# position), "uint16" (input), "overlap" (ShardedUpscaler's, default on)
LOCAL_CASES = tuple(c + ({},) for c in CASES) + (
    ("fused quantize", "precise", {"a": 3, "intermediate_quantize": True}, "mxu", "auto", {}),
    ("uint16 (float path)", "precise", {"a": 3}, "auto", "xla", {"uint16": True}),
    ("fused fp32, overlap off", "precise", {"a": 3}, "mxu", "auto", {"overlap": False}),
    ("gather (drop edges), overlap off", "precise", {"a": 3, "edge_mode": "drop"}, "gather",
     "xla", {"overlap": False}),
    ("fused fp32, batch of 4", "precise", {"a": 3}, "mxu", "auto", {"batch": 4}),
)
VIDEO_FRAMES, VIDEO_REPS = 16, 5
COPY_BYTES = 256 << 20  # a copy between two cards, and the ring's longest hop


def splits(n: int) -> list:
    """Every (data, rows) mesh shape of ``n`` positions, rows longest first."""
    return [(n // r, r) for r in range(n, 0, -1) if n % r == 0]


def peer_access(n: int) -> list:
    """``[i][j]``: whether cuda:i reads cuda:j's memory directly (None on the
    diagonal); a copy between cards without it is staged through the host."""
    import torch

    return [[None if i == j else bool(torch.cuda.can_device_access_peer(i, j))
             for j in range(n)] for i in range(n)]


def copy_rates(n: int, nbytes: int = COPY_BYTES, reps: int = 5) -> list:
    """``[i][j]``: GB/s of an ``nbytes`` copy from cuda:i to cuda:j (None on
    the diagonal), timed by events on cuda:i, whose current stream carries
    the copy: an NVLink pair reads hundreds, PCIe or a copy staged through
    the host tens."""
    import torch

    bufs = [torch.empty(nbytes, dtype=torch.uint8, device=f"cuda:{i}") for i in range(n)]
    rates = [[None] * n for _ in range(n)]
    for i in range(n):
        with torch.cuda.device(i):
            for j in range(n):
                if i == j:
                    continue
                bufs[j].copy_(bufs[i])
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                sync_cards()
                start.record()
                for _ in range(reps):
                    bufs[j].copy_(bufs[i])
                end.record()
                sync_cards()
                rates[i][j] = round(nbytes * reps / (start.elapsed_time(end) * 1e-3) / 1e9, 1)
    return rates


def local_main(n: int, shape: tuple, cpu: bool) -> tuple:
    """The one-process form over ``n`` cards (``n`` positions of the CPU
    with ``cpu``): ``(one result a mesh shape, the scaling of one frame)``."""
    import traceback

    import torch

    import lanczos_torch
    from lanczos_torch.ops import resample_cuda as rc
    from lanczos_torch.parallel import multihost
    from lanczos_torch.parallel.mesh import Mesh, halo_permutes

    cards = [torch.device("cpu")] * n if cpu else [torch.device("cuda", i) for i in range(n)]
    first, iters = cards[0], 2 if cpu else 10

    def wall_ms(fn, reps: int = iters, warm: bool = True) -> float:
        """Host ms a call of ``fn``, after one untimed call unless ``warm`` is
        off, every card synchronized before and after (events see one card's
        stream only)."""
        if warm:
            fn()
        sync_cards()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        sync_cards()
        return (time.perf_counter() - t0) * 1e3 / reps

    rng = np.random.default_rng(0)
    host8 = rng.integers(0, 256, (4,) + shape + (3,), dtype=np.uint8)
    host16 = rng.integers(0, 65536, (4,) + shape + (3,), dtype=np.uint16)
    fp32 = lanczos_torch.ResampleConfig.from_profile("precise", shape, scale=(2, 1), a=3)
    one = lanczos_torch.Upscaler(fp32, device=first)
    results = []
    for D, R in splits(n):
        mesh = Mesh.local(cards, (D, R))
        res = {"mesh": [D, R], "devices": [str(mesh.device(p)) for p in mesh.positions()],
               "cases": {}}
        try:
            for name, profile, kw, backend, single, opt in LOCAL_CASES:
                b = opt.get("batch", D)
                img = torch.from_numpy((host16 if opt.get("uint16") else host8)[:b]).to(first)
                cfg = lanczos_torch.ResampleConfig.from_profile(profile, shape, scale=(2, 1),
                                                                **kw)
                sh = lanczos_torch.ShardedUpscaler(cfg, mesh, backend=backend,
                                                   overlap=opt.get("overlap", True))
                before = dict(rc.launches)
                parts = sh.shards(img)
                sync_cards()
                launched = {k: c - before[k] for k, c in rc.launches.items() if c != before[k]}
                # the fused kernel launches once a position (twice with channel
                # groups); its plain version on the CPU counts nothing
                fused = sh.use_mxu and img.dtype == torch.uint8
                expect = len(parts) * (2 if sh.overlap else 1) if fused and not cpu else 0
                ok = sum(launched.values()) == expect
                bl, ol = b // D, sh.out_h_local
                wants = {}
                for (d, r), part in parts.items():
                    dev = mesh.device((d, r))
                    if dev not in wants:  # the single-device result on this card
                        wants[dev] = lanczos_torch.Upscaler(cfg, backend=single,
                                                            device=dev)(img.to(dev))
                    ok = ok and part.device == dev and torch.equal(
                        part, wants[dev][d * bl : (d + 1) * bl, r * ol : (r + 1) * ol])
                ok = ok and torch.equal(sh(img), wants[first])
                res["cases"][name] = dict(ok=bool(ok), launches=launched, fused=fused,
                                          shift=sh.use_shift, halo=sh.halo, batch=b)
                del parts, wants
            x = torch.from_numpy(host8[:D]).to(first)
            sh = lanczos_torch.ShardedUpscaler(fp32, mesh)
            res["frames_a_call"] = D
            res["ms_a_call"] = wall_ms(lambda: sh(x))
            res["shards_ms"] = wall_ms(lambda: sh.shards(x))  # without the gather
            res["one_card_ms"] = wall_ms(lambda: one(x))
            res["halo_bytes"] = sh.halo_spec()["bytes"]
            res["halo_exchange_ms"] = res["ring_bytes_s"] = res["ring_256mib_bytes_s"] = None
            if R >= 2:
                blocks = sh._blocks(x)
                res["halo_exchange_ms"] = wall_ms(
                    lambda: halo_permutes(mesh, blocks, sh.halo)[1](), 20)
                if mesh.distinct_on("rows", (0, 0)) >= 2:  # 8 MiB, and COPY_BYTES, a hop
                    res["ring_bytes_s"], res["ring_256mib_bytes_s"] = (
                        multihost.measure_ici_bw(mesh, "rows", nbytes=nb, iters=10)
                        for nb in (8 << 20, COPY_BYTES))
            video = host8[np.arange(VIDEO_FRAMES) % 4]
            vu = lanczos_torch.VideoUpscaler(fp32, mesh=mesh, batch=D)
            want = [one(torch.from_numpy(f).to(first)).cpu().numpy() for f in host8]
            got = vu(video)
            res["video_ok"] = all(np.array_equal(got[k], want[k % 4])
                                  for k in range(VIDEO_FRAMES))
            fps = sorted(VIDEO_FRAMES / wall_ms(lambda: vu(video), 1, warm=False) * 1e3
                         for _ in range(VIDEO_REPS))
            res["video_frames_s"] = fps[len(fps) // 2]  # the median of VIDEO_REPS
            res["video_frames_s_band"] = [fps[0], fps[-1]]
            del got, want
        except Exception as e:  # recorded; the other meshes still run
            traceback.print_exc()
            res["error"] = f"{type(e).__name__}: {e}"
        results.append(res)
    scaling = {"ok": True, "one_card_ms": None, "ms_by_rows": {}}
    try:  # one frame split by rows over the first R cards
        x1 = torch.from_numpy(host8[:1]).to(first)
        want = one(x1)
        scaling["one_card_ms"] = wall_ms(lambda: one(x1))
        for R in sorted(r for _, r in splits(n)):
            sh = lanczos_torch.ShardedUpscaler(fp32, Mesh.local(cards[:R], (1, R)))
            scaling["ok"] = scaling["ok"] and torch.equal(sh(x1), want)
            scaling["ms_by_rows"][R] = wall_ms(lambda: sh(x1))
    except Exception as e:
        traceback.print_exc()
        scaling.update(ok=False, error=f"{type(e).__name__}: {e}")
    return results, scaling


def _f(v, digits: int = 4) -> str:
    return "-" if v is None else f"{v:.{digits}f}"


def local_report(n: int, cpu: bool, results: list, scaling: dict, links: dict) -> bool:
    """Print each mesh's JSON line, the summary and the last line (with
    ``links``: the peer access and copy rate matrices); whether every case
    held."""
    for res in results:
        print(json.dumps(res), flush=True)
    ok = scaling["ok"] and all(
        "error" not in res and res["video_ok"] and all(c["ok"] for c in res["cases"].values())
        for res in results)
    where = "CPU positions" if cpu else "cards"
    for res in results:
        D, R = res["mesh"]
        for name, c in res["cases"].items():
            print(f"  ({D}, {R}) {name}: " + (
                "every shard identical to the single-device rows on its card" if c["ok"]
                else "DIFFERS from the single-device rows"), flush=True)
        if "error" in res:
            print(f"  ({D}, {R}) FAILED: {res['error']}", flush=True)
            continue
        ring, ring256 = (None if v is None else v / 1e9
                         for v in (res["ring_bytes_s"], res["ring_256mib_bytes_s"]))
        lo, hi = res["video_frames_s_band"]
        print(f"  ({D}, {R}) on {n} {where}: {D} frame(s) sharded {_f(res['ms_a_call'])} ms "
              f"wall ({_f(res['shards_ms'])} without the gather), one card "
              f"{_f(res['one_card_ms'])}; halo exchange alone {_f(res['halo_exchange_ms'])} ms "
              f"({res['halo_bytes']} B a direction a shard); ring {_f(ring, 1)} GB/s a "
              f"direction at 8 MiB a hop, {_f(ring256, 1)} at 256 MiB; video "
              f"{_f(res['video_frames_s'], 1)} frames/s (median of {VIDEO_REPS}, "
              f"{_f(lo, 1)}-{_f(hi, 1)}), "
              f"{'every frame identical to one card' if res['video_ok'] else 'frames DIFFER'}",
              flush=True)
    rows = ", ".join(f"R={r} {_f(ms)}" for r, ms in scaling["ms_by_rows"].items())
    print(f"  one frame by rows over the {where}: {rows} ms wall; one card "
          f"{_f(scaling['one_card_ms'])} ms; "
          f"{'identical' if scaling['ok'] else 'DIFFERS or failed'}", flush=True)
    print(json.dumps({"ok": ok, "form": "local", "cards": n, **links,
                      "one_frame_ms_by_rows": scaling["ms_by_rows"],
                      "one_card_ms": scaling["one_card_ms"]}), flush=True)
    return ok


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
                         timeout_s=120)  # a hung exchange fails in 2 minutes
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
        result["ring_bytes_s"] = (multihost.measure_ici_bw(mesh, nbytes=8 << 20, iters=10)
                                  if world > 1 else None)  # one rank: no ring to measure
    except Exception as e:  # reported by the launcher, which exits non-zero
        result["error"] = f"{type(e).__name__}: {e}"
        raise
    finally:
        (out / f"rank{rank}.json").write_text(json.dumps(result))
        dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=4,
                    help="processes, one a card (with --local: cards of one process)")
    ap.add_argument("--local", action="store_true",
                    help="one process over Mesh.local of the cards, every mesh shape")
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
    links = {}
    if not args.cpu:
        import torch

        if torch.cuda.device_count() < args.ranks:
            print(f"multicard: {args.ranks} {'cards' if args.local else 'ranks'} need "
                  f"{args.ranks} CUDA devices, {torch.cuda.device_count()} found", flush=True)
            return 1
        from lanczos_torch.ops import _build

        _build.library()  # build once, before the ranks load it
        links["peer_access"] = peer_access(args.ranks)
        print(f"# peer access, row i: can cuda:i read cuda:j directly: "
              f"{json.dumps(links['peer_access'])}", flush=True)
        if args.local and args.ranks > 1:
            links["copy_gb_s"] = copy_rates(args.ranks)
            print(f"# a {COPY_BYTES >> 20} MiB copy, row i: cuda:i -> cuda:j, GB/s (events on "
                  f"cuda:i): {json.dumps(links['copy_gb_s'])}", flush=True)
    if args.local:
        return 0 if local_report(args.ranks, args.cpu, *local_main(args.ranks, shape, args.cpu),
                                 links) else 1
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
            codes.append(p.wait(timeout=300))
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
        ring = None if results[0]["ring_bytes_s"] is None else min(
            res["ring_bytes_s"] for res in results) / 1e9
        print(f"  halo exchange alone (3 rows each way): "
              f"{max(res['halo_exchange_ms'] for res in results):.4f} ms; ring bandwidth "
              f"{_f(ring, 1)} GB/s a direction (slowest rank)", flush=True)
    print(json.dumps({"ok": ok, "form": "ranks", "ranks": args.ranks, "exit_codes": codes}),
          flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
