"""Ablation harness of the fused kernel on the H100.

    python -m lanczos_torch.tools.ablate_fused 64:full 64:f32full 64:novert ...

The port of ``tools/ablate_mxu.py``: each spec is ``tile:variant``, and a
variant is one stage of the dense fused kernel deleted or restructured in
``csrc/ablate_fused.cu``, so that its time against ``full``'s shows what
that stage costs.  The dense kernel is the design carried over from the
TPU (both passes dense products over per-tile windows); it was the
production kernel until ``csrc/fused_resample.cu`` became band-sparse, and
``full`` / ``f32full`` keep it here, so every run also times the old
design beside the new.  A ``f32`` prefix runs the fp32 weights, no prefix
the bf16 ones.  Stages (:data:`STAGES`):

- ``full``: the dense kernel's stages;
- ``notrunc``: a saturating conversion in place of the store's clamp and
  truncation;
- ``bfmid``: the intermediate held in shared memory as bf16;
- ``manout``: the output tile staged in shared memory, 16-byte stores;
- ``novert``, ``nohoriz``: one pass's products deleted, replaced by a copy
  (intermediate row r is band row r % kv; output column c is intermediate
  column c % kh);
- ``rollband``, ``band3``, ``swpipe``: a block walks consecutive row tiles
  of one column block, and keeps the overlap of consecutive bands, fills a
  3-slot ``cp.async`` ring, or overlaps the horizontal pass of tile s−1
  with the load and vertical pass of tile s.

The frame is the JAX tool's: 12 planes of 2160×3840 → 4320×7680,
Lanczos-3, uniform noise from ``numpy.random.default_rng(0)``.  For each
spec the tool checks the variant's bytes against its own dense plain
version on the first frame (always equal) and against ``fused_call`` on
the same plan.  The production kernel sums each output's taps alone, in
another order than a dense product, so a variant that keeps ``full``'s
semantics agrees with it within the fused kernel's limits (fp32 ≤ 1 LSB on
≤ 1% of pixels, bf16 ≤ 3 LSB on ≤ 50%), not byte for byte; ``bfmid``,
``novert`` and ``nohoriz`` may differ (:data:`DIFFERS`).  Then it times
the production kernel and the variant with CUDA events (order production,
variant, variant, production) and prints ms per 3-plane frame with the
card's name and power limit.  It exits non-zero where a variant that
should match does not, and, before running anything, on a spec it cannot
run: the TPU variants that merged hi/lo products to fill the MXU have no
counterpart (:data:`NO_COUNTERPART`).
"""

from __future__ import annotations

import dataclasses
import functools
import subprocess
import sys
from typing import Optional

import numpy as np
import torch

from lanczos_torch.core.config import Precision, ResampleConfig
from lanczos_torch.ops import _build
from lanczos_torch.ops import resample_cuda as rc

STAGES = ("full", "notrunc", "bfmid", "manout", "novert", "nohoriz",
          "rollband", "band3", "swpipe")
DIFFERS = frozenset({"bfmid", "novert", "nohoriz"})  # the TPU tool's EXPECT_DIFF
VARIANTS = tuple(p + s for p in ("", "f32") for s in STAGES)
_HILO = (
    "deleted a hi/lo bf16 correction product of the TPU's fp32 split; the "
    "port's fp32 kernel is plain SIMT fp32 with no such products (novert "
    "and nohoriz delete whole passes instead)"
)
_MXU = (
    "merged products to fill the MXU's 128x128 shape; the port has no hi/lo "
    "products to merge and no matrix unit to fill"
)
NO_COUNTERPART = {
    "stackh": _MXU, "f32mstack": _MXU, "f32nstack": _MXU,
    "f32novertlo": _HILO, "f32nomidlo": _HILO, "f32nowhlo": _HILO,
}
FRAME_IN, FRAME_OUT, PLANES = (2160, 3840), (4320, 7680), 12
# (max |d|, share of differing pixels) a variant that keeps ``full``'s
# semantics may show against the production kernel
LIMITS = {Precision.FP32: (1, 0.01), Precision.BF16: (3, 0.50)}

# Launches of the ablation kernels by this process, per variant; only
# ablate_call adds to it, where it launches.
launches = {f"ablate_fused_{v}": 0 for v in VARIANTS}


@dataclasses.dataclass(frozen=True)
class Spec:
    tile: int
    precision: Precision
    stage: str

    @property
    def variant(self) -> str:
        return ("f32" if self.precision == Precision.FP32 else "") + self.stage

    def __str__(self) -> str:
        return f"{self.tile}:{self.variant}"


def parse_spec(spec: str) -> Spec:
    """``"64:f32full"`` → ``Spec(64, FP32, "full")``; raises ``ValueError``
    with the reason for a malformed spec, an unknown variant or one with
    no counterpart."""
    tile_s, sep, variant = spec.partition(":")
    if not sep or not tile_s.isdigit() or int(tile_s) < 1:
        raise ValueError(f"{spec!r}: expected tile:variant, e.g. 64:full")
    if variant in NO_COUNTERPART:
        raise ValueError(f"{spec!r} has no counterpart on the H100: it "
                         f"{NO_COUNTERPART[variant]}")
    fp32 = variant.startswith("f32")
    stage = variant[3:] if fp32 else variant
    if stage not in STAGES:
        raise ValueError(f"{spec!r}: unknown variant; known: {', '.join(VARIANTS)}")
    return Spec(int(tile_s), Precision.FP32 if fp32 else Precision.BF16, stage)


def frame_cfg(precision: Precision, in_shape=FRAME_IN, out_shape=FRAME_OUT) -> ResampleConfig:
    return ResampleConfig.from_profile("precise", in_shape, out_shape=out_shape, a=3,
                                       precision=precision)


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=8)
def _dense_tables(plan: rc.FusedPlan, precision: Precision, device: str):
    wv, wh = rc.plan_weights(plan, precision)
    uniq_h = torch.from_numpy(plan.uniq_h.astype(np.int64))
    starts_v = torch.from_numpy(plan.starts_v.astype(np.int64))
    starts_h = torch.from_numpy(plan.starts_h.astype(np.int64))
    tables = (
        torch.from_numpy(wv),
        torch.from_numpy(wh)[uniq_h],
        starts_v[:, None] + torch.arange(plan.kv),
        starts_h[:, None] + torch.arange(plan.kh),
    )
    return tuple(t.to(torch.device(device)) for t in tables)


def ablation_reference(
    x: torch.Tensor, plan: rc.FusedPlan, precision: Precision, stage: str,
    out_shape: tuple,
) -> torch.Tensor:
    """Plain PyTorch version of one ablation variant: (NC, H, W) uint8 →
    (NC, OH, OW) uint8 on ``plan``, both passes dense products over the
    plan's windows as the dense kernel takes them (the stages that keep
    ``full``'s semantics are the dense plain version of the linear fused
    resample).  ``bfmid`` rounds the intermediate to bf16 whatever the
    weights; ``novert`` and ``nohoriz`` replace their pass's product by the
    kernel's copy.  On CUDA the caller must keep TF32 off
    (``torch.backends.cuda.matmul.allow_tf32 = False``)."""
    precision = Precision(precision)
    if stage not in STAGES:
        raise ValueError(f"unknown stage {stage!r}; one of {STAGES}")
    if x.dtype != torch.uint8 or x.dim() != 3:
        raise ValueError(f"expected (NC, H, W) uint8, got {tuple(x.shape)} {x.dtype}")
    nc, h, w = x.shape
    wv, wh, rows, cols = _dense_tables(plan, precision, str(x.device))
    # zero beyond the image, as the kernel's masked band loads
    hp = max(h, int(plan.starts_v.max()) + plan.kv)
    wp = max(w, int(plan.starts_h.max()) + plan.kh)
    xf = torch.zeros((nc, hp, wp), dtype=torch.float32, device=x.device)
    xf[:, :h, :w] = x
    band = xf[:, rows]  # (nc, num_tiles, kv, wp)
    if stage == "novert":
        mid = band[:, :, torch.arange(plan.tile_out, device=x.device) % plan.kv]
    else:
        mid = torch.matmul(wv, band)  # (nc, num_tiles, tile, wp)
    if precision == Precision.BF16 or stage == "bfmid":
        mid = mid.to(torch.bfloat16).to(torch.float32)
    mb = mid[..., cols]  # (nc, num_tiles, tile, n_cb, kh)
    if stage == "nohoriz":
        y = mb[..., torch.arange(plan.cb, device=x.device) % plan.kh]
    else:
        y = torch.einsum("ntrbk,bkc->ntrbc", mb, wh)
    y = y.reshape(nc, plan.num_tiles * plan.tile_out, plan.n_cb * plan.cb)
    y = y[:, : out_shape[0], : out_shape[1]]
    return torch.trunc(torch.clamp(y, 0.0, 255.0)).to(torch.uint8)


# ---------------------------------------------------------------------------
# the kernels' wrapper
# ---------------------------------------------------------------------------


def dense_layout(plan: rc.FusedPlan, precision: Precision) -> dict:
    """Host arrays in the dense kernels' layout: ``wvT (num_tiles, kv,
    tile_p)`` and ``wh (n_uniq, kh, cb_p)`` zero-padded to ``tile_p =
    round_up(tile, 8)`` and ``cb_p = round_up(cb, 4)``, the int32 starts,
    and the integer launch arguments (``kh_p = round_up(kh, 8)``)."""
    tile, cb = plan.tile_out, plan.cb
    tile_p, cb_p, kh_p = rc._round_up(tile, 8), rc._round_up(cb, 4), rc._round_up(plan.kh, 8)
    wv, wh = rc.plan_weights(plan, precision)
    wvT = np.zeros((plan.num_tiles, plan.kv, tile_p), np.float32)
    wvT[:, :, :tile] = np.transpose(wv, (0, 2, 1))
    whp = np.zeros((wh.shape[0], plan.kh, cb_p), np.float32)
    whp[:, :, :cb] = wh
    return dict(
        wvT=wvT, wh=whp,
        starts_v=plan.starts_v.astype(np.int32),
        starts_h=plan.starts_h.astype(np.int32),
        uniq_h=plan.uniq_h.astype(np.int32),
        tile=tile, tile_p=tile_p, kv=plan.kv, cb=cb, cb_p=cb_p, kh=plan.kh,
        kh_p=kh_p, n_cb=plan.n_cb, num_tiles=plan.num_tiles,
    )


@functools.lru_cache(maxsize=4)
def _dense_tensors(plan: rc.FusedPlan, precision: Precision, device: torch.device) -> tuple:
    """The plan's weights in the dense kernels' layout on ``device`` (fp32,
    or bf16 for ``Precision.BF16``) and the integer launch arguments."""
    lay = dense_layout(plan, precision)
    wdt = torch.bfloat16 if precision == Precision.BF16 else torch.float32
    tensors = {k: torch.from_numpy(lay[k]).to(device, wdt) for k in ("wvT", "wh")}
    tensors |= {k: torch.from_numpy(lay[k]).to(device)
                for k in ("starts_v", "starts_h", "uniq_h")}
    return tensors, {k: v for k, v in lay.items() if isinstance(v, int)}


def ablate_call(ops: rc.FusedOps, x: torch.Tensor, stage: str) -> torch.Tensor:
    """(NC, H, W) uint8 → (NC, OH, OW) uint8 through one ablation variant of
    ``ops``'s linear fused plan and weights: a CUDA tensor launches the
    kernel (or raises), a CPU tensor runs :func:`ablation_reference`."""
    if stage not in STAGES:
        raise ValueError(f"unknown stage {stage!r}; one of {STAGES}")
    cfg = ops.cfg
    if ops.variant != "mxu" or ops.tr_ops is not None or cfg.dering or cfg.intermediate_quantize:
        raise ValueError("the ablation kernels take a linear, height-first fused plan")
    (h, w), (oh, ow) = cfg.in_shape, cfg.out_shape
    if x.dtype != torch.uint8 or x.dim() != 3 or tuple(x.shape[1:]) != (h, w):
        raise ValueError(f"expected (NC, {h}, {w}) uint8, got {tuple(x.shape)} {x.dtype}")
    if x.device != ops.device:
        raise ValueError(f"input on {x.device}, weights on {ops.device}")
    if x.device.type == "cpu":
        return ablation_reference(x, ops.plan, cfg.precision, stage, (oh, ow))
    if not x.is_contiguous():
        raise ValueError("the ablation kernels need a contiguous input")
    if stage == "band3" and w % 4:
        raise ValueError(f"band3 copies 4-byte words: the width ({w}) must be a multiple of 4")
    nc = x.shape[0]
    if nc > 65535:
        raise ValueError(f"{nc} planes exceed gridDim.z")
    lib = _build.library()
    out = torch.empty((nc, oh, ow), dtype=torch.uint8, device=x.device)
    t, a = _dense_tensors(ops.plan, cfg.precision, ops.device)
    bf16 = cfg.precision == Precision.BF16
    with torch.cuda.device(x.device):
        code = lib.lanczos_ablate_fused(
            x.data_ptr(), out.data_ptr(), t["wvT"].data_ptr(), t["wh"].data_ptr(),
            t["starts_v"].data_ptr(), t["starts_h"].data_ptr(), t["uniq_h"].data_ptr(),
            nc, h, w, oh, ow, a["tile"], a["tile_p"], a["kv"], a["cb"], a["cb_p"],
            a["kh"], a["kh_p"], a["n_cb"], a["num_tiles"], int(bf16), STAGES.index(stage),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(code)
    launches["ablate_fused_" + ("" if bf16 else "f32") + stage] += 1
    return out


# ---------------------------------------------------------------------------
# the harness
# ---------------------------------------------------------------------------


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def run(specs: list, img: torch.Tensor, out_shape=FRAME_OUT, log=print) -> list:
    """Check and time each spec on ``img`` ((NC, H, W) uint8 on CUDA,
    NC a multiple of 3); one dict per spec: ``ms`` and ``prod_ms`` (the
    variant and the production kernel, ms per 3-plane frame, two runs
    each), ``plain_ms`` (its plain version on one frame), how it compares
    with the production kernel on the first frame (``same``: equal bytes;
    ``max_abs_diff`` and ``differing``, the share of pixels; ``within``:
    inside :data:`LIMITS` for its precision) and with its plain version
    (``plain_same``, ``plain_max_abs_diff``), and ``ok``: equal to its
    plain version and, unless it is one of :data:`DIFFERS`, within the
    limits of the production kernel."""
    from lanczos_torch.utils.timing import cuda_time_ms

    frames = img.shape[0] / 3
    plans, held = {}, {}  # a plan depends on the tile only; weights on the precision too
    results = []
    for spec in specs:
        cfg = frame_cfg(spec.precision, tuple(img.shape[1:]), out_shape)
        if spec.tile not in plans:
            plans[spec.tile] = rc.plan_at(cfg, spec.tile)
        plan = plans[spec.tile]
        if plan is None:
            raise ValueError(f"{spec}: no fused plan fits tile {spec.tile}")
        key = (spec.tile, spec.precision)
        ops = held[key] = held.get(key) or rc.FusedOps(cfg, img.device, plan)
        got = ablate_call(ops, img, spec.stage)
        prod = rc.fused_call(ops, img)
        plain = ablation_reference(img[:3], plan, spec.precision, spec.stage, out_shape)
        torch.cuda.synchronize()
        same = torch.equal(got, prod)
        plain_same = torch.equal(got[:3], plain)
        d = (got[:3].int() - prod[:3].int()).abs()
        d_max, differing = int(d.max()), float((d > 0).float().mean())
        lim, share = LIMITS[spec.precision]
        within = d_max <= lim and differing <= share
        plain_d = int((got[:3].int() - plain.int()).abs().max())
        del got, prod, plain, d
        runs = [
            cuda_time_ms(f) / frames
            for f in (lambda: rc.fused_call(ops, img), lambda: ablate_call(ops, img, spec.stage),
                      lambda: ablate_call(ops, img, spec.stage), lambda: rc.fused_call(ops, img))
        ]
        plain_ms = cuda_time_ms(lambda: ablation_reference(
            img[:3], plan, spec.precision, spec.stage, out_shape), iters=5)
        ok = plain_same and (within or spec.stage in DIFFERS)
        log(f"{spec}: tile_out={plan.tile_out} num_tiles={plan.num_tiles} "
            f"{runs[1]:.4f} / {runs[2]:.4f} ms/frame, production {runs[0]:.4f} / "
            f"{runs[3]:.4f}, plain version {plain_ms:.4f}; against production: max |d| "
            f"{d_max} on {differing:.6f} (limit {lim} on {share}: "
            f"{'within' if within else 'outside'}); equals its "
            f"plain version: {plain_same}{'' if ok else '  MISMATCH'}")
        results.append(dict(
            spec=str(spec), variant=spec.variant, ms=(runs[1] + runs[2]) / 2,
            prod_ms=(runs[0] + runs[3]) / 2, plain_ms=plain_ms, same=same, within=within,
            plain_same=plain_same, max_abs_diff=d_max, differing=differing,
            plain_max_abs_diff=plain_d, ok=ok,
        ))
    return results


def main(argv: Optional[list] = None) -> int:
    args = sys.argv[1:] if argv is None else argv
    try:
        specs = [parse_spec(s) for s in (args or ["64:full"])]
    except ValueError as e:
        print(f"ablate_fused: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("ablate_fused: needs a CUDA device (the kernels have no CPU mode)",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(card(), flush=True)
    rng = np.random.default_rng(0)
    img = torch.from_numpy(rng.integers(0, 256, (PLANES,) + FRAME_IN, np.uint8)).cuda()
    results = run(specs, img, log=lambda s: print(s, flush=True))
    bad = [r["spec"] for r in results if not r["ok"]]
    if bad:
        print(f"ablate_fused: output mismatch: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
