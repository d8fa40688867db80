"""Row and batch sharded 2-D resampling on a :class:`~lanczos_torch.parallel.mesh.Mesh`:
the port of ``lanczos_tpu/parallel/sharded.py``'s ``ShardedUpscaler``.

Image **rows** are split over the mesh's ``rows`` axis and frames over its
``data`` axis.  Each shard needs ``halo`` input rows from each ring
neighbour for its slice of the vertical pass (``mesh.halo_permutes``); the
horizontal pass is row-local.  With reduced scale N/D and ``IN_H``
divisible by the rows-axis size R, shard r produces output rows
``[r·OUT_H/R, (r+1)·OUT_H/R)`` from input rows within its slice ± the
halo, and rebases the frame's own tap indices by ``r·IN_H/R − halo``, so
the first and last shards never read the wrap-around rows of the ring.

Every path equals the port's single-device result of the same config
byte for byte, as the reference holds its paths to its single chip:

- gather (``ops/resample_gather.apply_banded``) on the frame's tables,
  with the interior/boundary split that leaves the interior rows free of
  the exchange (``overlap``);
- shift (``ops/resample_strided._axis_shift_pass``) where the phase
  pattern is shard-invariant, the halo doubling as the support pad and the
  first and last shards padding by the edge mode;
- ``hls`` (``ops/fixed_point``) with the halo the schedule's drift needs;
- ``c_oracle`` (``ops/c_exact``) on the uint8 intermediate, its in-place
  fix rows recomputed on their owner shard;
- the fused kernel for uint8 frames: one plan every shard shares
  (horizontal tables, launch shape) and each shard's own vertical tables
  (``upscale_frames(..., wv=)``), cut from the frame's own operator so each
  output row has the single-device kernel's weights, in the same order;
  window offsets of zero weights add exact zeros.  Two channel groups
  give the overlap: the second group's exchange is under way while the
  first group's kernels run.

On a mesh of one process the shards run one after another; on one card
(``Mesh.local(["cuda:0"] * 8, (2, 4))``) a sharded frame is therefore no
faster than the whole-frame kernel.
"""

from __future__ import annotations

import dataclasses
import types

import numpy as np
import torch

from lanczos_torch.core.config import Order, Precision, ResampleConfig
from lanczos_torch.models.upscaler import _shift_eligible
from lanczos_torch.ops import _build
from lanczos_torch.ops.c_exact import CExactOps, _AxisTables, _exact_pass_axis0, _exact_single_row
from lanczos_torch.ops.fixed_point import HLSOps, hls_horizontal_pass, hls_vertical_pass
from lanczos_torch.ops.resample_cuda import (
    _operators,
    _window_lengths,
    build_fused_plan,
    make_fused_ops,
    upscale_frames,
    vertical_tables,
)
from lanczos_torch.ops.resample_gather import (
    SeparableOps,
    apply_banded,
    compute_dtype,
    quantize_uint8,
    store,
)
from lanczos_torch.ops.resample_shift_cuda import _pad_map
from lanczos_torch.ops.resample_strided import StridedOps, _axis_shift_pass
from lanczos_torch.parallel.mesh import (  # noqa: F401  (choose_mesh_shape: the reference's home)
    Mesh,
    choose_mesh_shape,
    gather,
    halo_exchange_rows,
    halo_permutes,
)
from lanczos_torch.utils.tracing import SHARDED_CALL, span

BACKENDS = ("auto", "mxu", "gather")
_TILES = ((64, 128), (32, 64), (16, 32))  # fused_plan's ladder


class ShardedUpscaler:
    """Row + batch sharded 2-D resample over a :class:`Mesh`.

    Input (B, H, W, C), B divisible by the ``data`` axis; output (B, OH, OW,
    C) on the device of this process's first position, every shard's rows
    (on a mesh over several processes, gathered from their owners);
    :meth:`shards` gives this process's shards alone.  ``backend``:
    ``"auto"`` takes the fused kernel for uint8 frames wherever its gates
    pass (on the CPU its plain version), ``"mxu"`` insists on it,
    ``"gather"`` keeps the tensor-op paths."""

    def __init__(
        self,
        cfg: ResampleConfig,
        mesh: Mesh,
        data_axis: str = "data",
        rows_axis: str = "rows",
        dtype=torch.float32,
        backend: str = "auto",
        overlap: bool = True,
    ):
        if not isinstance(mesh, Mesh):
            raise TypeError(f"mesh= takes a lanczos_torch.parallel.mesh.Mesh, got "
                            f"{type(mesh).__name__}")
        if backend not in BACKENDS:
            raise ValueError(f"unknown sharded backend {backend!r}")
        self._backend_req = backend
        self.overlap = overlap
        self.cfg = cfg
        self.mesh = mesh
        self.data_axis, self.rows_axis = data_axis, rows_axis
        self._dk, self._rk = mesh.axis(data_axis), mesh.axis(rows_axis)
        R = mesh.shape[rows_axis]
        in_h, out_h = cfg.in_shape[0], cfg.out_shape[0]
        if in_h % R or out_h % R:
            raise ValueError(
                f"in_h={in_h} and out_h={out_h} must divide rows axis size {R}"
            )
        self.rows_n = R
        self.in_h_local = in_h // R
        self.out_h_local = out_h // R
        n, d = cfg.scale_h
        # halo in input rows; covers upscale (d<=n: a) and downscale bands
        self.halo = -(-(cfg.a * d) // n) if n < d else cfg.a
        self.dtype = torch.bfloat16 if cfg.precision == Precision.BF16 else dtype
        self.compute = compute_dtype(self.dtype)
        self.fixed = cfg.precision == Precision.FIXED
        self.c_exact = cfg.c_faithful and not self.fixed
        self.use_shift = self.use_mxu = False
        self._on: dict = {}  # device -> that device's tables

        if self.c_exact:
            if n < d:
                raise NotImplementedError("sharded c_faithful downscale")
            self.cx = CExactOps(cfg)
            self.halo = cfg.a
            if self.halo > self.in_h_local:
                raise ValueError(
                    f"halo {self.halo} exceeds {self.in_h_local} rows per "
                    "shard; use fewer shards"
                )
            # the oracle's in-place quirk rows read final rows above
            # themselves: every row a fix row touches must be resident on
            # the fix row's owner shard (true unless shards are tiny)
            for y in self.cx.fix_rows:
                owner = y // self.out_h_local
                for i in self.cx.tbl_v.idx[y]:
                    i = int(i)
                    if i > y and i // self.out_h_local != owner:
                        raise ValueError(
                            "c_faithful fix rows cross shard boundaries; "
                            "use fewer shards"
                        )
                    if i <= y and not (
                        0
                        <= i - (owner * self.in_h_local - self.halo)
                        < self.in_h_local + 2 * self.halo
                    ):
                        raise ValueError(
                            "c_faithful fix-row taps exceed the halo; "
                            "use fewer shards"
                        )
        elif self.fixed:
            self.hls = HLSOps.build(cfg)
            # The quantized step predicate makes the stream's gather
            # indices drift from the nominal y·D/N (by ~y·(D/N − q/2^P)),
            # so the float paths' a-row halo is NOT enough: compute the
            # exact halo each shard needs from the schedule itself.
            eff = self.hls.v_eff.numpy()
            need = self.halo
            for rr in range(R):
                rows = eff[rr * self.out_h_local : (rr + 1) * self.out_h_local]
                need = max(
                    need,
                    rr * self.in_h_local - int(rows.min()),
                    int(rows.max()) - ((rr + 1) * self.in_h_local - 1),
                )
            if need > self.in_h_local:
                raise ValueError(
                    f"HLS stream index drift needs a {need}-row halo but "
                    f"shards hold only {self.in_h_local} rows; use fewer "
                    "shards or a larger bit_precision"
                )
            self.halo = int(need)
        else:
            if self.halo > self.in_h_local:
                # Without this, the neighbours' strips would be cut short
                # and the rebased gather indices misalign
                raise ValueError(
                    f"vertical halo of {self.halo} rows exceeds the "
                    f"{self.in_h_local} rows held per shard; use fewer "
                    "shards along the rows axis"
                )
            self.ops = SeparableOps(cfg, self.dtype)
            # the shift formulation applies per shard when the phase
            # pattern is shard-invariant: local output rows a multiple of
            # N, local input rows of D
            self.use_shift = (
                _shift_eligible(cfg)
                and self.out_h_local % n == 0
                and self.in_h_local % d == 0
            )
            if self.use_shift:
                self.shift = StridedOps(cfg, self.dtype)
            self._compute_split_bounds()

        if not self.fixed and not self.c_exact and backend in ("auto", "mxu"):
            self._setup_fused()
        if backend == "mxu" and not self.use_mxu:
            raise NotImplementedError(
                "sharded fused path needs a float config with shard-local "
                "output rows ≡ 0 (mod N), height-first nonlinearities, "
                "and one plan every shard fits in shared memory"
            )

    # ------------------------------------------------------------ set-up

    def _compute_split_bounds(self) -> None:
        """Shard-invariant statics for the interior/boundary split of the
        gather vertical pass:

        - ``b_top``/``b_bot``: max over shards of leading/trailing local
          output rows whose tap window leaves the local row slab (these
          depend on the exchanged halos);
        - ``wtop``/``wbot``: local input rows the boundary windows must
          carry beyond the halo strips.

        Interior rows [b_top, ol − b_bot) gather from the local slab alone
        on EVERY shard, so their compute needs no strip.  Disabled
        (``b_top = −1``) when a boundary set is non-contiguous or the
        interior would be empty."""
        idxg = self.ops.idx_v.numpy()
        ol, il, R = self.out_h_local, self.in_h_local, self.rows_n
        b_top = b_bot = 0
        wtop = wbot = 1
        ok = True
        for rr in range(R):
            lo_r = idxg[rr * ol : (rr + 1) * ol].min(axis=1) - rr * il
            hi_r = idxg[rr * ol : (rr + 1) * ol].max(axis=1) - rr * il
            need_top = lo_r < 0
            need_bot = hi_r >= il
            t, b = int(need_top.sum()), int(need_bot.sum())
            if need_top[t:].any() or (b and need_bot[: ol - b].any()):
                ok = False  # non-contiguous boundary set
                break
            b_top, b_bot = max(b_top, t), max(b_bot, b)
        if ok and b_top + b_bot < ol:
            for rr in range(R):
                hi_r = idxg[rr * ol : (rr + 1) * ol].max(axis=1) - rr * il
                lo_r = idxg[rr * ol : (rr + 1) * ol].min(axis=1) - rr * il
                if b_top:
                    wtop = max(wtop, int(hi_r[:b_top].max()) + 1)
                if b_bot:
                    wbot = max(wbot, il - int(lo_r[ol - b_bot :].min()))
            self.b_top, self.b_bot = b_top, b_bot
            self.wtop, self.wbot = min(wtop, il), min(wbot, il)
        else:
            self.b_top = -1  # overlap structurally unavailable

    def _setup_fused(self) -> None:
        """Build one plan per shard from the shard's slice of the frame's
        own vertical operator, rebased by ``r·il − halo`` (window offset
        ``off_eff = off + 2·N·halo``, the same band formula on every shard),
        all to one band height ``kv`` and one window length ``win_v``, or
        leave ``use_mxu`` False.  Tiles and blocks follow ``fused_plan``'s
        ladder, so the horizontal tables are the single-device plan's."""
        cfg = self.cfg
        n, d = cfg.scale_h
        if self.out_h_local % n:
            return
        if (cfg.dering or cfg.intermediate_quantize) and cfg.order != Order.HEIGHT_FIRST:
            return
        op_v, op_h, _, _, off = _operators(cfg)
        if self.halo < op_v.a:
            return
        R, ol, il, halo = self.rows_n, self.out_h_local, self.in_h_local, self.halo
        syn = dataclasses.replace(
            cfg, in_shape=(il + 2 * halo, cfg.in_shape[1]), out_shape=(ol, cfg.out_shape[1]))
        off_eff = off + 2 * n * halo
        ops_r = [
            types.SimpleNamespace(idx=op_v.idx[r * ol : (r + 1) * ol] - (r * il - halo),
                                  weights=op_v.weights[r * ol : (r + 1) * ol], a=int(op_v.a))
            for r in range(R)
        ]
        for tile, cb in _TILES:
            plans = [build_fused_plan(syn, tile, o, op_h, n, d, off_eff, cb) for o in ops_r]
            if any(p is None for p in plans):
                continue
            kv = max(p.kv for p in plans)
            plans = [build_fused_plan(syn, tile, o, op_h, n, d, off_eff, cb, kv=kv)
                     for o in ops_r]
            if any(p is None for p in plans):
                continue
            win = max(_window_lengths(p)[0] for p in plans)
            plans = [dataclasses.replace(p, win_v=win) for p in plans]
            if all(p.smem_bytes() <= _build.SMEM_LIMIT and _same_horizontal(p, plans[0])
                   for p in plans):
                break
        else:
            return
        self._syn, self._plans = syn, plans
        self.use_mxu = True

    def _tables(self, device: torch.device):
        """This config's tables on ``device`` (made at first use): the ops of
        the path that runs and, for the fused path, the shared kernel ops
        and every shard's vertical tables."""
        t = self._on.get(device)
        if t is not None:
            return t
        t = types.SimpleNamespace()
        if self.c_exact:
            t.cx = CExactOps(self.cfg, device)
        elif self.fixed:
            t.hls = HLSOps.build(self.cfg, device=device)
        else:
            t.ops = SeparableOps(self.cfg, self.dtype, device)
            if self.use_shift:
                t.shift = StridedOps(self.cfg, self.dtype, device)
            if self.use_mxu:
                t.fused = make_fused_ops(self._syn, self._plans[0], device)
                t.wv = [vertical_tables(p, self.cfg.precision, device) for p in self._plans]
        self._on[device] = t
        return t

    # ------------------------------------------------------------ shard passes

    def _r(self, pos: tuple) -> int:
        return pos[self._rk]

    def _exchange_rows(self, blocks: dict) -> dict:
        return halo_exchange_rows(self.mesh, blocks, self.halo, self.rows_axis, axis=1)

    def _run_fused(self, blocks: dict) -> dict:
        """uint8 (b, il, W, C) blocks → (b, ol, OW, C), through the kernel."""

        def one(group: dict, strips: dict, wait) -> dict:
            wait()
            out = {}
            for p, x in group.items():
                top, bot = strips[p]
                ext = torch.cat([top, x, bot], dim=1)
                t = self._tables(ext.device)
                out[p] = upscale_frames(ext, t.fused, wv=t.wv[self._r(p)])
            return out

        def permutes(group: dict) -> tuple:
            return (group,) + halo_permutes(self.mesh, group, self.halo, self.rows_axis, 1)

        channels = next(iter(blocks.values())).shape[-1]
        if not self.overlap or channels < 2:
            return one(*permutes(blocks))
        # the kernel consumes the whole halo-extended block, so the
        # interior/boundary split cannot thread through it; two channel
        # groups give the overlap instead: the second group's exchange is
        # under way while the first group's kernels run
        h = channels // 2
        first = permutes({p: x[..., :h] for p, x in blocks.items()})
        second = permutes({p: x[..., h:] for p, x in blocks.items()})
        a, b = one(*first), one(*second)
        return {p: torch.cat([a[p], b[p]], dim=-1) for p in blocks}

    def _run_fixed(self, blocks: dict) -> dict:
        """HLS-faithful fixed-point path: the stream schedule's global
        gather indices already encode the zero pre-roll and the bottom
        replicate, so the rebase into the halo applies as on the gather
        path, and edge shards never read their wrap-around rows."""
        a, P = self.cfg.a, self.cfg.bit_precision
        ol, il = self.out_h_local, self.in_h_local
        out = {}
        for p, ext in self._exchange_rows(blocks).items():
            r, hls = self._r(p), self._tables(ext.device).hls
            rows = slice(r * ol, (r + 1) * ol)
            local_eff = hls.v_eff[rows] - (r * il - self.halo)
            mid = hls_vertical_pass(ext.to(torch.int32), local_eff, hls.v_w[rows],
                                    hls.v_valid[rows], a, P, axis=1)
            out[p] = hls_horizontal_pass(mid, hls.h_eff, hls.h_w, hls.h_valid, a, P, axis=2)
        return out

    def _run_c_exact(self, blocks: dict) -> dict:
        """Bit-exact c_faithful path: the width pass is row-local, the height
        pass exchanges ``a`` rows of the uint8 intermediate and applies the
        locally rebased exact pass; the oracle's in-place quirk rows are then
        recomputed on their owner shard."""
        ol, il, halo = self.out_h_local, self.in_h_local, self.halo
        mids = {p: _exact_pass_axis0(x.movedim(2, 0), self._tables(x.device).cx.dev_h)
                .movedim(0, 2) for p, x in blocks.items()}
        out = {}
        for p, ext in self._exchange_rows(mids).items():
            r, cx = self._r(p), self._tables(ext.device).cx
            rows = slice(r * ol, (r + 1) * ol)
            tv = cx.dev_v
            tblv = _AxisTables(tv.idx[rows] - (r * il - halo), tv.w50[rows], tv.w70[rows],
                               tv.is_walk[rows], tv.center[rows], tv.center[rows])
            extT = ext.movedim(1, 0)  # (il + 2·halo, B, OW, C)
            F = _exact_pass_axis0(extT, tblv)  # (ol, B, OW, C)
            for y in cx.fix_rows:  # descending
                if y // ol != r:
                    continue
                srcs = [F[int(i) - r * ol] if int(i) > y else extT[int(i) - (r * il - halo)]
                        for i in cx.tbl_v.idx[y]]
                F[y - r * ol] = _exact_single_row(y, srcs, tv)
            out[p] = F.movedim(0, 1)
        return out

    def _edge_pad_rows(self, v: torch.Tensor, s: int, top: bool) -> torch.Tensor:
        """Edge-mode pad rows for the first/last shard's invalid halo: the
        rows the whole frame's pad map gives there."""
        il = v.shape[1]
        m = _pad_map(il, s, self.shift.pad_mode)
        m = m[:s] if top else m[-s:]
        vz = torch.cat([v, v.new_zeros(v[:, :1].shape)], dim=1)  # row il: a zero
        return vz.index_select(1, torch.from_numpy(np.where(m < 0, il, m).astype(np.int64))
                               .to(v.device))

    def _run_float(self, blocks: dict) -> dict:
        """The gather or shift path over float blocks (stored in the storage
        dtype, as ``resample_2d_gather`` stores them)."""
        cfg = self.cfg
        mesh, R, il, ol = self.mesh, self.rows_n, self.in_h_local, self.out_h_local

        def vpass_gather(v: dict) -> dict:
            # the communicating pass (the horizontal pass is row-local).
            # Overlapped: start the exchange, compute the interior rows (no
            # strip needed), then the b_top/b_bot boundary rows from
            # halo+edge windows.  Identical to exchange-then-compute: same
            # taps, same weights, same order, from value-equal buffers.
            def tables(p):
                ops, r = self._tables(v[p].device).ops, self._r(p)
                return ops.idx_v[r * ol : (r + 1) * ol], ops.w_v[r * ol : (r + 1) * ol], r * il

            if not self.overlap or self.b_top < 0:
                out = {}
                for p, ext in self._exchange_rows(v).items():
                    idx, w, base = tables(p)
                    out[p] = apply_banded(ext, idx - (base - self.halo), w, 1, dering=cfg.dering)
                return out
            strips, wait = halo_permutes(mesh, v, self.halo, self.rows_axis, 1)
            bt, bb = self.b_top, self.b_bot
            mids = {}
            for p, x in v.items():
                idx, w, base = tables(p)
                mids[p] = apply_banded(x, idx[bt : ol - bb] - base, w[bt : ol - bb], 1,
                                       dering=cfg.dering)
            wait()
            out = {}
            for p, x in v.items():
                idx, w, base = tables(p)
                top, bot = strips[p]
                parts = []
                if bt:
                    win = torch.cat([top, x[:, : self.wtop]], dim=1)
                    parts.append(apply_banded(win, idx[:bt] - (base - self.halo), w[:bt], 1,
                                              dering=cfg.dering))
                parts.append(mids[p])
                if bb:
                    win = torch.cat([x[:, il - self.wbot :], bot], dim=1)
                    parts.append(apply_banded(win, idx[ol - bb :] - (base + il - self.wbot),
                                              w[ol - bb :], 1, dering=cfg.dering))
                out[p] = torch.cat(parts, dim=1)
            return out

        def vpass_shift(v: dict) -> dict:
            # the halo doubles as the shift pass's support pad; the first
            # and last shards pad by the edge mode instead (their ring halo
            # holds the other end of the image)
            s, out = self.halo, {}
            for p, ext in self._exchange_rows(v).items():
                r, sh, x = self._r(p), self._tables(ext.device).shift, v[p]
                top = self._edge_pad_rows(x, s, True) if r == 0 else ext[:, :s]
                bot = self._edge_pad_rows(x, s, False) if r == R - 1 else ext[:, -s:]
                ext = torch.cat([top, x, bot], dim=1)
                out[p] = _axis_shift_pass(ext, sh.nv, sh.dv, sh.sup_v, sh.tbl_v, 1,
                                          cfg.dering, sh.off_v)
            return out

        def hpass(x: torch.Tensor) -> torch.Tensor:
            t = self._tables(x.device)
            if not self.use_shift:
                return apply_banded(x, t.ops.idx_h, t.ops.w_h, 2, dering=cfg.dering)
            sh = t.shift
            xz = torch.cat([x, x.new_zeros(x[:, :, :1].shape)], dim=2)  # column W: a zero
            return _axis_shift_pass(xz.index_select(2, sh.cols), sh.nh, sh.dh, sh.sup_h,
                                    sh.tbl_h, 2, cfg.dering, sh.off_h)

        vpass = vpass_shift if self.use_shift else vpass_gather

        def maybe_q(v: torch.Tensor) -> torch.Tensor:
            v = quantize_uint8(v, v.dtype) if cfg.intermediate_quantize else v
            return store(v, self.dtype)

        def run(v: dict) -> dict:
            if cfg.order == Order.WIDTH_FIRST:
                return vpass({p: maybe_q(hpass(x)) for p, x in v.items()})
            return {p: hpass(maybe_q(x)) for p, x in vpass(v).items()}

        some = next(iter(blocks.values()))
        was_int = not some.is_floating_point()
        x = {p: store(b.to(self.compute), self.dtype) for p, b in blocks.items()}
        if self.use_shift and self.overlap and some.shape[-1] >= 2:
            # the shift formulation consumes the whole halo-extended block,
            # so the interior/boundary split does not apply; two channel
            # groups instead (channels are independent: identical bytes)
            h = some.shape[-1] // 2
            a = run({p: v[..., :h] for p, v in x.items()})
            b = run({p: v[..., h:] for p, v in x.items()})
            out = {p: torch.cat([a[p], b[p]], dim=-1) for p in x}
        else:
            out = run(x)
        if was_int or cfg.intermediate_quantize:
            return {p: quantize_uint8(v) for p, v in out.items()}
        return {p: v.to(self.dtype) for p, v in out.items()}

    # ------------------------------------------------------------ entry

    def halo_spec(self, channels: int = 3, uint8_input: bool = True) -> dict:
        """Wire bytes per exchange direction for this model's actual
        exchange path (the input of ``multihost.ici_halo_model``): the
        fused path (uint8 frames only: pass ``uint8_input=False`` when
        feeding floats, which take the gather/shift path) and the
        fixed-point path exchange uint8 input rows; the c_exact path the
        uint8 OW-wide intermediate; the float gather/shift paths rows of
        the compute dtype, OW wide when the vertical pass runs second
        (width first)."""
        cfg = self.cfg
        if (self.use_mxu and uint8_input) or self.fixed:
            width, nbytes = cfg.in_shape[1], 1
        elif self.c_exact:
            width, nbytes = cfg.out_shape[1], 1
        else:
            width = (
                cfg.out_shape[1]
                if cfg.order == Order.WIDTH_FIRST
                else cfg.in_shape[1]
            )
            nbytes = torch.empty(0, dtype=self.compute).element_size()
        return {
            "halo_rows": self.halo,
            "bytes": self.halo * width * channels * nbytes,
        }

    def _blocks(self, img) -> dict:
        """This process's input blocks, each on its position's device."""
        if img.ndim != 4 or tuple(img.shape[1:3]) != tuple(self.cfg.in_shape):
            raise ValueError(f"expected (B, {self.cfg.in_shape[0]}, {self.cfg.in_shape[1]}, C), "
                             f"got {tuple(img.shape)}")
        n_data = self.mesh.shape[self.data_axis]
        if img.shape[0] % n_data:
            raise ValueError(f"batch {img.shape[0]} must divide the data axis size {n_data}")
        bl, il = img.shape[0] // n_data, self.in_h_local
        out = {}
        for p in self.mesh.local_positions():
            d, r = p[self._dk], p[self._rk]
            part = img[d * bl : (d + 1) * bl, r * il : (r + 1) * il]
            if not isinstance(part, torch.Tensor):
                part = torch.from_numpy(np.ascontiguousarray(part))
            out[p] = part.to(self.mesh.device(p))
        return out

    def shards(self, img) -> dict:
        """``{position: (B/data, OH/rows, OW, C)}``: the output shards of this
        process's positions, each on its position's device."""
        blocks = self._blocks(img)
        some = next(iter(blocks.values()), None)
        if some is None:
            return {}
        if some.dtype == torch.uint16:
            # the Upscaler dtype contract at 16-bit width: the float path,
            # then the same trunc-clip against 65535
            if self.fixed or self.c_exact:
                raise ValueError(
                    "uint16 input is not defined for the bit-exact uint8 "
                    "semantics profiles (hls/c_oracle); convert explicitly"
                )
            out = self._run_float({p: b.to(torch.float32) for p, b in blocks.items()})
            return {p: torch.trunc(torch.clamp(y.float(), 0.0, 65535.0)).to(torch.uint16)
                    for p, y in out.items()}
        if self.use_mxu and some.dtype == torch.uint8:
            return self._run_fused(blocks)
        if self._backend_req == "mxu":
            raise TypeError(
                f"backend='mxu' processes uint8 frames; got {some.dtype} — "
                "cast the input or use the gather path (backend='auto')"
            )
        if self.c_exact:
            return self._run_c_exact(blocks)
        if self.fixed:
            return self._run_fixed(blocks)
        return self._run_float(blocks)

    def __call__(self, img) -> torch.Tensor:
        """(B, H, W, C) → (B, OH, OW, C): every shard's rows, on the device
        of this process's first position."""
        with span(SHARDED_CALL):
            out = self.shards(img)
            if not out:
                raise ValueError("this process holds no position of the mesh")
            device = self.mesh.device(self.mesh.local_positions()[0])
            every = gather(self.mesh, out, device)
            some = next(iter(every.values()))
            bl, ol = some.shape[0], self.out_h_local
            n_data = self.mesh.shape[self.data_axis]
            y = torch.empty((bl * n_data, ol * self.rows_n) + tuple(some.shape[2:]),
                            dtype=some.dtype, device=device)
            for p, part in every.items():
                d, r = p[self._dk], p[self._rk]
                y[d * bl : (d + 1) * bl, r * ol : (r + 1) * ol] = part
            return y


def _same_horizontal(p, q) -> bool:
    """Whether two plans share their horizontal pass (launch shape and
    tables): each shard's plan must, to run on one shared plan."""
    same = (p.tile_out, p.num_tiles, p.cb, p.kh, p.n_cb) == (q.tile_out, q.num_tiles, q.cb,
                                                             q.kh, q.n_cb)
    arrays = [(p.starts_h, q.starts_h), (p.uniq_h, q.uniq_h), (p.wh, q.wh)]
    if p.center_h is not None or q.center_h is not None:
        arrays.append((p.center_h, q.center_h))
    return same and all(a is not None and b is not None and np.array_equal(a, b)
                        for a, b in arrays)
