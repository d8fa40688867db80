"""One run of one cell of the benchmark of ``lanczos_torch``.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``: a configuration
(the file its ``configs`` entry names) under a traffic mix
(``benchmark/traffic/<traffic>.json``).  The traffic file names its driver
(``benchmark/drivers/<driver>.py``), which makes the inputs from the seed,
builds the program's objects, warms them up and runs the measured loop.  A
per-layer metric is a reader of its own (``benchmark/metrics/<name>.py``).
Everything is found by the names in ``BENCHMARK.json``: nothing here names
a cell, a configuration, a traffic mix or a metric.

A run: set-up (``setup_s`` counts from the start of the process); the
measured window of ``--seconds``; with ``--trace 1`` a second window of at
most :data:`TRACE_SECONDS` under ``torch.profiler``; the peak device memory;
the program's objects freed; then a sample of the outputs that the windows
produced, drawn from the seed, compared with the plain float64 reference
that the configuration names (``benchmark/reference/<reference>.py``).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib.util
import json
import math
import random
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path
from typing import Optional

ROOT = Path(__file__).resolve().parent.parent
# the traced window: long enough for thousands of calls or hundreds of
# frames, short enough that the profiler's events stay in memory and are
# read within seconds
TRACE_SECONDS = 3.0
# modules that may not be loaded in the process that prints the result
# (compared by their whole top-level name)
FORBIDDEN = ("jax", "jaxlib", "flax", "lanczos_tpu")
# calls of the program's entry that a window hands in before it may end:
# a call that returns the result of the call before shows only in a second
MIN_CALLS = 2
# what the program's preset must mean for the reference to hold it
SEMANTICS = ("a", "channels", "filter", "edge_mode", "align", "order", "normalize",
             "dering", "intermediate_quantize")


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def read_json(path: Path):
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    spec: dict
    root: Path


def find_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``, with its configuration
    and traffic files read."""
    spec = read_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json; cells: {sorted(cells)}")
    w = cells[name]
    files = {c["name"]: c["file"] for c in spec["configs"]}
    config = read_json(root / files[w["config"]])
    traffic = read_json(root / "benchmark" / "traffic" / f"{w['traffic']}.json")
    return Cell(name, config, traffic, int(w["chips"]), spec, root)


def load(root: Path, kind: str, name: str):
    """``root/benchmark/<kind>/<name>.py`` as a module (a metric's name may
    hold dots, so it is loaded by its path)."""
    path = root / "benchmark" / kind / f"{name}.py"
    mod_name = "benchmark_" + kind + "_" + "".join(c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"no {kind} file {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def control_config(conf: dict) -> dict:
    """The configuration file with its ``control`` settings (the program one
    step below what the file states) in place of its own keys.  Raises
    ``ValueError`` where ``control`` is null (the program has nothing
    lower) or sets a key that the file does not state."""
    over = conf["control"]
    if over is None:
        raise ValueError(f"configuration {conf['name']!r} states no control: the program "
                         f"has nothing below what it states")
    unknown = sorted(set(over) - set(conf))
    if unknown:
        raise ValueError(f"configuration {conf['name']!r}: its control sets {unknown}, "
                         f"keys that the file does not state")
    return {**conf, **over}


def program_config(conf: dict, shape=None):
    """The program's ``ResampleConfig`` for the configuration file;
    ``shape`` ``((H, W), (OH, OW))`` replaces the file's shapes (tests on
    the CPU).  Raises where the program's preset no longer means what the
    file states."""
    from lanczos_torch.core.config import ResampleConfig

    in_shape, out_shape = shape or (conf["in_shape"], conf["out_shape"])
    cfg = ResampleConfig.from_profile(conf["profile"], tuple(in_shape),
                                      out_shape=tuple(out_shape), a=conf["a"],
                                      precision=conf["precision"])
    for key in SEMANTICS:
        got = getattr(cfg, key)
        got = getattr(got, "value", got)
        if got != conf[key]:
            raise ValueError(f"profile {conf['profile']!r} gives {key}={got!r}; the "
                             f"configuration states {conf[key]!r}")
    return cfg


class Sampler:
    """Keeps ``k`` of the units (calls or frames) that the windows produce,
    by reservoir sampling drawn from the seed, and always the last one."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = random.Random(f"sample:{seed}")
        self.seen = 0
        self.kept: list = []
        self.last = None

    def offer(self, key, out) -> None:
        item = (self.seen, key, out)
        if len(self.kept) < self.k:
            self.kept.append(item)
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.k:
                self.kept[j] = item
        self.last = item
        self.seen += 1

    def items(self) -> list:
        out = list(self.kept)
        if self.last is not None and all(i != self.last[0] for i, _, _ in out):
            out.append(self.last)
        return out


@dataclasses.dataclass
class Window:
    """What a driver's window returns: its end-to-end values by metric
    name (none on the CPU), the units handed to the program and those that
    never came back, and the frames done."""

    values: dict
    attempted: int
    missing: int
    frames: int


@dataclasses.dataclass
class Context:
    cell: Cell
    cfg: object  # the program's ResampleConfig
    seed: int
    devices: list  # torch.device, one a chip the cell asks for (the CPU repeated in tests)
    on_card: bool
    traced: bool = False

    @property
    def torch_seed(self) -> int:
        return self.seed % (1 << 63)

    def span(self, name: str):
        """A benchmark span the profiler sees, in a traced window only."""
        if not self.traced:
            return contextlib.nullcontext()
        from benchmark import devtrace

        return devtrace.annotate(name)

    def sync(self) -> None:
        """Wait for every card of the cell (nothing on the CPU)."""
        if self.on_card:
            import torch

            for d in self.devices:
                torch.cuda.synchronize(d)


@dataclasses.dataclass
class MetricInput:
    """What a per-layer reader reads: the traced window's summary (None
    where nothing was traced), the frames done in it, the bound of one
    frame, the cell and the program's config."""

    trace: object
    frames: int
    bound: dict
    cell: Cell
    cfg: object


def listed(spec: dict, cell: str, kind: str) -> list:
    """The metrics of ``kind`` (``end_to_end`` or ``per_layer``) that the
    cell reports."""
    e2e = [m for m in spec["end_to_end"] if cell in m.get("workloads", [cell])]
    if kind == "end_to_end":
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in moved else [])]


def end_to_end(cell: Cell, values: dict, setup_s: float) -> dict:
    """The cell's end-to-end metrics from its driver's ``values``; a metric
    named ``<value>.<tag>`` reports its driver's ``<value>`` under a bound
    of its own."""
    out = {}
    for m in listed(cell.spec, cell.name, "end_to_end"):
        name = m["name"] if m["name"] in values else m["name"].split(".")[0]
        out[m["name"]] = {"value": setup_s if name == "setup_s" else values[name],
                          "unit": m["unit"]}
    return out


def per_layer(cell: Cell, inp: MetricInput) -> dict:
    """The cell's per-layer metrics, each from its reader; a reader that
    finds nothing to read leaves its metric out."""
    out = {}
    for m in listed(cell.spec, cell.name, "per_layer"):
        value = load(cell.root, "metrics", m["name"]).read(inp)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def percentile(values: list, q: float) -> float:
    """The ``q``-th percentile by nearest rank: a value that was observed."""
    s = sorted(values)
    return s[max(0, math.ceil(q / 100 * len(s)) - 1)]


def forbidden_loaded() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def reference(cell: Cell):
    """The plain reference that the cell's configuration names by its
    ``reference`` key: ``benchmark/reference/<reference>.py``, with
    ``check_semantics(conf)``, ``exact(planes, conf, out_shape)`` and
    ``gap_lsb(got, r)``."""
    return load(cell.root, "reference", cell.config["reference"])


def judge(drv, samples: list, ref, conf: dict, out_shape, device, limit: float) -> dict:
    """The widest gap, in output levels, between a sampled output and the
    float64 reference ``ref`` of its input, over every sampled output
    (``inf`` where an output has the wrong shape), and how many sampled
    outputs lie past ``limit``."""
    by_key = defaultdict(list)
    for _, key, out in samples:
        by_key[key].append(out)
    gap, checked, frames, bad = 0.0, 0, 0, 0
    for key in sorted(by_key):
        x = drv.input_planes(key).to(device)
        r = ref.exact(x, conf, out_shape)
        for out in by_key[key]:
            got = drv.output_planes(out)
            checked += 1
            if got is None or tuple(got.shape) != tuple(r.shape):
                gap, bad = math.inf, bad + 1
                continue
            got = got.to(device)
            frames += 1
            one = max(ref.gap_lsb(got[p], r[p]) for p in range(got.shape[0]))
            gap, bad = max(gap, one), bad + int(not one <= limit)
        del r
    return dict(gap_lsb=gap, checked=checked, shaped=frames, bad=bad)


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return "; ".join(sorted(set(out.stdout.strip().splitlines()))) or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def execute(cell: Cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
            shape=None, control: bool = False, t0: Optional[float] = None) -> dict:
    """One run of ``cell``; returns the result line's object.  ``device``
    ``"cpu"`` runs the program's plain versions (tests: nothing is timed,
    no metric is reported); ``control`` runs the program with the
    configuration's ``control`` settings (:func:`control_config`)."""
    t0 = time.perf_counter() if t0 is None else t0
    import torch

    from benchmark import bounds, devtrace

    conf = cell.config
    on_card = device == "cuda"
    devices = ([torch.device("cuda", i) for i in range(cell.chips)] if on_card
               else [torch.device("cpu")] * cell.chips)
    run = dataclasses.replace(cell, config=control_config(conf)) if control else cell
    cfg = program_config(run.config, shape)
    ctx = Context(run, cfg, seed, devices, on_card)
    drv = load(cell.root, "drivers", cell.traffic["driver"]).Driver(ctx)
    drv.setup()
    ctx.sync()
    setup_s = time.perf_counter() - t0

    sampler = Sampler(int(cell.traffic["sample"]), seed)
    win = drv.window(seconds, sampler)
    attempted, missing = win.attempted, win.missing
    summary, traced_frames = None, 0
    if trace:
        ctx.traced = True
        with devtrace.session(on_card) as got:
            tw = drv.window(min(seconds, TRACE_SECONDS), sampler)
        ctx.traced = False
        attempted, missing = attempted + tw.attempted, missing + tw.missing
        traced_frames = tw.frames
        if on_card:
            summary = devtrace.summarize(got[0], [d.index for d in devices])
            del got
            kinds = defaultdict(int)
            for o in summary.ops:
                kinds[o.kind] += 1
            log(f"# traced {summary.window_s} s: {traced_frames} frames, device ops by kind "
                f"{dict(kinds)}, {len(summary.host)} host events")
    peak = max(torch.cuda.max_memory_allocated(d) for d in devices) if on_card else 0
    drv.release()

    (h, w), (oh, ow) = cfg.in_shape, cfg.out_shape
    samples = sampler.items()
    del sampler
    limit = float(conf["limits"]["gap_lsb"])
    verdict = judge(drv, samples, reference(cell), conf, (oh, ow), devices[0], limit)
    del samples
    correct = (verdict["gap_lsb"] <= limit and missing == 0 and verdict["checked"] > 0)

    metrics = {}
    if on_card and not trace:
        metrics = end_to_end(cell, win.values, setup_s)
    elif on_card:
        metrics = per_layer(cell, MetricInput(
            summary, traced_frames, bounds.resample_bound((h, w), (oh, ow), cfg.a, cfg.channels),
            cell, cfg))
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": len(devices), "memory_peak_bytes": peak}
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": missing + verdict["bad"], "metrics": metrics, "device": dev}
    if summary is not None:
        dev.update(busy_s=summary.mean_busy_s(), window_s=summary.window_s)
        result["breakdown"] = summary.breakdown()
    if on_card:
        log(f"# {power_limit()} x{len(devices)}; setup_s {setup_s}")
    for k, v in win.values.items():
        log(f"# {k} {v}")
    log(f"# compared {verdict['checked']} sampled outputs ({verdict['shaped']} of the right "
        f"shape, {verdict['bad']} past the limit) of {attempted} units with the float64 reference")
    result["check"] = {"gap_lsb": {"value": verdict["gap_lsb"], "limit": limit},
                       "missing": {"value": missing, "limit": 0}}
    return result


def main(argv=None, t0: Optional[float] = None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    p = argparse.ArgumentParser(prog="benchmark/run.py", description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = find_cell(args.workload)
    import torch

    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        log(f"{args.workload} needs {cell.chips} CUDA device(s); {have} found")
        return 2
    result = execute(cell, args.seed, args.seconds, bool(args.trace), t0=t0)
    leaked = forbidden_loaded()
    if leaked:
        log(f"loaded in this process, and forbidden: {leaked}")
        return 3
    for name, c in result["check"].items():
        log(f"{name} {c['value']} limit {c['limit']}")
    print(json.dumps(result), flush=True)
    return 0
