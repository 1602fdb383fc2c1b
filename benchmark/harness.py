"""One run of one cell: set-up, the measured window, the check, the result.

Everything that belongs to one configuration, traffic mix or metric is a
file found by its name in ``BENCHMARK.json``:

- ``configs/<config>.json`` (the manifest's ``file``): the deployment, its
  sizes (``n``), its dtype, the PC and its options, ``generator``, the
  matrix's maker and what it hands the program, in
  ``problems/<generator>.py``, and ``reference``, the plain arithmetic
  (A X, the float64 answers and the control's) in
  ``reference/<reference>.py``;
- ``traffic/<traffic>.json``: ``entry`` (``one``: ``make_solver``, a vector
  a call; ``many``: ``make_solver_many``, ``columns`` a call), the KSP
  type, its parameters, the pool of seeded right-hand sides sent in turn
  and how many calls the check samples;
- ``workloads/<cell>.json``: the limits of the cell's check;
- ``metrics/<metric>.py``: the reader of each metric, ``read(run)``; a
  reader of the program's spans names them in ``SPANS``, and a traced run
  reduces those names (``trace.py``).

The program, ``spike_petsc_tpu_torch``, gives the system under test, its
counts (``KSPResult.its``, ``.reason``), its spans, and the set-up stages
and events it records (``utils.profiling``) and its PC's ``info``, copied
onto the run; the
benchmark's spans, the clocks, the trace's reduction, the inputs and the
reference are the benchmark's own.
The harness knows no matrix format: the generator makes the matrix, the
reference does its arithmetic, the program is given what the generator
builds from it.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import random
import statistics
import sys
import time
from contextlib import nullcontext
from pathlib import Path

from benchmark import trace as tracing

ROOT = Path(__file__).resolve().parents[1]
# a traced run traces at most this long a window of whole calls: the trace
# of a longer one takes longer to read than a run may last
TRACE_WINDOW_S = 3.0
# modules the process that prints the result may not hold
BANNED = ("jax", "jaxlib", "flax", "spike_petsc_tpu")


class RunError(RuntimeError):
    """A run that cannot give a result."""


@dataclasses.dataclass
class Run:
    """What the readers of ``metrics/`` read.  Times in seconds."""

    cfg: dict
    traffic: dict
    setup_s: float = 0.0
    pc_setup_s: float = 0.0
    window_s: float = 0.0
    call_s: list = dataclasses.field(default_factory=list)
    call_its: list = dataclasses.field(default_factory=list)
    its: list = dataclasses.field(default_factory=list)
    columns: int = 0                # attempted in the window
    columns_ok: int = 0             # converged and not failed by the check
    trace: tracing.TraceSummary | None = None
    # what the program's ``utils.profiling`` recorded while the cell was
    # built: each set-up stage's seconds, and the events it logged; and
    # what the PC reports of itself (``PC.info``)
    stages: dict = dataclasses.field(default_factory=dict)
    events: list = dataclasses.field(default_factory=list)
    pc_info: dict = dataclasses.field(default_factory=dict)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(root: Path, kind: str, name: str):
    """``<root>/benchmark/<kind>/<name>.py`` as a module."""
    path = root / "benchmark" / kind / f"{name}.py"
    if not path.is_file():
        raise RunError(f"no {kind} file {path}")
    spec = importlib.util.spec_from_file_location(
        f"benchmark.{kind}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_spec(root: Path, workload: str) -> dict:
    """The manifest's entries and the files of one cell."""
    manifest = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise RunError(f"unknown workload {workload!r}: {sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in manifest["configs"]}
    cfg = load_json(root / configs[cell["config"]]["file"])

    def metrics(kind):
        return [m for m in manifest[kind]
                if workload in m.get("workloads", [workload])]

    return dict(
        cell=cell, cfg=cfg,
        traffic=load_json(root / "benchmark" / "traffic"
                          / f"{cell['traffic']}.json"),
        limits=load_json(root / "benchmark" / "workloads"
                         / f"{workload}.json")["limits"],
        end_to_end=metrics("end_to_end"), per_layer=metrics("per_layer"))


def import_port():
    """The program, imported from the harness's own checkout and nowhere
    else."""
    import spike_petsc_tpu_torch as port
    where = Path(port.__file__).resolve()
    if ROOT not in where.parents:
        raise RunError(f"spike_petsc_tpu_torch comes from {where}, "
                       f"not from the checkout {ROOT}")
    return port


def banned_modules() -> list:
    """Top-level module names in ``sys.modules`` that the run may not
    load, compared whole (``spike_petsc_tpu_torch`` is not
    ``spike_petsc_tpu``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


def sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def make_matrix(root: Path, cfg: dict, seed: int, device):
    """The configuration's matrix, made from ``seed`` on ``device`` by its
    generator, in the form its reference reads."""
    return load_module(root, "problems", cfg["generator"]).make(
        cfg, seed, device)


def make_pool(root: Path, cfg: dict, traffic: dict, matrix, seed: int,
              device, indices=None):
    """The pool of right-hand sides, ``B = A X`` with X drawn from a
    generator seeded with ``seed + 1`` on ``device``, one block of
    ``columns`` a call (a vector for ``entry`` ``one``), A X in float64
    by the configuration's reference and rounded to its dtype.
    ``indices`` keeps only those blocks (each drawn as in the whole
    pool)."""
    import torch
    matvec = load_module(root, "reference", cfg["reference"]).matvec
    dtype = getattr(torch, cfg["dtype"])
    r = traffic["columns"]
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    pool = {}
    for p in range(traffic["pool"]):
        X = torch.randn((cfg["n"], r), generator=gen, device=device,
                        dtype=dtype)
        if indices is None or p in indices:
            B = matvec(cfg, matrix, X).to(dtype)
            pool[p] = B[:, 0].contiguous() if traffic["entry"] == "one" else B
    return pool


def build(root: Path, port, cfg: dict, traffic: dict, matrix, device,
          trace: bool = False):
    """The program set up for the cell on ``matrix``: (the PC, the
    composed solver, the synchronized ``make_pc`` call's seconds), the
    PC's applies spanned where ``trace``.  The generator's
    ``program_operator`` gives the operator, which is the PC matrix too,
    and where the program places it."""
    A, place = load_module(root, "problems", cfg["generator"]) \
        .program_operator(port, cfg, matrix, device)
    sync(device)
    t0 = time.perf_counter()
    pc = port.make_pc(cfg["pc_type"], A, port.Options(dict(cfg["options"])),
                      **place)
    sync(device)
    pc_setup_s = time.perf_counter() - t0
    return pc, compose(port, cfg, traffic, A, traced_pc(pc, trace),
                       place), pc_setup_s


def traced_pc(pc, enabled: bool):
    """The PC, its applies each inside a ``bench.pc_apply`` span where
    ``enabled``."""
    if not enabled:
        return pc
    from torch.profiler import record_function

    def spanned(fn):
        if fn is None:
            return None

        def apply(r):
            with record_function(tracing.PC_SPAN):
                return fn(r)
        return apply
    return dataclasses.replace(pc, apply=spanned(pc.apply),
                               apply_many=spanned(pc.apply_many))


def compose(port, cfg: dict, traffic: dict, A, pc, place: dict):
    """The cell's entry on the operator ``A``, placed by ``place``,
    composed with the given PC."""
    opts = port.Options(dict(cfg["options"]))
    make = {"one": port.make_solver, "many": port.make_solver_many}
    return make[traffic["entry"]](A, options=opts,
                                  ksp_type=traffic["ksp_type"], pc=pc,
                                  **place, **traffic["params"])


def column_stats(res, r: int):
    """(its of each column, converged flags of each column) of a result."""
    import torch
    if isinstance(res.its, torch.Tensor):
        return ([int(v) for v in res.its.tolist()],
                [bool(v) for v in (res.reason > 0).tolist()])
    return [int(res.its)] * r, [int(res.reason) > 0] * r


def window(solver, pool: dict, seconds: float, device, rng: random.Random,
           sample: int, run: Run, span: bool):
    """The closed loop: one caller, the next call once the last returned
    and the device finished it, the pool's blocks in turn, for
    ``seconds``.  Keeps a uniform sample of ``sample`` calls' answers
    (reservoir, drawn from ``rng``): ``[(pool index, x)]``."""
    from torch.profiler import record_function
    r = run.traffic["columns"]
    kept, unconverged = [], 0
    start = time.perf_counter()
    deadline = start + seconds
    call = 0
    while True:
        p = call % len(pool)
        t0 = time.perf_counter()
        with record_function(tracing.CALL_SPAN) if span else nullcontext():
            res = solver(pool[p])
            sync(device)
        t1 = time.perf_counter()
        its, conv = column_stats(res, r)
        run.call_s.append(t1 - t0)
        run.call_its.append(max(its))
        run.its.extend(its)
        run.columns += r
        unconverged += conv.count(False)
        run.columns_ok += conv.count(True)
        if len(kept) < sample:
            kept.append((p, res.x))
        else:
            j = rng.randrange(call + 1)
            if j < sample:
                kept[j] = (p, res.x)
        call += 1
        if t1 >= deadline:
            break
    run.window_s = time.perf_counter() - start
    return kept, unconverged


def check(root: Path, spec: dict, seed: int, kept: list, device) -> list:
    """The reference's answers for the sampled calls and the gap of the
    program's: ``xerr``, the widest over the sampled columns of
    max|x - x_ref| / max|x_ref|, x_ref solved in float64 by the
    configuration's plain reference from the matrix and right-hand sides
    made anew from the seed.  Returns each sampled call's per-column
    gaps."""
    import torch
    cfg, traffic = spec["cfg"], spec["traffic"]
    matrix = make_matrix(root, cfg, seed, device)
    used = sorted({p for p, _ in kept})
    pool = make_pool(root, cfg, traffic, matrix, seed, device,
                     indices=set(used))
    B = torch.cat([pool[p].reshape(cfg["n"], -1) for p in used], dim=1)
    X = load_module(root, "reference", cfg["reference"]).solve(cfg, matrix,
                                                               B)
    del matrix, pool, B
    r = traffic["columns"]
    ref = {p: X[:, i * r:(i + 1) * r] for i, p in enumerate(used)}
    return [column_gaps(x, ref[p]) for p, x in kept]


def column_gaps(x, ref) -> list:
    """max|x - ref| / max|ref| of each column of ``ref`` ``[n, r]``; a
    column with a NaN reads infinite."""
    import torch
    x = x.reshape(ref.shape).to(torch.float64)
    gap = (x - ref).abs().amax(dim=0) / ref.abs().amax(dim=0)
    return gap.nan_to_num(nan=float("inf")).tolist()


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, device, started: float) -> dict:
    """One run; returns the result line's object."""
    import torch
    spec = cell_spec(root, workload)
    cfg, traffic = spec["cfg"], spec["traffic"]
    port = import_port()
    run = Run(cfg=cfg, traffic=traffic)
    device = torch.device(device)
    on_card = device.type == "cuda"

    records = importlib.import_module(f"{port.__name__}.utils.profiling")
    stages, logged = records.stage_times(), len(records.event_log())

    matrix = make_matrix(root, cfg, seed, device)
    pc, solver, run.pc_setup_s = build(root, port, cfg, traffic, matrix,
                                       device, trace)
    run.stages = {k: v - stages.get(k, 0.0)
                  for k, v in records.stage_times().items()
                  if v != stages.get(k)}
    run.events = records.event_log()[logged:]
    run.pc_info = dict(pc.info)
    pool = make_pool(root, cfg, traffic, matrix, seed, device)
    for p in range(min(2, len(pool))):          # the cell's own shapes
        solver(pool[p])
    sync(device)
    run.setup_s = time.perf_counter() - started

    names = spec["per_layer" if trace else "end_to_end"]
    readers = {m["name"]: load_module(root, "metrics", m["name"])
               for m in names}
    rng = random.Random(seed)
    if trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if on_card:
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            kept, unconverged = window(solver, pool,
                                       min(seconds, TRACE_WINDOW_S), device,
                                       rng, traffic["sample_calls"], run,
                                       span=True)
        run.trace = tracing.summarize(prof, run.window_s, [
            s for r in readers.values() for s in getattr(r, "SPANS", ())])
        del prof
    else:
        kept, unconverged = window(solver, pool, seconds, device, rng,
                                   traffic["sample_calls"], run, span=False)

    dev_info = {"platform": "gpu" if on_card else "cpu",
                "kind": torch.cuda.get_device_name(device) if on_card
                else "cpu",
                "count": 1,
                "memory_peak_bytes": torch.cuda.max_memory_allocated(device)
                if on_card else 0}
    del solver, pc, matrix, pool
    if on_card:
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    gaps = check(root, spec, seed, kept, device)
    print(f"benchmark: set-up {run.setup_s:.3f} s (make_pc "
          f"{run.pc_setup_s:.3f} s), window {run.window_s:.3f} s of "
          f"{len(run.call_s)} calls (median "
          f"{statistics.median(run.call_s) * 1e3:.3f} ms), check "
          f"{time.perf_counter() - t0:.3f} s", file=sys.stderr)
    limit = spec["limits"]["xerr"]
    xerr = max(max(g) for g in gaps)
    over = sum(v > limit for g in gaps for v in g)
    failed = unconverged + over
    run.columns_ok = max(0, run.columns_ok - over)
    checks = {"xerr": {"value": xerr, "limit": limit},
              "unconverged": {"value": unconverged, "limit": 0}}
    correct = xerr <= limit and unconverged == 0

    metrics = {}
    for m in names:
        value = readers[m["name"]].read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if trace:
        dev_info["busy_s"] = run.trace.busy_s
        dev_info["window_s"] = run.trace.window_s
    out = {"correct": correct, "attempted": run.columns, "failed": failed,
           "metrics": metrics, "device": dev_info}
    if trace:
        out["breakdown"] = {"device_ops": run.trace.top_ops,
                            "idle_gaps": run.trace.idle_gaps}
    out["check"] = checks
    return out
