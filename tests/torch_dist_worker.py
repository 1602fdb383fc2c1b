"""Spawned gloo ranks for the distributed parity tests
(tests/test_torch_dist*.py, tests/test_torch_sync_print.py).

``run_ranks(world, "module:function", tmp_path)`` starts ``world`` ranks
with ``torch.multiprocessing`` (spawn, ``join=False``), each initializing
the default group with gloo on a ``file://`` store under ``tmp_path`` (no
port to clash between pytest workers), one torch thread and a 60 s
collective timeout.  Every rank calls ``function(rank, world)``, which
returns ``{case: {key: array}}``; a case that raises on a rank returns its
traceback under the key ``"error"`` instead.  The ranks write their results
to ``tmp_path`` and the caller gets one dict per rank.  The join has a wall
limit: past it the ranks are killed and ``TimeoutError`` raised; a rank that
dies takes the others down, and its traceback is raised here.

Start the ranks once per test file and run every case of the file in them.
A pytest worker never initializes a process group itself.  This module and
the rank programs import torch, numpy and the port only, and every rank
asserts that JAX was not imported.
"""

import importlib
import os
import sys
import time
import traceback
from datetime import timedelta

import numpy as np

WALL_SECONDS = 120


def _rank_main(rank, world, store, outdir, target):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=60))
    try:
        module, fn = target.split(":")
        results = getattr(importlib.import_module(module), fn)(rank, world)
        assert "jax" not in sys.modules, "a rank imported JAX"
        flat = {}
        for case, arrays in results.items():
            for key, value in arrays.items():
                flat[f"{case}/{key}"] = np.asarray(value)
        np.savez(os.path.join(outdir, f"rank{rank}.npz"), **flat)
    finally:
        dist.destroy_process_group()


def run_case(results: dict, case: str, fn, *args) -> None:
    """``results[case] = fn(*args)``, or the traceback when it raises (the
    other cases of the rank program still run)."""
    try:
        results[case] = fn(*args)
    except Exception:                        # noqa: BLE001 - reported by case
        results[case] = {"error": traceback.format_exc()}


def run_ranks(world: int, target: str, tmp_path, wall=WALL_SECONDS) -> list:
    """Run ``target`` ("module:function") on ``world`` gloo ranks; returns
    the ranks' ``{case: {key: array}}`` in rank order."""
    import torch.multiprocessing as mp
    outdir = str(tmp_path)
    store = os.path.join(outdir, "store")
    ctx = mp.start_processes(_rank_main,
                             args=(world, store, outdir, target),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + wall
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{world} ranks of {target} ran past "
                                   f"{wall} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    out = []
    for rank in range(world):
        res = {}
        with np.load(os.path.join(outdir, f"rank{rank}.npz")) as z:
            for name in z.files:
                case, key = name.split("/", 1)
                res.setdefault(case, {})[key] = z[name]
        out.append(res)
    return out


def case_result(ranks: list, case: str, rank: int = 0) -> dict:
    """The results of ``case`` on ``rank``; fails with the rank's
    traceback where the case raised."""
    res = ranks[rank][case]
    if "error" in res:
        raise AssertionError(f"case {case} raised on rank {rank}:\n"
                             f"{res['error']}")
    return res
