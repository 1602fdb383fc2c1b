"""Rank-ordered collective printing, the PetscSynchronizedPrintf analog (the
port of ``spike_petsc_tpu.utils.sync_print``).

The reference prints per-rank diagnostics in rank order through
``PetscSynchronizedPrintf/Flush``.  Here every rank of a mesh axis calls
``sync_print`` with its own values; they are all-gathered over the axis's
group and printed once, in rank order, by the axis's rank 0::

    sync_print("diag weight = {:.3e}", w_local, axis=mesh.axis("p"))

prints one ``[rank] ...`` line per rank.  Cost: one small ``all_gather``
per argument (of the index, without arguments), the traffic
PetscSynchronizedPrintf pays to ship its strings to rank 0.
"""

from __future__ import annotations

import torch


def sync_print(fmt: str, *args, axis, prefix: str = "[{rank}] ") -> None:
    """Print ``fmt.format(*args)`` for every rank along ``axis`` (a
    ``parallel.mesh.MeshAxis``), in rank order, exactly once.  ``args`` are
    this rank's scalars or tensors of one shape on every rank."""
    def gather(a):
        t = torch.as_tensor(a)
        return axis.all_gather(t.to(axis.device)).cpu().numpy()

    blank = not args
    ops = [gather(axis.rank)] if blank else [gather(a) for a in args]
    if axis.rank != 0:
        return
    for r in range(ops[0].shape[0]):
        vals = () if blank else tuple(a[r] for a in ops)
        print(prefix.format(rank=r) + fmt.format(*vals), flush=True)
