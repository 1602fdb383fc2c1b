"""Operator-route tuner: measure every matvec route at YOUR shape, record it.

    python -m spike_petsc_tpu_torch.tools.tune -n 1000000 -halfbw 100
    python -m spike_petsc_tpu_torch.tools.tune -n 1000000 -kl 6 -ku 6 -reps 20
    python -m spike_petsc_tpu_torch.tools.tune -n 1000000 -kl 100 -ku 100 \
        -dtype f64

Each run builds a seeded band with a dominant diagonal (uniform(-1, 1)
entries, the diagonal the row's absolute sum + 1) on the card, times the
plain route (``xla``), the banded kernel (``banded_cuda``: #2, or #6 for an
f64 band) and the block-tridiagonal kernel (``blocktri``: #7, where its
gate admits the band) through the library's own dispatch
(``as_matvec(impl=...)``), prints one JSON line, and merges the faster
KERNEL route into the tuning record (``SPIKE_TUNING_FILE``, default
``~/.cache/spike_petsc_tpu_torch/tuning.json``) under ``cuda:<card name>``,
with every route's time beside it.  ``as_matvec("auto")`` does not read
the record (``utils/tuning.py``).  ``-platform cpu`` runs it on the
CPU (the kernels' plain versions; the record lands under ``cpu``).

Timing: ``utils.tuning.measure_matvec_ms``, a chained loop differenced
between two repetition counts, by CUDA events on the card.
"""

from __future__ import annotations

import json
import sys

import torch

_DTYPES = {"f32": torch.float32, "f64": torch.float64, "bf16": torch.bfloat16}
_KERNEL_ROUTES = ("banded_cuda", "banded_cuda_f64", "blocktri")


def tuning_band(n: int, kl: int, ku: int, dtype: torch.dtype, device,
                seed: int = 0):
    """The tuner's band and start vector: uniform(-1, 1) entries drawn from
    a ``torch.Generator`` seeded by ``seed`` (f32, or f64 for an f64 band,
    then cast), the diagonal set to the row's absolute sum + 1; x0
    standard normal from ``seed + 1``."""
    from ..ops.band import BandedMatrix
    draw = torch.float64 if dtype == torch.float64 else torch.float32
    gen = torch.Generator(device=device).manual_seed(seed)
    data = torch.rand((n, kl + ku + 1), generator=gen, device=device,
                      dtype=draw) * 2 - 1
    data[:, kl] = data.abs().sum(dim=1) + 1
    gen.manual_seed(seed + 1)
    x0 = torch.randn(n, generator=gen, device=device, dtype=draw)
    return (BandedMatrix(data=data.to(dtype), kl=kl, ku=ku), x0.to(dtype))


def main(argv=None) -> int:
    from ..solvers.operator import as_matvec, blocktri_feasible
    from ..utils import tuning
    from ..utils.options import Options

    opts = Options.from_argv(sys.argv[1:] if argv is None else argv)
    platform_req = opts.get_string("platform", "cuda")
    if platform_req == "cpu":
        device = torch.device("cpu")
    elif not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the tuner measures the card "
                           "(pass -platform cpu to run on the CPU)")
    else:
        device = torch.device("cuda")
    n = opts.get_int("n", 1_000_000)
    hb = opts.get_int("halfbw", None)
    kl = opts.get_int("kl", hb if hb is not None else 100)
    ku = opts.get_int("ku", hb if hb is not None else 100)
    reps = opts.get_int("reps", 20)
    dt = opts.get_string("dtype", "f32")
    dtype = _DTYPES[dt]
    w = kl + ku + 1
    platform = tuning.platform_key(device)

    band, x0 = tuning_band(n, kl, ku, dtype, device)
    routes = {}
    for impl in ("xla", "banded_cuda", "blocktri"):
        if impl == "blocktri" and not (band.data.is_cuda
                                       and blocktri_feasible(band)):
            continue                      # the route does not take it
        mv, _, _ = as_matvec(band, impl=impl)
        routes[mv._route] = round(tuning.measure_matvec_ms(mv, x0, reps), 4)
    kernels = {k: v for k, v in routes.items() if k in _KERNEL_ROUTES}
    if not kernels:
        print(json.dumps({"error": "no feasible kernel route", "n": n,
                          "w": w}))
        return 1
    winner = min(kernels, key=kernels.get)
    timed = {f"{k}_ms": v for k, v in routes.items()}
    path = tuning.update(platform, "banded_matvec",
                         tuning.matvec_key(w, dtype),
                         {**timed, "winner": winner, "n": n, "dtype": dt})
    print(json.dumps({"platform": platform, "n": n, "w": w, "dtype": dt,
                      **timed, "winner": winner, "tuning_file": path}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
