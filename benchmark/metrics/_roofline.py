"""Frozen arithmetic of the rooflines: the card's peaks and the bytes the
preconditioner's apply must move.

The peak: NVIDIA's data sheet for one H100 SXM (80 GB HBM3), at the full
700 W power limit; a card set below it reaches less, and the run reports the
card's power limit beside every share.  The applies of the benchmark's cells
are bound by their bytes: their block products take at most half the bytes'
time even at float32's 67 TFLOP/s outside the tensor cores (the SPD factor,
32 columns: 0.12 ms against 0.27).

The apply's bytes are worked out from the configuration's sizes and stored
dtypes, so they are the same whatever kernel implements the apply: each
input read once and each output written once.  For a SPIKE factor of K
partitions of nb block rows of b x b blocks, tip size k:

- the partition factors, 3 nb - 2 matrices a partition for ``inv``
  (F_1 .. F_{nb-1}, U_0 .. U_{nb-2} and every Sinv_i) and 2 nb - 1 for
  ``spd`` (F_1 .. F_{nb-1} and every Sinv_i), in the stored dtype;
- the stored spikes V and W, K x nb x b x k each, in the spike dtype;
- the reduced system of K - 1 block rows of 2k x 2k in float32: its
  inverted diagonal blocks when truncated, else the 3 (K - 1) - 2 matrices
  of its ``inv`` block-Thomas factor;
- the right-hand sides in and the corrections out, n x columns float32.
"""

from __future__ import annotations

PEAK_BYTES_S = 3.35e12          # HBM3

_SIZES = {"bf16": 2, "f32": 4, "f64": 8}
_METHODS = {"spike": "inv", "cholesky": "spd"}


def spike_geometry(cfg: dict) -> dict:
    """(K, nb, b, k, method, store_spikes, truncated, factor and spike
    bytes) of the configuration's spike-family PC, as the PC builds it:
    K capped so that every partition covers 2k rows, partition rows rounded
    up to a multiple of the block.

    The PC is ``pc_type`` with its options ``pc_<type>_*`` and the band's
    half-width ``max(kl, ku)``, or, where ``pc_type`` is ``banded``, the PC
    on the band it extracts: ``banded_pc_type`` (``spike`` by default),
    with the options ``banded_pc_<type>_*`` and the half-width ``band_k``
    that the extraction keeps."""
    name, prefix = cfg["pc_type"], ""
    opts = cfg["options"]
    if name == "banded":
        name, prefix = opts.get("banded_pc_type", "spike"), "banded_"
        k = max(cfg["band_k"], 1)
    else:
        k = max(cfg["kl"], cfg["ku"], 1)
    key = f"{prefix}pc_{name}_"
    n = cfg["n"]
    K = max(1, min(int(opts.get(key + "partitions", 1)), n // (2 * k)))
    b = int(opts[key + "block"])
    rows = -(-n // K)
    nb = -(-rows // b)
    factor = _SIZES[opts.get(key + "store_dtype") or "f32"]
    return dict(n=n, K=K, nb=nb, b=b, k=k,
                method=opts.get(key + "method", _METHODS[name]),
                store_spikes=bool(int(opts.get(key + "store_spikes", 0))),
                truncated=bool(int(opts.get(key + "truncated", 0))),
                factor_bytes=factor,
                spike_bytes=_SIZES.get(opts.get(key + "spike_dtype"),
                                       factor))


def apply_bytes(g: dict, columns: int) -> int:
    """The bytes one apply to ``columns`` right-hand sides must move."""
    K, nb, b, k = g["K"], g["nb"], g["b"], g["k"]
    mats = {"inv": 3 * nb - 2, "spd": 2 * nb - 1}[g["method"]]
    total = K * mats * b * b * g["factor_bytes"]
    if K > 1:
        if g["store_spikes"]:
            total += 2 * K * nb * b * k * g["spike_bytes"]
        red = K - 1 if g["truncated"] else 3 * (K - 1) - 2
        total += red * (2 * k) ** 2 * 4
    return total + 2 * g["n"] * columns * 4


def least_ms(nbytes: float) -> float:
    """The least time in ms the card could take to move ``nbytes``."""
    return nbytes / PEAK_BYTES_S * 1e3
