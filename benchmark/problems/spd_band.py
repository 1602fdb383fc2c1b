"""The symmetric dominant band (the matrix of BASELINE config 2), made on
the device.

The upper diagonals uniform(-1, 1), mirrored onto the lower ones so that
``data[i, k + d] == data[i + d, k - d]``; the diagonal the row's absolute
sum plus 1 (symmetric positive definite by strict dominance); slots outside
the matrix zero.  One draw a diagonal from a generator seeded with ``seed``
on ``device``.

The program is given the band as its ``BandedMatrix``
(``_band.program_operator``).
"""

import torch

from benchmark.problems._band import program_operator  # noqa: F401


def make(cfg: dict, seed: int, device) -> torch.Tensor:
    """The band's entries ``data [n, 2k + 1]`` (float32), ``k = kl = ku``."""
    n, k = cfg["n"], cfg["kl"]
    if cfg["ku"] != k:
        raise ValueError("spd_band: kl and ku must be equal")
    gen = torch.Generator(device=device).manual_seed(seed)
    data = torch.zeros((n, 2 * k + 1), device=device, dtype=torch.float32)
    for d in range(1, k + 1):
        v = torch.rand(n - d, generator=gen, device=device) * 2 - 1
        data[:n - d, k + d] = v
        data[d:, k - d] = v
    data[:, k] = data.abs().sum(dim=1) + 1
    return data
