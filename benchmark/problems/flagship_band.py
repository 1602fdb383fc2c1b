"""The flagship's band: dominant and random, made on the device.

Entries uniform(-1, 1) (the slots outside the matrix too), then the
diagonal set to the row's absolute sum plus 1: strict row dominance by a
margin of 1.  One draw of ``n x (kl + ku + 1)`` from a generator seeded
with ``seed`` on ``device``.

The program is given the band as its ``BandedMatrix``
(``_band.program_operator``).
"""

import torch

from benchmark.problems._band import program_operator  # noqa: F401


def make(cfg: dict, seed: int, device) -> torch.Tensor:
    """The band's entries ``data [n, kl + ku + 1]`` (float32)."""
    n, kl, ku = cfg["n"], cfg["kl"], cfg["ku"]
    gen = torch.Generator(device=device).manual_seed(seed)
    data = torch.rand((n, kl + ku + 1), generator=gen, device=device,
                      dtype=torch.float32) * 2 - 1
    data[:, kl] = data.abs().sum(dim=1) + 1
    return data
