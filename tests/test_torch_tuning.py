"""PyTorch port, measured-route tuning records (``utils/tuning.py``) and the
route tuner (``tools/tune.py``), the cases of the JAX package's
tests/test_tuning.py in the port's terms, on the CPU.

The port's platform keys are ``cuda:<card name>`` (``cpu`` off the card),
its winners the port's route names (``banded_cuda``, ``banded_cuda_f64``,
``blocktri``, ``xla``); a record naming JAX's routes is ignored.
``as_matvec('auto')`` follows no record: on a CUDA band that is a card test
(tests/test_torch_cuda.py); here a CPU band keeps its plain route.
"""

import json
import warnings

import numpy as np
import pytest
import torch

from spike_petsc_tpu_torch.convert import banded_from_numpy
from spike_petsc_tpu_torch.solvers.operator import as_matvec
from spike_petsc_tpu_torch.tools import tune
from spike_petsc_tpu_torch.utils import tuning

from torch_parity import CPU, random_band

H100 = "cuda:nvidiah10080gbhbm3"
F32 = torch.float32


@pytest.fixture
def record_file(tmp_path, monkeypatch):
    path = tmp_path / "t.json"
    monkeypatch.setenv("SPIKE_TUNING_FILE", str(path))
    return path


def test_route_hint_nearest_bandwidth(record_file):
    tuning.update(H100, "banded_matvec", tuning.matvec_key(201, F32),
                  {"winner": "blocktri", "xla_ms": 5.2, "blocktri_ms": 0.51,
                   "n": 1_000_000})
    tuning.update(H100, "banded_matvec", tuning.matvec_key(13, F32),
                  {"winner": "banded_cuda", "banded_cuda_ms": 0.03,
                   "n": 1_000_000})
    hint = tuning.matvec_route_hint
    assert hint(H100, 201, F32, 1_000_000) == "blocktri"
    assert hint(H100, 150, F32, 1_000_000) == "blocktri"      # within 2x
    assert hint(H100, 17, F32, 1_000_000) == "banded_cuda"
    assert hint(H100, 50, F32, 1_000_000) is None             # >2x from both
    assert hint("cpu", 201, F32, 1_000_000) is None           # other platform
    # dtype and problem-size gates; numpy dtypes name the same keys
    assert hint(H100, 201, torch.float64, 1_000_000) is None
    assert hint(H100, 201, F32, 300) is None
    assert hint(H100, 201, np.float32, 1_000_000) == "blocktri"
    assert tuning.matvec_key(201, np.float32) == "201:float32"
    assert tuning.matvec_key(13, torch.bfloat16) == "13:bfloat16"


def test_card_keyed_records_never_cross(record_file):
    """A record for one card never applies on another: one RuntimeWarning
    per platform announces the static rule."""
    tuning.update(H100, "banded_matvec", tuning.matvec_key(201, F32),
                  {"winner": "blocktri", "n": 1_000_000})
    assert tuning.matvec_route_hint(H100, 201, F32, 1_000_000) == "blocktri"
    other = "cuda:nvidiah100nvl"
    tuning._warned_platforms.discard(other)
    with pytest.warns(RuntimeWarning, match=other):
        assert tuning.matvec_route_hint(other, 201, F32, 1_000_000) is None
    with warnings.catch_warnings():               # once per platform
        warnings.simplefilter("error")
        assert tuning.matvec_route_hint(other, 201, F32, 1_000_000) is None
        # the CPU stays silent: its absence is no hardware gap
        assert tuning.matvec_route_hint("cpu", 201, F32, 1_000_000) is None


def test_record_with_jax_route_names_is_ignored(record_file):
    """The JAX package's records share the file (``SPIKE_TUNING_FILE``)
    under its own names; the port follows none of them."""
    tuning.update(H100, "banded_matvec", tuning.matvec_key(201, F32),
                  {"winner": "banded_pallas", "n": 1_000_000})
    tuning.update("cpu", "banded_matvec", tuning.matvec_key(7, F32),
                  {"winner": "banded_pallas", "n": 4096})
    assert tuning.matvec_route_hint(H100, 201, F32, 1_000_000) is None
    assert tuning.matvec_route_hint("cpu", 7, F32, 4096) is None
    # a port record at another width still applies beside it
    tuning.update(H100, "banded_matvec", tuning.matvec_key(180, F32),
                  {"winner": "blocktri", "n": 1_000_000})
    assert tuning.matvec_route_hint(H100, 201, F32, 1_000_000) == "blocktri"


def test_update_merges_and_is_atomic(record_file):
    tuning.update(H100, "banded_matvec", "201:float32",
                  {"winner": "blocktri"})
    tuning.update(H100, "banded_matvec", "13:float32", {"winner": "xla"})
    tuning.update("cpu", "banded_matvec", "201:float32", {"winner": "xla"})
    with open(record_file) as f:
        data = json.load(f)
    assert set(data) == {H100, "cpu"}
    assert set(data[H100]["banded_matvec"]) == {"201:float32", "13:float32"}
    # no temporary file is left beside the record
    assert [p.name for p in record_file.parent.iterdir()] == ["t.json"]


def test_platform_key_cpu():
    assert tuning.platform_key() == "cpu"              # no card here
    assert tuning.platform_key(CPU) == "cpu"


def test_cpu_band_keeps_its_plain_route_under_a_record(record_file):
    """A CPU band runs the plain version under 'auto', record or not, and
    it computes the banded route's product."""
    n, k = 4096, 3
    band = banded_from_numpy(random_band(n, k, k, seed=1), k, k, device=CPU)
    tuning.update("cpu", "banded_matvec", tuning.matvec_key(7, band.dtype),
                  {"winner": "blocktri", "n": n})
    mv, _, _ = as_matvec(band, impl="auto")
    assert mv._route == "xla"
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(n))
    mv2, _, _ = as_matvec(band, impl="banded_cuda")
    torch.testing.assert_close(mv(x), mv2(x), rtol=1e-12, atol=1e-12)


def test_measure_matvec_ms_cpu():
    n, k = 2048, 3
    band = banded_from_numpy(random_band(n, k, k, seed=4), k, k, device=CPU)
    mv, _, _ = as_matvec(band, impl="xla")
    ms = tuning.measure_matvec_ms(mv, torch.ones(n, dtype=torch.float64),
                                  reps=4)
    assert ms > 0


def test_tune_main_prints_jax_fields(record_file, capsys):
    """``tools.tune.main`` on the CPU at n = 2000 prints the JAX tool's
    fields, records the faster kernel route under ``cpu`` with the plain
    time beside it, and the record parses back."""
    from spike_petsc_tpu.tools import tune as jtune
    argv = ["-platform", "cpu", "-n", "2000", "-halfbw", "3", "-reps", "2"]
    assert jtune.main(argv) == 0
    jline = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert tune.main(argv) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    def fields(d):
        return {k for k in d if not k.endswith("_ms")}
    assert fields(line) == fields(jline)
    for key in ("platform", "n", "w", "dtype", "tuning_file"):
        assert line[key] == jline[key]
    assert line["platform"] == "cpu" and line["w"] == 7
    # the CPU has no blocktri kernel route: the plain and the banded routes
    assert set(line) - fields(line) == {"xla_ms", "banded_cuda_ms"}
    assert line["winner"] == "banded_cuda"
    with open(record_file) as f:
        entry = json.load(f)["cpu"]["banded_matvec"]["7:float32"]
    assert entry["winner"] == "banded_cuda" and entry["xla_ms"] > 0
    # JAX's own entry under the same key was replaced by the port's
    assert tuning.matvec_route_hint("cpu", 7, F32, 2000) == "banded_cuda"


def test_tuning_band_is_dominant():
    band, x0 = tune.tuning_band(500, 4, 2, torch.float64, CPU)
    d = band.data
    assert d.shape == (500, 7) and x0.shape == (500,)
    assert bool((d[:, 4] > d.abs().sum(dim=1) - d[:, 4]).all())
    assert float(d[:, [0, 1, 2, 3, 5, 6]].abs().max()) <= 1.0
