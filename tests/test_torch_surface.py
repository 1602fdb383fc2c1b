"""The port's public surface covers the JAX package's: every name in
``spike_petsc_tpu.__all__`` and ``spike_petsc_tpu.parallel.__all__`` is
exported by the port's package of the same place, and none of the port's
parallel names is a stub."""

import inspect

import pytest

import spike_petsc_tpu
import spike_petsc_tpu.parallel
import spike_petsc_tpu_torch
import spike_petsc_tpu_torch.parallel


@pytest.mark.parametrize("jax_mod, torch_mod", [
    (spike_petsc_tpu, spike_petsc_tpu_torch),
    (spike_petsc_tpu.parallel, spike_petsc_tpu_torch.parallel)],
    ids=["top", "parallel"])
def test_surface_covers_the_jax_package(jax_mod, torch_mod):
    missing = set(jax_mod.__all__) - set(torch_mod.__all__)
    assert not missing, sorted(missing)
    for name in torch_mod.__all__:
        obj = getattr(torch_mod, name)
        mod = getattr(obj, "__module__", "") or ""
        assert inspect.ismodule(obj) or mod.startswith(
            "spike_petsc_tpu_torch"), (name, mod)
        assert "not_ported" not in getattr(obj, "__qualname__", ""), name
