"""The port's ``utils.sync_print`` on four gloo ranks: one line per rank,
in rank order, printed by the axis's rank 0 only, with and without
arguments, identical to what the JAX package's ``sync_print`` prints over
``make_mesh(4)`` (the cases of its ``tests/test_sync_print.py``)."""

import jax
import jax.numpy as jnp
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from spike_petsc_tpu.parallel import make_mesh
from spike_petsc_tpu.utils.sync_print import sync_print

from torch_dist_worker import case_result, run_ranks


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(4, "torch_dist_cases:sync_print_program",
                     tmp_path_factory.mktemp("sync_print"))


def jax_lines(capfd, fmt, with_value):
    mesh = make_mesh(4, axis="p")
    x = jax.device_put(jnp.arange(4.0) * 10.0, NamedSharding(mesh, P("p")))

    def local(xl):
        if with_value:
            sync_print(fmt, xl[0], axis="p")
        else:
            sync_print(fmt, axis="p")
        return xl

    jax.block_until_ready(jax.shard_map(local, mesh=mesh, in_specs=P("p"),
                                        out_specs=P("p"))(x))
    jax.effects_barrier()
    return capfd.readouterr().out.splitlines()


@pytest.mark.parametrize("case,fmt", [("values", "value = {:.1f}"),
                                      ("no_args", "here")])
def test_sync_print_matches_jax(ranks, capfd, case, fmt):
    out = str(case_result(ranks, case)["out"])
    lines = out.splitlines()
    assert lines == [f"[{r}] " + (fmt.format(r * 10.0) if case == "values"
                                  else fmt) for r in range(4)], out
    for r in range(1, 4):
        assert str(case_result(ranks, case, r)["out"]) == ""
    assert lines == jax_lines(capfd, fmt, case == "values")
