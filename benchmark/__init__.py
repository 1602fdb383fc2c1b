"""The benchmark of spike_petsc_tpu_torch on an NVIDIA H100 (see run.py)."""
