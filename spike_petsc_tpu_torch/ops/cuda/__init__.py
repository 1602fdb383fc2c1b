"""Hand-written CUDA kernels of the port (sources in ``csrc/``), each with
its plain PyTorch version beside it and a launch count."""

from . import (band_matvec, band_matvec_f64, band_matvec_many,
               blocktri_matvec, blocktri_matvec_grid, fused_sweep,
               fused_sweep_many, fused_sweep_many_spd, fused_sweep_spd,
               reduced_thomas, sweeps)

KERNELS = (band_matvec.KERNEL, fused_sweep.KERNEL, fused_sweep_many.KERNEL,
           blocktri_matvec.KERNEL, fused_sweep_spd.KERNEL,
           fused_sweep_many_spd.KERNEL, band_matvec_f64.KERNEL,
           sweeps.KERNEL, blocktri_matvec_grid.KERNEL, reduced_thomas.KERNEL,
           band_matvec_many.KERNEL)
