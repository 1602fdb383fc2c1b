#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card, end to end.

    python3 chip_smoke.py          # from the repository root

In order, it:
  1. prints the card (nvidia-smi name and power limit, torch's device name);
  2. builds the CUDA kernels from csrc/ (one nvcc per source, in parallel)
     and the host matching engine (g++);
  3. factors the flagship band (n = 1e6, bandwidth 201, K = 64, b = 128,
     stored bf16 spikes, newton_fixed) and holds each kernel against its
     plain PyTorch version on the same inputs: the banded matvec at the
     flagship and a ragged shape; the fused sweep with f32 and bf16 factors
     at the flagship factor shape and at nb = 1, at the cluster size its
     plan picks and at each other (1, 2, 4); the multi-RHS fused sweep
     at the same shapes for r = 32, 1 and 100; the block-tridiagonal matvec
     on the flagship conversion (f32 and bf16 blocks) and a ragged band;
     the f64 banded matvec on the flagship band in f64 and a ragged band
     (and both it and its plain version against an f64 CSR product); the
     two-pass sweeps at the fused sweep's shapes; the grid block-tridiagonal
     matvec (kt = 8) on the flagship conversion and a ragged nb;
  4. checks that the multi-RHS f32 solve carries f32 (against an f64 solve
     of the same factor);
  5. runs each path through the library entry point, with every kernel's
     launch count set to 0 just before and read just after, and checks the
     answer:
       * ``solve(A, b, ksp_type="gmres", pc_type="spike", options=...)``
         (against x = 1, and against the plain CPU path in f64 on a small
         band), and the same with ``-mat_matvec_impl blocktri``;
       * serving, ``solve_many(A, B, ksp_type="bcgs", pc_type="spike", ...)``
         on 32 right-hand sides at rtol 1e-8 and at rtol 1e-4 (the
         half-step exit), and against the plain CPU path in f64;
       * f64-grade refinement, ``solve(A64, b64, ksp_type="richardson",
         pc_type="spike", ...)`` with ``-pc_spike_factor_dtype f32`` at
         rtol 1e-12 on the flagship band in f64 (the launch counts checked
         exactly, the answer against x = 1 with the plain f64 operator),
         the same with bf16-stored factors, and a small band on the card
         against the CPU;
       * ``spike_solve(sf, b, impl="pallas")`` (the two-pass sweeps) and
         ``blocktri_matvec_pallas`` (the grid matvec) on the flagship;
  6. times the factor, the solves, the GMRES and serving solves, the
     operators, the fused sweep (#1) beside the two-pass sweeps (#9) on
     the flagship factor (f32 and bf16, each with its bound and #1's time
     before its redesign), and each kernel beside its plain version and,
     where one
     PyTorch call computes the same function (a sparse product), beside
     that call, with CUDA events (median and spread of the repetitions),
     the serving stage's device busy time (torch.profiler), and the card's
     device-to-device copy rate; the multi-RHS band kernel (#11) at
     n = 1e6, r = 32 and w = 33, 201, 13 and 3 against its plain version
     and #2's column loop (each column bit-equal), timed beside its bound,
     its plain version and the two routes it replaced (the column loop
     and ``blocktri_many``), and the operator's launches a call in the
     batched solves' profiles; the reduced-system kernel on the
     flagship's reduced factor ([63, 200, 200]) at r = 32 and r = 1 against
     the plain loop (within 2e-6 of max|plain|), its device time a launch
     and a call's, the plain loop's call and the bound by ``sweep_bytes``
     of the reduced factor; the refinement solve with the f64 kernel
     against the plain f64 operator, with its device busy time; then the
     transpose-free KSP types on the flagship, the spike PC built once
     (``make_pc``) and passed to each ``solve``: fgmres, lgmres, gcr, cgs,
     tfqmr, bcgsl, chebyshev (``-ksp_chebyshev_esteig``), gmres with a
     right PC and with ``-ksp_monitor_true_residual``, each with its
     reason, an iteration bound, the true f32 relres and launches of #1
     and #2;
  7. frees the flagship and runs BASELINE config 3 through the port's
     testbed CLI, ``spike_petsc_tpu_torch.testbed.main(argv)`` in this
     process: the ill-scaled nonsymmetric band at n = 1e6 (k = 6), MC64
     job 5 scaling and permutation and RCM on the host, the 0.9999 band
     extracted, bcgs at rtol 1e-8 with the ``banded`` PC (its inner spike
     PC at 64 partitions, b = 128) on the card; it checks the printed
     bandwidths (6 after both passes), the operator line, <= 3 iterations,
     the true f32 relative residual (<= 1e-6), the native matching
     engine, and the launches of #2 and #1 exactly (bcgs: 2 its + 1 and
     4 its); the same pipeline at n = 20000 on the card (f32) against the
     CPU (f64); the factor and the solve by CUDA events, the solve's device
     busy time, #1 and #2 against their plain versions on this path's
     inputs and #2 at w = 13 beside its bound and the CSR product; then
     BASELINE config 1 through the testbed CLI: gmres + lu with
     ``-ksp_monitor_true_residual`` on the tridiagonal Laplacian at
     n = 1e5 in f32 (the lu PC's card block 64, one partition of 1563
     block rows: 'auto' runs the two-pass sweeps #9, never #1), the
     launches of #9 and #2 held exactly, the solution against an f64
     host solve, n = 1e4 on the card against the CPU in f32, the factor,
     the solve and #9 at K = 1 beside its plain version and its bound, the
     chunks of its plan (the chunked scan over the card's SMs), its time
     at other chunk counts and at one block (C = 1), #9 beside #1 on the
     n = 1e4 factor that #1 admits, and #2 at config 1's operator beside
     its bound;
  8. frees config 3 and runs the SPD path (BASELINE config 2: a
     symmetric dominant band, n = 1e6, bandwidth 33, f32; the ``cholesky``
     PC with 16 partitions, b = 64, the truncated reduced system and stored
     spikes): the symmetric fused sweep and its multi-RHS form against their
     plain versions (f32 and bf16 factors, nb = 1, r = 32, 1 and 100), the
     multi-RHS f32 carry, ``solve(... ksp_type="cg", pc_type="cholesky")``
     at rtol 1e-8 and ``solve_many`` on 32 right-hand sides through the
     entry points with launch counts (cg: exactly its + 1 launches of the
     spd sweep; cg serving: 2 iterations in every column and exactly 3
     launches of the multi-RHS spd sweep), the card against the CPU in f64
     on a small band, and the timings of that path (each spd sweep's time
     beside its time before its redesign, its microseconds per serial step
     and its cluster shape), the symmetric KSP types (cr, minres, symmlq,
     pipecg) with the cholesky PC built once, launches of #3 and #2, and
     every KSP type on 20 000-row bands, the card in f32 against the CPU in
     f64;
  9. the transpose stack (``phase_transpose_*``): on the flagship the
     spike PC's transpose built from the band and from the L blocks kept
     at factor time (``-pc_spike_store_lt 1``), each setup timed; #1 on
     the regular-form transposed factor against its plain version and
     against the plain transpose sweeps of the marker form, timed beside
     #1 on the forward factor; ``solve(A, b, transpose=True)`` (gmres,
     rtol 1e-8) on the banded and the blocktri operator with its launches
     held exactly, its wall and device time beside the forward solve's;
     bicg, lsqr and cgls with their launches held exactly;
     ``-ksp_compute_singularvalues``; the A^T types and the transposed
     gmres at n = 20000, the card in f32 against the CPU in f64; config 3
     through the testbed CLI with ``-ksp_type bicg`` (#1 and #2 held
     exactly); config 1's system transposed (gmres + lu, #9 at K = 1, 2
     (its + 2) launches, #1 none, against an f64 host solve); config 2's
     cg with ``transpose=True`` (the PC's own spd factor, #3 its + 1
     launches, the forward solve's answer); and, in the config-1 phase,
     one ``copy_`` of the bytes #2 moves there, the card's floor for them;
 10. the rest of the factor surface (``phase_zerodiag``,
     ``phase_cr_flagship``, ``phase_methods_flagship``, ``phase_grouped``,
     ``phase_factor_surface_reference``): the reference's zero-diagonal
     matrix at n = 1e6 through the testbed, gmres with the spike PC
     (K = 64, b = 64: #1) and the lu PC (b = 64: #9 at nb = 15625), each
     with ``-pc_factor_shift_type nonzero`` (raised pivots counted) and
     without, launches held exactly; the flagship at K = 512, whose 511
     reduced block rows 'auto' factors by cyclic reduction (#1 at nb = 16
     against its plain version, timed beside its bound; ``spike_solve``
     with the CR reduced system against the Thomas one, wall, device time
     and launches); the flagship's spike PC with ``-pc_spike_method lu``
     and ``cr`` (the plain sweeps: #1 launched 0 times) and
     ``-pc_spike_inverter newton_pan``; ``spike_factor_grouped`` (8 groups)
     against ``spike_factor``, with each one's peak device memory; and
     small cases on the card in f64 against the CPU;
 11. the remaining PCs (``phase_pcs_*``), each through ``solve`` with the
     PC built once, its launches held exactly where the path fixes them
     (one apply's kernels times the Krylov method's PC applies, one #2 an
     operator apply), its set-up and apply timed by CUDA events and one
     apply's device busy time, CUDA launches and idle share from
     torch.profiler: on the flagship asm (16 windows of 490 block rows:
     #9) restrict and basic, composite jacobi + bjacobi additive and
     multiplicative, fgmres with ``-pc_type ksp`` (inner gmres + spike:
     #1, #2); config 1 through the testbed with cg + mg (11 levels, 20 #2
     and one #1 a V-cycle, the coarse factor at block 64 against #1's
     plain version); on config 2 SOR at block 64 (cg with the symmetric
     sweep, gmres with the forward one, ``-pc_sor_its 2`` with #7; #9 at
     K = 1, nb = 15625 and #7 on those blocks against their plain
     versions) and at its default block 16 (n = 2e4: the plain sweep);
     config 2 through ``testbed2.main`` with the reference's Schur
     fieldsplit recipe (lu on both fields: #9 at nb = 7813; the set-up's
     parts timed); and each PC at n = 2e4, the card in f32 against the
     CPU in f64;
 12. complex scalars, ``ops/autodiff.py``, ``gmres_many``'s options and
     the factor checks (``phase_gmres_many_options``, ``phase_autodiff``,
     ``phase_checks`` on the flagship, ``phase_complex`` after it):
     ``make_solver_many(ksp_type="gmres")`` at r = 32 with the spike PC on
     the left and on the right (#4) under each CGS refinement, the
     operator #11 under ``-mat_matvec_impl banded_cuda`` (#2 not
     launched), every column converged, timed per
     right-hand side; ``solve_banded_diff`` on the flagship (K = 64: #1)
     and config 1's band (K = 1: #9), each pass's launches held to
     AUTODIFF_LAUNCHES, the adjoint residual, the gradients against those
     of the plain sweeps on the same factors, forward and backward timed
     with their device time, and n = 2e4 against the CPU in f64;
     ``-pc_spike_check 1`` (health OK on the flagship, FloatingPointError
     on the unshifted zero-diagonal matrix at b = 3), the flagship factor
     with bf16 spikes through ``save_factorization`` /
     ``load_factorization`` (the reloaded solve bit-equal); a complex64
     band at the flagship's shape (gmres + spike) and a complex Hermitian
     one at config 2's (cg + cholesky), converged, no kernel launched,
     every tensor on the card, the factor and the solve timed, and
     n = 2e4 on the card against the CPU in complex128;
 13. the distributed path at one rank (``phase_dist_flagship``,
     ``phase_dist_reference``, ``phase_dist_config2``): a one-rank default
     group (gloo for CPU tensors, NCCL for CUDA ones) and ``make_mesh(1)``
     on the card; ``dist_spike_factor`` on the flagship (K = 64 partitions
     on the rank, b = 128, bf16 spikes, newton_fixed; its reduced system by
     cyclic reduction, K - 1 >= 33), ``make_dist_solver`` gmres at rtol
     1e-8 on the band route (#2) with the single-device path's iteration
     count, on the blocks route (#7 through ``blocktri_matvec_chunked_cuda``,
     held against its plain version), ``dist_spike_solve_many`` at r = 32
     (#4) and bicg with ``dist_spike_transpose`` (#1 on the transposed
     factor, #7 for A^T), each with its launches held exactly and its wall,
     device busy time and idle share beside the single-device solve's; a
     small band through ``make_dist_solver`` on the card (f32) and on a CPU
     mesh (f64) in one process (equal iterations, x within 1e-5); config 2
     on the mesh (cg with #3 and #2, and ``make_dist_solver_batched`` cg
     serving on a (1, 1) mesh at r = 32 with #5), launches held exactly;
     the rest of the distributed path at one rank (``phase_dist_multislice``,
     ``phase_dist_3d``, ``phase_dist_autodiff``, ``phase_elastic``,
     ``phase_dist_ms_reference``): the flagship on a (1, 1)
     ``make_mesh_multislice`` (its factor's pieces against the 1-D mesh's,
     ``make_dist_solver_multislice`` gmres on the band and the blocks
     routes in the 1-D mesh's iterations, bicg on
     ``dist_spike_transpose_multislice``, ``make_dist_solver_multislice_
     batched`` richardson and bcgs at r = 32 on #4), a (1, 1, 1)
     ``make_mesh_3d`` with ``make_dist_solver_3d`` richardson and gmres at
     r = 32, ``dist_solve_banded_diff`` and its multislice form against the
     single-device ``solve_banded_diff``'s gradients, ``resilient_solve``
     (a fault after segment 0, the same-size retry, a checkpoint resumed)
     and ``resilient_serve`` on (1, 1) and (1, 1, 1) with a fault, each
     with its launches held; a small band through the multislice and 3-D
     solvers on the card (f32) and on a CPU mesh (f64);
 14. the route tuner, the native assembly, config 4 and the auction
     (``phase_tuning``, ``phase_native_factor``, ``phase_config4``,
     ``phase_config4_reference``, ``phase_auction``), the script's own
     tuning record a fresh file from the start: ``tools.tune.main`` at the
     flagship, at config 3's width and at the flagship in f64 (each
     route's time, the record under ``cuda:<card name>``, each route's y
     against the plain version), then ``as_matvec(band)`` under 'auto'
     with a record naming ``blocktri`` (#7 once, #2 never) and one naming
     ``banded_cuda`` (the reverse); ``problems.blocktri_diagdom_device``
     at the flagship (its structure: masks, identity rows past n, strict
     dominance), ``spike_factor_blocks`` with the flagship's settings
     timed beside the band-entry factor, gmres (rtol 1e-8) on the
     block-tridiagonal operator with the spike PC, #1 and #7 launched
     exactly; BASELINE config 4 (``problems.general_sparse`` at n = 1e5,
     scrambled) through the testbed with ``-mat_ordering_type fiedler
     -mat_ordering_fiedler_method lobpcg -pc_type banded``, gmres in f32
     at rtol 1e-6: the LOBPCG's iterations and time on the card, the host
     stages, the bandwidth before and after, the true relres, the
     launches held exactly; n = 5000 on the card in f32 against the CPU in
     f64; ``parallel.auction_match`` on config 3's matrix at n = 1e5 and,
     where the first run predicts it under a minute, 1e6 (rounds, time,
     a permutation within n eps of MC64 job 5's log-product, the ELL
     arrays on the card), and ``auction_match_dist`` on a one-rank mesh
     at n = 1e5 (``phase_dist_auction``: the same checks, its rounds and
     time beside ``auction_match``'s);
 15. prints a ``{"kernels": [...]}`` line (each kernel's launches on its
     path, error, time, plain time, bound and library time, and its
     launches on each further path: the PCs', gmres_many's, autodiff's,
     the tuner's 'auto' checks, the native assembly's, config 4's, the
     distributed paths' ``dist_*``, ``dist_ms_*``, ``dist_3d_*``,
     ``dist_diff_*`` and ``resilient_*``) and
     the script's time in all, and, last, the line
     ``{"ok": true, "device": {...}}``.

Any failed check raises: the exit code is then non-zero and no result line
is printed.  Without a CUDA device it exits with code 2 at once.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time

N, HALF_BW, K, BLOCK = 1_000_000, 100, 64, 128
PC_OPTIONS = {"pc_spike_partitions": K, "pc_spike_block": BLOCK,
              "pc_spike_store_spikes": 1, "pc_spike_spike_dtype": "bf16",
              "pc_spike_inverter": "newton_fixed"}
SEED = 0
REPS = 5
KERNEL_TOL = 1e-5          # max|kernel - plain| / max|plain|
REDUCED_TOL = 2e-6         # the reduced-system kernel's, the same measure
ITERS_REDUCED = 20         # launches queued back to back: the device's time
SPIKE_RELRES_MAX = 2.5e-4  # f32 relative residual of one bf16-spike solve
GMRES_ITS_MAX = 3
NRHS = 32                  # serving batch (BASELINE config 2's batched mode)
SERVE_ITS_MAX = 2          # bcgs at rtol 1e-8; the TPU yardstick is 1
SERVE_RELRES_MAX = 1e-4    # per-column true f32 relative residual
CARRY_REL_MAX = 1e-5       # f32 multi-RHS solve against its f64 solve
# the SPD path: BASELINE config 2 (SPD band, bandwidth 33, n = 1e6, 16
# partitions, truncated reduced system), the cholesky PC
SPD_N, SPD_HALF_BW, SPD_K, SPD_BLOCK = 1_000_000, 16, 16, 64
SPD_OPTIONS = {"pc_cholesky_partitions": SPD_K,
               "pc_cholesky_block": SPD_BLOCK,
               "pc_cholesky_truncated": 1, "pc_cholesky_store_spikes": 1}
CG_ITS_MAX = 5             # the JAX config-2 test's bound
DIST_REF_RTOL = 1e-5       # f32-attainable: the card and the CPU f64 agree
CG_SERVE_ITS = 2           # cg serving on config 2: every column, 2 its
# kernel #5 before its redesign (PERF.md §6, row #5, in brackets: H100
# 80GB HBM3, 700 W), printed beside this run's time
MANY_SPD_BEFORE_MS = {"f32": 4.3266, "bf16": 4.3867}
# kernel #3 before its redesign (PERF.md §6, row #3, in brackets: H100
# 80GB HBM3, 700 W), printed beside this run's time
SPD_BEFORE_MS = {"f32": 1.3904, "bf16": 1.2257}
# kernel #4 before its redesign (PERF.md §6, row #4, in brackets: H100
# 80GB HBM3, 700 W), printed beside this run's time
MANY_BEFORE_MS = {"f32": 1.4496, "bf16": 1.2226}
# kernel #1 before its redesign (PERF.md §6, row #1, in brackets: H100
# 80GB HBM3, 700 W; one block a partition), printed beside this run's
# time: the flagship, the zero-diagonal factor (K = 64, nb = 245, b = 64),
# K = 512, nb = 16, and K = 1, nb = 157 (device time a call); config 4's
# inner factor (K = 16, nb = 49, b = 128), which no earlier run timed, from
# the first design's source built beside the redesign in one call of
# experiments/torch_lab_fused_sweep.py (CUDA events, random factor).  All
# constants, not measured in this run
FUSED_BEFORE_MS = {"flagship_f32": 0.6383, "flagship_bf16": 0.4232,
                   "zerodiag": 0.5174, "k512": 0.5081, "k1_nb157": 0.2395,
                   "config4": 0.2212}
# f64-grade refinement on the flagship band (f64 operator, f32 factors):
# the recipe of spike_petsc_tpu/testbed.py (-ksp_type richardson
# -pc_spike_factor_dtype f32), rtol 1e-12 and maxit 20 as bench.py's stage
REFINE_OPTIONS = dict(PC_OPTIONS, pc_spike_factor_dtype="f32")
REFINE_RTOL, REFINE_MAXIT = 1e-12, 20
REFINE_ITS_MAX = 4         # the TPU took 3
REFINE_XERR_MAX = 1e-10    # max|x - 1|
LADDER_OPTIONS = dict(REFINE_OPTIONS, pc_spike_store_dtype="bf16")
LADDER_MAXIT = 30          # bf16-stored factors: the ladder's second rung
F64_KERNEL_TOL = 1e-13     # the f64 band kernel against its plain version
F64_CSR_TOL = 3e-13        # either against an f64 CSR product (the JAX
#                            test's bound for its emulated-f64 kernel)
GRID_KT = 8                # block rows per thread block of the grid matvec
# BASELINE config 3 through the port's testbed CLI (bench.py:863-956,
# stage_ordering): illscaled n = 1e6, MC64 job 5 with scaling, RCM, the
# 0.9999 band (k = 6), the banded PC's inner spike at K = 64, b = 128
# (kernel #1 takes b = 64 or 128 only; the default block is the tip size)
CONFIG3_ARGV = (
    "-problem illscaled:1000000:6:6 -mat_ordering_type wbm "
    "-mat_ordering_scale 1 -mat_ordering_type2 rcm -banded_pre_mat 1 "
    "-pc_banded_kmax 50 -pc_banded_frac 0.9999 -ksp_type bcgs "
    "-ksp_rtol 1e-8 -ksp_max_it 50 -pc_type banded "
    "-banded_pc_spike_partitions 64 -banded_pc_spike_block 128 "
    "-ksp_converged_reason -log_view").split()
CONFIG3_K, CONFIG3_BLOCK = 64, 128
CONFIG3_ITS_MAX = 3        # the TPU took 2 (BENCH_r05.json)
CONFIG3_RELRES_MAX = 1e-6  # true f32 relative residual
CONFIG3_REF_TOL = 1e-5     # card f32 against CPU f64, max|dx| / max|x|
# BASELINE config 1 through the testbed CLI: the reference's canned recipe
# (reference/src/makefile:18: gmres + lu + -ksp_monitor_true_residual) on
# the tridiagonal Laplacian at n = 1e5, f32 on the card.  The lu PC gets
# block 64 there (k = 1), one partition of nb = 1563 block rows, which #1's
# shared-memory rule refuses: 'auto' runs the two-pass sweeps #9
CONFIG1_ARGV = ("-problem tridiag -ksp_type gmres -pc_type lu "
                "-ksp_rtol 1e-10 -ksp_monitor_true_residual "
                "-ksp_converged_reason -log_view").split()
CONFIG1_N, CONFIG1_BLOCK = 100_000, 64
CONFIG1_ITS_MAX = 40       # f32 on the CPU took 26 (both packages)
# ||x - x64|| / ||x64|| against an f64 host solve of the same (f32-rounded)
# system.  kappa(A) = 4n^2/pi^2 ~ 4.05e9 at n = 1e5: the f32 solve ends at a
# true relres of ~5e-5 (eps_f32 ||A|| ||x|| / ||b||), and its error is the
# smoothest modes'.  The port's f32 CPU runs reached 2.9e-3 (block 64) and
# 4.4e-4 to 8.9e-4 (block 1); the bound is ~7x the larger.  It scales with
# kappa, so the n = 1e4 reference holds 1/100 of it
CONFIG1_REL_MAX = 2e-2
CONFIG1_REF_N = 10_000
CONFIG1_REF_REL_MAX = 2e-4
# the two-pass sweeps (#9) at few long partitions, where they take the
# chunked scan (C > 1 chunks a partition): (K, nb, b, the band's half width)
# of dominant random bands beside config 1's factor (K = 1, nb = 1563,
# b = 64); nb = 301 with b = 128 is ragged under its plan's C, and K = 2
# and 4 spread their partitions' chunks over the card
SWEEPS_CHUNKED_SHAPES = ((1, 301, 128, 60), (2, 400, 64, 20),
                         (4, 400, 64, 20))
# chunk counts #9 is timed at on config 1's factor, beside the plan's,
# and its time there with one block a partition (PERF.md)
CONFIG1_CHUNKS = (16, 33, 66, 100, 132)
CONFIG1_SWEEPS_BEFORE_MS = 2.2506
# the transpose-free KSP types on the flagship (the spike PC built once)
# and on config 2 (the cholesky PC built once): (type, options, the largest
# iteration count it may take, rtol).  The flagship's gmres takes 2; bcgsl
# counts ell = 2 an MR cycle; chebyshev's interval [0.1, 1.1] lambda_max
# from a 2-step Arnoldi estimate shrinks a residual by ~1.9 an iteration
# around lambda = 1 (27 its in an f32 CPU run at n = 5e4).  One PC apply
# leaves an f32 relres of ~1e-7 to 5e-7 on these bands, and rtol 1e-8 lies
# below it: types whose monitored norm is a short recurrence of the true
# residual then run on roundoff.  In f32 CPU runs at n = 2e4 and 5e4: gcr's
# norm (||r||^2 - <Ap, r>^2 / ||Ap||^2, noise ~sqrt(eps) ||r||) stopped
# after 1 and 31 its (f64: 2); on config 2 cr's and pipecg's recurrences
# stalled at 1.0e-7 to 2.4e-7 (cr broke down, pipecg ran to maxit).  Those
# run at rtol 1e-6.  The reference sub-phase compares f32 with f64
# iteration counts: at rtol 1e-8 f32 rounding sets them (gcr 31 against 2,
# bcgsl 4 against 2, chebyshev 31 against 27 in an f32 CPU run at n = 2e4),
# so it runs at 1e-6.  gcr's f32 norm is noise once a step cuts the
# residual by more than sqrt(eps_f32) ~ 3.5e-4, as the spike PC's first
# step does (it stopped after 1 step by CONVERGED_ATOL, the norm cancelled
# to 0, where f64 took 2), so its reference takes the jacobi PC, whose steps
# cut the residual by ~6 (8 its in f32 and in f64, 9e-7 apart)
KSP_TYPE_CASES = (
    ("fgmres", {}, 3, 1e-8), ("lgmres", {}, 3, 1e-8), ("gcr", {}, 3, 1e-6),
    ("cgs", {}, 3, 1e-8), ("tfqmr", {}, 3, 1e-8), ("bcgsl", {}, 6, 1e-8),
    ("chebyshev", {"ksp_chebyshev_esteig": "",
                   "ksp_chebyshev_esteig_steps": 2}, 40, 1e-8),
    ("gmres", {"ksp_pc_side": "right"}, 3, 1e-8),
    ("gmres", {"ksp_monitor_true_residual": 1}, 3, 1e-8))
SPD_KSP_TYPE_CASES = (("cr", {}, 5, 1e-6), ("minres", {}, 5, 1e-6),
                      ("symmlq", {}, 5, 1e-6), ("pipecg", {}, 5, 1e-6))
KSP_TYPE_REF_RTOL = 1e-6
KSP_TYPE_REF_PC = {"gcr": "jacobi"}
KSP_TYPE_RELRES_MAX = 1e-4    # true f32 relres from banded_matvec
KSP_TYPE_REF_TOL = 1e-5       # card f32 against CPU f64, max|dx| / max|x|
# the transpose stack (phase_transpose_*): the A^T types on the flagship
# at rtol 1e-8, each with the spike PC built once.  In f32 CPU runs of the
# JAX package at n = 2e4 (w = 41, the flagship's PC options at K = 8,
# b = 64) bicg, cgne, cgls and lsqr reached rtol 1e-8 in 2 its (their
# monitored norms ended at 3e-9 to 6e-9 of ||b||), gmres with
# transpose=True in 2, and each true f32 relres was 9e-8 to 2e-7
TRANSPOSE_KSP_CASES = (("bicg", 4), ("lsqr", 4), ("cgls", 4))
TRANSPOSE_REF_CASES = ("bicg", "cgne", "cgnr", "cgls", "lsqr", "gmres")
# config 3 with bicg: the JAX testbed in f32 on the CPU took 2 its at
# n = 2e4 and 2e5 (true relres 8e-8)
CONFIG3_BICG_ITS_MAX = 3
# the rest of the factor surface (phase_zerodiag, phase_cr_flagship,
# phase_methods_flagship, phase_grouped, phase_factor_surface_reference).
# A: the reference's zero-diagonal scenario (testbed.c:266-272, makefile:18:
# -pc_factor_shift_type nonzero) at full size in f32 through the testbed,
# the spike PC at K = 64, b = 64 (#1 at nb = 245) and the lu PC at b = 64
# (#9 at K = 1, nb = 15625), each with and without the shift.  The block is
# named so that a CPU reference has the same geometry.  rtol 1e-9 is the
# JAX test's; in f32 on the CPU both packages reach it with the shift in
# 2-3 its at n = 2e4 and 2e5 (the monitored norm is the preconditioned
# one).  Without the shift both converge as well: at n = 2e4 in 1-2 its,
# at n = 2e5 the JAX package in 31 (spike) and 29 (lu) its, the port in 1
# and 2; hence the iteration bound
ZERODIAG_N = 1_000_000
ZERODIAG_PCS = {
    "spike": "-pc_type spike -pc_spike_partitions 64 -pc_spike_block 64",
    "lu": "-pc_type lu -pc_lu_block 64"}
ZERODIAG_ARGV = ("-problem zerodiag:{n} -ksp_type gmres {pc} {shift} "
                 "-ksp_rtol 1e-9 -ksp_converged_reason -ksp_view")
ZERODIAG_ITS_MAX = 40
# ||x - u|| / ||u|| in f32: the matrix's condition grows as n (its
# eigenvalues are 2 cos(k pi / (n + 1))), and so does the f32 error.  The
# JAX package in f32 on the CPU (spike, lu; shifted): 2.0e-4, 3.7e-5 at
# n = 2e4 and 4.5e-3, 3.9e-4 at n = 2e5 (the port: 2.7e-5, 7.4e-5 and
# 6.6e-4, 1.1e-3; unshifted, both packages 3e-4 or less); the spike PC's
# growing as ~n^1.35 extrapolates to ~4e-2 at n = 1e6
ZERODIAG_REL_MAX = 0.1
# the sweep kernel of each shifted zero-diagonal PC against the plain sweep
# in f64 on the same factor, max|kernel - f64| / max|f64|.  The factor is
# ill-conditioned (pivots raised to 1e-8 of the matrix's scale), so two f32
# sweeps that sum in different orders differ by far more than KERNEL_TOL.
# On an H100 80GB HBM3 (700 W): #1 7.8e-5 (its first design 3.9e-5) and #9
# 6.0e-4; their plain f32 versions 3.4e-5 and 3.8e-3.  #1's copies that
# sum each row serially, forward or backward, read 4.8e-5 and 3.9e-5 on
# this right-hand side, and on three random ones #1 reads 0.96e-6 to
# 1.39e-6 against plain f32's 1.14e-6 to 1.65e-6
# (experiments/torch_lab_fused_sweep.py --orders)
ZERODIAG_SWEEP_TOL = {"fused_sweep": 1e-4, "sweeps": 2e-3}
# B: the flagship at K = 512 (nb = 16): K - 1 = 511 = 2^9 - 1 reduced
# block rows, which 'auto' factors by cyclic reduction
CR_K = 512
# C: the partition methods on the flagship (K = 64, b = 128): lu and cr
# factors take the plain sweeps (#1's rule refuses them), newton_pan is an
# inv factor (#1 and the safety net's probe)
METHOD_CASES = (("lu", {"pc_spike_method": "lu"}),
                ("cr", {"pc_spike_method": "cr"}),
                ("newton_pan", {"pc_spike_inverter": "newton_pan"}))
# D: spike_factor_grouped on the flagship
GROUPS = 8
GROUPED_FACTOR_TOL = 1e-6      # factor blocks, max|d| / max|monolithic|
GROUPED_SOLVE_TOL = 1e-5       # the solves, max|dx| / max|x|
# E: card (f64) against the port's CPU path (f64)
FACTOR_REF_N = 20_000
FACTOR_REF_TOL = 1e-6
# the remaining PCs (phase_pcs_*): rtol 1e-8 everywhere (cg's and gmres's
# recurrence residuals go below f32's floor; the f32 CPU runs of these
# recipes reached it), the true f32 relres held as on the flagship paths
PCS_RTOL = 1e-8
PCS_RELRES_MAX = 1e-4
PCS_MAXIT = 200
SOR_BLOCK = 64             # config 2 at this block: #9 at K = 1, nb = 15625
SOR_SMALL_N = 20_000       # SOR's default block (16): the plain sweep
TESTBED2_ARGV = ("-problem spd:1000000:16 -ksp_type fgmres -pc_type "
                 "fieldsplit -pc_fieldsplit_type schur -fieldsplit_0_pc_type "
                 "lu -fieldsplit_1_pc_type lu -ksp_rtol 1e-8 "
                 "-ksp_converged_reason -log_view").split()
MG_ARGV = ("-problem tridiag -ksp_type cg -pc_type mg -ksp_rtol 1e-8 "
           "-ksp_converged_reason -log_view").split()
MG_ITS_MAX = 15            # JAX's bound (tests/test_mg.py); f32 CPU: 8
MG_REL_MAX = 2e-2          # against an f64 host solve, as config 1's lu
PCS_REF_N = 20_000
# NVIDIA's data sheet for the H100 SXM (700 W): the bound of each kernel
# complex scalars, ops/autodiff.py, gmres_many's options and the factor
# checks (phase_complex, phase_gmres_many_options, phase_autodiff,
# phase_checks).  Complex input launches none of the kernels (their
# rules admit f32/bf16 only; complex spd takes the plain sweep)
COMPLEX_RTOL = 1e-5
COMPLEX_RELRES_MAX = 1e-4
COMPLEX_REF_N, COMPLEX_REF_TOL = 20_000, 1e-4
# gmres_many at r = 32 (side, CGS refinement, rtol).  One CGS pass in
# f32 loses the basis's orthogonality and the residual estimate stalls at
# the true f32 residual: the JAX package's gmres_many in f32 on the CPU
# (n = 2e4, w = 201, K = 8, b = 128, bf16 spikes, right PC, 'never')
# stalls at ~2.5e-6 of ||b|| and runs to maxit at rtol 1e-8 (its
# single-RHS gmres too; 'always' and 'ifneeded' 2 its), so 'never' runs at
# rtol 1e-5
GMRES_MANY_CASES = (("left", "always", 1e-8), ("right", "always", 1e-8),
                    ("right", "never", 1e-5), ("right", "ifneeded", 1e-8))
# the gradients with the kernels against those from the plain sweeps on
# the same factors (max|d| / max|plain|), the adjoint residual
# ||A^T lam - g|| / ||g||, and the card's f32 gradients at n = 2e4 against
# the CPU's f64 ones
AUTODIFF_PLAIN_TOL = 1e-4
AUTODIFF_ADJOINT_MAX = 1e-4
AUTODIFF_REF_N, AUTODIFF_REF_TOL = 20_000, 1e-3
# the launches each pass of solve_banded_diff makes, read from the code
# (PERF.md, before the first run).  K = 64: spike_factor stores no spikes
# (the JAX default), so each spike_solve sweeps the partitions twice (g,
# then the boundary-corrected solve; ops/spike.py spike_solve), #1 twice a
# pass, and its reduced system (63 block rows of 200) on the reduced
# kernel once; the 'auto' inverter is lapack (no Newton probe, which only
# the PCs run), and spike_transpose's spikes are one plain batched solve.
# On the mesh the reduced system of 64 partitions is cyclic reduction (from
# 33 block rows): no reduced kernel.  K = 1 at nb = 1563: one solve a pass
# with no reduced system, the two-pass pair #9
AUTODIFF_LAUNCHES = {"flagship": {"fused_sweep": 2, "reduced_thomas": 1},
                     "dist_flagship": {"fused_sweep": 2},
                     "config1": {"sweeps": 2}}
ZERODIAG_CHECK = (20_000, 64, 3)       # n, K, block: singular b = 3 blocks
# the route tuner (tools/tune.py) at the flagship, at config 3's width and
# at the flagship in f64; each shape's timing loops of TUNE_REPS matvecs
TUNE_SHAPES = (("flagship", 1_000_000, 100, 100, "f32"),
               ("config3_width", 1_000_000, 6, 6, "f32"),
               ("flagship_f64", 1_000_000, 100, 100, "f64"))
TUNE_REPS = 20
# the flagship class assembled in block-tridiagonal layout on the card
# (problems.blocktri_diagdom_device), factored natively, gmres + spike on
# the block-tridiagonal operator (#7)
NATIVE_ITS_MAX = 3
NATIVE_RELRES_MAX = 1e-4
# BASELINE config 4 ("General sparse: Fiedler reorder + banded extraction"):
# problems.general_sparse at its default density, scrambled by a seeded
# permutation (as tests/test_baseline_configs.py:97-117), through the
# testbed with the device LOBPCG Fiedler ordering and PCBANDED; the banded
# options of that test (kmax 80, frac 0.999), the inner spike PC at 16
# partitions (its default), gmres in f32 at rtol 1e-6.  LOBPCG's test is
# |r| < tol * 10 * n * (theta + |A v|): at JAX's tol (1e-8) and n = 1e5 it
# accepts the random start after one iteration (lambda2 470 against ~0.4,
# the bandwidth 99982 -> 99998), so the Fiedler solve is asked for
# tol * 10 * n = 1e-8 (and up to 1000 iterations).  That test sits far
# above the rounding floor (on the card the ratio |r| / (10 n (theta +
# |A v|)) falls below 1e-14 at iteration 207 and on to ~1e-22 at n = 1e5;
# at n = 5000 below 1e-14 at 593, on to ~6e-16, the CPU's trace the same),
# so the card and the CPU stop within a few iterations of each other
CONFIG4_N = 100_000
CONFIG4_SEED, CONFIG4_PERM_SEED = 6, 2
CONFIG4_ARGV = ("-mat {path} -mat_ordering_type fiedler "
                "-mat_ordering_fiedler_method lobpcg "
                "-mat_ordering_fiedler_tol 1e-14 "
                "-mat_ordering_fiedler_max_it 1000 -pc_type banded "
                "-pc_banded_kmax 80 -pc_banded_frac 0.999 "
                "-banded_pc_spike_partitions 16 -ksp_type gmres "
                "-ksp_rtol 1e-6 -ksp_max_it 300 -ksp_converged_reason "
                "-log_view")
CONFIG4_RELRES_MAX = 1e-5  # true f32 relative residual
CONFIG4_REF_N = 5_000      # the card in f32 against the CPU in f64
CONFIG4_REF_LAM2_TOL = 1e-10   # measured 1.1e-13 (LOBPCG in f64 on both)
CONFIG4_REF_LOBPCG_ITS = 5     # measured equal (593 and 593)
# the single-device auction on config 3's matrix (illscaled_nonsym, kl =
# ku = 6, seed 0), then at the larger n if the first run predicts it under
# AUCTION_BUDGET_S (its rounds x its per-round time x the size ratio)
AUCTION_N = (100_000, 1_000_000)
AUCTION_BUDGET_S = 60.0
# the rest of the distributed path at one rank: the serving engines'
# richardson at rtol 0 runs exactly DIST_SERVE_TRIPS trips (one #4 launch
# each, stored spikes); the multislice autodiff's GMRES at an
# f32-attainable rtol; the elastic drill's segments of one iteration
DIST_SERVE_TRIPS = 2
DIST_DIFF_RTOL, DIST_DIFF_MAXIT = 1e-6, 30
DIST_DIFF_TOL = 1e-4       # gradients against solve_banded_diff's, f32
ELASTIC_RNORM_MAX = 1e-4   # the true f32 relres after the drills
PEAK_BYTES_S = 3.35e12     # HBM3
PEAK_F32_FLOPS = 67e12     # f32 outside the tensor cores
PEAK_F64_FLOPS = 34e12     # f64 outside the tensor cores
PEAK_TF32_FLOPS = 495e12   # TF32 on the tensor cores, dense (kernel #4)
REPLACES = {
    "band_matvec": "spike_petsc_tpu/ops/pallas/band_matvec.py:66",
    "fused_sweep": "spike_petsc_tpu/ops/pallas/fused_sweep.py:109",
    "fused_sweep_many": "spike_petsc_tpu/ops/pallas/fused_sweep.py:378",
    "blocktri_matvec": "spike_petsc_tpu/ops/pallas/matvec.py:89",
    "fused_sweep_spd": "spike_petsc_tpu/ops/pallas/fused_sweep.py:190",
    "fused_sweep_many_spd": "spike_petsc_tpu/ops/pallas/fused_sweep.py:458",
    "band_matvec_f64": "spike_petsc_tpu/ops/pallas/band_matvec.py:231",
    "sweeps": "spike_petsc_tpu/ops/pallas/sweeps.py:66/:84",
    "reduced_thomas": "none (JAX: lax.scan in spike_petsc_tpu/ops/blocktri.py)",
    "blocktri_matvec_grid": "spike_petsc_tpu/ops/pallas/matvec.py:31",
    "band_matvec_many": "none (JAX: a column loop or batched block products "
                        "in spike_petsc_tpu/solvers/operator.py "
                        "as_matvec_many)",
}
# the multi-RHS band kernel (#11) at n = N, r = NRHS: (kl, ku) of the
# cells' widths (33, 201) and of config 3's and config 1's (13, 3)
BAND_MANY_SHAPES = ((16, 16), (100, 100), (6, 6), (1, 1))


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def flagship_band(n, half_bw, device, seed=SEED):
    """Diagonally dominant random band, built on the device as bench.py
    builds its flagship band: uniform(-1, 1) entries, the diagonal set to
    the row's absolute sum + 1 (edge rows keep nonzero out-of-range slots).
    Right-hand side b = A @ 1, so the solution is all ones."""
    import torch
    from spike_petsc_tpu_torch import BandedMatrix
    from spike_petsc_tpu_torch.ops.band import banded_matvec
    gen = torch.Generator(device=device).manual_seed(seed)
    data = torch.rand((n, 2 * half_bw + 1), generator=gen, device=device,
                      dtype=torch.float32) * 2 - 1
    data[:, half_bw] = data.abs().sum(dim=1) + 1
    band = BandedMatrix(data=data, kl=half_bw, ku=half_bw)
    return band, banded_matvec(band, torch.ones(n, device=device))


def spd_band(n, half_bw, device, seed=SEED):
    """Symmetric diagonally dominant random band (BASELINE config 2, the
    matrix of ``models.problems.spd_banded``), built on the device: the
    upper diagonals uniform(-1, 1), mirrored to the lower ones so that
    data[i, k + d] == data[i + d, k - d]; the diagonal the row's absolute
    sum + 1; slots outside the matrix zero.  Right-hand side b = A @ 1."""
    import torch
    from spike_petsc_tpu_torch import BandedMatrix
    from spike_petsc_tpu_torch.ops.band import banded_matvec
    gen = torch.Generator(device=device).manual_seed(seed)
    k = half_bw
    data = torch.zeros((n, 2 * k + 1), device=device)
    for d in range(1, k + 1):
        v = torch.rand(n - d, generator=gen, device=device) * 2 - 1
        data[:n - d, k + d] = v
        data[d:, k - d] = v
    data[:, k] = data.abs().sum(dim=1) + 1
    band = BandedMatrix(data=data, kl=k, ku=k)
    return band, banded_matvec(band, torch.ones(n, device=device))


def laplacian_factor(n, device):
    """The factor config 1's ``lu`` PC builds on the card: the tridiagonal
    Laplacian (2 on the diagonal, -1 beside it) at n, one partition, block
    64, f32."""
    import numpy as np
    from spike_petsc_tpu_torch.convert import banded_from_numpy
    from spike_petsc_tpu_torch.ops.spike import spike_factor
    band = banded_from_numpy(np.tile(np.float32([-1, 2, -1]), (n, 1)), 1, 1,
                             device=device)
    return spike_factor(band, K=1, block_b=CONFIG1_BLOCK)


def random_inv_factor(K, nb, b, dtype, device, seed):
    """An ``inv`` factor of random matrices, scaled so that both sweeps
    stay bounded (each matrix's norm ~0.5), made on ``device`` from a seed:
    for a sweep kernel at shapes no problem gives (its work does not depend
    on the values)."""
    import torch
    from spike_petsc_tpu_torch.ops.blocktri import BlockTriFactor
    gen = torch.Generator(device=device).manual_seed(seed)
    s = 0.25 / b ** 0.5
    F, U, Sinv = (torch.randn((K, nb, b, b), generator=gen, device=device)
                  * s for _ in range(3))
    Sinv += 0.5 * torch.eye(b, device=device)
    return BlockTriFactor(F=F.to(dtype), U=U.to(dtype), Sinv=Sinv.to(dtype),
                          method="inv")


def time_ms(fn, reps=REPS, iters=1):
    """Median and spread (max - min) in ms per call of ``fn`` over ``reps``
    repetitions of ``iters`` calls, with CUDA events, after one warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / iters)
    return statistics.median(times), max(times) - min(times)


def kernel_err(got, ref):
    """(max|got - ref|, that over max|ref|)."""
    diff = float((got.double() - ref.double()).abs().max())
    return diff, diff / float(ref.double().abs().max())


def roofline(nbytes, flops, peak_flops=PEAK_F32_FLOPS):
    """(ms, "bytes" or "operations"): the least time the card could take,
    the larger of ``nbytes`` (each input read once, each output written
    once) over the data sheet's memory rate and ``flops`` (an FMA is two)
    over its rate for their type (f32 unless ``peak_flops`` says)."""
    by_bytes = nbytes / PEAK_BYTES_S * 1e3
    by_ops = flops / peak_flops * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def sweep_bytes(fact, r=1):
    """The bytes a block-Thomas solve of ``r`` right-hand sides must move:
    each matrix the two sweeps read, once (``inv``: F_1 .. F_{nb-1},
    U_0 .. U_{nb-2} and every Sinv_i, 3 nb - 2 a partition; ``spd``:
    F_1 .. F_{nb-1} and every Sinv_i, 2 nb - 1; F_0 and U_{nb-1} are never
    read), r in and x out in f32.  A kernel's own round trips (#9's y) are
    not the function's."""
    K, nb, b, _ = fact.F.shape
    mats = {"inv": 3 * nb - 2, "spd": 2 * nb - 1}[fact.method]
    return (K * mats * b * b * fact.F.element_size()
            + 2 * K * nb * b * r * 4)


def sweep_bound(fact, r=1, peak_flops=PEAK_F32_FLOPS):
    """The roofline of a fused block-Thomas solve of ``r`` right-hand
    sides: ``sweep_bytes``, and 3 nb - 2 matrix-vector products per
    partition and column at ``peak_flops`` (the CUDA cores' f32 rate
    unless the kernel runs its products on the tensor cores)."""
    K, nb, b, _ = fact.F.shape
    return roofline(sweep_bytes(fact, r), 2 * K * (3 * nb - 2) * b * b * r,
                    peak_flops)


def band_csr(band):
    """The band's entries inside the matrix as a CSR tensor (int32
    indices): the input of the library's sparse product."""
    import torch
    n, dev = band.n, band.data.device
    cols = (torch.arange(n, device=dev)[:, None]
            + torch.arange(band.width, device=dev)[None] - band.kl)
    keep = (cols >= 0) & (cols < n)
    crow = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    crow[1:] = keep.sum(dim=1).cumsum(0)
    return torch.sparse_csr_tensor(crow.int(), cols[keep].int(),
                                   band.data[keep], size=(n, n))


def blocktri_bsr(T):
    """A block-tridiagonal matrix as a BSR tensor of its stored b x b
    blocks (int32 indices), L_0 and U_{nb-1} left out."""
    import torch
    nb, b, dev = T.nb, T.b, T.D.device
    vals = torch.stack([T.L, T.D, T.U], dim=1).reshape(3 * nb, b, b)[1:-1]
    cols = (torch.arange(nb, device=dev)[:, None]
            + torch.arange(-1, 2, device=dev)[None]).reshape(-1)[1:-1]
    counts = torch.full((nb,), 3, dtype=torch.int64, device=dev)
    counts[0] = counts[-1] = 2
    crow = torch.zeros(nb + 1, dtype=torch.int64, device=dev)
    crow[1:] = counts.cumsum(0)
    return torch.sparse_bsr_tensor(crow.int(), cols.int(),
                                   vals.contiguous(), size=(nb * b, nb * b))


def phase_card():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device 0: {torch.cuda.get_device_name(0)}, "
          f"count {torch.cuda.device_count()}")
    check(not torch.backends.cuda.matmul.allow_tf32,
          "f32 matmuls must run in full FP32 (TF32 is on)")
    return smi


def phase_build():
    from spike_petsc_tpu_torch.ops.cuda import KERNELS
    from spike_petsc_tpu_torch.ops.cuda._build import build_all
    from spike_petsc_tpu_torch.native import loader
    seconds, logs = build_all(KERNELS)
    print(f"build: {seconds:.2f} s for {len(KERNELS)} kernels")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    # the host matching engine (g++ at first use), built here so that the
    # config-3 stage times hold no compile
    t0 = time.perf_counter()
    engine = loader.engine()
    print(f"build: native matching engine {engine} in "
          f"{time.perf_counter() - t0:.2f} s")


def phase_kernels(band, rhs, sf, device):
    """Each kernel against its plain version on the same inputs."""
    import torch
    from spike_petsc_tpu_torch import BandedMatrix
    from spike_petsc_tpu_torch.ops.blocktri import (BlockTridiagonal,
                                                    band_to_blocktri,
                                                    cast_factor)
    from spike_petsc_tpu_torch.ops.cuda import band_matvec as cbm
    from spike_petsc_tpu_torch.ops.cuda import blocktri_matvec as cbt
    from spike_petsc_tpu_torch.ops.cuda import fused_sweep as cfs
    from spike_petsc_tpu_torch.ops.cuda import fused_sweep_many as cfm
    from spike_petsc_tpu_torch.ops.spike import spike_factor
    errs = {}
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    ragged = BandedMatrix(
        data=torch.rand((100_003, 231), generator=gen, device=device) - 0.5,
        kl=150, ku=80)
    for label, bm in (("flagship n=1e6 w=201", band),
                      ("ragged n=100003 kl=150 ku=80", ragged)):
        prep = cbm.prepare_banded_mv(bm)
        x = torch.randn(bm.n, generator=gen, device=device)
        diff, err = kernel_err(
            cbm.banded_matvec_prepared(prep, x),
            cbm.banded_matvec_prepared(prep, x, impl="plain"))
        torch.cuda.synchronize()
        print(f"band_matvec {label}: max abs err {diff:.3e}, "
              f"relative {err:.3e}")
        check(err <= KERNEL_TOL, f"band_matvec {label} err {err}")
        errs.setdefault("band_matvec", diff)

    # nb = 1 needs partitions of one block, so a band of half width 50
    small_band, _ = flagship_band(K * BLOCK, 50, device, seed=SEED + 2)
    small = spike_factor(small_band, K=K, block_b=BLOCK, inverter="lapack")
    check(small.nb == 1, "small factor must have nb = 1")
    rblk = torch.nn.functional.pad(rhs, (0, K * sf.m - N)).reshape(
        K, sf.nb, BLOCK)
    cases = [("flagship f32", sf.fact, rblk),
             ("flagship bf16", cast_factor(sf.fact, torch.bfloat16), rblk),
             ("nb=1 f32", small.fact,
              torch.randn((K, 1, BLOCK), generator=gen, device=device))]
    sms = cfs.device_sms(device)
    for label, fact, r in cases:
        plain = cfs.blocktri_solve_fused_cuda(fact, r, impl="plain")
        diff, err = kernel_err(cfs.blocktri_solve_fused_cuda(fact, r), plain)
        torch.cuda.synchronize()
        k, nb, b, _ = fact.F.shape
        plan = cfs.fused_sweep_cluster(k, nb, b, sms)
        cfg = cfs.kernel_config(b, fact.F.dtype, plan)
        print(f"fused_sweep {label} {tuple(fact.F.shape)}: max abs err "
              f"{diff:.3e}, relative {err:.3e}; plan c={plan} "
              f"({k * plan} blocks on {sms} SMs, {cfg['compute_warps']} "
              f"compute warps "
              f"and 1 producer warp a block, ring {cfg['depth']} slabs, "
              f"{cfg['smem_bytes']} B of shared memory)")
        check(err <= KERNEL_TOL, f"fused_sweep {label} err {err}")
        errs.setdefault("fused_sweep", diff)
        # every cluster size the plan can pick, on the same inputs
        for c in cfs.CLUSTER_SIZES:
            diff, err = kernel_err(
                cfs.blocktri_solve_fused_cuda(fact, r, cluster=c), plain)
            torch.cuda.synchronize()
            print(f"  fused_sweep {label} at c={c} ({k * c} blocks): max "
                  f"abs err {diff:.3e}, relative {err:.3e}")
            check(err <= KERNEL_TOL, f"fused_sweep {label} c={c} err {err}")

    # the multi-RHS sweep: one column chunk (r = 32), one column, and
    # several chunks (r = 100), f32 and bf16 factors, and nb = 1
    for label, fact, nb, r in (
            ("flagship f32 r=32", sf.fact, sf.nb, NRHS),
            ("flagship bf16 r=32", cast_factor(sf.fact, torch.bfloat16),
             sf.nb, NRHS),
            ("flagship f32 r=1", sf.fact, sf.nb, 1),
            ("flagship bf16 r=100", cast_factor(sf.fact, torch.bfloat16),
             sf.nb, 100),
            ("flagship f32 r=100", sf.fact, sf.nb, 100),
            ("nb=1 f32 r=32", small.fact, 1, NRHS)):
        rm = torch.randn((K, nb, BLOCK, r), generator=gen, device=device)
        diff, err = kernel_err(
            cfm.blocktri_solve_fused_many_cuda(fact, rm),
            cfm.blocktri_solve_fused_many_cuda(fact, rm, impl="plain"))
        torch.cuda.synchronize()
        print(f"fused_sweep_many {label} {tuple(fact.F.shape)}: max abs err "
              f"{diff:.3e}, relative {err:.3e}")
        check(err <= KERNEL_TOL, f"fused_sweep_many {label} err {err}")
        errs.setdefault("fused_sweep_many", diff)

    # the block-tridiagonal matvec: the flagship conversion, and a ragged
    # band (n not a multiple of 128, max(kl, ku) <= 128)
    ragged_bt = BandedMatrix(
        data=torch.rand((100_003, 198), generator=gen, device=device) - 0.5,
        kl=120, ku=77)
    T = band_to_blocktri(band, BLOCK)
    for label, t, n in (
            ("flagship f32", T, N),
            ("flagship bf16", BlockTridiagonal(
                D=T.D.bfloat16(), L=T.L.bfloat16(), U=T.U.bfloat16()), N),
            ("ragged n=100003 kl=120 ku=77 f32",
             band_to_blocktri(ragged_bt, BLOCK), ragged_bt.n)):
        x = torch.randn(n, generator=gen, device=device)
        diff, err = kernel_err(cbt.blocktri_matvec_cuda(t, x),
                               cbt.blocktri_matvec_cuda(t, x, impl="plain"))
        torch.cuda.synchronize()
        print(f"blocktri_matvec {label} {tuple(t.D.shape)}: max abs err "
              f"{diff:.3e}, relative {err:.3e}")
        check(err <= KERNEL_TOL, f"blocktri_matvec {label} err {err}")
        errs.setdefault("blocktri_matvec", diff)
    return errs


def phase_accuracy(band, rhs, sf):
    """One spike_solve's f32 residual, and Newton's max|S X - I| on a sample
    of the flagship's Schur blocks, rebuilt from the band and the factor."""
    import torch
    from spike_petsc_tpu_torch.ops.band import banded_matvec, pad_banded
    from spike_petsc_tpu_torch.ops.blocktri import (_skew_block_rows,
                                                    newton_inv_fixed)
    from spike_petsc_tpu_torch.ops.spike import spike_solve
    x = spike_solve(sf, rhs)
    relres = float(torch.linalg.norm(banded_matvec(band, x) - rhs)
                   / torch.linalg.norm(rhs))
    print(f"spike_solve f32 relative residual: {relres:.3e} "
          f"(TPU v5e yardstick 8.29e-5)")
    check(relres <= SPIKE_RELRES_MAX, f"spike_solve relres {relres}")
    nb, w = sf.nb, band.width
    local = pad_banded(band, K * sf.m).data.reshape(K, nb, BLOCK, w)
    worst = 0.0
    for i in (0, 1, nb - 1):
        _, d, _ = _skew_block_rows(local[:, i], BLOCK, band.kl, band.ku)
        S = d if i == 0 else d - sf.fact.F[:, i] @ sf.fact.U[:, i - 1]
        X = newton_inv_fixed(S)
        eye = torch.eye(BLOCK, dtype=torch.float64, device=S.device)
        worst = max(worst, float((S.double() @ X.double() - eye).abs().max()))
    print(f"newton_inv_fixed max|S X - I| over block rows 0, 1, nb-1 of "
          f"{K} partitions: {worst:.3e} (TPU v5e docstring 2.4e-7)")
    check(worst <= 1e-4, f"newton max|SX-I| {worst}")
    return relres, worst


def phase_main_path(band, rhs, device):
    """The main path through ``solve``, launch counts read around it."""
    import torch
    from spike_petsc_tpu_torch import Options, solve
    from spike_petsc_tpu_torch.ops.band import banded_matvec
    from spike_petsc_tpu_torch.ops.cuda import KERNELS
    from spike_petsc_tpu_torch.solvers.types import CONVERGED_RTOL, reason_str
    for kern in KERNELS:
        kern.launches = 0
    res = solve(band, rhs, ksp_type="gmres", pc_type="spike",
                options=Options(dict(PC_OPTIONS)), rtol=1e-8, restart=30,
                maxit=30)
    torch.cuda.synchronize()
    launches = {kern.name: kern.launches for kern in KERNELS}
    bnorm = float(torch.linalg.norm(rhs))
    true_rel = float(torch.linalg.norm(banded_matvec(band, res.x) - rhs)
                     / bnorm)
    xerr = float((res.x - 1).abs().max())
    print(f"gmres+spike: {res.its} its, {reason_str(res.reason)}, "
          f"preconditioned rnorm/||b|| {res.rnorm / bnorm:.3e}, "
          f"true relres (f32) {true_rel:.3e}, max|x - 1| {xerr:.3e} "
          f"(TPU v5e yardstick: 2 its to 3.96e-11)")
    print(f"launches on the main path: {launches}")
    check(res.reason == CONVERGED_RTOL and res.its <= GMRES_ITS_MAX,
          f"gmres: {res.its} its, reason {res.reason}")
    check(res.x.shape == (N,) and bool(torch.isfinite(res.x).all()),
          "solution shape / finiteness")
    check(xerr <= 1e-3 and true_rel <= 1e-4, "solution accuracy")
    check(launches["band_matvec"] > 0 and launches["fused_sweep"] > 0
          and launches["reduced_thomas"] > 0,
          f"a kernel did not run on the main path: {launches}")
    return res, launches


def phase_reference(device):
    """The same solve on a small band, on the card (kernels, f32) and on the
    CPU (plain versions, f64): the solutions must agree."""
    import torch
    from spike_petsc_tpu_torch import BandedMatrix, Options, solve
    band, rhs = flagship_band(20_000, 20, device, seed=SEED + 3)
    opts = dict(PC_OPTIONS, pc_spike_partitions=8, pc_spike_block=64)
    got = solve(band, rhs, ksp_type="gmres", pc_type="spike",
                options=Options(dict(opts)), rtol=1e-8)
    cpu = BandedMatrix(data=band.data.double().cpu(), kl=20, ku=20)
    ref = solve(cpu, rhs.double().cpu(), ksp_type="gmres", pc_type="spike",
                options=Options(dict(opts)), rtol=1e-8)
    err = float((got.x.double().cpu() - ref.x).abs().max())
    print(f"small band n=20000 w=41: card {got.its} its vs CPU f64 "
          f"{ref.its} its, max|x_card - x_cpu| {err:.3e}")
    check(err <= 1e-5 and got.reason == ref.reason == 2,
          "card and CPU reference disagree")


def reset_launches():
    from spike_petsc_tpu_torch.ops.cuda import KERNELS
    for kern in KERNELS:
        kern.launches = 0


def read_launches():
    import torch
    from spike_petsc_tpu_torch.ops.cuda import KERNELS
    torch.cuda.synchronize()
    return {kern.name: kern.launches for kern in KERNELS}


def phase_carry(sf, device, kern, label, seed=SEED + 5):
    """The multi-RHS precision trap: the f32 solve through the kernel
    ``kern`` must match an f64 solve of the same factor (factors and bf16
    spikes promoted exactly; the plain path, since the kernel takes no f64)
    to f32 level.  A carry rounded to bf16 would miss by ~1e-3."""
    import dataclasses
    import torch
    from spike_petsc_tpu_torch.ops.blocktri import BlockTriFactor
    from spike_petsc_tpu_torch.ops.spike import spike_solve_many

    def f64(t):
        return None if t is None else t.double()

    def f64_factor(f):
        return None if f is None else BlockTriFactor(
            F=f.F.double(), U=f.U.double(), Sinv=f.Sinv.double(),
            method=f.method)
    sf64 = dataclasses.replace(
        sf, fact=f64_factor(sf.fact), red_fact=f64_factor(sf.red_fact),
        red_Dinv=f64(sf.red_Dinv), Btip=f64(sf.Btip), Ctip=f64(sf.Ctip),
        V=f64(sf.V), W=f64(sf.W))
    gen = torch.Generator(device=device).manual_seed(seed)
    R = torch.randn((sf.n, NRHS), generator=gen, device=device)
    before = kern.KERNEL.launches
    x32 = spike_solve_many(sf, R)
    launched = kern.KERNEL.launches - before
    x64 = spike_solve_many(sf64, R.double(), impl="plain")
    rel = float(torch.linalg.norm(x32.double() - x64)
                / torch.linalg.norm(x64))
    print(f"spike_solve_many f32 ({label}, kernel) against its f64 solve: "
          f"relative error {rel:.3e} (limit {CARRY_REL_MAX})")
    check(launched == 1 and x32.dtype == torch.float32,
          f"the f32 multi-RHS solve did not run {kern.KERNEL.name}")
    check(rel <= CARRY_REL_MAX, f"multi-RHS f32 carry: relative error {rel}")
    return rel


def phase_blocktri_route(band, rhs, band_its):
    """The GMRES main path with ``-mat_matvec_impl blocktri``: the
    block-tridiagonal kernel as the operator, the same iteration count."""
    import torch
    from spike_petsc_tpu_torch import Options, solve
    from spike_petsc_tpu_torch.ops.band import banded_matvec
    from spike_petsc_tpu_torch.solvers.types import CONVERGED_RTOL, reason_str
    reset_launches()
    res = solve(band, rhs, ksp_type="gmres", pc_type="spike",
                options=Options(dict(PC_OPTIONS, mat_matvec_impl="blocktri")),
                rtol=1e-8, restart=30, maxit=30)
    launches = read_launches()
    true_rel = float(torch.linalg.norm(banded_matvec(band, res.x) - rhs)
                     / torch.linalg.norm(rhs))
    print(f"gmres+spike, blocktri operator: {res.its} its, "
          f"{reason_str(res.reason)}, true relres (f32) {true_rel:.3e}; "
          f"launches {launches}")
    check(res.reason == CONVERGED_RTOL and res.its == band_its,
          f"blocktri route: {res.its} its (band route {band_its}), "
          f"reason {res.reason}")
    check(true_rel <= 1e-4, "blocktri route accuracy")
    check(launches["blocktri_matvec"] > 0,
          f"blocktri kernel did not run on the blocktri route: {launches}")
    return launches


def phase_serving(band, device):
    """Serving through ``solve_many``: 32 seeded right-hand sides B = A X,
    bcgs + spike PC at rtol 1e-8, then at rtol 1e-4, where every column
    exits at the half step (one iteration, one launch of the multi-RHS
    sweep)."""
    import torch
    from spike_petsc_tpu_torch import Options, solve_many
    from spike_petsc_tpu_torch.ops.band import banded_matvec
    from spike_petsc_tpu_torch.solvers.operator import as_matvec_many
    from spike_petsc_tpu_torch.solvers.types import CONVERGED_RTOL
    gen = torch.Generator(device=device).manual_seed(SEED + 6)
    X = torch.randn((N, NRHS), generator=gen, device=device)
    B = banded_matvec(band, X)
    route = as_matvec_many(band)[0]._route
    print(f"solve_many operator route (-mat_matvec_impl auto): {route}")
    check(route == "banded_cuda_many", f"serving operator route {route}")
    main_launches = None
    for rtol in (1e-8, 1e-4):
        reset_launches()
        res = solve_many(band, B, ksp_type="bcgs", pc_type="spike",
                         options=Options(dict(PC_OPTIONS)), rtol=rtol,
                         maxit=20)
        launches = read_launches()
        relres = (torch.linalg.norm(banded_matvec(band, res.x) - B, dim=0)
                  / torch.linalg.norm(B, dim=0))
        xerr = float((res.x - X).abs().max())
        its = res.its.tolist()
        print(f"bcgs+spike serving r={NRHS} rtol={rtol:g}: its "
              f"min {min(its)} max {max(its)}, reasons "
              f"{sorted(set(res.reason.tolist()))}, per-column true relres "
              f"(f32) max {float(relres.max()):.3e}, max|x - X| {xerr:.3e}; "
              f"launches {launches} (TPU v5e yardstick at rtol 1e-8: 1 it)")
        check(res.x.shape == (N, NRHS) and bool(torch.isfinite(res.x).all()),
              "serving solution shape / finiteness")
        check(bool((res.reason == CONVERGED_RTOL).all()),
              f"serving reasons {res.reason.tolist()}")
        if rtol == 1e-8:
            check(max(its) <= SERVE_ITS_MAX, f"serving its {its}")
            check(float(relres.max()) <= SERVE_RELRES_MAX,
                  f"serving relres {float(relres.max())}")
            check(launches["fused_sweep_many"] > 0
                  and launches["band_matvec_many"] > 0,
                  f"multi-RHS sweep or #11 did not run on the serving path: "
                  f"{launches}")
            main_launches = launches
        else:
            check(its == [1] * NRHS and launches["fused_sweep_many"] == 1,
                  f"half-step exit: its {its}, launches {launches}")
    return main_launches


def phase_reference_many(device):
    """``solve_many`` on a small band on the card (f32, kernels) and on the
    CPU (plain versions, f64): the solutions must agree."""
    import torch
    from spike_petsc_tpu_torch import BandedMatrix, Options, solve_many
    band, _ = flagship_band(20_000, 20, device, seed=SEED + 7)
    gen = torch.Generator(device=device).manual_seed(SEED + 8)
    B = torch.randn((20_000, 4), generator=gen, device=device)
    opts = dict(PC_OPTIONS, pc_spike_partitions=8, pc_spike_block=64)
    got = solve_many(band, B, ksp_type="bcgs", pc_type="spike",
                     options=Options(dict(opts)), rtol=1e-8)
    cpu = BandedMatrix(data=band.data.double().cpu(), kl=20, ku=20)
    ref = solve_many(cpu, B.double().cpu(), ksp_type="bcgs",
                     pc_type="spike", options=Options(dict(opts)), rtol=1e-8)
    err = float((got.x.double().cpu() - ref.x).abs().max()
                / ref.x.abs().max())
    print(f"solve_many small band n=20000 w=41 r=4: card its "
          f"{got.its.tolist()} vs CPU f64 its {ref.its.tolist()}, "
          f"max|x_card - x_cpu| / max|x_cpu| {err:.3e}")
    check(err <= 1e-5 and bool((got.reason == 2).all())
          and bool((ref.reason == 2).all()),
          "solve_many: card and CPU reference disagree")


def operator_launches(fn):
    """(#11, #2) launches of one call of ``fn``: a batched solve's
    operator is one #11 a ``MatMult`` on the band route."""
    reset_launches()
    fn()
    launches = read_launches()
    return launches["band_matvec_many"], launches["band_matvec"]


def device_profile(fn, top=6):
    """(device busy ms of one call of ``fn``, its largest device items):
    the sum of the CUDA activity torch.profiler records (every launch,
    the port's own kernels included)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    items = [e for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    items.sort(key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in items) / 1e3
    return busy, [(e.key[:60], e.count, e.self_device_time_total / 1e3)
                  for e in items[:top]]


def shower(t):
    """A printer that records each (median, spread) time in ``t``."""
    def show(name, ms, gbytes=None):
        t[name] = ms
        rate = f" ({gbytes * 1e3 / ms[0]:.1f} GB/s)" if gbytes else ""
        print(f"time {name}: {ms[0]:.4f} ms median, spread {ms[1]:.4f} ms"
              f"{rate}")
    return show


def phase_timing(band, rhs, sf, device):
    import torch
    from spike_petsc_tpu_torch import Options, make_solver, make_solver_many
    from spike_petsc_tpu_torch.ops.band import banded_matvec
    from spike_petsc_tpu_torch.ops.blocktri import (BlockTridiagonal,
                                                    band_to_blocktri,
                                                    cast_factor)
    from spike_petsc_tpu_torch.ops.cuda import band_matvec as cbm
    from spike_petsc_tpu_torch.ops.cuda import blocktri_matvec as cbt
    from spike_petsc_tpu_torch.ops.cuda import fused_sweep as cfs
    from spike_petsc_tpu_torch.ops.cuda import fused_sweep_many as cfm
    from spike_petsc_tpu_torch.ops.cuda import sweeps as csw
    from spike_petsc_tpu_torch.ops.spike import (spike_factor, spike_solve,
                                                 spike_solve_many)
    from spike_petsc_tpu_torch.solvers.operator import as_matvec_many
    t, bounds = {}, {}
    show = shower(t)

    nbytes = 1 << 30
    src = torch.empty(nbytes, dtype=torch.uint8, device=device)
    dst = torch.empty_like(src)
    show("d2d_copy_1GiB", time_ms(lambda: dst.copy_(src), iters=5),
         2 * nbytes / 1e9)
    del src, dst
    show("factor", time_ms(lambda: spike_factor(
        band, K=K, block_b=BLOCK, store_spikes=True,
        spike_dtype=torch.bfloat16, inverter="newton_fixed"), reps=3))
    show("spike_solve", time_ms(lambda: spike_solve(sf, rhs), iters=5))
    solver = make_solver(band, ksp_type="gmres", pc_type="spike",
                         options=Options(dict(PC_OPTIONS)), rtol=1e-8,
                         restart=30, maxit=30)
    show("gmres_solve", time_ms(lambda: solver(rhs)))

    prep = cbm.prepare_banded_mv(band)
    x = torch.randn(N, device=device)
    mv_gb = (band.n * band.width * 4 + 2 * N * 4) / 1e9
    show("band_matvec_cuda", time_ms(
        lambda: cbm.banded_matvec_prepared(prep, x), iters=20), mv_gb)
    show("band_matvec_plain", time_ms(
        lambda: cbm.banded_matvec_prepared(prep, x, impl="plain"), iters=5),
        mv_gb)
    bounds["band_matvec"] = roofline(band.n * band.width * 4 + 2 * N * 4,
                                     2 * band.n * band.width)
    csr = band_csr(band)
    _, err = kernel_err(csr @ x, cbm.banded_matvec_prepared(prep, x))
    check(err <= KERNEL_TOL, f"CSR product disagrees with the band: {err}")
    show("band_matvec_library", time_ms(lambda: csr @ x, iters=20), mv_gb)
    del csr
    rblk = torch.nn.functional.pad(rhs, (0, K * sf.m - N)).reshape(
        K, sf.nb, BLOCK)
    sms = cfs.device_sms(device)
    plan = cfs.fused_sweep_cluster(K, sf.nb, BLOCK, sms)
    for label, fact in (("f32", sf.fact),
                        ("bf16", cast_factor(sf.fact, torch.bfloat16))):
        gb = sweep_bytes(fact) / 1e9
        show(f"fused_sweep_cuda_{label}", time_ms(
            lambda: cfs.blocktri_solve_fused_cuda(fact, rblk), iters=10), gb)
        show(f"fused_sweep_plain_{label}", time_ms(
            lambda: cfs.blocktri_solve_fused_cuda(fact, rblk, impl="plain"),
            iters=3), gb)
        # #9 on the same factor: the same function in two launches
        show(f"sweeps_cuda_flagship_{label}", time_ms(
            lambda: csw.blocktri_solve_batched_cuda(fact, rblk), iters=10),
            gb)
        bms, bby = sweep_bound(fact)
        ms1, ms9 = (t[f"{k}_{label}"][0] for k in ("fused_sweep_cuda",
                                                   "sweeps_cuda_flagship"))
        print(f"fused_sweep (#1, c={plan}: {K * plan} blocks) against sweeps "
              f"(#9) on the flagship factor ({label}): #1 {ms1:.4f} ms, "
              f"#9 {ms9:.4f} ms; bound {bms:.4f} ms ({bby}), bound / time "
              f"#1 {bms / ms1:.3f}, #9 {bms / ms9:.3f}; #1 before its "
              f"redesign (PERF.md) {FUSED_BEFORE_MS[f'flagship_{label}']} ms")
    bounds["fused_sweep"] = sweep_bound(sf.fact)
    # #4 runs its products on the tensor cores (3xTF32 / 2xTF32)
    bounds["fused_sweep_many"] = sweep_bound(sf.fact, NRHS, PEAK_TF32_FLOPS)
    many_bf16_bound = sweep_bound(cast_factor(sf.fact, torch.bfloat16), NRHS,
                                  PEAK_TF32_FLOPS)

    # serving: the multi-RHS sweep, the solve and the bcgs solve at r = 32
    gen = torch.Generator(device=device).manual_seed(SEED + 9)
    X = torch.randn((N, NRHS), generator=gen, device=device)
    B = banded_matvec(band, X)
    rm = torch.nn.functional.pad(B, (0, 0, 0, K * sf.m - N)).reshape(
        K, sf.nb, BLOCK, NRHS)
    for label, fact in (("f32", sf.fact),
                        ("bf16", cast_factor(sf.fact, torch.bfloat16))):
        gb = sweep_bytes(fact, NRHS) / 1e9
        show(f"fused_sweep_many_cuda_{label}", time_ms(
            lambda: cfm.blocktri_solve_fused_many_cuda(fact, rm), iters=5),
            gb)
        show(f"fused_sweep_many_plain_{label}", time_ms(
            lambda: cfm.blocktri_solve_fused_many_cuda(fact, rm,
                                                       impl="plain"),
            iters=2), gb)
    steps = 3 * sf.nb - 2
    f32_ms, bf16_ms = (t[f"fused_sweep_many_cuda_{d}"][0]
                       for d in ("f32", "bf16"))
    cfgs = {d: cfm.kernel_config(BLOCK, dt) for d, dt in
            (("f32", torch.float32), ("bf16", torch.bfloat16))}
    cfg = cfgs["f32"]
    print(f"fused_sweep_many (flagship: K={K} nb={sf.nb} b={BLOCK} "
          f"r={NRHS}): f32 {f32_ms:.4f} ms, {f32_ms * 1e3 / steps:.3f} us "
          f"per step of {steps}; bf16 {bf16_ms:.4f} ms, "
          f"{bf16_ms * 1e3 / steps:.3f} us per step; cluster "
          f"{cfg['cluster']} blocks of {cfg['cols']} columns, {cfg['warps']} "
          f"consumer warps and 1 producer warp a block, ring depth "
          + ", ".join(f"{c['depth']} matrices ({d})"
                      for d, c in cfgs.items())
          + f"; bound f32 {bounds['fused_sweep_many'][0]:.4f} ms "
          f"({bounds['fused_sweep_many'][1]}), bf16 {many_bf16_bound[0]:.4f} "
          f"ms ({many_bf16_bound[1]}); before the redesign (PERF.md) f32 "
          f"{MANY_BEFORE_MS['f32']} ms, bf16 {MANY_BEFORE_MS['bf16']} ms")
    show("spike_solve_many_r32", time_ms(lambda: spike_solve_many(sf, B),
                                         iters=3))
    print(f"  spike_solve_many per RHS: "
          f"{t['spike_solve_many_r32'][0] / NRHS:.4f} ms "
          f"(spike_solve alone {t['spike_solve'][0]:.4f} ms)")
    for rtol in (1e-8, 1e-4):
        server = make_solver_many(band, ksp_type="bcgs", pc_type="spike",
                                  options=Options(dict(PC_OPTIONS)),
                                  rtol=rtol, maxit=20)
        name = f"serve_bcgs_rtol{rtol:g}"
        show(name, time_ms(lambda: server(B), reps=3))
        print(f"  {name} per RHS: {t[name][0] / NRHS:.4f} ms")
        busy, items = device_profile(lambda: server(B))
        print(f"  {name} device busy {busy:.3f} ms of {t[name][0]:.3f} ms "
              f"wall: idle share {1 - busy / t[name][0]:.3f}; operator "
              "launches a call (#11, #2): "
              f"{operator_launches(lambda: server(B))}")
        for key, count, ms in items:
            print(f"    {ms:8.3f} ms  {count:5d} x  {key}")

    # the operators: the blocktri kernel, its plain version, the band
    # kernel, and the multi-RHS blocktri_many product at r = 32
    T = band_to_blocktri(band, BLOCK)
    bt_gb = (3 * T.D.numel() * 4 + 2 * N * 4) / 1e9
    show("blocktri_matvec_cuda", time_ms(
        lambda: cbt.blocktri_matvec_cuda(T, x), iters=20), bt_gb)
    show("blocktri_matvec_plain", time_ms(
        lambda: cbt.blocktri_matvec_cuda(T, x, impl="plain"), iters=5),
        bt_gb)
    T16 = BlockTridiagonal(D=T.D.bfloat16(), L=T.L.bfloat16(),
                           U=T.U.bfloat16())
    show("blocktri_matvec_cuda_bf16", time_ms(
        lambda: cbt.blocktri_matvec_cuda(T16, x), iters=20), bt_gb / 2)
    del T16
    bounds["blocktri_matvec"] = roofline(3 * T.D.numel() * 4 + 2 * N * 4,
                                         2 * 3 * T.D.numel())
    bsr = blocktri_bsr(T)
    xp = torch.nn.functional.pad(x, (0, T.nb * T.b - N))
    _, err = kernel_err((bsr @ xp)[:N], cbt.blocktri_matvec_cuda(T, x))
    check(err <= KERNEL_TOL, f"BSR product disagrees with the blocks: {err}")
    show("blocktri_matvec_library", time_ms(lambda: bsr @ xp, iters=20),
         bt_gb)
    del bsr
    mv_many = as_matvec_many(band, impl="blocktri")[0]
    show("blocktri_many_r32", time_ms(lambda: mv_many(X), iters=5),
         (3 * T.D.numel() * 4 + 2 * N * NRHS * 4) / 1e9)
    return t, bounds


def phase_band_many(device, t, bounds, errs):
    """#11 at n = N, r = NRHS, each width of ``BAND_MANY_SHAPES``: against
    its plain version and the column loop of #2 (each column bit-equal),
    timed beside its bound, its plain version and the two routes it
    replaces (#2 column by column with a stack, as the column loop
    ``vmap_banded_cuda`` ran it, and ``blocktri_many``);
    at w = 201 also with bf16 storage.  Times go into ``t`` as
    ``band_matvec_many_<route>_w<w>``."""
    import torch
    from spike_petsc_tpu_torch import BandedMatrix
    from spike_petsc_tpu_torch.ops.cuda import band_matvec as cbm
    from spike_petsc_tpu_torch.ops.cuda import band_matvec_many as cbmm
    from spike_petsc_tpu_torch.solvers.operator import as_matvec_many
    show = shower(t)
    gen = torch.Generator(device=device).manual_seed(SEED + 41)
    X = torch.randn((N, NRHS), generator=gen, device=device)
    for kl, ku in BAND_MANY_SHAPES:
        w = kl + ku + 1
        band = BandedMatrix(data=torch.randn((N, w), generator=gen,
                                             device=device), kl=kl, ku=ku)
        prep = cbm.prepare_banded_mv(band)
        got = cbmm.banded_matvec_many_prepared(prep, X)

        def loop(X):
            return torch.stack([cbm.banded_matvec_prepared(
                prep, X[:, j].contiguous()) for j in range(X.shape[1])],
                dim=1)
        _, err = kernel_err(got, cbmm.banded_matvec_many_prepared(
            prep, X, impl="plain"))
        errs["band_matvec_many"] = max(errs.get("band_matvec_many", 0.0),
                                       err)
        equal = bool(torch.equal(got, loop(X)))
        plan = cbmm.band_many_plan(kl, ku, 4)
        print(f"band_matvec_many w={w} r={NRHS}: plan {plan}, against its "
              f"plain version {err:.3e}, columns equal to #2's: {equal}")
        check(err <= KERNEL_TOL, f"#11 against its plain version at w={w}: "
              f"{err}")
        check(equal, f"#11's columns differ from #2's at w={w}")
        nbytes = N * w * 4 + 2 * N * NRHS * 4
        bounds[f"band_matvec_many_w{w}"] = roofline(nbytes,
                                                    2 * N * w * NRHS)
        gb = nbytes / 1e9
        show(f"band_matvec_many_cuda_w{w}", time_ms(
            lambda: cbmm.banded_matvec_many_prepared(prep, X), iters=20), gb)
        show(f"band_matvec_many_plain_w{w}", time_ms(
            lambda: cbmm.banded_matvec_many_prepared(prep, X, impl="plain"),
            reps=3), gb)
        show(f"band_matvec_many_loop_w{w}", time_ms(lambda: loop(X),
                                                    iters=3), gb)
        blocks = as_matvec_many(band, impl="blocktri")[0]
        show(f"band_matvec_many_blocktri_w{w}", time_ms(lambda: blocks(X),
                                                        iters=5), gb)
        del blocks
        if w == 201:
            p16 = cbm.prepare_banded_mv(BandedMatrix(
                data=band.data.bfloat16(), kl=kl, ku=ku))
            nb16 = N * w * 2 + 2 * N * NRHS * 4
            bounds["band_matvec_many_w201_bf16"] = roofline(
                nb16, 2 * N * w * NRHS)
            show("band_matvec_many_cuda_w201_bf16", time_ms(
                lambda: cbmm.banded_matvec_many_prepared(p16, X), iters=20),
                nb16 / 1e9)
            del p16
        ms = t[f"band_matvec_many_cuda_w{w}"][0]
        bms, by = bounds[f"band_matvec_many_w{w}"]
        print(f"  #11 w={w}: {ms:.4f} ms, bound {bms:.4f} ms ({by}), "
              f"time / bound {ms / bms:.2f}; column loop "
              f"{t[f'band_matvec_many_loop_w{w}'][0]:.4f} ms, blocktri_many "
              f"{t[f'band_matvec_many_blocktri_w{w}'][0]:.4f} ms")
        del band, prep
        torch.cuda.empty_cache()
    bounds["band_matvec_many"] = bounds["band_matvec_many_w201"]


def spd_factor(band, K=SPD_K):
    """The config-2 factor the cholesky PC builds from SPD_OPTIONS."""
    from spike_petsc_tpu_torch.ops.spike import spike_factor
    return spike_factor(band, K=K, block_b=SPD_BLOCK, method="spd",
                        truncated=True, store_spikes=True)


def phase_reduced(sf, device, t, bounds, errs):
    """The reduced-system kernel (``csrc/reduced_thomas.cu``) on the
    flagship's own reduced factor ([K - 1, 2k, 2k] = [63, 200, 200], f32)
    at r = 32 and r = 1: against the plain loop (``blocktri_solve``) within
    ``REDUCED_TOL`` of max|plain|; the device time a launch (``ITERS``
    launches queued back to back), the plain loop's call (host-paced, as in
    the PC apply), and the bound by ``sweep_bytes`` of the reduced factor."""
    import torch
    from spike_petsc_tpu_torch.ops.blocktri import (BlockTriFactor,
                                                    blocktri_solve)
    from spike_petsc_tpu_torch.ops.cuda import reduced_thomas as crt
    show = shower(t)
    fact = sf.red_fact
    nb, B = fact.F.shape[0], fact.F.shape[-1]
    check(crt.reduced_thomas_feasible(fact, torch.empty((nb, B, NRHS),
                                                        device=device)),
          f"the flagship's reduced factor is not the kernel's: "
          f"{type(fact).__name__} {tuple(fact.F.shape)}")
    as4 = BlockTriFactor(F=fact.F[None], U=fact.U[None],
                         Sinv=fact.Sinv[None])
    gen = torch.Generator(device=device).manual_seed(SEED + 24)
    for r in (NRHS, 1):
        rhs = torch.randn((nb, B, r), generator=gen, device=device)
        if r == 1:
            rhs = rhs[..., 0]
        diff, err = kernel_err(crt.blocktri_solve_reduced_cuda(fact, rhs),
                               blocktri_solve(fact, rhs))
        print(f"reduced_thomas flagship [{nb}, {B}, {B}] r={r}: max abs err "
              f"{diff:.3e}, relative {err:.3e}")
        check(err <= REDUCED_TOL, f"reduced_thomas r={r} err {err}")
        errs["reduced_thomas"] = max(errs.get("reduced_thomas", 0.0), diff)
        plan = crt.reduced_thomas_plan(B, r)
        x = torch.empty_like(rhs)
        gb = sweep_bytes(as4, r) / 1e9
        label = "f32" if r == NRHS else "f32_r1"
        show(f"reduced_thomas_cuda_{label}", time_ms(
            lambda: crt._launch(fact, rhs, x, r, plan),
            iters=ITERS_REDUCED), gb)
        show(f"reduced_thomas_call_{label}", time_ms(
            lambda: crt.blocktri_solve_reduced_cuda(fact, rhs)), gb)
        show(f"reduced_thomas_plain_{label}", time_ms(
            lambda: blocktri_solve(fact, rhs)), gb)
        bms, bby = sweep_bound(as4, r)
        print(f"reduced_thomas r={r} (plan {plan}): kernel "
              f"{t[f'reduced_thomas_cuda_{label}'][0]:.4f} ms a launch, "
              f"{t[f'reduced_thomas_call_{label}'][0]:.4f} a call; plain loop "
              f"{t[f'reduced_thomas_plain_{label}'][0]:.4f} ms a call; bound "
              f"{bms:.4f} ms ({bby})")
    bounds["reduced_thomas"] = sweep_bound(as4, NRHS)


def phase_spd_kernels(rhs, ssf, device):
    """The symmetric sweeps (#3, #5) against their plain versions: the
    config-2 factor in f32 and bf16, and an nb = 1 factor."""
    import torch
    from spike_petsc_tpu_torch.ops.blocktri import cast_factor
    from spike_petsc_tpu_torch.ops.cuda import fused_sweep_many_spd as cfms
    from spike_petsc_tpu_torch.ops.cuda import fused_sweep_spd as cfss
    errs = {}
    gen = torch.Generator(device=device).manual_seed(SEED + 11)
    small_band, _ = spd_band(SPD_K * SPD_BLOCK, SPD_HALF_BW, device,
                             seed=SEED + 12)
    small = spd_factor(small_band)
    check(small.nb == 1, "small spd factor must have nb = 1")
    f16 = cast_factor(ssf.fact, torch.bfloat16)
    rblk = torch.nn.functional.pad(rhs, (0, SPD_K * ssf.m - SPD_N)).reshape(
        SPD_K, ssf.nb, SPD_BLOCK)
    for label, fact, r in (
            ("config-2 f32", ssf.fact, rblk), ("config-2 bf16", f16, rblk),
            ("nb=1 f32", small.fact, torch.randn(
                (SPD_K, 1, SPD_BLOCK), generator=gen, device=device))):
        diff, err = kernel_err(
            cfss.blocktri_solve_fused_spd_cuda(fact, r),
            cfss.blocktri_solve_fused_spd_cuda(fact, r, impl="plain"))
        torch.cuda.synchronize()
        print(f"fused_sweep_spd {label} {tuple(fact.F.shape)}: max abs err "
              f"{diff:.3e}, relative {err:.3e}")
        check(err <= KERNEL_TOL, f"fused_sweep_spd {label} err {err}")
        errs.setdefault("fused_sweep_spd", diff)
    for label, fact, nb, r in (
            ("config-2 f32 r=32", ssf.fact, ssf.nb, NRHS),
            ("config-2 bf16 r=32", f16, ssf.nb, NRHS),
            ("config-2 f32 r=1", ssf.fact, ssf.nb, 1),
            ("config-2 bf16 r=100", f16, ssf.nb, 100),
            ("config-2 f32 r=100", ssf.fact, ssf.nb, 100),
            ("nb=1 f32 r=32", small.fact, 1, NRHS)):
        rm = torch.randn((SPD_K, nb, SPD_BLOCK, r), generator=gen,
                         device=device)
        diff, err = kernel_err(
            cfms.blocktri_solve_fused_many_spd_cuda(fact, rm),
            cfms.blocktri_solve_fused_many_spd_cuda(fact, rm, impl="plain"))
        torch.cuda.synchronize()
        print(f"fused_sweep_many_spd {label} {tuple(fact.F.shape)}: max abs "
              f"err {diff:.3e}, relative {err:.3e}")
        check(err <= KERNEL_TOL, f"fused_sweep_many_spd {label} err {err}")
        errs.setdefault("fused_sweep_many_spd", diff)
    return errs


def phase_spd_main_path(band, rhs):
    """``solve(A, b, ksp_type="cg", pc_type="cholesky")`` on config 2,
    launch counts read around it."""
    import torch
    from spike_petsc_tpu_torch import Options, solve
    from spike_petsc_tpu_torch.ops.band import banded_matvec
    from spike_petsc_tpu_torch.solvers.types import CONVERGED_RTOL, reason_str
    reset_launches()
    res = solve(band, rhs, ksp_type="cg", pc_type="cholesky",
                options=Options(dict(SPD_OPTIONS)), rtol=1e-8, maxit=50)
    launches = read_launches()
    true_rel = float(torch.linalg.norm(banded_matvec(band, res.x) - rhs)
                     / torch.linalg.norm(rhs))
    xerr = float((res.x - 1).abs().max())
    print(f"cg+cholesky (config 2): {res.its} its, {reason_str(res.reason)}, "
          f"rnorm/||b|| {res.rnorm / float(torch.linalg.norm(rhs)):.3e}, "
          f"true relres (f32) {true_rel:.3e}, max|x - 1| {xerr:.3e}")
    print(f"launches on the cg path: {launches}")
    check(res.reason == CONVERGED_RTOL and res.its <= CG_ITS_MAX,
          f"cg: {res.its} its, reason {res.reason}")
    check(res.x.shape == (SPD_N,) and bool(torch.isfinite(res.x).all()),
          "cg solution shape / finiteness")
    check(xerr <= 1e-3 and true_rel <= 1e-4, "cg solution accuracy")
    check(launches["band_matvec"] > 0,
          f"the band kernel did not run on the cg path: {launches}")
    # one PC apply before the loop and one an iteration
    check(launches["fused_sweep_spd"] == res.its + 1,
          f"the spd sweep ran {launches['fused_sweep_spd']} times on cg, "
          f"expected {res.its + 1}")
    return launches


def phase_spd_serving(band, device):
    """Serving config 2 through ``solve_many``: 32 seeded right-hand sides
    B = A X, cg + cholesky at rtol 1e-8."""
    import torch
    from spike_petsc_tpu_torch import Options, solve_many
    from spike_petsc_tpu_torch.ops.band import banded_matvec
    from spike_petsc_tpu_torch.solvers.operator import as_matvec_many
    from spike_petsc_tpu_torch.solvers.types import CONVERGED_RTOL
    gen = torch.Generator(device=device).manual_seed(SEED + 13)
    X = torch.randn((SPD_N, NRHS), generator=gen, device=device)
    B = banded_matvec(band, X)
    route = as_matvec_many(band)[0]._route
    print(f"cg serving operator route: {route}")
    check(route == "banded_cuda_many", f"cg serving operator route {route}")
    reset_launches()
    res = solve_many(band, B, ksp_type="cg", pc_type="cholesky",
                     options=Options(dict(SPD_OPTIONS)), rtol=1e-8, maxit=50)
    launches = read_launches()
    relres = (torch.linalg.norm(banded_matvec(band, res.x) - B, dim=0)
              / torch.linalg.norm(B, dim=0))
    its = res.its.tolist()
    print(f"cg+cholesky serving r={NRHS} rtol=1e-08: its min {min(its)} "
          f"max {max(its)}, reasons {sorted(set(res.reason.tolist()))}, "
          f"per-column true relres (f32) max {float(relres.max()):.3e}, "
          f"max|x - X| {float((res.x - X).abs().max()):.3e}; "
          f"launches {launches}")
    check(res.x.shape == (SPD_N, NRHS) and bool(torch.isfinite(res.x).all()),
          "cg serving solution shape / finiteness")
    check(bool((res.reason == CONVERGED_RTOL).all()),
          f"cg serving reasons {res.reason.tolist()}")
    check(float(relres.max()) <= SERVE_RELRES_MAX,
          f"cg serving relres {float(relres.max())}")
    check(min(its) == max(its) == CG_SERVE_ITS,
          f"cg serving: its {its}, expected {CG_SERVE_ITS} in every column")
    # one PC apply before the loop and one an iteration
    check(launches["fused_sweep_many_spd"] == CG_SERVE_ITS + 1,
          f"the spd multi-RHS sweep ran {launches['fused_sweep_many_spd']} "
          f"times on cg serving, expected {CG_SERVE_ITS + 1}")
    check(launches["band_matvec_many"] > 0,
          f"#11 did not run on cg serving: {launches}")
    return launches


def phase_spd_reference(device):
    """cg + cholesky on a small SPD band on the card (kernels, f32) and on
    the CPU (plain versions, f64): the solutions must agree."""
    from spike_petsc_tpu_torch import BandedMatrix, Options, solve
    band, rhs = spd_band(20_000, SPD_HALF_BW, device, seed=SEED + 14)
    got = solve(band, rhs, ksp_type="cg", pc_type="cholesky",
                options=Options(dict(SPD_OPTIONS)), rtol=1e-8)
    cpu = BandedMatrix(data=band.data.double().cpu(), kl=SPD_HALF_BW,
                       ku=SPD_HALF_BW)
    ref = solve(cpu, rhs.double().cpu(), ksp_type="cg", pc_type="cholesky",
                options=Options(dict(SPD_OPTIONS)), rtol=1e-8)
    err = float((got.x.double().cpu() - ref.x).abs().max()
                / ref.x.abs().max())
    print(f"cg+cholesky small band n=20000 w=33: card {got.its} its vs CPU "
          f"f64 {ref.its} its, max|x_card - x_cpu| / max|x_cpu| {err:.3e}")
    check(err <= 1e-5 and got.reason == ref.reason == 2,
          "cg: card and CPU reference disagree")
    # no options: one partition, and on the card the block the kernel takes
    before = read_launches()["fused_sweep_spd"]
    got = solve(band, rhs, ksp_type="cg", pc_type="cholesky", rtol=1e-8)
    ran = read_launches()["fused_sweep_spd"] - before
    ref = solve(cpu, rhs.double().cpu(), ksp_type="cg", pc_type="cholesky",
                rtol=1e-8)
    err = float((got.x.double().cpu() - ref.x).abs().max()
                / ref.x.abs().max())
    print(f"cg+cholesky default options n=20000: card {got.its} its "
          f"(fused_sweep_spd {ran} launches) vs CPU f64 {ref.its} its, "
          f"max|x_card - x_cpu| / max|x_cpu| {err:.3e}")
    check(err <= 1e-5 and got.reason == ref.reason == 2 and ran > 0,
          "cg + cholesky with default options")


def phase_spd_timing(band, rhs, ssf, device):
    import torch
    from spike_petsc_tpu_torch import Options, make_solver, make_solver_many
    from spike_petsc_tpu_torch.ops.band import banded_matvec
    from spike_petsc_tpu_torch.ops.blocktri import cast_factor
    from spike_petsc_tpu_torch.ops.cuda import fused_sweep_many_spd as cfms
    from spike_petsc_tpu_torch.ops.cuda import fused_sweep_spd as cfss
    from spike_petsc_tpu_torch.ops.spike import spike_solve, spike_solve_many
    t, bounds = {}, {}
    show = shower(t)
    show("spd_factor", time_ms(lambda: spd_factor(band), reps=3))
    show("cholesky_spike_solve", time_ms(lambda: spike_solve(ssf, rhs),
                                         iters=5))
    solver = make_solver(band, ksp_type="cg", pc_type="cholesky",
                         options=Options(dict(SPD_OPTIONS)), rtol=1e-8,
                         maxit=50)
    show("cg_solve", time_ms(lambda: solver(rhs)))
    busy, items = device_profile(lambda: solver(rhs))
    print(f"  cg_solve device busy {busy:.3f} ms of {t['cg_solve'][0]:.3f} "
          f"ms wall: idle share {1 - busy / t['cg_solve'][0]:.3f}")
    for key, count, ms in items:
        print(f"    {ms:8.3f} ms  {count:5d} x  {key}")

    rblk = torch.nn.functional.pad(rhs, (0, SPD_K * ssf.m - SPD_N)).reshape(
        SPD_K, ssf.nb, SPD_BLOCK)
    gen = torch.Generator(device=device).manual_seed(SEED + 15)
    X = torch.randn((SPD_N, NRHS), generator=gen, device=device)
    B = banded_matvec(band, X)
    rm = torch.nn.functional.pad(B, (0, 0, 0, SPD_K * ssf.m - SPD_N)).reshape(
        SPD_K, ssf.nb, SPD_BLOCK, NRHS)
    for label, fact in (("f32", ssf.fact),
                        ("bf16", cast_factor(ssf.fact, torch.bfloat16))):
        gb = sweep_bytes(fact) / 1e9
        show(f"fused_sweep_spd_cuda_{label}", time_ms(
            lambda: cfss.blocktri_solve_fused_spd_cuda(fact, rblk),
            iters=5), gb)
        show(f"fused_sweep_spd_plain_{label}", time_ms(
            lambda: cfss.blocktri_solve_fused_spd_cuda(fact, rblk,
                                                       impl="plain"),
            reps=3), gb)
        show(f"fused_sweep_many_spd_cuda_{label}", time_ms(
            lambda: cfms.blocktri_solve_fused_many_spd_cuda(fact, rm),
            iters=3), gb)
        show(f"fused_sweep_many_spd_plain_{label}", time_ms(
            lambda: cfms.blocktri_solve_fused_many_spd_cuda(fact, rm,
                                                            impl="plain"),
            reps=3), gb)
    bounds["fused_sweep_spd"] = sweep_bound(ssf.fact)
    bounds["fused_sweep_many_spd"] = sweep_bound(ssf.fact, NRHS)
    steps = 2 * ssf.nb - 1
    cfg = cfss.kernel_config(SPD_BLOCK)
    f32_ms, bf16_ms = (t[f"fused_sweep_spd_cuda_{d}"][0]
                       for d in ("f32", "bf16"))
    print(f"fused_sweep_spd (config 2: K={SPD_K} nb={ssf.nb} "
          f"b={SPD_BLOCK}): f32 {f32_ms:.4f} ms, "
          f"{f32_ms * 1e3 / steps:.3f} us per step of {steps}; bf16 "
          f"{bf16_ms:.4f} ms, {bf16_ms * 1e3 / steps:.3f} us per step; "
          f"cluster {cfg['cluster']} blocks, {cfg['compute_warps']} compute "
          f"and {cfg['copy_warps']} copy warps a block, ring depth "
          f"{cfg['depth']} slots of {cfg['steps_per_slot']} steps; bound "
          f"{bounds['fused_sweep_spd'][0]:.4f} ms "
          f"({bounds['fused_sweep_spd'][1]}); before the redesign "
          f"(PERF.md) f32 {SPD_BEFORE_MS['f32']} ms, bf16 "
          f"{SPD_BEFORE_MS['bf16']} ms")
    cfg = cfms.kernel_config(SPD_BLOCK)
    f32_ms, bf16_ms = (t[f"fused_sweep_many_spd_cuda_{d}"][0]
                       for d in ("f32", "bf16"))
    print(f"fused_sweep_many_spd (config 2: K={SPD_K} nb={ssf.nb} "
          f"b={SPD_BLOCK} r={NRHS}): f32 {f32_ms:.4f} ms, "
          f"{f32_ms * 1e3 / steps:.3f} us per step of {steps}; bf16 "
          f"{bf16_ms:.4f} ms; cluster {cfg['cluster']} blocks, "
          f"{cfg['cols']} columns per cluster, ring depth {cfg['depth']}; "
          f"bound {bounds['fused_sweep_many_spd'][0]:.4f} ms "
          f"({bounds['fused_sweep_many_spd'][1]}); before the redesign "
          f"(PERF.md) f32 {MANY_SPD_BEFORE_MS['f32']} ms, bf16 "
          f"{MANY_SPD_BEFORE_MS['bf16']} ms")
    show("cholesky_spike_solve_many_r32",
         time_ms(lambda: spike_solve_many(ssf, B), iters=3))
    server = make_solver_many(band, ksp_type="cg", pc_type="cholesky",
                              options=Options(dict(SPD_OPTIONS)), rtol=1e-8,
                              maxit=50)
    show("serve_cg_r32", time_ms(lambda: server(B), reps=3))
    print(f"  serve_cg_r32 per RHS: {t['serve_cg_r32'][0] / NRHS:.4f} ms")
    busy, items = device_profile(lambda: server(B))
    print(f"  serve_cg_r32 device busy {busy:.3f} ms of "
          f"{t['serve_cg_r32'][0]:.3f} ms wall: idle share "
          f"{1 - busy / t['serve_cg_r32'][0]:.3f}; operator launches a call "
          f"(#11, #2): {operator_launches(lambda: server(B))}")
    for key, count, ms in items:
        print(f"    {ms:8.3f} ms  {count:5d} x  {key}")
    return t, bounds


def phase_alternate_kernels(band, rhs, sf, device):
    """The kernels of the refinement path and of the alternate sweep and
    matvec against their plain versions: the f64 band matvec (#6) on the
    flagship band in f64 and on a ragged band, and both against an f64 CSR
    product of the band; the two-pass sweeps (#9) on the flagship factor
    in f32 and bf16 and at nb = 1 (one block a partition, C = 1), and at
    the shapes where its plan chunks each partition (C > 1): config 1's
    factor (K = 1, nb = 1563, b = 64), K = 1 at b = 128 with nb = 301
    (ragged chunks), K = 2 and K = 4, each in f32 and bf16; the grid
    block-tridiagonal matvec (#8) on the flagship conversion and at a
    ragged nb."""
    import torch
    from spike_petsc_tpu_torch import BandedMatrix
    from spike_petsc_tpu_torch.ops.blocktri import (BlockTridiagonal,
                                                    band_to_blocktri,
                                                    cast_factor)
    from spike_petsc_tpu_torch.ops.cuda import band_matvec_f64 as cbm64
    from spike_petsc_tpu_torch.ops.cuda import blocktri_matvec_grid as cgrid
    from spike_petsc_tpu_torch.ops.cuda import sweeps as csw
    from spike_petsc_tpu_torch.ops.spike import spike_factor
    errs = {}
    gen = torch.Generator(device=device).manual_seed(SEED + 21)
    band64 = BandedMatrix(data=band.data.double(), kl=band.kl, ku=band.ku)
    ragged = BandedMatrix(
        data=torch.rand((100_003, 231), generator=gen, device=device,
                        dtype=torch.float64) - 0.5, kl=150, ku=80)
    for label, bm in (("flagship f64 n=1e6 w=201", band64),
                      ("ragged f64 n=100003 kl=150 ku=80", ragged)):
        prep = cbm64.prepare_banded_mv_f64(bm)
        x = torch.randn(bm.n, generator=gen, device=device,
                        dtype=torch.float64)
        got = cbm64.banded_matvec_prepared_f64(prep, x)
        plain = cbm64.banded_matvec_prepared_f64(prep, x, impl="plain")
        diff, err = kernel_err(got, plain)
        csr = band_csr(bm)
        lib = csr @ x
        _, err_csr = kernel_err(got, lib)
        _, err_plain_csr = kernel_err(plain, lib)
        torch.cuda.synchronize()
        del prep, csr
        print(f"band_matvec_f64 {label}: max abs err {diff:.3e}, relative "
              f"{err:.3e}; against the f64 CSR product: kernel "
              f"{err_csr:.3e}, plain {err_plain_csr:.3e}")
        check(err <= F64_KERNEL_TOL, f"band_matvec_f64 {label} err {err}")
        check(err_csr <= F64_CSR_TOL and err_plain_csr <= F64_CSR_TOL,
              f"band_matvec_f64 {label} against CSR: {err_csr}, "
              f"{err_plain_csr}")
        errs.setdefault("band_matvec_f64", diff)
    del band64, ragged

    small_band, _ = flagship_band(K * BLOCK, 50, device, seed=SEED + 22)
    small = spike_factor(small_band, K=K, block_b=BLOCK, inverter="lapack")
    check(small.nb == 1, "small factor must have nb = 1")
    rblk = torch.nn.functional.pad(rhs, (0, K * sf.m - N)).reshape(
        K, sf.nb, BLOCK)
    lap = laplacian_factor(CONFIG1_N, device).fact
    cases = [
        ("flagship f32", sf.fact, rblk, False),
        ("flagship bf16", cast_factor(sf.fact, torch.bfloat16), rblk, False),
        ("nb=1 f32", small.fact,
         torch.randn((K, 1, BLOCK), generator=gen, device=device), False),
        ("config 1 f32", lap, None, True),
        ("config 1 bf16", cast_factor(lap, torch.bfloat16), None, True)]
    for k, nb, b, hw in SWEEPS_CHUNKED_SHAPES:
        band_c, _ = flagship_band(k * nb * b, hw, device, seed=SEED + nb + k)
        fact_c = spike_factor(band_c, K=k, block_b=b).fact
        cases += [(f"K={k} nb={nb} b={b} f32", fact_c, None, True),
                  (f"K={k} nb={nb} b={b} bf16",
                   cast_factor(fact_c, torch.bfloat16), None, True)]
    sms = csw.device_sms(device)
    for label, fact, r, chunked in cases:
        k, nb, b, _ = fact.F.shape
        if r is None:
            r = torch.randn((k, nb, b), generator=gen, device=device)
        C = csw.sweeps_chunks(k, nb, b, sms)
        diff, err = kernel_err(
            csw.blocktri_solve_batched_cuda(fact, r),
            csw.blocktri_solve_batched_cuda(fact, r, impl="plain"))
        torch.cuda.synchronize()
        print(f"sweeps {label} {tuple(fact.F.shape)}: C={C} chunks a "
              f"partition ({'ragged' if nb % C else 'even'}), {k * C} "
              f"blocks; max abs err {diff:.3e}, relative {err:.3e}")
        check(err <= KERNEL_TOL, f"sweeps {label} err {err}")
        check((C > 1) == chunked and k * C <= sms,
              f"sweeps {label}: plan C={C} on {sms} SMs")
        errs.setdefault("sweeps", diff)
    check(any(nb % csw.sweeps_chunks(k, nb, b, sms)
              for k, nb, b, _ in SWEEPS_CHUNKED_SHAPES),
          "no chunked shape is ragged under its plan")
    del lap, cases

    ragged_bt = BandedMatrix(
        data=torch.rand((100_003, 198), generator=gen, device=device) - 0.5,
        kl=120, ku=77)
    T = band_to_blocktri(band, BLOCK)
    for label, t in (
            ("flagship f32", T),
            ("flagship bf16", BlockTridiagonal(
                D=T.D.bfloat16(), L=T.L.bfloat16(), U=T.U.bfloat16())),
            ("ragged nb=782 (nb % kt = 6) f32",
             band_to_blocktri(ragged_bt, BLOCK))):
        x = torch.randn((t.nb, BLOCK), generator=gen, device=device)
        diff, err = kernel_err(
            cgrid.blocktri_matvec_pallas(t, x, kt=GRID_KT),
            cgrid.blocktri_matvec_pallas(t, x, kt=GRID_KT, impl="plain"))
        torch.cuda.synchronize()
        print(f"blocktri_matvec_grid kt={GRID_KT} {label} "
              f"{tuple(t.D.shape)}: max abs err {diff:.3e}, relative "
              f"{err:.3e}")
        check(err <= KERNEL_TOL, f"blocktri_matvec_grid {label} err {err}")
        errs.setdefault("blocktri_matvec_grid", diff)
    return errs


def f64_band(band):
    """The flagship's data in f64 and b64 = A64 @ 1 (the plain f64 route)."""
    import torch
    from spike_petsc_tpu_torch import BandedMatrix
    from spike_petsc_tpu_torch.ops.band import banded_matvec
    a64 = BandedMatrix(data=band.data.double(), kl=band.kl, ku=band.ku)
    return a64, banded_matvec(a64, torch.ones(a64.n, dtype=torch.float64,
                                              device=a64.device))


def capture(fn, *args, **kwargs):
    """(return value, standard output) of ``fn(*args, **kwargs)``."""
    import contextlib
    import io
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rv = fn(*args, **kwargs)
    return rv, out.getvalue()


def run_testbed(argv, record, entry=None):
    """``spike_petsc_tpu_torch.testbed.main(argv)`` (or ``entry``, e.g.
    ``testbed2.main``) in this process, its standard output captured:
    (exit code, output)."""
    from spike_petsc_tpu_torch import testbed
    from spike_petsc_tpu_torch.utils import profiling
    profiling.clear()
    return capture(entry or testbed.main, argv, record=record)


def phase_config3(device):
    """BASELINE config 3 end to end through the testbed CLI at n = 1e6:
    the host pre-pass (MC64 scaling and permutation, RCM, the banded
    extraction), then bcgs with the banded PC on the card; the launches of
    #2 and #1 counted around the run and held to what bcgs makes: per
    iteration two operator applies and two PC applies, each PC apply two
    sweeps (the spikes are not stored, so the correction sweeps again),
    and one operator apply for the final residual (x0 = 0 needs none
    first)."""
    import re
    import torch
    from spike_petsc_tpu_torch.native import loader
    from spike_petsc_tpu_torch.ops.band import banded_matvec
    from spike_petsc_tpu_torch.solvers.types import CONVERGED_RTOL
    rec = {}
    t0 = time.perf_counter()
    reset_launches()
    rc, out = run_testbed(CONFIG3_ARGV, rec)
    launches = read_launches()
    wall = time.perf_counter() - t0
    for line in out.splitlines():
        print(f"  testbed| {line}")
    engine = loader.engine()
    print(f"config 3: testbed exit code {rc}, {wall:.2f} s in all; "
          f"matching engine: {engine}")
    check(rc == 0, f"config 3 testbed exit code {rc}")
    check(engine == "native", "the native matching engine did not load")
    bws = re.findall(r"(?:Reduced|Increased) bandwidth from (\d+) to (\d+)",
                     out)
    check(len(bws) == 2 and int(bws[0][1]) == 6 and int(bws[1][1]) == 6
          and "Reduced bandwidth from" in out.split("using rcm")[0],
          f"config 3 bandwidths after wbm and rcm: {bws}")
    check("Bandwidth of 100% band: 6 " in out, "config 3 extracted band")
    check("Device operator: band storage kl=6 ku=6" in out,
          "config 3 device operator")
    res, op, b = rec["result"], rec["operator"], rec["b"]
    err = float(out.split("Error in solution:")[1].split()[0])
    true_rel = float(torch.linalg.norm(banded_matvec(op, res.x) - b)
                     / torch.linalg.norm(b))
    expected = {name: 0 for name in launches}
    expected["band_matvec"] = 2 * res.its + 1
    expected["fused_sweep"] = 2 * 2 * res.its
    expected["reduced_thomas"] = 2 * res.its     # one a PC apply
    print(f"bcgs+banded (config 3, n={op.n}): {res.its} its, reason "
          f"{res.reason}, true relres (f32) {true_rel:.3e}, error in "
          f"solution {err:g} (TPU v5e yardstick: 2 its, relres 8.6e-8)")
    print(f"launches on the config-3 path: {launches}")
    print(f"expected launches (bcgs: {res.its} its x (2 operator + 2 PC "
          f"applies of 2 sweeps) + 1 final residual): {expected}")
    check(res.reason == CONVERGED_RTOL and res.its <= CONFIG3_ITS_MAX,
          f"config 3 bcgs: {res.its} its, reason {res.reason}")
    check(res.x.shape == (op.n,) and bool(torch.isfinite(res.x).all()),
          "config 3 solution shape / finiteness")
    check(true_rel <= CONFIG3_RELRES_MAX, f"config 3 relres {true_rel}")
    check(launches == expected, f"config 3 launches {launches}")
    return rec, launches


def phase_config3_reference(device):
    """The config-3 pipeline at n = 20000 (partitions 8, block 128) on the
    card in f32 with the kernels and on the CPU in f64: the iteration
    counts within 1, the solutions (the same permuted system) within
    CONFIG3_REF_TOL."""
    argv = [a.replace("1000000", "20000") for a in CONFIG3_ARGV]
    argv[argv.index("-banded_pc_spike_partitions") + 1] = "8"
    got, ref = {}, {}
    rc_card, _ = run_testbed(argv, got)
    rc_cpu, _ = run_testbed(argv + ["-x64", "1", "-platform", "cpu"], ref)
    xg, xr = got["result"].x, ref["result"].x
    err = float((xg.double().cpu() - xr).abs().max() / xr.abs().max())
    print(f"config 3 n=20000: card f32 {got['result'].its} its vs CPU f64 "
          f"{ref['result'].its} its, max|x_card - x_cpu| / max|x_cpu| "
          f"{err:.3e} (limit {CONFIG3_REF_TOL})")
    check(rc_card == rc_cpu == 0 and xg.is_cuda and not xr.is_cuda
          and xr.dtype.itemsize == 8, "config 3 reference runs")
    check(abs(got["result"].its - ref["result"].its) <= 1
          and err <= CONFIG3_REF_TOL,
          "config 3: card and CPU reference disagree")


def phase_config3_timing(rec, device, t):
    """The config-3 factor (the extracted band, K = 64, b = 128) and the
    bcgs solve, by CUDA events; the solve's device busy time; #1 and #2
    against their plain versions on this path's inputs; #2 at w = 13 beside
    its bound and the CSR product."""
    import torch
    from spike_petsc_tpu_torch import BandedMatrix, Options, make_solver
    from spike_petsc_tpu_torch import sparse as hsp
    from spike_petsc_tpu_torch.ops.cuda import band_matvec as cbm
    from spike_petsc_tpu_torch.ops.cuda import fused_sweep as cfs
    from spike_petsc_tpu_torch.ops.spike import spike_factor
    show = shower(t)
    op, pmat, b = rec["operator"], rec["pmat"], rec["b"]
    ext = hsp.extract_banded(pmat, kmax=50, frac=0.9999)
    data, kl, ku = hsp.csr_to_banded_arrays(ext.matrix, kl=ext.k, ku=ext.k)
    band = BandedMatrix(data=torch.as_tensor(data, dtype=torch.float32,
                                             device=device), kl=kl, ku=ku)
    show("config3_factor", time_ms(lambda: spike_factor(
        band, K=CONFIG3_K, block_b=CONFIG3_BLOCK), reps=3))
    solver = make_solver(op, pmat=pmat, options=Options.from_argv(
        CONFIG3_ARGV))
    show("config3_bcgs_solve", time_ms(lambda: solver(b), reps=3))
    busy, items = device_profile(lambda: solver(b))
    wall = t["config3_bcgs_solve"][0]
    print(f"  config3_bcgs_solve device busy {busy:.3f} ms of {wall:.3f} ms "
          f"wall: idle share {1 - busy / wall:.3f}")
    for key, count, ms in items:
        print(f"    {ms:8.3f} ms  {count:5d} x  {key}")

    errs = {}
    sf = spike_factor(band, K=CONFIG3_K, block_b=CONFIG3_BLOCK)
    rblk = torch.nn.functional.pad(b, (0, sf.K * sf.m - op.n)).reshape(
        sf.K, sf.nb, sf.b)
    _, errs["fused_sweep"] = kernel_err(
        cfs.blocktri_solve_fused_cuda(sf.fact, rblk),
        cfs.blocktri_solve_fused_cuda(sf.fact, rblk, impl="plain"))
    prep = cbm.prepare_banded_mv(op)
    x = torch.randn(op.n, device=device)
    _, errs["band_matvec"] = kernel_err(
        cbm.banded_matvec_prepared(prep, x),
        cbm.banded_matvec_prepared(prep, x, impl="plain"))
    print(f"config 3 kernels against their plain versions (K={sf.K} "
          f"nb={sf.nb} b={sf.b}; n={op.n} w={op.width}): "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    check(max(errs.values()) <= KERNEL_TOL, f"config 3 kernels {errs}")
    nbytes = op.n * op.width * 4 + 2 * op.n * 4
    gb = nbytes / 1e9
    show("config3_band_matvec_cuda", time_ms(
        lambda: cbm.banded_matvec_prepared(prep, x), iters=20), gb)
    show("config3_band_matvec_plain", time_ms(
        lambda: cbm.banded_matvec_prepared(prep, x, impl="plain"), iters=5),
        gb)
    csr = band_csr(op)
    _, err = kernel_err(csr @ x, cbm.banded_matvec_prepared(prep, x))
    check(err <= KERNEL_TOL, f"config 3 CSR product disagrees: {err}")
    show("config3_band_matvec_library", time_ms(lambda: csr @ x, iters=20),
         gb)
    bound = roofline(nbytes, 2 * op.n * op.width)
    print(f"band_matvec (config 3: n={op.n} w={op.width}): "
          f"{t['config3_band_matvec_cuda'][0]:.4f} ms, plain "
          f"{t['config3_band_matvec_plain'][0]:.4f} ms, CSR "
          f"{t['config3_band_matvec_library'][0]:.4f} ms; bound "
          f"{bound[0]:.4f} ms ({bound[1]})")


def config1_expected(its, launches, restart=30):
    """The launches left-preconditioned gmres makes under the true-residual
    monitor with x0 = 0: PC applies (two #9 sweeps each) for ||M^-1 b||, the
    first residual, each iteration and each restart's residual; operator
    applies (#2) for the first residual and its true norm, two an iteration
    (the Arnoldi step and the true residual of the iterate) and one a
    restart."""
    cycles = -(-its // restart)
    expected = {name: 0 for name in launches}
    expected["sweeps"] = 2 * (2 + its + cycles - 1)
    expected["band_matvec"] = 2 + 2 * its + cycles - 1
    return expected


def host_solve_f64(op, b):
    """x64: scipy.linalg.solve_banded of the operator's band and b, both
    promoted exactly to f64 on the host."""
    import numpy as np
    import scipy.linalg
    data = op.data.double().cpu().numpy()
    n, kl, ku = op.n, op.kl, op.ku
    ab = np.zeros((kl + ku + 1, n))
    for d in range(-kl, ku + 1):
        rows = np.arange(max(0, -d), min(n, n - d))
        ab[ku - d, rows + d] = data[rows, d + kl]
    return scipy.linalg.solve_banded((kl, ku), ab,
                                      b.double().cpu().numpy())


def phase_config1(device, t, bounds):
    """BASELINE config 1 end to end through the testbed CLI at n = 1e5 in
    f32 (gmres + lu, -ksp_monitor_true_residual): the launches of #9 and #2
    counted around the run and held to what gmres makes (#1 none); the
    solution against an f64 host solve of the same system; then the factor,
    the solve and #9 at this shape (K = 1, nb = 1563, b = 64) beside its
    plain version and its bound, with its plan's chunk count C (> 1) and
    its time at other counts and at C = 1; then #9 and #1 timed on the
    n = 1e4 factor (nb = 157), which #1 admits; #2 at this path's operator
    (n = 1e5, w = 3) a launch at a time, beside the CSR product and its
    bound."""
    import numpy as np
    import torch
    from spike_petsc_tpu_torch import Options, make_solver
    from spike_petsc_tpu_torch.ops.cuda import band_matvec as cbm
    from spike_petsc_tpu_torch.ops.cuda import fused_sweep as cfs
    from spike_petsc_tpu_torch.ops.cuda import sweeps as csw
    from spike_petsc_tpu_torch.ops.cuda.fused_sweep import (
        fused_sweep_feasible)
    from spike_petsc_tpu_torch.ops.spike import spike_factor
    from spike_petsc_tpu_torch.solvers.pc import make_pc
    rec = {}
    reset_launches()
    t0 = time.perf_counter()
    rc, out = run_testbed(CONFIG1_ARGV, rec)
    launches = read_launches()
    wall = time.perf_counter() - t0
    lines = out.splitlines()
    for line in lines[:3] + ["..."] + lines[-8:]:
        print(f"  testbed| {line}")
    res, op, b = rec["result"], rec["operator"], rec["b"]
    x64 = host_solve_f64(op, b)
    rel = float(np.linalg.norm(res.x.double().cpu().numpy() - x64)
                / np.linalg.norm(x64))
    expected = config1_expected(res.its, launches)
    print(f"gmres+lu (config 1, n={op.n}, f32): testbed exit code {rc}, "
          f"{res.its} its, reason {res.reason}, {wall:.2f} s in all; "
          f"||x - x64|| / ||x64|| {rel:.3e} (limit {CONFIG1_REL_MAX}); "
          f"true relres (f32) {float(res.true_history[res.its]) / float(torch.linalg.norm(b)):.3e}")
    print(f"launches on the config-1 path: {launches}")
    print(f"expected launches (gmres: {res.its} its; 2 sweeps a PC apply, "
          f"{res.its} + 2 applies; 2 + 2 its operator applies): {expected}")
    check(rc == 0 and res.reason > 0 and res.its <= CONFIG1_ITS_MAX,
          f"config 1: exit code {rc}, {res.its} its, reason {res.reason}")
    check(res.x.shape == (CONFIG1_N,) and bool(torch.isfinite(res.x).all()),
          "config 1 solution shape / finiteness")
    check(rel <= CONFIG1_REL_MAX, f"config 1 error {rel}")
    check(launches["sweeps"] > 0 and launches["fused_sweep"] == 0
          and launches["band_matvec"] > 0, f"config 1 launches {launches}")
    check(launches == expected, f"config 1 launches {launches}")

    show = shower(t)
    show("config1_factor", time_ms(lambda: make_pc("lu", op, Options()),
                                   reps=3))
    solver = make_solver(op, options=Options.from_argv(CONFIG1_ARGV))
    show("config1_gmres_solve", time_ms(lambda: solver(b), reps=3))
    sf = spike_factor(op, K=1, block_b=CONFIG1_BLOCK)
    check(solver.pc.info["block"] == CONFIG1_BLOCK
          and (sf.K, sf.nb) == (1, -(-CONFIG1_N // CONFIG1_BLOCK))
          and not fused_sweep_feasible(sf.fact, sf.b)
          and csw.sweeps_feasible(sf.fact, sf.b),
          f"config 1 factor K={sf.K} nb={sf.nb} b={sf.b}")
    r = torch.randn((1, sf.nb, sf.b), generator=torch.Generator(
        device=device).manual_seed(SEED + 17), device=device)
    diff, err = kernel_err(csw.blocktri_solve_batched_cuda(sf.fact, r),
                           csw.blocktri_solve_batched_cuda(sf.fact, r,
                                                           impl="plain"))
    print(f"sweeps (config 1: K=1 nb={sf.nb} b={sf.b}) against its plain "
          f"version: max abs err {diff:.3e}, relative {err:.3e}")
    check(err <= KERNEL_TOL, f"config 1 sweeps err {err}")
    gb = sweep_bytes(sf.fact) / 1e9
    show("config1_sweeps_cuda", time_ms(
        lambda: csw.blocktri_solve_batched_cuda(sf.fact, r), iters=10), gb)
    show("config1_sweeps_plain", time_ms(
        lambda: csw.blocktri_solve_batched_cuda(sf.fact, r, impl="plain"),
        iters=2))
    bound = sweep_bound(sf.fact)
    bounds["config1_sweeps"] = bound
    ms = t["config1_sweeps_cuda"][0]
    sms = csw.device_sms(device)
    C = csw.sweeps_chunks(sf.K, sf.nb, sf.b, sms)
    check(C > 1, f"config 1: the plan keeps one block ({sms} SMs)")
    print(f"sweeps (config 1: K=1 nb={sf.nb} b={sf.b}): {ms:.4f} ms for "
          f"the two launches, C={C} chunks of at most "
          f"{-(-sf.nb // C)} block rows on {sf.K * C} SMs; plain "
          f"{t['config1_sweeps_plain'][0]:.4f} ms; bound {bound[0]:.4f} ms "
          f"({bound[1]}), bound / time {bound[0] / ms:.3f}; before the "
          f"chunked scan (PERF.md) {CONFIG1_SWEEPS_BEFORE_MS} ms")
    # the plan's C among others, and C = 1 (one block: the kernel before
    # the chunked scan), in this call
    for c in sorted({1, C, *(c for c in CONFIG1_CHUNKS if c <= sms)}):
        tc = time_ms(lambda: csw.blocktri_solve_batched_cuda(
            sf.fact, r, chunks=c), iters=10)
        print(f"  sweeps config 1 at C={c}: {tc[0]:.4f} ms median, spread "
              f"{tc[1]:.4f} ms{' (the plan)' if c == C else ''}")
    # #9 beside #1 on a single partition that #1 admits (the n = 1e4
    # reference's factor); the route gives it to #1
    ref = laplacian_factor(CONFIG1_REF_N, device)
    check(fused_sweep_feasible(ref.fact, ref.b), "#1 must admit nb = 157")
    r2 = torch.randn((1, ref.nb, ref.b), generator=torch.Generator(
        device=device).manual_seed(SEED + 18), device=device)
    plain2 = csw.blocktri_solve_batched_cuda(ref.fact, r2, impl="plain")
    _, e9 = kernel_err(csw.blocktri_solve_batched_cuda(ref.fact, r2), plain2)
    _, e1 = kernel_err(cfs.blocktri_solve_fused_cuda(ref.fact, r2), plain2)
    torch.cuda.synchronize()
    check(max(e9, e1) <= KERNEL_TOL, f"n=1e4 sweeps err {e9}, {e1}")
    show("config1_ref_sweeps_cuda", time_ms(
        lambda: csw.blocktri_solve_batched_cuda(ref.fact, r2), iters=20))
    show("config1_ref_fused_sweep_cuda", time_ms(
        lambda: cfs.blocktri_solve_fused_cuda(ref.fact, r2), iters=20))
    # device time a call: CUDA events time these short calls at the host's
    # launch rate
    d9 = device_profile(lambda: [csw.blocktri_solve_batched_cuda(
        ref.fact, r2) for _ in range(20)])[0] / 20
    d1 = device_profile(lambda: [cfs.blocktri_solve_fused_cuda(
        ref.fact, r2) for _ in range(20)])[0] / 20
    b1 = sweep_bound(ref.fact)
    print(f"sweeps (#9, C={csw.sweeps_chunks(1, ref.nb, ref.b, sms)}) "
          f"against fused_sweep (#1, c="
          f"{cfs.fused_sweep_cluster(1, ref.nb, ref.b, sms)}) on the "
          f"n={CONFIG1_REF_N} factor (K=1 "
          f"nb={ref.nb} b={ref.b}, which #1 admits and the route gives to "
          f"#1): #9 {t['config1_ref_sweeps_cuda'][0]:.4f} ms a call, "
          f"{d9:.4f} ms of device time; #1 "
          f"{t['config1_ref_fused_sweep_cuda'][0]:.4f} ms, {d1:.4f} ms of "
          f"device time (before its redesign, PERF.md: "
          f"{FUSED_BEFORE_MS['k1_nb157']}); #1's bound {b1[0]:.4f} ms "
          f"({b1[1]}), bound / device time {b1[0] / d1:.3f}; relative "
          f"errors {e9:.3e}, {e1:.3e}")
    # #2 at this path's operator (n = 1e5, w = 3), a launch at a time
    prep = cbm.prepare_banded_mv(op)
    xv = torch.randn(op.n, generator=torch.Generator(device=device)
                     .manual_seed(SEED + 19), device=device)
    _, e2 = kernel_err(cbm.banded_matvec_prepared(prep, xv),
                       cbm.banded_matvec_prepared(prep, xv, impl="plain"))
    check(e2 <= KERNEL_TOL, f"config 1 band_matvec err {e2}")
    nbytes = op.n * op.width * 4 + 2 * op.n * 4
    csr = band_csr(op)
    ms2 = device_profile(lambda: [cbm.banded_matvec_prepared(prep, xv)
                                  for _ in range(50)])[0] / 50
    lib2 = device_profile(lambda: [csr @ xv for _ in range(50)])[0] / 50
    call2 = time_ms(lambda: cbm.banded_matvec_prepared(prep, xv), iters=50)
    bound2 = roofline(nbytes, 2 * op.n * op.width)
    print(f"band_matvec (config 1: n={op.n} w={op.width}): {ms2:.4f} ms of "
          f"device time a launch (torch.profiler, 50 launches), "
          f"{call2[0]:.4f} ms a call by CUDA events (the host's launch "
          f"rate); CSR {lib2:.4f} ms of device time; bound {bound2[0]:.4f} "
          f"ms ({bound2[1]}), bound / device time "
          f"{bound2[0] / ms2 if ms2 else float('nan'):.3f}; "
          f"relative error {e2:.3e}")
    del csr
    # the card's floor for moving #2's bytes at this size: one copy_ that
    # reads and writes as many bytes in all as #2 moves (2.0 MB here)
    src = torch.empty(nbytes // 8, device=device)
    dst = torch.empty_like(src)
    copy_ms = device_profile(lambda: [dst.copy_(src)
                                      for _ in range(50)])[0] / 50
    print(f"copy_ of {nbytes / 2e6:.3f} MB (reads and writes "
          f"{nbytes / 1e6:.3f} MB in all, the bytes of #2 at n={op.n} "
          f"w={op.width}): {copy_ms:.4f} ms of device time a launch "
          f"(torch.profiler, 50 launches), beside #2's {ms2:.4f} ms")
    del src, dst
    busy, items = device_profile(lambda: solver(b))
    wall = t["config1_gmres_solve"][0]
    print(f"  config1_gmres_solve device busy {busy:.3f} ms of {wall:.3f} ms "
          f"wall: idle share {1 - busy / wall:.3f}")
    for key, count, ms in items:
        print(f"    {ms:8.3f} ms  {count:5d} x  {key}")
    return launches


def phase_config1_reference(device):
    """Config 1 at n = 1e4 with -pc_lu_block 64 on both sides: the card in
    f32 against the port's CPU plain path in f32; the iteration counts
    within 1, the solutions within CONFIG1_REF_REL_MAX.  Here nb = 157, so
    one partition's vector fits #1's shared memory and #1 runs, not #9."""
    import torch
    argv = ([a.replace("tridiag", f"tridiag:{CONFIG1_REF_N}")
             for a in CONFIG1_ARGV] + ["-pc_lu_block", str(CONFIG1_BLOCK)])
    got, ref = {}, {}
    reset_launches()
    rc_card, _ = run_testbed(argv, got)
    ran = {k: v for k, v in read_launches().items() if v}
    rc_cpu, _ = run_testbed(argv + ["-platform", "cpu"], ref)
    xg, xr = got["result"].x, ref["result"].x
    err = float(torch.linalg.norm((xg.cpu() - xr).double())
                / torch.linalg.norm(xr.double()))
    print(f"config 1 n={CONFIG1_REF_N}: card f32 {got['result'].its} its "
          f"(launches {ran}) vs CPU f32 {ref['result'].its} its, "
          f"||x_card - x_cpu|| / ||x_cpu|| {err:.3e} (limit "
          f"{CONFIG1_REF_REL_MAX})")
    check(rc_card == rc_cpu == 0 and xg.is_cuda and not xr.is_cuda
          and ran.get("fused_sweep", 0) > 0, "config 1 reference runs")
    check(abs(got["result"].its - ref["result"].its) <= 1
          and err <= CONFIG1_REF_REL_MAX,
          "config 1: card and CPU reference disagree")


def _ksp_case_name(ksp, opts):
    extra = ",".join(f"{k[4:]}" + (f"={v}" if v not in ("", 1) else "")
                     for k, v in opts.items())
    return ksp + (f"[{extra}]" if extra else "")


def phase_ksp_types(band, rhs, pc, cases, kernels):
    """Each KSP type of ``cases`` through ``solve(band, rhs, pc=pc, ...)``
    at its rtol, the PC built once; its launch counts read around it; the
    reason, its bound on the iterations, the true f32 relres and a launch
    of each of ``kernels`` held."""
    import torch
    from spike_petsc_tpu_torch import Options, solve
    from spike_petsc_tpu_torch.ops.band import banded_matvec
    from spike_petsc_tpu_torch.solvers.types import reason_str
    bnorm = torch.linalg.norm(rhs)
    rows = {}
    for ksp, opts, its_max, rtol in cases:
        name = _ksp_case_name(ksp, opts)
        reset_launches()
        t0 = time.perf_counter()
        res = solve(band, rhs, ksp_type=ksp, pc=pc,
                    options=Options(dict(opts)), rtol=rtol)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        launches = {k: v for k, v in read_launches().items() if v}
        relres = float(torch.linalg.norm(banded_matvec(band, res.x) - rhs)
                       / bnorm)
        print(f"ksp {name} rtol={rtol:g}: {res.its} its, "
              f"{reason_str(res.reason)}, wall "
              f"{wall:.2f} ms, true relres (f32) {relres:.3e}, launches "
              f"{launches}")
        check(res.reason > 0 and res.its <= its_max,
              f"ksp {name}: {res.its} its (at most {its_max}), reason "
              f"{res.reason}")
        check(bool(torch.isfinite(res.x).all())
              and relres <= KSP_TYPE_RELRES_MAX, f"ksp {name} relres {relres}")
        check(all(launches.get(k, 0) > 0 for k in kernels),
              f"ksp {name}: a kernel of {kernels} did not run: {launches}")
        if opts.get("ksp_monitor_true_residual"):
            check(res.true_history is not None and bool(
                torch.isfinite(res.true_history[:res.its + 1]).all()),
                  f"ksp {name}: no true history")
        rows[name] = (res.its, res.reason, wall, launches)
    return rows


def phase_ksp_types_reference(device):
    """Each type on a 20 000-row band (the flagship's kind, w = 41, and
    config 2's, w = 33) with its PC built once a side (gcr: the jacobi
    PC, KSP_TYPE_REF_PC), at rtol 1e-6: the card in f32 against the CPU in
    f64; the iteration counts within 1, the
    solutions within KSP_TYPE_REF_TOL of max|x|."""
    import torch
    from spike_petsc_tpu_torch import BandedMatrix, Options, solve
    from spike_petsc_tpu_torch.solvers.pc import make_pc
    nonsym, nrhs = flagship_band(20_000, 20, device, seed=SEED + 3)
    spd, srhs = spd_band(20_000, SPD_HALF_BW, device, seed=SEED + 14)
    opts = dict(PC_OPTIONS, pc_spike_partitions=8, pc_spike_block=64)
    worst = 0.0
    for band, rhs, pc_name, pc_opts, cases in (
            (nonsym, nrhs, "spike", opts, KSP_TYPE_CASES),
            (spd, srhs, "cholesky", SPD_OPTIONS, SPD_KSP_TYPE_CASES)):
        cpu = BandedMatrix(data=band.data.double().cpu(), kl=band.kl,
                           ku=band.ku)
        pcs = {dev: make_pc(pc_name, b, Options(dict(pc_opts)))
               for dev, b in (("card", band), ("cpu", cpu))}
        for ksp, kopts, _, _ in cases:
            own = KSP_TYPE_REF_PC.get(ksp)
            got = solve(band, rhs, ksp_type=ksp, pc_type=own,
                        pc=None if own else pcs["card"],
                        options=Options(dict(kopts)), rtol=KSP_TYPE_REF_RTOL)
            ref = solve(cpu, rhs.double().cpu(), ksp_type=ksp, pc_type=own,
                        pc=None if own else pcs["cpu"],
                        options=Options(dict(kopts)), rtol=KSP_TYPE_REF_RTOL)
            err = float((got.x.double().cpu() - ref.x).abs().max()
                        / ref.x.abs().max())
            worst = max(worst, err)
            name = _ksp_case_name(ksp, kopts)
            name += f"+{own}" if own else ""
            print(f"ksp {name} n=20000 w={band.width}: card {got.its} its vs "
                  f"CPU f64 {ref.its} its, max|x_card - x_cpu| / max|x_cpu| "
                  f"{err:.3e}")
            check(got.reason > 0 and ref.reason > 0
                  and abs(got.its - ref.its) <= 1 and err <= KSP_TYPE_REF_TOL,
                  f"ksp {name}: card and CPU reference disagree")
    return worst


def gmres_expected(its, launches, sweep, matvec, sweeps_per_apply=1,
                   restart=30, reduced=False):
    """The launches of left-preconditioned gmres from x0 = 0 without the
    true-residual monitor: PC applies (``sweeps_per_apply`` launches of
    ``sweep`` each) for ||M^-1 b||, the first residual, each iteration and
    each restart's residual; operator applies (``matvec``) for the first
    residual, each iteration and each restart's residual.  ``reduced``: a
    spike PC whose reduced system takes the reduced kernel, once an
    apply."""
    cycles = -(-its // restart)
    expected = {name: 0 for name in launches}
    expected[sweep] = sweeps_per_apply * (2 + its + cycles - 1)
    expected[matvec] = 1 + its + cycles - 1
    if reduced:
        expected["reduced_thomas"] = 2 + its + cycles - 1
    return expected


def transpose_types_expected(ksp, its, launches):
    """The launches of the A^T types from x0 = 0 with the flagship's spike
    PC (stored spikes: one #1 sweep an apply, forward or transposed) and
    the band operator (#2 for A and for A^T).  bicg: two PC applies before
    the loop and two an iteration, two operator applies an iteration and
    one for the final residual; lsqr: M^-T A^T u0, then per iteration
    A M^-1 v and M^-T A^T u, then x = M^-1 y and the final residual; cgls:
    M^-1 b and A^T M^-T c, then per iteration M^-1 A p and A^T M^-T s, then
    the final residual.  Each PC apply also solves its reduced system on
    the reduced kernel once."""
    expected = {name: 0 for name in launches}
    expected["fused_sweep"] = expected["reduced_thomas"] = 2 * its + 2
    expected["band_matvec"] = 2 * its + (1 if ksp == "bicg" else 2)
    return expected


def transposed_rhs(band, device):
    """b = A^T 1, so that A^T x = b has x = 1."""
    import torch
    from spike_petsc_tpu_torch.ops.band import banded_matvec_t
    return banded_matvec_t(band, torch.ones(band.n, device=device))


def phase_transpose_flagship(band, rhs, sf, pc, device, t):
    """The transpose stack on the flagship: the spike PC's transpose built
    from the band and from the L blocks kept at factor time
    (``-pc_spike_store_lt 1``), each setup timed; #1 on the regular-form
    transposed factor against its plain version and against the plain
    transpose sweeps of the marker form on the forward factor (the same
    function), timed beside #1 on the forward factor; ``solve(A, b,
    transpose=True)`` (gmres, rtol 1e-8) on the banded and the blocktri
    operator, the launches held exactly, timed beside the forward solve
    with each one's device busy time; bicg, lsqr and cgls, launches held
    exactly; ``-ksp_compute_singularvalues`` on the transposed gmres."""
    import contextlib
    import io
    import torch
    from spike_petsc_tpu_torch import Options, make_solver, solve
    from spike_petsc_tpu_torch.ops.band import banded_matvec_t, banded_matvec
    from spike_petsc_tpu_torch.ops.blocktri import blocktri_solve_transpose
    from spike_petsc_tpu_torch.ops.cuda import fused_sweep as cfs
    from spike_petsc_tpu_torch.ops.spike import spike_transpose
    from spike_petsc_tpu_torch.solvers.pc import make_pc
    from spike_petsc_tpu_torch.solvers.types import CONVERGED_RTOL, reason_str
    show = shower(t)
    t0 = time.perf_counter()
    pct = pc.transpose()
    torch.cuda.synchronize()
    setup_band = (time.perf_counter() - t0) * 1e3
    pc_lt = make_pc("spike", band,
                    Options(dict(PC_OPTIONS, pc_spike_store_lt=1)))
    t0 = time.perf_counter()
    pct_lt = pc_lt.transpose()
    torch.cuda.synchronize()
    setup_lt = (time.perf_counter() - t0) * 1e3
    check(pc.transpose() is pct and pct.transpose() is pc
          and pct.name == "spike_transpose", "PC.transpose cache/involution")
    print(f"transposed spike PC setup (flagship): from the band "
          f"{setup_band:.1f} ms, from the kept L blocks (store_lt) "
          f"{setup_lt:.1f} ms")

    # #1 on the regular-form factor: the same shapes as the forward one
    factT = spike_transpose(sf, band=band).fact
    check(all(getattr(factT, m).is_contiguous() for m in ("F", "U", "Sinv"))
          and cfs.fused_sweep_feasible(factT, sf.b),
          "the regular-form transpose must be a contiguous factor #1 takes")
    r = torch.randn((K, sf.nb, BLOCK), generator=torch.Generator(
        device=device).manual_seed(SEED + 21), device=device)
    got = cfs.blocktri_solve_fused_cuda(factT, r)
    _, e_plain = kernel_err(got, cfs.blocktri_solve_fused_cuda(
        factT, r, impl="plain"))
    _, e_marker = kernel_err(got, blocktri_solve_transpose(sf.fact, r))
    torch.cuda.synchronize()
    print(f"fused_sweep on the regular-form transpose {tuple(factT.F.shape)}"
          f": relative error {e_plain:.3e} against its plain version, "
          f"{e_marker:.3e} against the marker form's plain transpose sweeps")
    check(max(e_plain, e_marker) <= KERNEL_TOL,
          f"#1 on the transpose: {e_plain}, {e_marker}")
    show("fused_sweep_cuda_transpose", time_ms(
        lambda: cfs.blocktri_solve_fused_cuda(factT, r), iters=10))
    show("fused_sweep_cuda_forward", time_ms(
        lambda: cfs.blocktri_solve_fused_cuda(sf.fact, r), iters=10))
    del factT

    # solve(A, b, transpose=True): gmres on the banded and blocktri routes
    bt = transposed_rhs(band, device)
    btnorm = float(torch.linalg.norm(bt))
    for impl, mv in (("auto", "band_matvec"), ("blocktri", "blocktri_matvec")):
        opts = Options({"mat_matvec_impl": impl})
        reset_launches()
        res = solve(band, bt, ksp_type="gmres", pc=pc, options=opts,
                    rtol=1e-8, restart=30, maxit=30, transpose=True)
        launches = read_launches()
        rel = float(torch.linalg.norm(banded_matvec_t(band, res.x) - bt)
                    / btnorm)
        expected = gmres_expected(res.its, launches, "fused_sweep", mv,
                                  reduced=True)
        print(f"gmres+spike transpose=True ({impl} operator): {res.its} its, "
              f"{reason_str(res.reason)}, true relres of A^T x = b (f32) "
              f"{rel:.3e}, max|x - 1| {float((res.x - 1).abs().max()):.3e}; "
              f"launches {launches}; expected {expected}")
        check(res.reason == CONVERGED_RTOL and res.its <= GMRES_ITS_MAX,
              f"transposed gmres ({impl}): {res.its} its, {res.reason}")
        check(bool(torch.isfinite(res.x).all()) and rel <= 1e-4,
              f"transposed gmres ({impl}) relres {rel}")
        check(launches == expected, f"transposed gmres ({impl}) launches")
        if impl == "auto":
            tr_launches = launches

    fwd = make_solver(band, pc=pc, ksp_type="gmres", rtol=1e-8, restart=30,
                      maxit=30)
    trs = make_solver(band, pc=pc, ksp_type="gmres", rtol=1e-8, restart=30,
                      maxit=30, transpose=True)
    for name, fn in (("gmres_solve_forward", lambda: fwd(rhs)),
                     ("gmres_solve_transpose", lambda: trs(bt))):
        show(name, time_ms(fn, reps=3))
        busy, items = device_profile(fn)
        wall = t[name][0]
        print(f"  {name} device busy {busy:.3f} ms of {wall:.3f} ms wall: "
              f"idle share {1 - busy / wall:.3f}")
        for key, count, ms in items:
            print(f"    {ms:8.3f} ms  {count:5d} x  {key}")

    # the types that iterate on A^T, the same PC (its transpose cached)
    bnorm = float(torch.linalg.norm(rhs))
    for ksp, its_max in TRANSPOSE_KSP_CASES:
        reset_launches()
        t0 = time.perf_counter()
        res = solve(band, rhs, ksp_type=ksp, pc=pc, rtol=1e-8, maxit=50)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        launches = read_launches()
        rel = float(torch.linalg.norm(banded_matvec(band, res.x) - rhs)
                    / bnorm)
        expected = transpose_types_expected(ksp, res.its, launches)
        print(f"ksp {ksp} rtol=1e-08: {res.its} its, "
              f"{reason_str(res.reason)}, wall {wall:.2f} ms, true relres "
              f"(f32) {rel:.3e}, launches {launches}; expected {expected}")
        check(res.reason > 0 and res.its <= its_max,
              f"ksp {ksp}: {res.its} its (at most {its_max}), {res.reason}")
        check(bool(torch.isfinite(res.x).all())
              and rel <= KSP_TYPE_RELRES_MAX, f"ksp {ksp} relres {rel}")
        check(launches == expected, f"ksp {ksp} launches")

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = solve(band, bt, ksp_type="gmres", pc=pc, rtol=1e-8,
                    transpose=True,
                    options=Options({"ksp_compute_singularvalues": 1}))
    lines = [ln for ln in out.getvalue().splitlines()
             if ln.startswith("Iteratively computed extreme singular")]
    print(f"gmres+spike transpose=True -ksp_compute_singularvalues: "
          f"{res.its} its; {lines[0] if lines else 'NO LINE'}")
    check(len(lines) == 1 and res.reason > 0, "singular-value line")
    del pc_lt, pct_lt
    return tr_launches


def phase_transpose_reference(device):
    """The A^T types and gmres with transpose=True on a 20 000-row band of
    the flagship's kind (w = 41), the spike PC built once a side, rtol
    1e-6: the card in f32 against the CPU in f64; the iteration counts
    within 1, the solutions within KSP_TYPE_REF_TOL of max|x|."""
    from spike_petsc_tpu_torch import BandedMatrix, Options, solve
    from spike_petsc_tpu_torch.solvers.pc import make_pc
    band, rhs = flagship_band(20_000, 20, device, seed=SEED + 3)
    cpu = BandedMatrix(data=band.data.double().cpu(), kl=band.kl, ku=band.ku)
    opts = dict(PC_OPTIONS, pc_spike_partitions=8, pc_spike_block=64)
    pcs = {dev: make_pc("spike", b, Options(dict(opts)))
           for dev, b in (("card", band), ("cpu", cpu))}
    for ksp in TRANSPOSE_REF_CASES:
        tr = ksp == "gmres"
        got = solve(band, rhs, ksp_type=ksp, pc=pcs["card"], transpose=tr,
                    rtol=KSP_TYPE_REF_RTOL, maxit=100)
        ref = solve(cpu, rhs.double().cpu(), ksp_type=ksp, pc=pcs["cpu"],
                    transpose=tr, rtol=KSP_TYPE_REF_RTOL, maxit=100)
        err = float((got.x.double().cpu() - ref.x).abs().max()
                    / ref.x.abs().max())
        name = ksp + ("[transpose]" if tr else "")
        print(f"ksp {name} n=20000 w={band.width}: card {got.its} its vs "
              f"CPU f64 {ref.its} its, max|x_card - x_cpu| / max|x_cpu| "
              f"{err:.3e}")
        check(got.reason > 0 and ref.reason > 0
              and abs(got.its - ref.its) <= 1 and err <= KSP_TYPE_REF_TOL,
              f"ksp {name}: card and CPU reference disagree")


def phase_transpose_config3(device):
    """BASELINE config 3 through the testbed CLI with ``-ksp_type bicg``:
    the banded PC's inner spike PC transposed (#1 at nb = 123, the
    regular form cut from its band) and A^T (#2 at w = 13); the launches
    held exactly (#2 2 its + 1; #1 4 (its + 1): spikes not stored, two
    sweeps an apply, two applies before the loop and two an iteration).
    The testbed runs its host pre-pass again (it takes no pre-pass from
    an earlier run); its -log_view table times it."""
    import torch
    from spike_petsc_tpu_torch.ops.band import banded_matvec
    from spike_petsc_tpu_torch.solvers.types import CONVERGED_RTOL
    argv = [("bicg" if a == "bcgs" else a) for a in CONFIG3_ARGV]
    rec = {}
    t0 = time.perf_counter()
    reset_launches()
    rc, out = run_testbed(argv, rec)
    launches = read_launches()
    wall = time.perf_counter() - t0
    for line in out.splitlines():
        print(f"  testbed| {line}")
    res, op, b = rec["result"], rec["operator"], rec["b"]
    rel = float(torch.linalg.norm(banded_matvec(op, res.x) - b)
                / torch.linalg.norm(b))
    expected = {name: 0 for name in launches}
    expected["band_matvec"] = 2 * res.its + 1
    expected["fused_sweep"] = 4 * (res.its + 1)
    expected["reduced_thomas"] = 2 * (res.its + 1)   # one a PC apply
    print(f"bicg+banded (config 3, n={op.n}): testbed exit code {rc}, "
          f"{wall:.2f} s in all, {res.its} its, reason {res.reason}, true "
          f"relres (f32) {rel:.3e}; launches {launches}; expected "
          f"{expected}")
    check(rc == 0 and res.reason == CONVERGED_RTOL
          and res.its <= CONFIG3_BICG_ITS_MAX,
          f"config 3 bicg: exit {rc}, {res.its} its, reason {res.reason}")
    check(bool(torch.isfinite(res.x).all()) and rel <= CONFIG3_RELRES_MAX,
          f"config 3 bicg relres {rel}")
    check(launches == expected, f"config 3 bicg launches {launches}")
    return launches


def phase_transpose_config1(device, t):
    """BASELINE config 1's system solved transposed: gmres + lu with
    ``transpose=True`` at rtol 1e-10 on the tridiagonal Laplacian at
    n = 1e5 in f32.  The lu PC's K = 1 factor (block 64, nb = 1563) is
    transposed in the regular form, which routes to #9 like the forward
    one: #9 launched 2 (its + 2) times (one cycle), #2 its + 1, #1 never;
    the solution against an f64 host solve of A^T x = b; the transposed
    PC's setup, and the solve's wall and device time."""
    import numpy as np
    import torch
    from spike_petsc_tpu_torch import Options, make_solver, solve
    from spike_petsc_tpu_torch.convert import banded_from_numpy
    from spike_petsc_tpu_torch.ops.band import banded_transpose
    from spike_petsc_tpu_torch.solvers.pc import make_pc
    show = shower(t)
    band = banded_from_numpy(np.tile(np.float32([-1, 2, -1]),
                                     (CONFIG1_N, 1)), 1, 1, device=device)
    b = transposed_rhs(band, device)
    pc = make_pc("lu", band, Options())
    t0 = time.perf_counter()
    pc.transpose()
    torch.cuda.synchronize()
    setup = (time.perf_counter() - t0) * 1e3
    reset_launches()
    res = solve(band, b, ksp_type="gmres", pc=pc, rtol=1e-10,
                transpose=True)
    launches = read_launches()
    x64 = host_solve_f64(banded_transpose(band), b)
    rel = float(np.linalg.norm(res.x.double().cpu().numpy() - x64)
                / np.linalg.norm(x64))
    expected = gmres_expected(res.its, launches, "sweeps", "band_matvec",
                              sweeps_per_apply=2)
    print(f"gmres+lu transpose=True (config 1, n={CONFIG1_N}, f32): "
          f"{res.its} its, reason {res.reason}; ||x - x64|| / ||x64|| "
          f"{rel:.3e} (limit {CONFIG1_REL_MAX}); transposed PC setup "
          f"{setup:.1f} ms (block {pc.info['block']}); launches {launches}; "
          f"expected {expected}")
    check(res.reason > 0 and res.its <= CONFIG1_ITS_MAX,
          f"config 1 transposed: {res.its} its, reason {res.reason}")
    check(bool(torch.isfinite(res.x).all()) and rel <= CONFIG1_REL_MAX,
          f"config 1 transposed error {rel}")
    check(launches == expected and launches["fused_sweep"] == 0,
          f"config 1 transposed launches {launches}")
    solver = make_solver(band, pc=pc, ksp_type="gmres", rtol=1e-10,
                         transpose=True)
    show("config1_gmres_solve_transpose", time_ms(lambda: solver(b), reps=3))
    busy, _ = device_profile(lambda: solver(b))
    wall = t["config1_gmres_solve_transpose"][0]
    print(f"  config1_gmres_solve_transpose device busy {busy:.3f} ms of "
          f"{wall:.3f} ms wall: idle share {1 - busy / wall:.3f}")
    return launches


def phase_transpose_config2(band, rhs, pc):
    """Config 2 transposed: cg + cholesky with ``transpose=True``.  A real
    spd factorization is its own transpose, so the transposed PC applies
    the same factor: #3 launched its + 1 times, and the answer the
    forward solve's."""
    import torch
    from spike_petsc_tpu_torch import solve
    from spike_petsc_tpu_torch.solvers.types import CONVERGED_RTOL
    fwd = solve(band, rhs, ksp_type="cg", pc=pc, rtol=1e-8, maxit=50)
    reset_launches()
    res = solve(band, rhs, ksp_type="cg", pc=pc, rtol=1e-8, maxit=50,
                transpose=True)
    launches = read_launches()
    same_factor = pc.transpose().apply.args[0] is pc.apply.args[0]
    dx = float((res.x - fwd.x).abs().max() / fwd.x.abs().max())
    print(f"cg+cholesky transpose=True (config 2): {res.its} its (forward "
          f"{fwd.its}), reason {res.reason}; the transposed PC applies the "
          f"PC's own factor: {same_factor}; max|x_T - x| / max|x| {dx:.3e} "
          f"(bitwise equal: {bool(torch.equal(res.x, fwd.x))}); launches "
          f"{launches}")
    check(res.reason == CONVERGED_RTOL and res.its == fwd.its
          and same_factor, f"config 2 transposed cg: {res.its} its")
    check(dx <= 1e-6, f"config 2 transposed cg differs from forward: {dx}")
    check(launches["fused_sweep_spd"] == res.its + 1
          and launches["fused_sweep"] == 0,
          f"config 2 transposed launches {launches}")
    return launches


def phase_refine(a64, b64):
    """f64-grade refinement through ``solve``: richardson + the spike PC
    with f32 factors on the f64 flagship band, rtol 1e-12, launch counts
    read around it; then the ladder's second rung (bf16-stored factors)."""
    import torch
    from spike_petsc_tpu_torch import Options, solve
    from spike_petsc_tpu_torch.ops.band import banded_matvec
    from spike_petsc_tpu_torch.solvers.operator import as_matvec
    from spike_petsc_tpu_torch.solvers.types import CONVERGED_RTOL, reason_str
    route = as_matvec(a64)[0]._route
    print(f"f64 operator route (-mat_matvec_impl auto): {route}")
    check(route == "banded_cuda_f64", f"f64 operator route {route}")
    bnorm = float(torch.linalg.norm(b64))
    main_launches = None
    for label, opts, maxit in (("f32 factors", REFINE_OPTIONS, REFINE_MAXIT),
                               ("bf16-stored factors", LADDER_OPTIONS,
                                LADDER_MAXIT)):
        reset_launches()
        res = solve(a64, b64, ksp_type="richardson", pc_type="spike",
                    options=Options(dict(opts)), rtol=REFINE_RTOL,
                    maxit=maxit)
        launches = read_launches()
        # the true residual with the plain f64 route, not the kernel
        true_rel = float(torch.linalg.norm(banded_matvec(a64, res.x) - b64)
                         / bnorm)
        xerr = float((res.x - 1).abs().max())
        print(f"richardson+spike ({label}) on the f64 band: {res.its} its, "
              f"{reason_str(res.reason)}, rnorm/||b|| {res.rnorm / bnorm:.3e},"
              f" true relres (f64) {true_rel:.3e}, max|x - 1| {xerr:.3e}; "
              f"launches {launches} (TPU v5e yardstick, f32 factors: 3 its "
              f"to 1.16e-13)")
        check(res.x.dtype == torch.float64 and res.x.shape == (N,)
              and bool(torch.isfinite(res.x).all()),
              f"refinement ({label}) solution dtype / shape / finiteness")
        check(res.reason == CONVERGED_RTOL and true_rel <= REFINE_RTOL,
              f"refinement ({label}): {res.its} its, reason {res.reason}, "
              f"true relres {true_rel}")
        if main_launches is None:
            # every residual on #6 (its + 1 with x0 = None: one per
            # iteration and the final rnorm), every PC apply on #1, and the
            # safety net's probe solve (newton_fixed) on #1 once; each of
            # those solves its reduced system on the reduced kernel once
            expect = {k: 0 for k in launches}
            expect.update(band_matvec_f64=res.its + 1,
                          fused_sweep=res.its + 1,
                          reduced_thomas=res.its + 1)
            print(f"  expected launches: {expect}")
            check(launches == expect, f"refinement launches {launches}, "
                  f"expected {expect}")
            check(res.its <= REFINE_ITS_MAX and xerr <= REFINE_XERR_MAX,
                  f"refinement: {res.its} its, max|x - 1| {xerr}")
            main_launches = launches
    return main_launches


def phase_refine_reference(device):
    """The refinement on a small f64 band on the card (kernels) and on the
    CPU (plain versions): both reach 1e-12 and the solutions agree."""
    from spike_petsc_tpu_torch import BandedMatrix, Options, solve
    band, _ = flagship_band(20_000, 20, device, seed=SEED + 23)
    a64, b64 = f64_band(band)
    opts = dict(REFINE_OPTIONS, pc_spike_partitions=8, pc_spike_block=64)
    got = solve(a64, b64, ksp_type="richardson", pc_type="spike",
                options=Options(dict(opts)), rtol=REFINE_RTOL,
                maxit=REFINE_MAXIT)
    cpu = BandedMatrix(data=a64.data.cpu(), kl=20, ku=20)
    ref = solve(cpu, b64.cpu(), ksp_type="richardson", pc_type="spike",
                options=Options(dict(opts)), rtol=REFINE_RTOL,
                maxit=REFINE_MAXIT)
    err = float((got.x.cpu() - ref.x).abs().max() / ref.x.abs().max())
    print(f"refinement small band n=20000 w=41 f64: card {got.its} its vs "
          f"CPU {ref.its} its, max|x_card - x_cpu| / max|x_cpu| {err:.3e}")
    check(err <= 1e-10 and got.reason == ref.reason == 2,
          "refinement: card and CPU reference disagree")


def phase_alternate_path(band, rhs, sf):
    """The alternate kernels on their paths: ``spike_solve(sf, rhs,
    impl="pallas")`` (the two-pass sweeps, two launches) against
    ``impl="pallas_fused"``, and ``blocktri_matvec_pallas`` on the
    flagship conversion against the blocktri kernel #7."""
    import torch
    from spike_petsc_tpu_torch.ops.band import banded_matvec
    from spike_petsc_tpu_torch.ops.blocktri import band_to_blocktri
    from spike_petsc_tpu_torch.ops.cuda import blocktri_matvec as cbt
    from spike_petsc_tpu_torch.ops.cuda.blocktri_matvec_grid import (
        blocktri_matvec_pallas)
    from spike_petsc_tpu_torch.ops.spike import spike_solve
    reset_launches()
    x = spike_solve(sf, rhs, impl="pallas")
    launches = read_launches()
    relres = float(torch.linalg.norm(banded_matvec(band, x) - rhs)
                   / torch.linalg.norm(rhs))
    _, err = kernel_err(x, spike_solve(sf, rhs, impl="pallas_fused"))
    torch.cuda.synchronize()
    print(f"spike_solve(impl='pallas'): f32 relative residual {relres:.3e}, "
          f"against impl='pallas_fused' {err:.3e}; launches {launches}")
    check(launches["sweeps"] == 2 and launches["fused_sweep"] == 0,
          f"spike_solve(impl='pallas') launches {launches}")
    check(relres <= SPIKE_RELRES_MAX and err <= KERNEL_TOL,
          f"spike_solve(impl='pallas'): relres {relres}, err {err}")

    T = band_to_blocktri(band, BLOCK)
    v = torch.nn.functional.pad(rhs, (0, T.nb * BLOCK - N))
    reset_launches()
    y = blocktri_matvec_pallas(T, v.reshape(T.nb, BLOCK), kt=GRID_KT)
    grid = read_launches()
    _, err = kernel_err(y.reshape(-1)[:N], cbt.blocktri_matvec_cuda(T, rhs))
    torch.cuda.synchronize()
    print(f"blocktri_matvec_pallas kt={GRID_KT} on the flagship conversion: "
          f"against the blocktri kernel {err:.3e}; launches {grid}")
    check(grid["blocktri_matvec_grid"] == 1 and err <= KERNEL_TOL,
          f"blocktri_matvec_pallas: err {err}, launches {grid}")
    launches["blocktri_matvec_grid"] = grid["blocktri_matvec_grid"]
    return launches


def phase_alternate_timing(band, a64, b64, rhs, sf, device, t):
    """The three kernels beside their plain versions, bounds and library
    calls, and the refinement solve with the f64 kernel against the same
    solve with the plain f64 operator (``-mat_matvec_impl xla``)."""
    import torch
    from spike_petsc_tpu_torch import Options, make_solver
    from spike_petsc_tpu_torch.ops.blocktri import (BlockTridiagonal,
                                                    band_to_blocktri,
                                                    cast_factor)
    from spike_petsc_tpu_torch.ops.cuda import band_matvec_f64 as cbm64
    from spike_petsc_tpu_torch.ops.cuda import blocktri_matvec_grid as cgrid
    from spike_petsc_tpu_torch.ops.cuda import sweeps as csw
    bounds = {}
    show = shower(t)

    prep = cbm64.prepare_banded_mv_f64(a64)
    x = torch.randn(N, dtype=torch.float64, device=device)
    nbytes = a64.n * a64.width * 8 + 2 * N * 8
    show("band_matvec_f64_cuda", time_ms(
        lambda: cbm64.banded_matvec_prepared_f64(prep, x), iters=20),
        nbytes / 1e9)
    show("band_matvec_f64_plain", time_ms(
        lambda: cbm64.banded_matvec_prepared_f64(prep, x, impl="plain"),
        iters=3), nbytes / 1e9)
    bounds["band_matvec_f64"] = roofline(nbytes, 2 * a64.n * a64.width,
                                         PEAK_F64_FLOPS)
    csr = band_csr(a64)
    show("band_matvec_f64_library", time_ms(lambda: csr @ x, iters=20),
         nbytes / 1e9)
    del csr, prep

    rblk = torch.nn.functional.pad(rhs, (0, K * sf.m - N)).reshape(
        K, sf.nb, BLOCK)
    for label, fact in (("f32", sf.fact),
                        ("bf16", cast_factor(sf.fact, torch.bfloat16))):
        gb = sweep_bytes(fact) / 1e9
        show(f"sweeps_cuda_{label}", time_ms(
            lambda: csw.blocktri_solve_batched_cuda(fact, rblk), iters=10),
            gb)
    show("sweeps_plain_f32", time_ms(
        lambda: csw.blocktri_solve_batched_cuda(sf.fact, rblk, impl="plain"),
        iters=3))
    bounds["sweeps"] = sweep_bound(sf.fact)

    T = band_to_blocktri(band, BLOCK)
    xb = torch.randn((T.nb, BLOCK), device=device)
    gb = (3 * T.D.numel() * 4 + 2 * T.nb * BLOCK * 4) / 1e9
    show("blocktri_matvec_grid_cuda", time_ms(
        lambda: cgrid.blocktri_matvec_pallas(T, xb, kt=GRID_KT), iters=20),
        gb)
    show("blocktri_matvec_grid_plain", time_ms(
        lambda: cgrid.blocktri_matvec_pallas(T, xb, kt=GRID_KT,
                                             impl="plain"), iters=5), gb)
    T16 = BlockTridiagonal(D=T.D.bfloat16(), L=T.L.bfloat16(),
                           U=T.U.bfloat16())
    show("blocktri_matvec_grid_cuda_bf16", time_ms(
        lambda: cgrid.blocktri_matvec_pallas(T16, xb, kt=GRID_KT),
        iters=20), gb / 2)
    del T16
    bounds["blocktri_matvec_grid"] = roofline(
        3 * T.D.numel() * 4 + 2 * T.nb * BLOCK * 4, 2 * 3 * T.D.numel())
    del T

    # the refinement solve: the f64 kernel (auto) against the plain f64
    # operator, in turns
    solvers = {impl: make_solver(
        a64, ksp_type="richardson", pc_type="spike",
        options=Options(dict(REFINE_OPTIONS, mat_matvec_impl=impl)),
        rtol=REFINE_RTOL, maxit=REFINE_MAXIT) for impl in ("auto", "xla")}
    best = {}
    for impl in ("xla", "auto", "auto", "xla"):
        ms = time_ms(lambda: solvers[impl](b64), reps=3)
        print(f"  refine_solve_{impl} turn: {ms[0]:.4f} ms median")
        if impl not in best or ms[0] < best[impl][0]:
            best[impl] = ms
    for impl in ("auto", "xla"):
        show(f"refine_solve_{impl}", best[impl])
    busy, items = device_profile(lambda: solvers["auto"](b64))
    wall = t["refine_solve_auto"][0]
    print(f"  refine_solve_auto device busy {busy:.3f} ms of {wall:.3f} ms "
          f"wall: idle share {1 - busy / wall:.3f}")
    for key, count, ms in items:
        print(f"    {ms:8.3f} ms  {count:5d} x  {key}")
    return bounds


# ---------------------------------------------------------------------------
# the rest of the factor surface: pivot shifts, the lu and cr methods,
# cyclic reduction for K > 255, newton_pan, spike_factor_grouped
# ---------------------------------------------------------------------------

def profile_launches(fn):
    """(device busy ms, CUDA launches) of one call of ``fn``, from
    torch.profiler (every launch, the port's own kernels included)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    items = [e for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    return (sum(e.self_device_time_total for e in items) / 1e3,
            sum(e.count for e in items))


def pc_factor(pc):
    """The SpikeFactor a spike-family PC applies (``partial(spike_solve,
    sf)``)."""
    return pc.apply.args[0]


def zerodiag_argv(pc, shifted, n=ZERODIAG_N):
    return ZERODIAG_ARGV.format(
        n=n, pc=ZERODIAG_PCS[pc],
        shift="-pc_factor_shift_type nonzero" if shifted else "").split()


def testbed_pc_line(out):
    """The PC's line of the testbed's -ksp_view."""
    return next((ln.strip() for ln in out.splitlines()
                 if ln.strip().startswith(("PC spike:", "PC lu:"))), "")


def phase_zerodiag(device, t, bounds):
    """A: the reference's zero-diagonal scenario at n = 1e6 in f32 through
    ``testbed.main``: tridiagonal [-1, 0, -1], every pivot zero; gmres with
    the spike PC (K = 64, b = 64: #1 at nb = 245, two sweeps an apply, the
    spikes not stored, and the reduced kernel once) and with the lu PC
    (b = 64: #9 at K = 1, nb = 15625, no reduced system),
    each with ``-pc_factor_shift_type nonzero`` and without.  Each run's
    launches of #1, #9 and #2 held exactly to what gmres makes; the shifted
    runs raise pivots (``shifted_pivots`` > 0) and end within
    ZERODIAG_REL_MAX of u = 1; the unshifted ones converge too (even b:
    the diagonal blocks are nonsingular, and the inverter pivots inside
    each), as the JAX package's do on the CPU.  Then the sweep kernel of
    each shifted PC and #2 at this band, each against its plain version
    and timed beside its bound."""
    import math
    import re
    import torch
    from spike_petsc_tpu_torch.ops.cuda import band_matvec as cbm
    from spike_petsc_tpu_torch.utils import profiling
    show = shower(t)
    out_launches = {}
    for pc_name, sweep in (("spike", "fused_sweep"), ("lu", "sweeps")):
        for shifted in (True, False):
            label = f"{pc_name}{'_shift' if shifted else ''}"
            argv = zerodiag_argv(pc_name, shifted)
            rec = {}
            reset_launches()
            t0 = time.perf_counter()
            rc, out = run_testbed(argv, rec)
            launches = read_launches()
            wall = time.perf_counter() - t0
            res, op = rec["result"], rec["operator"]
            err = float(out.split("Error in solution:")[1].split()[0])
            rel = err / math.sqrt(ZERODIAG_N)
            found = re.search(r"shifted_pivots=(\d+)", out)
            shifted_pivots = int(found.group(1)) if found else None
            expected = gmres_expected(res.its, launches, sweep,
                                      "band_matvec", sweeps_per_apply=2,
                                      reduced=pc_name == "spike")
            print(f"zerodiag {label} (n={ZERODIAG_N}, f32, testbed): exit "
                  f"code {rc}, {res.its} its, reason {res.reason}, error in "
                  f"solution {err:.6g} (||x - u|| / ||u|| {rel:.3e}, limit "
                  f"{ZERODIAG_REL_MAX}), {wall:.2f} s in all")
            print(f"  testbed| {testbed_pc_line(out)}")
            print(f"  launches {launches}; expected {expected}")
            check(rc == 0 and res.reason > 0 and res.its <= ZERODIAG_ITS_MAX,
                  f"zerodiag {label}: exit code {rc}, {res.its} its, reason "
                  f"{res.reason}")
            check(bool(torch.isfinite(res.x).all())
                  and rel <= ZERODIAG_REL_MAX,
                  f"zerodiag {label}: relative error {rel}")
            check(launches == expected and launches[sweep] > 0,
                  f"zerodiag {label} launches {launches}")
            check((shifted_pivots is not None and shifted_pivots > 0)
                  == shifted, f"zerodiag {label}: shifted_pivots "
                  f"{shifted_pivots}")
            if shifted:
                out_launches[pc_name] = launches
                t[f"zerodiag_{label}_factor"] = (
                    profiling.stage_times()["PCSetUp"] * 1e3, 0.0)
                print(f"  zerodiag_{label}_factor: "
                      f"{t[f'zerodiag_{label}_factor'][0]:.1f} ms (the "
                      "testbed's PCSetUp stage)")
                zerodiag_kernels(pc_factor(rec["pc"]), rec["b"], sweep, t,
                                 bounds)
            del rec
    prep = cbm.prepare_banded_mv(op)
    x = torch.randn(op.n, device=device)
    _, err = kernel_err(cbm.banded_matvec_prepared(prep, x),
                        cbm.banded_matvec_prepared(prep, x, impl="plain"))
    check(err <= KERNEL_TOL, f"band_matvec at the zero-diagonal band: {err}")
    show("zerodiag_band_matvec", time_ms(
        lambda: cbm.banded_matvec_prepared(prep, x), iters=20))
    bounds["zerodiag_band_matvec"] = roofline(
        op.n * op.width * 4 + 2 * op.n * 4, 2 * op.n * op.width)
    print(f"  band_matvec (zero-diagonal: n={op.n} w={op.width}) against "
          f"its plain version {err:.3e}; bound "
          f"{bounds['zerodiag_band_matvec'][0]:.4f} ms "
          f"({bounds['zerodiag_band_matvec'][1]})")
    return out_launches


def zerodiag_kernels(sf, b, sweep, t, bounds):
    """The sweep kernel of a zero-diagonal PC (#1 for the spike PC, #9 for
    the lu PC) on that PC's shifted factor and right-hand side, timed
    beside the solve's bound (``sweep_bound``, #1's and #9's alike).  The
    kernel is held within ZERODIAG_SWEEP_TOL of the plain sweep in f64 on
    the same factor; its plain f32 version's distance from that sweep is
    printed beside it."""
    import dataclasses
    import torch
    import torch.nn.functional as tnf
    from spike_petsc_tpu_torch.ops.blocktri import blocktri_solve
    from spike_petsc_tpu_torch.ops.cuda import fused_sweep as cfs
    from spike_petsc_tpu_torch.ops.cuda import sweeps as csw
    show = shower(t)
    rblk = tnf.pad(b, (0, sf.K * sf.m - sf.n)).reshape(sf.K, sf.nb, sf.b)
    kern = (cfs.blocktri_solve_fused_cuda if sweep == "fused_sweep"
            else csw.blocktri_solve_batched_cuda)
    got, plain = kern(sf.fact, rblk), kern(sf.fact, rblk, impl="plain")
    f64 = dataclasses.replace(sf.fact, F=sf.fact.F.double(),
                              U=sf.fact.U.double(),
                              Sinv=sf.fact.Sinv.double())
    ref = blocktri_solve(f64, rblk.double())
    _, err = kernel_err(got, ref)
    _, err_plain = kernel_err(plain, ref)
    _, err_pair = kernel_err(got, plain)
    tol = ZERODIAG_SWEEP_TOL[sweep]
    if sweep == "fused_sweep":
        # every cluster size sums each row in the same order: the same bits
        for c in cfs.CLUSTER_SIZES:
            x = kern(sf.fact, rblk, cluster=c)
            _, err_c = kernel_err(x, ref)
            same = bool(torch.equal(x, got))
            print(f"  fused_sweep (zero-diagonal) at c={c}: against the f64 "
                  f"sweep {err_c:.3e}, bit-identical to the plan's: {same}")
            check(err_c <= tol and same, f"fused_sweep at the zero-diagonal "
                  f"factor, c={c}: {err_c} from the f64 sweep, limit {tol}, "
                  f"bit-identical {same}")
    del f64, ref
    name = f"zerodiag_{sweep}"
    show(name, time_ms(lambda: kern(sf.fact, rblk), iters=10))
    bounds[name] = sweep_bound(sf.fact)
    before = (f"; before its redesign (PERF.md) "
              f"{FUSED_BEFORE_MS['zerodiag']} ms"
              if sweep == "fused_sweep" else "")
    print(f"  {sweep} (zero-diagonal: K={sf.K} nb={sf.nb} b={sf.b}, "
          f"shifted factor) against the f64 sweep {err:.3e} (limit "
          f"{tol:.3e}), its plain f32 version against the f64 sweep "
          f"{err_plain:.3e}, kernel against plain f32 {err_pair:.3e}; bound "
          f"{bounds[name][0]:.4f} ms ({bounds[name][1]}), bound / time "
          f"{bounds[name][0] / t[name][0]:.3f}{before}")
    check(err <= tol, f"{sweep} at the zero-diagonal factor: {err} from the "
          f"f64 sweep, limit {tol}")


def phase_cr_flagship(band, rhs, device, t, bounds):
    """B: the flagship at K = 512 partitions (nb = 16): 511 reduced block
    rows, which 'auto' factors by cyclic reduction.  gmres + spike through
    ``solve`` (rtol 1e-8, restart 30), the PC built in the counted run: #1
    once a PC apply and once for the safety net's probe, #2 once an
    operator apply; #1 at this shape against its plain version and timed
    beside its bound; ``spike_solve`` with the CR reduced system against
    the Thomas one (``reduced='thomas'``), in turns, wall (CUDA events),
    device time and launches (torch.profiler) a solve.  Returns the
    K = 512 #1 error."""
    import torch
    import torch.nn.functional as tnf
    from spike_petsc_tpu_torch import Options, solve
    from spike_petsc_tpu_torch.ops.band import banded_matvec
    from spike_petsc_tpu_torch.ops.cuda import fused_sweep as cfs
    from spike_petsc_tpu_torch.ops.cyclic import CRFactor
    from spike_petsc_tpu_torch.ops.spike import spike_factor, spike_solve
    from spike_petsc_tpu_torch.solvers.pc import make_pc
    show = shower(t)
    opts = dict(PC_OPTIONS, pc_spike_partitions=CR_K)
    reset_launches()
    t0 = time.perf_counter()
    pc = make_pc("spike", band, Options(dict(opts)))
    res = solve(band, rhs, ksp_type="gmres", pc=pc, rtol=1e-8, restart=30)
    launches = read_launches()
    wall = (time.perf_counter() - t0) * 1e3
    sf = pc_factor(pc)
    relres = float(torch.linalg.norm(banded_matvec(band, res.x) - rhs)
                   / torch.linalg.norm(rhs))
    expected = gmres_expected(res.its, launches, "fused_sweep",
                              "band_matvec")
    expected["fused_sweep"] += 1                 # the safety net's probe
    print(f"gmres+spike K={CR_K} (flagship, nb={sf.nb}, reduced "
          f"{type(sf.red_fact).__name__}, {len(sf.red_fact.levels)} levels, "
          f"n_pad {sf.red_fact.n_pad}): {res.its} its, reason {res.reason}, "
          f"true relres (f32) {relres:.3e}, {wall:.1f} ms with the factor; "
          f"launches {launches}; expected {expected}")
    check(isinstance(sf.red_fact, CRFactor) and sf.red_fact.n_pad == CR_K - 1,
          f"K={CR_K}: the reduced factor is {type(sf.red_fact).__name__}")
    check(res.reason > 0 and res.its <= GMRES_ITS_MAX and relres <= 1e-4,
          f"K={CR_K}: {res.its} its, reason {res.reason}, relres {relres}")
    check(launches == expected, f"K={CR_K} launches {launches}")

    rblk = tnf.pad(rhs, (0, sf.K * sf.m - sf.n)).reshape(sf.K, sf.nb, BLOCK)
    diff, err = kernel_err(cfs.blocktri_solve_fused_cuda(sf.fact, rblk),
                           cfs.blocktri_solve_fused_cuda(sf.fact, rblk,
                                                         impl="plain"))
    print(f"fused_sweep (K={CR_K} nb={sf.nb} b={BLOCK}) against its plain "
          f"version: max abs {diff:.3e}, relative {err:.3e}")
    check(err <= KERNEL_TOL, f"fused_sweep at K={CR_K}: {err}")
    gb = sweep_bytes(sf.fact) / 1e9
    show("fused_sweep_cuda_k512", time_ms(
        lambda: cfs.blocktri_solve_fused_cuda(sf.fact, rblk), iters=10), gb)
    bms, bby = sweep_bound(sf.fact)
    plan = cfs.fused_sweep_cluster(CR_K, sf.nb, BLOCK,
                                   cfs.device_sms(device))
    print(f"  fused_sweep K={CR_K} (c={plan}) bound {bms:.4f} ms ({bby}), "
          f"bound / time {bms / t['fused_sweep_cuda_k512'][0]:.3f}; before "
          f"its redesign (PERF.md) {FUSED_BEFORE_MS['k512']} ms")
    bounds["fused_sweep_k512"] = (bms, bby)

    t0 = time.perf_counter()
    sft = spike_factor(band, K=CR_K, block_b=BLOCK, store_spikes=True,
                       spike_dtype=torch.bfloat16, inverter="newton_fixed",
                       reduced="thomas")
    torch.cuda.synchronize()
    print(f"  spike_factor K={CR_K} reduced='thomas': "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    xc, xt = spike_solve(sf, rhs), spike_solve(sft, rhs)
    _, dx = kernel_err(xc, xt)
    print(f"  spike_solve K={CR_K}: CR against Thomas reduced solves "
          f"{dx:.3e}")
    check(dx <= 1e-4, f"K={CR_K} CR and Thomas reduced solves differ: {dx}")
    best = {}
    for label, f in (("cr", sf), ("thomas", sft), ("thomas", sft),
                     ("cr", sf)):
        ms = time_ms(lambda: spike_solve(f, rhs), iters=5)
        print(f"  spike_solve_k512_{label} turn: {ms[0]:.4f} ms median")
        if label not in best or ms[0] < best[label][0]:
            best[label] = ms
    for label, f in (("cr", sf), ("thomas", sft)):
        show(f"spike_solve_k512_{label}", best[label])
        busy, count = profile_launches(lambda: spike_solve(f, rhs))
        t[f"spike_solve_k512_{label}_device"] = (busy, 0.0)
        print(f"  spike_solve_k512_{label}: device busy {busy:.3f} ms, "
              f"{count} launches a solve")
    del sft
    return diff


def phase_methods_flagship(band, rhs, device, t):
    """C: the partition methods on the flagship (K = 64, b = 128) through
    ``solve`` (gmres, rtol 1e-8), each PC built once (``make_pc``, timed):
    ``-pc_spike_method lu`` and ``cr``, whose factors #1's rule refuses, so
    their sweeps are plain (#1 launched 0 times, #2 once an operator
    apply); ``-pc_spike_inverter newton_pan`` (an inv factor: #1 once an
    apply and once for the safety net's probe).  Each solve timed, and the
    plain sweeps' host launches counted (torch.profiler)."""
    import torch
    from spike_petsc_tpu_torch import Options, solve
    from spike_petsc_tpu_torch.ops.band import banded_matvec
    from spike_petsc_tpu_torch.solvers.pc import make_pc
    show = shower(t)
    for name, extra in METHOD_CASES:
        opts = Options(dict(PC_OPTIONS, **extra))
        reset_launches()
        t0 = time.perf_counter()
        pc = make_pc("spike", band, opts)
        torch.cuda.synchronize()
        factor_ms = (time.perf_counter() - t0) * 1e3
        res = solve(band, rhs, ksp_type="gmres", pc=pc, rtol=1e-8)
        launches = read_launches()
        relres = float(torch.linalg.norm(banded_matvec(band, res.x) - rhs)
                       / torch.linalg.norm(rhs))
        expected = gmres_expected(res.its, launches, "fused_sweep",
                                  "band_matvec")
        if name == "newton_pan":
            expected["fused_sweep"] += 1         # the safety net's probe
            # an inv reduced system: the reduced kernel once a solve
            expected["reduced_thomas"] = expected["fused_sweep"]
        else:
            expected["fused_sweep"] = 0          # plain sweeps
        print(f"gmres+spike -pc_spike_{'inverter' if name == 'newton_pan' else 'method'} "
              f"{name} (flagship K={K}): {res.its} its, reason "
              f"{res.reason}, true relres (f32) {relres:.3e}; PC set-up "
              f"{factor_ms:.1f} ms ({pc.describe()}); launches {launches}; "
              f"expected {expected}")
        check(res.reason > 0 and res.its <= GMRES_ITS_MAX and relres <= 1e-4,
              f"method {name}: {res.its} its, reason {res.reason}, relres "
              f"{relres}")
        check(launches == expected, f"method {name} launches {launches}")
        t[f"method_{name}_factor"] = (factor_ms, 0.0)
        show(f"method_{name}_solve", time_ms(
            lambda: solve(band, rhs, ksp_type="gmres", pc=pc, rtol=1e-8),
            reps=2))
        busy, count = profile_launches(lambda: pc.apply(rhs))
        print(f"  method {name}: one PC apply {busy:.3f} ms of device time, "
              f"{count} launches")
        del pc, res
        torch.cuda.empty_cache()


def phase_grouped(band, rhs, device):
    """D: ``spike_factor_grouped`` (8 groups of 8 partitions) against
    ``spike_factor`` on the flagship: the factor blocks within
    GROUPED_FACTOR_TOL, the solves within GROUPED_SOLVE_TOL, and the peak
    device memory of each (``torch.cuda.max_memory_allocated`` above what
    was allocated before it, reset in between)."""
    import torch
    from spike_petsc_tpu_torch.ops.spike import (spike_factor,
                                                 spike_factor_grouped,
                                                 spike_solve)
    kw = dict(block_b=BLOCK, store_spikes=True, spike_dtype=torch.bfloat16,
              inverter="newton_fixed")
    peaks, facts, secs = {}, {}, {}
    for label in ("monolithic", "grouped", "monolithic_again"):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        f = (spike_factor_grouped(band, K, GROUPS, **kw)
             if label == "grouped" else spike_factor(band, K, **kw))
        torch.cuda.synchronize()
        secs[label] = time.perf_counter() - t0
        peaks[label] = (torch.cuda.max_memory_allocated() - before) / 2**30
        facts[label] = f
        if label == "monolithic_again":
            del facts[label]
    sm, sg = facts["monolithic"], facts["grouped"]
    fdiff = max(kernel_err(getattr(sg.fact, nm), getattr(sm.fact, nm))[1]
                for nm in ("F", "U", "Sinv"))
    fdiff = max(fdiff, kernel_err(sg.V, sm.V)[1], kernel_err(sg.W, sm.W)[1],
                kernel_err(sg.red_fact.Sinv, sm.red_fact.Sinv)[1])
    _, xdiff = kernel_err(spike_solve(sg, rhs), spike_solve(sm, rhs))
    stored = sum(a.numel() * a.element_size() for a in (
        sm.fact.F, sm.fact.U, sm.fact.Sinv, sm.V, sm.W)) / 2**30
    print(f"spike_factor_grouped (flagship, K={K}, {GROUPS} groups): factor "
          f"blocks within {fdiff:.3e} of spike_factor's, solves within "
          f"{xdiff:.3e}; peak device memory above the band: monolithic "
          f"{peaks['monolithic']:.3f} GiB (again {peaks['monolithic_again']:.3f}),"
          f" grouped {peaks['grouped']:.3f} GiB; the stored factor and "
          f"spikes {stored:.3f} GiB; {secs['monolithic']:.2f} s, "
          f"{secs['grouped']:.2f} s")
    check(fdiff <= GROUPED_FACTOR_TOL and xdiff <= GROUPED_SOLVE_TOL,
          f"grouped factor {fdiff}, solve {xdiff}")
    return peaks


def phase_factor_surface_reference(device):
    """E: the small cases on the card (f64: the plain sweeps, #6 for the
    operator) against the port's CPU path (f64), within FACTOR_REF_TOL of
    max|x|: the zero-diagonal testbed at n = 2e4 (spike and lu PCs, shifted;
    iteration counts equal), K = 300 on a w = 41 band (the CR reduced
    system), and the lu, cr and newton_pan PCs at K = 8."""
    import torch
    from spike_petsc_tpu_torch import BandedMatrix, Options, solve
    from spike_petsc_tpu_torch.ops.cyclic import CRFactor
    from spike_petsc_tpu_torch.solvers.pc import make_pc
    for pc_name in ZERODIAG_PCS:
        argv = zerodiag_argv(pc_name, True, n=FACTOR_REF_N) + ["-x64", "1"]
        got, ref = {}, {}
        rc_c, _ = run_testbed(argv, got)
        rc_h, _ = run_testbed(argv + ["-platform", "cpu"], ref)
        rg, rh = got["result"], ref["result"]
        _, dx = kernel_err(rg.x.cpu(), rh.x)
        print(f"zerodiag {pc_name} shifted n={FACTOR_REF_N} f64: card "
              f"{rg.its} its vs CPU {rh.its} its, max|x_card - x_cpu| / "
              f"max|x_cpu| {dx:.3e}")
        check(rc_c == rc_h == 0 and rg.its == rh.its and dx <= FACTOR_REF_TOL,
              f"zerodiag {pc_name} card against CPU: {rg.its}/{rh.its} its, "
              f"{dx}")
    band, _ = flagship_band(FACTOR_REF_N, 20, device, seed=SEED + 31)
    a64 = BandedMatrix(data=band.data.double(), kl=20, ku=20)
    cpu = BandedMatrix(data=a64.data.cpu(), kl=20, ku=20)
    b64 = torch.ones(FACTOR_REF_N, dtype=torch.float64, device=device)
    for label, opts in (
            ("K=300", {"pc_spike_partitions": 300, "pc_spike_block": 64}),
            ("lu", {"pc_spike_partitions": 8, "pc_spike_block": 64,
                    "pc_spike_method": "lu"}),
            ("cr", {"pc_spike_partitions": 8, "pc_spike_block": 64,
                    "pc_spike_method": "cr"}),
            ("newton_pan", {"pc_spike_partitions": 8, "pc_spike_block": 64,
                            "pc_spike_inverter": "newton_pan"})):
        pc = make_pc("spike", a64, Options(dict(opts)))
        got = solve(a64, b64, ksp_type="gmres", pc=pc, rtol=1e-12)
        ref = solve(cpu, b64.cpu(), ksp_type="gmres", pc_type="spike",
                    options=Options(dict(opts)), rtol=1e-12)
        _, dx = kernel_err(got.x.cpu(), ref.x)
        red = type(pc_factor(pc).red_fact).__name__
        print(f"spike {label} n={FACTOR_REF_N} w=41 f64 (reduced {red}): "
              f"card {got.its} its vs CPU {ref.its} its, max|x_card - x_cpu|"
              f" / max|x_cpu| {dx:.3e}")
        check(got.its == ref.its and got.reason > 0 and dx <= FACTOR_REF_TOL,
              f"spike {label} card against CPU: {got.its}/{ref.its} its, "
              f"{dx}")
        if label == "K=300":
            check(isinstance(pc_factor(pc).red_fact, CRFactor),
                  f"K=300 reduced factor {red}")


# ---------------------------------------------------------------------------
# the remaining PCs: sor, ksp, asm, composite, fieldsplit, mg
# ---------------------------------------------------------------------------

def nonzero(launches):
    return {k: v for k, v in launches.items() if v}


def krylov_applies(ksp, its, restart=30):
    """(PC applies, operator applies) of ``ksp`` from x0 = 0 over ``its``
    iterations without the true-residual monitor: gmres (left PC) as
    ``gmres_expected``; fgmres (right, flexible) one of each an iteration
    and an operator apply for each cycle's residual; cg one of each before
    the loop and one an iteration."""
    cycles = -(-its // restart)
    if ksp == "gmres":
        return 2 + its + cycles - 1, 1 + its + cycles - 1
    if ksp == "fgmres":
        return its, 1 + its + cycles - 1
    if ksp == "cg":
        return its + 1, its + 1
    raise ValueError(f"no apply counts for {ksp!r}")


def counted(pc):
    """(``pc`` with its applies counted, the count: a one-element list)."""
    import dataclasses
    count = [0]

    def apply(r):
        count[0] += 1
        return pc.apply(r)
    return dataclasses.replace(pc, apply=apply), count


def apply_launches(pc, r):
    """The kernels one apply of ``pc`` on ``r`` launches (the nonzero
    counts)."""
    reset_launches()
    pc.apply(r)
    return nonzero(read_launches())


def pc_path(label, band, rhs, pc, ksp, per_apply, t, exact=True):
    """``solve(band, rhs, ksp_type=ksp, pc=pc)`` (x = 1) at PCS_RTOL with
    the kernels' launches counted around it.  With ``exact`` they are held
    to ``per_apply`` (one apply's launches) times the PC applies, plus one
    #2 an operator apply (``krylov_applies``).  Returns the launches."""
    import torch
    from spike_petsc_tpu_torch import solve
    from spike_petsc_tpu_torch.ops.band import banded_matvec
    cpc, count = counted(pc)
    reset_launches()
    t0 = time.perf_counter()
    res = solve(band, rhs, ksp_type=ksp, pc=cpc, rtol=PCS_RTOL,
                maxit=PCS_MAXIT)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    launches = nonzero(read_launches())
    true_rel = float(torch.linalg.norm(banded_matvec(band, res.x) - rhs)
                     / torch.linalg.norm(rhs))
    xerr = float((res.x - 1).abs().max())
    applies, matvecs = krylov_applies(ksp, res.its)
    expected = {k: v * applies for k, v in per_apply.items()}
    expected["band_matvec"] = expected.get("band_matvec", 0) + matvecs
    t[f"{label}_solve_wall"] = (wall, 0.0)
    print(f"{label}: {ksp} {res.its} its, reason {res.reason}, true relres "
          f"(f32) {true_rel:.3e}, max|x - 1| {xerr:.3e}, {count[0]} PC "
          f"applies, solve wall {wall:.2f} ms (host clock)")
    print(f"  launches {launches}"
          + (f", expected {expected}" if exact else " (not fixed by the "
             "path: every apply is an inner solve)"))
    check(res.reason > 0 and bool(torch.isfinite(res.x).all())
          and true_rel <= PCS_RELRES_MAX and xerr <= 1e-3,
          f"{label}: reason {res.reason}, relres {true_rel}, max|x-1| {xerr}")
    if exact:
        check(count[0] == applies and launches == expected,
              f"{label}: launches {launches} over {count[0]} applies, "
              f"expected {expected}")
    return launches


def pc_timings(label, make, pc, r, t):
    """The PC's set-up (``make``, unless None) and one apply by CUDA events
    (median and spread), one apply's device busy time, CUDA launches and
    largest items (torch.profiler), and its idle share (1 - busy / apply
    time)."""
    show = shower(t)
    if make is not None:
        show(f"{label}_setup", time_ms(make, reps=3))
    show(f"{label}_apply", time_ms(lambda: pc.apply(r)))
    for _ in range(3):          # the profiler sometimes drops a window
        busy, items = device_profile(lambda: pc.apply(r), top=4)
        _, n_launch = profile_launches(lambda: pc.apply(r))
        if busy > 0 and n_launch > 0:
            break
    print(f"  {label} apply: device busy {busy:.4f} ms, {n_launch} CUDA "
          f"launches, idle share {1 - busy / t[label + '_apply'][0]:.3f}; "
          + "; ".join(f"{k} x{c} {ms:.4f} ms" for k, c, ms in items))


def sweep_check(label, kern, fact, r, t, bounds):
    """``kern`` (#1's or #9's wrapper) on ``fact`` against its plain
    version, timed beside the solve's bound (``sweep_bound``, #1's and
    #9's alike).  Returns the relative error."""
    from spike_petsc_tpu_torch.ops.cuda import fused_sweep as cfs
    show = shower(t)
    _, err = kernel_err(kern(fact, r), kern(fact, r, impl="plain"))
    show(label, time_ms(lambda: kern(fact, r), iters=10))
    K, nb, b, _ = fact.F.shape
    bounds[label] = sweep_bound(fact)
    print(f"  {label} (K={K} nb={nb} b={b}) against its plain version "
          f"{err:.3e}; bound {bounds[label][0]:.4f} ms ({bounds[label][1]}), "
          f"bound / time {bounds[label][0] / t[label][0]:.3f}")
    check(err <= KERNEL_TOL, f"{label}: {err}")
    return err


def phase_pcs_config2(band, rhs, device, t, bounds, errs):
    """SOR on config 2 (n = 1e6, bandwidth 33, f32): at ``-pc_sor_block 64``
    the symmetric sweep with cg, the forward sweep with gmres and
    ``-pc_sor_its 2`` with cg (#7 for its residual), each sweep one #9
    pair (K = 1, nb = 15625: #1's rule refuses it), launches held exactly;
    #9 on the pseudo-factor and #7 on its blocks against their plain
    versions; then SOR's default block (the bandwidth, 16) at n = 2e4,
    which no kernel takes: the plain sweep, timed and its CUDA launches
    counted.  Returns each path's launches."""
    import torch
    from spike_petsc_tpu_torch import Options
    from spike_petsc_tpu_torch.ops.blocktri import (band_to_blocktri,
                                                    batched_inverse)
    from spike_petsc_tpu_torch.ops.cuda import blocktri_matvec as cbt
    from spike_petsc_tpu_torch.ops.cuda import sweeps as csw
    from spike_petsc_tpu_torch.solvers.pc import _sor_factor, make_pc
    paths = {}
    for label, extra, ksp, want in (
            ("sor_ssor", {}, "cg", {"sweeps": 2}),
            ("sor_forward", {"pc_sor_type": "forward"}, "gmres",
             {"sweeps": 2}),
            ("sor_its2", {"pc_sor_its": 2}, "cg",
             {"sweeps": 4, "blocktri_matvec": 1})):
        opts = Options(dict(extra, pc_sor_block=SOR_BLOCK))

        def make(opts=opts):
            return make_pc("sor", band, opts)
        pc = make()
        per_apply = apply_launches(pc, rhs)
        print(f"{label} (config 2, {pc.info}): one apply launches "
              f"{per_apply}")
        check(per_apply == want, f"{label}: one apply launched {per_apply}, "
              f"expected {want}")
        paths[label] = pc_path(label, band, rhs, pc, ksp, per_apply, t)
        pc_timings(label, make, pc, rhs, t)
        del pc
    torch.cuda.empty_cache()

    T = band_to_blocktri(band, SOR_BLOCK)
    fact = _sor_factor(T, batched_inverse(T.D), 1.0, "symmetric")
    gen = torch.Generator(device=device).manual_seed(SEED + 40)
    r = torch.randn((1, T.nb, T.b), generator=gen, device=device)
    errs["sweeps"] = max(errs["sweeps"], sweep_check(
        "sor_sweeps", csw.blocktri_solve_batched_cuda, fact, r, t, bounds))
    x = r.reshape(-1)
    _, e7 = kernel_err(cbt.blocktri_matvec_cuda(T, x),
                       cbt.blocktri_matvec_cuda(T, x, impl="plain"))
    shower(t)("sor_blocktri_matvec",
              time_ms(lambda: cbt.blocktri_matvec_cuda(T, x), iters=10))
    bounds["sor_blocktri_matvec"] = roofline(
        3 * T.D.numel() * 4 + 2 * x.numel() * 4, 2 * 3 * T.D.numel())
    print(f"  blocktri_matvec (config 2's blocks: nb={T.nb} b={T.b}) "
          f"against its plain version {e7:.3e}; bound "
          f"{bounds['sor_blocktri_matvec'][0]:.4f} ms (bytes)")
    check(e7 <= KERNEL_TOL, f"blocktri_matvec on config 2's blocks: {e7}")
    errs["blocktri_matvec"] = max(errs["blocktri_matvec"], e7)
    del T, fact, r, x
    torch.cuda.empty_cache()

    small, srhs = spd_band(SOR_SMALL_N, SPD_HALF_BW, device, seed=SEED + 41)

    def make_small():
        return make_pc("sor", small, Options())
    pc = make_small()
    per_apply = apply_launches(pc, srhs)
    busy, n_launch = profile_launches(lambda: pc.apply(srhs))
    print(f"sor at its default block {pc.info['block']} (n = {SOR_SMALL_N}, "
          f"nb = {-(-SOR_SMALL_N // pc.info['block'])}): no kernel's rule "
          f"takes it, the plain sweep: {n_launch} CUDA launches an apply, "
          f"device busy {busy:.4f} ms; kernels {per_apply}")
    check(per_apply == {}, f"sor block 16 launched {per_apply}")
    paths["sor_block16"] = pc_path("sor_block16", small, srhs, pc, "cg", {},
                                   t)
    pc_timings("sor_block16", make_small, pc, srhs, t)
    return paths


def phase_pcs_testbed2(device, t, bounds, errs):
    """Config 2 through ``testbed2.main`` (``-problem spd:1000000:16``,
    f32): the reference's Schur fieldsplit recipe (testbed2.c:4), fgmres
    with ``-pc_type fieldsplit -pc_fieldsplit_type schur`` and lu on both
    fields (each n = 5e5, block 64: #9 at K = 1, nb = 7813), ``-log_view``
    stages (the set-up slices the host CSR; its parts are the fieldsplit
    PC's own stages).  Each Schur apply is three lu applies (two #9
    launches each) and two CSR products, so the launches are 6 #9 an
    fgmres iteration and one #2 an operator apply, held exactly.  #9 on
    field 0's lu factor (the PC's ``inner``) against its plain version.
    Returns the launches."""
    import torch
    from spike_petsc_tpu_torch import testbed2
    from spike_petsc_tpu_torch.ops.band import banded_matvec
    from spike_petsc_tpu_torch.ops.cuda import sweeps as csw
    from spike_petsc_tpu_torch.utils.profiling import stage_times
    rec = {}
    reset_launches()
    t0 = time.perf_counter()
    rc, out = run_testbed(TESTBED2_ARGV, rec, entry=testbed2.main)
    launches = nonzero(read_launches())
    wall = time.perf_counter() - t0
    stages = stage_times()
    for line in out.splitlines():
        print(f"  testbed2| {line}")
    res, op, b, pc = rec["result"], rec["operator"], rec["b"], rec["pc"]
    true_rel = float(torch.linalg.norm(banded_matvec(op, res.x) - b)
                     / torch.linalg.norm(b))
    applies, matvecs = krylov_applies("fgmres", res.its)
    expected = {"sweeps": 6 * applies, "band_matvec": matvecs}
    print(f"fieldsplit schur (testbed2, n={op.n}, f32): exit code {rc}, "
          f"{res.its} its, reason {res.reason}, true relres (f32) "
          f"{true_rel:.3e}, {wall:.2f} s in all; stages (s) "
          + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
          + f"; PC {pc.info}")
    print(f"  launches {launches}, expected {expected}")
    check(rc == 0 and res.reason > 0 and true_rel <= PCS_RELRES_MAX,
          f"testbed2 fieldsplit: rc {rc}, reason {res.reason}, {true_rel}")
    check(launches == expected, f"testbed2 fieldsplit launches {launches}")
    t["fieldsplit_schur_setup_stage"] = (stages["PCSetUp"] * 1e3, 0.0)
    sf = pc_factor(pc.inner)
    gen = torch.Generator(device=device).manual_seed(SEED + 46)
    r = torch.randn((sf.K, sf.nb, sf.b), generator=gen, device=device)
    errs["sweeps"] = max(errs["sweeps"], sweep_check(
        "fieldsplit_sweeps", csw.blocktri_solve_batched_cuda, sf.fact, r, t,
        bounds))
    del sf, r
    pc_timings("fieldsplit_schur", None, pc, b, t)
    return launches


def phase_pcs_flagship(band, rhs, device, t, bounds, errs):
    """The flagship (n = 1e6, w = 201, f32), gmres at PCS_RTOL: asm with
    its defaults (16 blocks, overlap 100, block 128: windows of 490 block
    rows, #9) restrict and basic; composite jacobi + bjacobi (16 blocks,
    block 128: #9) additive and multiplicative (one #2 a stage); launches
    held exactly.  fgmres with ``-pc_type ksp`` (inner gmres + spike,
    K = 64, b = 128: #1, #2), whose launches the inner solves set.  #9 at
    asm's and bjacobi's factor shapes against its plain version.  Returns
    each path's launches."""
    import torch
    from spike_petsc_tpu_torch import Options
    from spike_petsc_tpu_torch.ops.band import pad_banded
    from spike_petsc_tpu_torch.ops.cuda import sweeps as csw
    from spike_petsc_tpu_torch.ops.spike import spike_factor
    from spike_petsc_tpu_torch.solvers.pc import make_pc
    paths = {}
    cases = (
        ("asm_restrict", "asm", {}, "gmres", True),
        ("asm_basic", "asm", {"pc_asm_type": "basic"}, "gmres", True),
        ("composite_additive", "composite",
         {"pc_composite_pcs": "jacobi,bjacobi"}, "gmres", True),
        ("composite_multiplicative", "composite",
         {"pc_composite_pcs": "jacobi,bjacobi",
          "pc_composite_type": "multiplicative"}, "gmres", True),
        ("ksp_gmres_spike", "ksp",
         {"ksp_ksp_type": "gmres", "ksp_pc_type": "spike",
          "ksp_pc_spike_partitions": K, "ksp_pc_spike_block": BLOCK},
         "fgmres", False))
    for label, name, opts, ksp, exact in cases:
        def make(name=name, opts=opts):
            return make_pc(name, band, Options(dict(opts)))
        pc = make()
        per_apply = apply_launches(pc, rhs)
        print(f"{label} (flagship, {pc.info}): one apply launches "
              f"{per_apply}")
        check(per_apply.get("sweeps", 0) + per_apply.get("fused_sweep", 0)
              > 0, f"{label}: no sweep kernel in an apply: {per_apply}")
        paths[label] = pc_path(label, band, rhs, pc, ksp, per_apply, t,
                               exact=exact)
        pc_timings(label, make, pc, rhs, t)
        del pc
        torch.cuda.empty_cache()
    gen = torch.Generator(device=device).manual_seed(SEED + 42)
    owned = -(-band.n // 16)                  # rows a block owns (16 blocks)
    for label, rows in (("asm_sweeps", owned + 2 * HALF_BW),
                        ("bjacobi_sweeps", owned)):
        m = -(-rows // BLOCK) * BLOCK         # asm's window, bjacobi's rows
        sf = spike_factor(pad_banded(band, 16 * m), K=16, block_b=BLOCK,
                          truncated=True)
        r = torch.randn((16, sf.nb, BLOCK), generator=gen, device=device)
        errs["sweeps"] = max(errs["sweeps"], sweep_check(
            label, csw.blocktri_solve_batched_cuda, sf.fact, r, t, bounds))
        del sf
    torch.cuda.empty_cache()
    return paths


def phase_pcs_config1(device, t, bounds, errs):
    """Config 1 through the testbed (``-problem tridiag``, n = 1e5, f32):
    cg with ``-pc_type mg`` at rtol 1e-8; the levels, the iteration count
    (JAX's bound MG_ITS_MAX), the answer against an f64 host solve, and the
    launches held exactly: each V-cycle two #2 a level above the coarsest
    and one #1 on the coarse factor (block 64, nb = 2), one more #2 an
    operator apply.  The coarse factor's #1 against its plain version;
    the PC's set-up and apply times.  Returns the launches."""
    import numpy as np
    import torch
    from spike_petsc_tpu_torch import Options
    from spike_petsc_tpu_torch.ops.cuda import fused_sweep as cfs
    from spike_petsc_tpu_torch.ops.spike import sweep_route
    from spike_petsc_tpu_torch.solvers.mg import _build_hierarchy
    from spike_petsc_tpu_torch.solvers.pc import make_pc
    rec = {}
    reset_launches()
    t0 = time.perf_counter()
    rc, out = run_testbed(MG_ARGV, rec)
    launches = nonzero(read_launches())
    wall = time.perf_counter() - t0
    for line in out.splitlines()[-12:]:
        print(f"  testbed| {line}")
    res, op, b, pc = rec["result"], rec["operator"], rec["b"], rec["pc"]
    x64 = host_solve_f64(op, b)
    rel = float(np.linalg.norm(res.x.double().cpu().numpy() - x64)
                / np.linalg.norm(x64))
    levels = pc.info["levels"]
    applies, matvecs = krylov_applies("cg", res.its)
    expected = {"fused_sweep": applies,
                "band_matvec": 2 * (levels - 1) * applies + matvecs}
    print(f"cg+mg (config 1, n={op.n}, f32): exit code {rc}, {res.its} its "
          f"(JAX's bound {MG_ITS_MAX}), reason {res.reason}, "
          f"||x - x64|| / ||x64|| {rel:.3e}, {wall:.2f} s in all; PC "
          f"{pc.info}")
    print(f"  launches {launches}, expected {expected} ({2 * (levels - 1)} "
          f"#2 and one #1 a V-cycle)")
    check(rc == 0 and res.reason > 0 and res.its <= MG_ITS_MAX
          and rel <= MG_REL_MAX, f"config 1 mg: rc {rc}, {res.its} its, "
          f"reason {res.reason}, error {rel}")
    check(launches == expected, f"config 1 mg launches {launches}")
    levels_, fact = _build_hierarchy(op, Options())
    route = sweep_route(fact.fact, fact.b, torch.float32, True)
    print(f"  mg coarse factor: n={levels_[-1].n}, K=1, b={fact.b}, "
          f"nb={fact.nb}, route {route}")
    check(route == "fused", f"mg coarse route {route}")
    gen = torch.Generator(device=device).manual_seed(SEED + 43)
    r = torch.randn((1, fact.nb, fact.b), generator=gen, device=device)
    errs["fused_sweep"] = max(errs["fused_sweep"], sweep_check(
        "mg_coarse_fused_sweep", cfs.blocktri_solve_fused_cuda, fact.fact, r,
        t, bounds))
    pc_timings("mg", lambda: make_pc("mg", op, Options()), pc, b, t)
    return launches


def phase_pcs_reference(device):
    """Each recipe of ``models.pc_recipes`` (every PC of this slice) through
    ``solve`` at n = 2e4 on config 2's matrix (k = 16; composite and
    fieldsplit on the host CSR, the others on the band): the card in f32
    against the CPU in f64 at rtol 1e-6, iteration counts within 1 and the
    answers within 1e-4 of max|x| (``pc_recipes.recipe_agrees``)."""
    from spike_petsc_tpu_torch.models import pc_recipes
    for name, argv, ksp in pc_recipes.PC_RECIPES:
        card, cpu, err = pc_recipes.solve_recipe(
            name, argv, ksp, device, n=PCS_REF_N, k=SPD_HALF_BW,
            seed=SEED + 44)
        print(f"n={PCS_REF_N} {name} {argv} {ksp}: card {card.its} its, "
              f"CPU f64 {cpu.its} its; max|x_card - x_cpu| / max|x_cpu| "
              f"{err:.3e}")
        check(pc_recipes.recipe_agrees(card, cpu, err),
              f"{name} card vs CPU: its {card.its} / {cpu.its}, err {err}")


def complex_band(n, half_bw, device, seed, hermitian=False):
    """A complex64 band in diagonal storage, built on the device by JAX's
    tests/test_complex.py rule: entries N(0,1) + i N(0,1) inside the
    matrix (zero outside), the diagonal the row's absolute sum + 1.
    ``hermitian``: the upper diagonals drawn, the lower ones their
    conjugates, the diagonal real.  Returns (band, x, b = A x) with x a
    seeded complex vector."""
    import torch
    from spike_petsc_tpu_torch import BandedMatrix
    from spike_petsc_tpu_torch.ops.band import banded_matvec
    gen = torch.Generator(device=device).manual_seed(seed)
    k, w = half_bw, 2 * half_bw + 1

    def crandn(*shape):
        re = torch.randn(shape, generator=gen, device=device)
        return torch.complex(re, torch.randn(shape, generator=gen,
                                             device=device))
    if hermitian:
        data = torch.zeros((n, w), dtype=torch.complex64, device=device)
        for d in range(1, k + 1):
            v = crandn(n - d)
            data[:n - d, k + d] = v
            data[d:, k - d] = v.conj()
    else:
        data = crandn(n, w)
        col = (torch.arange(n, device=device)[:, None]
               + torch.arange(w, device=device)[None, :] - k)
        data[(col < 0) | (col >= n)] = 0
        del col
    data[:, k] = data.abs().sum(dim=1) + 1
    band = BandedMatrix(data=data, kl=k, ku=k)
    x = crandn(n)
    return band, x, banded_matvec(band, x)


def complex_solve(label, band, x, b, ksp, pc, opts, t):
    """``solve`` of a complex band on the card: converged at COMPLEX_RTOL,
    true relres <= COMPLEX_RELRES_MAX, no kernel launched, every tensor on
    the card, the partition sweep's route plain; the PC's factor and one
    apply timed."""
    import torch
    from spike_petsc_tpu_torch import Options, solve
    from spike_petsc_tpu_torch.ops.band import banded_matvec
    from spike_petsc_tpu_torch.ops.spike import spike_solve, sweep_route
    from spike_petsc_tpu_torch.solvers.pc import make_pc
    from spike_petsc_tpu_torch.utils.debug import _tensors
    show = shower(t)
    t0 = time.perf_counter()
    p = make_pc(pc, band, Options(dict(opts)))
    torch.cuda.synchronize()
    setup = (time.perf_counter() - t0) * 1e3
    reset_launches()
    t0 = time.perf_counter()
    res = solve(band, b, ksp_type=ksp, pc=p, rtol=COMPLEX_RTOL, maxit=100)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    launches = nonzero(read_launches())
    relres = float(torch.linalg.norm(banded_matvec(band, res.x) - b)
                   / torch.linalg.norm(b))
    xerr = float((res.x - x).abs().max())
    sf = pc_factor(p)
    route = sweep_route(sf.fact, sf.b, b.dtype, True)
    on_card = all(v.is_cuda for v in _tensors(sf)) and res.x.is_cuda
    t[f"{label}_setup"] = (setup, 0.0)
    t[f"{label}_solve_wall"] = (wall, 0.0)
    print(f"{label}: {ksp}+{pc} {res.its} its, reason {res.reason}, true "
          f"relres (c64) {relres:.3e}, max|x - x*| {xerr:.3e}; PC set-up "
          f"{setup:.1f} ms, solve {wall:.1f} ms (host clock); sweep route "
          f"{route}, launches {launches}, every tensor on the card: "
          f"{on_card}")
    show(f"{label}_apply", time_ms(lambda: spike_solve(sf, b), reps=3))
    check(res.reason > 0 and relres <= COMPLEX_RELRES_MAX
          and res.x.dtype == torch.complex64
          and bool(torch.isfinite(res.x).all()),
          f"{label}: reason {res.reason}, relres {relres}")
    check(not launches and route == "plain" and on_card,
          f"{label}: launches {launches}, route {route}, card {on_card}")
    return res


def phase_complex(device, t):
    """Complex scalars on the card: the flagship's shape in complex64 (gmres
    + spike, K = 64, b = 128, inv), config 2's shape Hermitian (cg +
    cholesky with config 2's options), and n = 2e4 on the card against the
    CPU in complex128."""
    import torch
    from spike_petsc_tpu_torch import BandedMatrix, Options, solve
    from spike_petsc_tpu_torch.ops.spike import spike_factor
    show = shower(t)
    band, x, b = complex_band(N, HALF_BW, device, SEED + 40)
    opts = {"pc_spike_partitions": K, "pc_spike_block": BLOCK}
    complex_solve("complex_flagship", band, x, b, "gmres", "spike", opts, t)
    show("complex_flagship_factor", time_ms(
        lambda: spike_factor(band, K=K, block_b=BLOCK), reps=2))
    del band, x, b
    torch.cuda.empty_cache()
    band, x, b = complex_band(SPD_N, SPD_HALF_BW, device, SEED + 41,
                              hermitian=True)
    complex_solve("complex_config2", band, x, b, "cg", "cholesky",
                  SPD_OPTIONS, t)
    del band, x, b
    torch.cuda.empty_cache()
    band, x, b = complex_band(COMPLEX_REF_N, 20, device, SEED + 42)
    opts = {"pc_spike_partitions": 8, "pc_spike_block": 64}
    got = solve(band, b, ksp_type="gmres", pc_type="spike",
                options=Options(dict(opts)), rtol=1e-8)
    cpu = BandedMatrix(data=band.data.to(torch.complex128).cpu(), kl=20,
                       ku=20)
    ref = solve(cpu, b.to(torch.complex128).cpu(), ksp_type="gmres",
                pc_type="spike", options=Options(dict(opts)), rtol=1e-8)
    err = float((got.x.to(torch.complex128).cpu() - ref.x).abs().max()
                / ref.x.abs().max())
    print(f"complex n={COMPLEX_REF_N} w=41: card c64 {got.its} its vs CPU "
          f"c128 {ref.its} its, max|x_card - x_cpu| / max|x_cpu| {err:.3e}")
    check(err <= COMPLEX_REF_TOL and abs(got.its - ref.its) <= 1
          and got.reason > 0 and ref.reason > 0,
          "complex: card and CPU reference disagree")


def phase_gmres_many_options(band, device, t):
    """``make_solver_many(ksp_type="gmres")`` on the flagship at r = 32 with
    the spike PC and ``-mat_matvec_impl banded_cuda``, which takes the
    multi-RHS band kernel (#11) as 'auto' does: the left PC (as before),
    then the right PC with each CGS refinement.  Every column converged at
    its rtol (GMRES_MANY_CASES) with a true f32 relres <= 1e-4; #4 (the PC
    through ``spike_solve_many``) and #11 launched, #2 not.  Each timed per right-hand side.  Returns the launches of
    the right-PC ``always`` run."""
    import torch
    from spike_petsc_tpu_torch import Options, make_solver_many
    from spike_petsc_tpu_torch.ops.band import banded_matvec
    show = shower(t)
    gen = torch.Generator(device=device).manual_seed(SEED + 43)
    X = torch.randn((N, NRHS), generator=gen, device=device)
    B = banded_matvec(band, X)
    right_launches = None
    for side, cgs, rtol in GMRES_MANY_CASES:
        opts = dict(PC_OPTIONS, ksp_pc_side=side,
                    ksp_gmres_cgs_refinement_type=cgs,
                    mat_matvec_impl="banded_cuda")
        server = make_solver_many(band, ksp_type="gmres", pc_type="spike",
                                  options=Options(opts), rtol=rtol, maxit=30)
        reset_launches()
        res = server(B)
        launches = nonzero(read_launches())
        relres = (torch.linalg.norm(banded_matvec(band, res.x) - B, dim=0)
                  / torch.linalg.norm(B, dim=0))
        its = res.its.tolist()
        name = f"gmres_many_{side}_{cgs}"
        print(f"{name} (r={NRHS}, rtol {rtol:g}): its min "
              f"{min(its)} max {max(its)}, reasons "
              f"{sorted(set(res.reason.tolist()))}, per-column true relres "
              f"(f32) max {float(relres.max()):.3e}; launches {launches}")
        check(bool((res.reason > 0).all()) and float(relres.max())
              <= SERVE_RELRES_MAX and bool(torch.isfinite(res.x).all()),
              f"{name}: reasons {res.reason.tolist()}, relres "
              f"{float(relres.max())}")
        check(launches.get("fused_sweep_many", 0) > 0
              and launches.get("band_matvec_many", 0) > 0
              and launches.get("band_matvec", 0) == 0,
              f"{name}: #4 or #11 did not run, or #2 did: {launches}")
        show(name, time_ms(lambda: server(B), reps=3))
        print(f"  {name} per RHS: {t[name][0] / NRHS:.4f} ms")
        if (side, cgs) == ("right", "always"):
            right_launches = launches
    print(f"  gmres_many right / left per RHS: "
          f"{t['gmres_many_right_always'][0] / t['gmres_many_left_always'][0]:.3f}"
          f"; bcgs serving (left, #11 operator) per RHS "
          f"{t['serve_bcgs_rtol1e-08'][0] / NRHS:.4f} ms")
    return right_launches


def autodiff_pass(data, rhs, kl, ku, K):
    """(x, data gradient, rhs gradient, forward launches, backward
    launches) of the loss sum(sin(x) x) through ``solve_banded_diff``."""
    import torch
    from spike_petsc_tpu_torch.ops.autodiff import solve_banded_diff
    d = data.detach().clone().requires_grad_(True)
    b = rhs.detach().clone().requires_grad_(True)
    reset_launches()
    x = solve_banded_diff(d, b, kl, ku, K)
    fwd = nonzero(read_launches())
    loss = (torch.sin(x) * x).sum()
    reset_launches()
    gd, gb = torch.autograd.grad(loss, (d, b))
    bwd = nonzero(read_launches())
    return x.detach(), gd, gb, fwd, bwd


def autodiff_plain(band, rhs, K, block):
    """The same gradients from the plain sweeps on the same factors:
    ``spike_solve(..., impl='plain')`` forward and backward."""
    import torch
    from spike_petsc_tpu_torch.ops.autodiff import band_cotangent
    from spike_petsc_tpu_torch.ops.spike import (spike_factor, spike_solve,
                                                 spike_transpose)
    sf = spike_factor(band, K=K, block_b=block)
    x = spike_solve(sf, rhs, impl="plain")
    g = torch.sin(x) + x * torch.cos(x)
    lam = spike_solve(spike_transpose(sf, band=band), g, impl="plain")
    return band_cotangent(lam, x, band.kl, band.ku), lam


def autodiff_case(label, band, rhs, K, block, want, t, adjoint=True):
    """One ``solve_banded_diff`` path on the card: its launches against
    ``want`` (each pass), the adjoint residual ||A^T lam - g|| / ||g||
    (held where ``adjoint``; config 1's kappa ~4e9 puts it far above
    AUTODIFF_ADJOINT_MAX in f32, so there it is printed beside the
    normwise backward error ||A^T lam - g|| / (||A||_1 ||lam|| + ||g||)),
    the gradients against the plain sweeps' (both held), forward and
    backward timed (CUDA events) with their device time.  Returns all
    launches."""
    import torch
    from spike_petsc_tpu_torch.ops.autodiff import solve_banded_diff
    from spike_petsc_tpu_torch.ops.band import banded_matvec, banded_transpose
    show = shower(t)
    kl, ku = band.kl, band.ku
    x, gd, gb, fwd, bwd = autodiff_pass(band.data, rhs, kl, ku, K)
    g = torch.sin(x) + x * torch.cos(x)
    res = torch.linalg.norm(banded_matvec(banded_transpose(band), gb) - g)
    adj = float(res / torch.linalg.norm(g))
    backward_err = float(res / (band.data.abs().sum(dim=1).max()
                                * torch.linalg.norm(gb)
                                + torch.linalg.norm(g)))
    gd_p, gb_p = autodiff_plain(band, rhs, K, block)
    err_d = float((gd - gd_p).abs().max() / gd_p.abs().max())
    err_b = float((gb - gb_p).abs().max() / gb_p.abs().max())
    print(f"{label} (K={K}, b={block}): launches forward {fwd}, backward "
          f"{bwd} (expected {want} each); adjoint residual "
          f"||A^T lam - g|| / ||g|| {adj:.3e} (normwise backward error "
          f"{backward_err:.3e}); against the plain sweeps: "
          f"data gradient {err_d:.3e}, rhs gradient {err_b:.3e}")
    check(fwd == want and bwd == want, f"{label}: launches {fwd}, {bwd}")
    check(not adjoint or adj <= AUTODIFF_ADJOINT_MAX,
          f"{label}: adjoint residual {adj}")
    check(max(err_d, err_b) <= AUTODIFF_PLAIN_TOL
          and bool(torch.isfinite(gd).all()),
          f"{label}: against plain {err_d}, {err_b}")
    d = band.data.detach().clone().requires_grad_(True)
    b = rhs.detach().clone().requires_grad_(True)

    def forward():
        return solve_banded_diff(d, b, kl, ku, K)
    x = forward()
    loss = (torch.sin(x) * x).sum()

    def backward():
        return torch.autograd.grad(loss, (d, b), retain_graph=True)
    show(f"{label}_forward", time_ms(forward, reps=3))
    show(f"{label}_backward", time_ms(backward, reps=3))
    for name, fn in (("forward", forward), ("backward", backward)):
        busy, items = device_profile(fn, top=4)
        print(f"  {label} {name}: device busy {busy:.3f} ms of "
              f"{t[f'{label}_{name}'][0]:.3f} ms; "
              + "; ".join(f"{k} x{c} {ms:.3f} ms" for k, c, ms in items))
    return {k: fwd.get(k, 0) + bwd.get(k, 0) for k in set(fwd) | set(bwd)}


def phase_autodiff(band, rhs, device, t):
    """``solve_banded_diff`` on the card: the flagship band in f32 at
    K = 64 (#1 both passes), config 1's band at K = 1 (nb = 1563: #9 both
    passes), and n = 2e4 against the CPU in f64.  Returns the launches of
    the two card paths."""
    import numpy as np
    import torch
    from spike_petsc_tpu_torch.convert import banded_from_numpy
    from spike_petsc_tpu_torch.ops.band import banded_matvec
    paths = {"autodiff_k64": autodiff_case(
        "autodiff_flagship", band, rhs, K, BLOCK,
        AUTODIFF_LAUNCHES["flagship"], t)}
    lap = banded_from_numpy(np.tile(np.float32([-1, 2, -1]), (CONFIG1_N, 1)),
                            1, 1, device=device)
    paths["autodiff_k1"] = autodiff_case(
        "autodiff_config1", lap, banded_matvec(lap, torch.ones(
            CONFIG1_N, device=device)), 1, CONFIG1_BLOCK,
        AUTODIFF_LAUNCHES["config1"], t, adjoint=False)
    small, srhs = flagship_band(AUTODIFF_REF_N, 20, device, seed=SEED + 44)
    _, gd, gb, _, _ = autodiff_pass(small.data, srhs, 20, 20, 8)
    _, gd64, gb64, _, _ = autodiff_pass(small.data.double().cpu(),
                                        srhs.double().cpu(), 20, 20, 8)
    err = max(float((gd.double().cpu() - gd64).abs().max()
                    / gd64.abs().max()),
              float((gb.double().cpu() - gb64).abs().max()
                    / gb64.abs().max()))
    print(f"autodiff n={AUTODIFF_REF_N} w=41 K=8: card f32 gradients "
          f"against CPU f64, max|d| / max|cpu| {err:.3e}")
    check(err <= AUTODIFF_REF_TOL, f"autodiff reference {err}")
    return paths


def phase_checks(band, rhs, sf, device, t):
    """``-pc_spike_check 1`` on the flagship (health OK), the unshifted
    zero-diagonal matrix at b = 3 with the lapack inverter (its singular
    pivots raise FloatingPointError), and the flagship factor (bf16
    spikes) through ``save_factorization`` / ``load_factorization``:
    the reloaded factor's solve bit-equal to the original's."""
    import os
    import torch
    from spike_petsc_tpu_torch import Options
    from spike_petsc_tpu_torch.io import load_factorization, save_factorization
    from spike_petsc_tpu_torch.models import problems
    from spike_petsc_tpu_torch.ops.spike import spike_solve
    from spike_petsc_tpu_torch.solvers.pc import make_pc
    from spike_petsc_tpu_torch.utils.debug import OK
    pc = make_pc("spike", band, Options(dict(PC_OPTIONS, pc_spike_check=1)))
    print(f"-pc_spike_check 1 on the flagship: health {pc.info['health']}")
    check(pc.info["health"] == OK, f"flagship health {pc.info['health']}")
    del pc
    n, k_parts, block = ZERODIAG_CHECK
    raised = ""
    try:
        make_pc("spike", problems.zero_diag_tridiag(n), Options({
            "pc_spike_check": 1, "pc_spike_inverter": "lapack",
            "pc_spike_partitions": k_parts, "pc_spike_block": block}),
            device=device, dtype=torch.float32)
    except FloatingPointError as e:
        raised = str(e)
    print(f"-pc_spike_check 1 on the unshifted zero-diagonal matrix "
          f"(n={n}, K={k_parts}, b={block}, lapack): {raised or 'no error'}")
    check("singular Schur pivots" in raised, "zero diagonal: no error")
    os.makedirs("build/checkpoints", exist_ok=True)
    path = "build/checkpoints/flagship.npz"
    t0 = time.perf_counter()
    save_factorization(path, sf)    # ~1.8 GB of leaves
    t_save = time.perf_counter() - t0
    t0 = time.perf_counter()
    sf2 = load_factorization(path, device=device)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    size = os.path.getsize(path) / 2**20
    os.remove(path)
    same = torch.equal(spike_solve(sf2, rhs), spike_solve(sf, rhs))
    print(f"checkpoint of the flagship factor (bf16 spikes {sf.V.dtype}): "
          f"{size:.0f} MiB, save {t_save:.1f} s, load {t_load:.1f} s "
          f"(host clock); reloaded solve bit-equal: {same}")
    t["checkpoint_save"], t["checkpoint_load"] = (t_save * 1e3, 0.0), (
        t_load * 1e3, 0.0)
    check(same and sf2.V.dtype == torch.bfloat16, "checkpoint round trip")


def phase_tuning(device, tmp, t):
    """``tools.tune.main`` at the flagship, at config 3's width and at the
    flagship in f64, into a record in ``tmp``: each route's time, the
    record under ``cuda:<card name>`` naming the faster kernel route, and
    each route's y against the plain version.  ``as_matvec('auto')`` reads
    no record, so no later phase depends on these."""
    import os
    import torch
    from spike_petsc_tpu_torch.solvers.operator import as_matvec
    from spike_petsc_tpu_torch.tools import tune
    from spike_petsc_tpu_torch.utils import tuning
    saved = os.environ.get("SPIKE_TUNING_FILE")
    os.environ["SPIKE_TUNING_FILE"] = record = os.path.join(tmp, "tuned.json")
    platform = tuning.platform_key()
    dtypes = {"f32": torch.float32, "f64": torch.float64}
    for label, n, kl, ku, dt in TUNE_SHAPES:
        argv = (f"-n {n} -kl {kl} -ku {ku} -dtype {dt} "
                f"-reps {TUNE_REPS}").split()
        rc, out = capture(tune.main, argv)
        line = json.loads(out.strip().splitlines()[-1])
        print(f"tune {label}: {json.dumps(line)}")
        check(rc == 0 and line["platform"] == platform
              and platform.startswith("cuda:"),
              f"tune {label}: exit code {rc}, platform {line['platform']}")
        dtype = dtypes[dt]
        with open(record) as f:
            entry = json.load(f)[platform]["banded_matvec"][
                tuning.matvec_key(line["w"], dtype)]
        routes = [k[:-3] for k in line if k.endswith("_ms")]
        for route in routes:
            t[f"tune_{label}_{route}"] = (line[f"{route}_ms"], 0.0)
        check(entry["winner"] == line["winner"]
              and line["winner"] in ("banded_cuda", "banded_cuda_f64",
                                     "blocktri")
              and entry["xla_ms"] == line["xla_ms"],
              f"tune {label}: record {entry}")
        band, x0 = tune.tuning_band(n, kl, ku, dtype, device)
        ref = as_matvec(band, impl="xla")[0](x0)
        errs = {}
        for route in routes:
            impl = "banded_cuda" if route.startswith("banded_cuda") \
                else route
            mv, _, _ = as_matvec(band, impl=impl)
            check(mv._route == route, f"tune {label}: route {mv._route}")
            _, errs[route] = kernel_err(mv(x0), ref)
        print(f"  tune {label} routes against the plain version: "
              + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
        check(max(errs.values()) <= KERNEL_TOL, f"tune {label}: {errs}")
        del band, x0, ref
        torch.cuda.empty_cache()
    if saved is None:
        del os.environ["SPIKE_TUNING_FILE"]
    else:
        os.environ["SPIKE_TUNING_FILE"] = saved


def native_structure(T, n, kl, ku):
    """The checks of JAX's tests/test_blocktri_native.py on the native
    blocks at full size: entries outside the band masks zero, the rows
    past n the identity (and the columns past n empty above them), strict
    row dominance on the true rows, and the derived band's product equal
    to the blocks' (plain versions, f32 sums in another order)."""
    import torch
    from spike_petsc_tpu_torch.ops.band import banded_matvec
    from spike_petsc_tpu_torch.ops.blocktri import (blocktri_matvec,
                                                    blocktri_to_band)
    NB, b, dev = T.nb, T.b, T.D.device
    p = torch.arange(b, device=dev)[:, None]
    q = torch.arange(b, device=dev)[None, :]
    outside = {"D": ~((q - p <= ku) & (p - q <= kl)),
               "U": ~(b + q - p <= ku), "L": ~(q - p >= b - kl)}
    for name, mask in outside.items():
        check(not bool(getattr(T, name)[:, mask].any()),
              f"native {name} blocks hold entries outside the band")
    rows = (torch.arange(NB, device=dev)[:, None] * b
            + torch.arange(b, device=dev)[None, :])        # [NB, b]
    pad = rows >= n
    eye = torch.eye(b, device=dev, dtype=torch.bool)
    dpad = T.D[pad]                                         # [P, b]
    check(bool((T.L[pad] == 0).all() and (T.U[pad] == 0).all()),
          "native padding rows couple to other blocks")
    check(bool((dpad == eye.expand(NB, b, b)[pad].to(dpad.dtype)).all()),
          "native padding rows are not the identity")
    off = (T.D.abs() * ~eye).sum(-1) + T.L.abs().sum(-1) + T.U.abs().sum(-1)
    diag = T.D.diagonal(dim1=-2, dim2=-1).abs()
    check(bool((diag[~pad] > off[~pad]).all()),
          "native rows are not strictly diagonally dominant")
    band = blocktri_to_band(T, kl, ku)
    x = torch.randn(NB * b, device=dev)
    y_bt = blocktri_matvec(T, x.reshape(NB, b)).reshape(-1)
    _, err = kernel_err(banded_matvec(band, x), y_bt)
    check(err <= KERNEL_TOL and torch.equal(y_bt[n:], x[n:]),
          f"native blocks against their band: {err}")
    return err


def phase_native_factor(device, t, errs, paths):
    """The flagship class assembled in block-tridiagonal layout on the card
    (``problems.blocktri_diagdom_device(1e6, 100, 100, 64, 128)``): its
    structure; ``spike_factor_blocks`` with the flagship's settings (inv,
    stored bf16 spikes, newton_fixed), timed beside the band-entry
    flagship factor of this run; gmres (rtol 1e-8) on the
    block-tridiagonal operator (#7) with the spike PC (#1; the padding
    rows past n carried through as the identity), its launches held
    exactly; #1 and #7 on these inputs against their plain versions."""
    import torch
    from spike_petsc_tpu_torch import solve
    from spike_petsc_tpu_torch.models.problems import blocktri_diagdom_device
    from spike_petsc_tpu_torch.ops.blocktri import blocktri_matvec
    from spike_petsc_tpu_torch.ops.cuda import blocktri_matvec as cbt
    from spike_petsc_tpu_torch.ops.cuda import fused_sweep as cfs
    from spike_petsc_tpu_torch.ops.spike import (spike_factor_blocks,
                                                 spike_solve)
    from spike_petsc_tpu_torch.solvers.pc import PC
    from spike_petsc_tpu_torch.solvers.types import CONVERGED_RTOL, reason_str
    show = shower(t)
    t0 = time.perf_counter()
    T, npad = blocktri_diagdom_device(N, HALF_BW, HALF_BW, K, BLOCK,
                                      device=device)
    torch.cuda.synchronize()
    print(f"native assembly: NB={T.nb} b={T.b} n_pad={npad}, "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms (host clock)")
    check(T.D.is_cuda and npad == T.nb * BLOCK and T.nb % K == 0,
          "native blocks on the card")
    err = native_structure(T, N, HALF_BW, HALF_BW)
    print(f"native structure: masks, identity rows past n, strict row "
          f"dominance held; band product within {err:.3e}")

    def factor():
        return spike_factor_blocks(
            T, n=N, K=K, kl=HALF_BW, ku=HALF_BW, store_spikes=True,
            spike_dtype=torch.bfloat16, inverter="newton_fixed")
    show("native_factor", time_ms(factor, reps=3))
    print(f"native factor {t['native_factor'][0]:.1f} ms beside the "
          f"band-entry flagship factor {t['factor'][0]:.1f} ms (this run)")
    sf = factor()
    u = torch.ones(npad, device=device)
    b = blocktri_matvec(T, u.reshape(T.nb, BLOCK)).reshape(-1)

    def apply(x):
        return torch.cat([spike_solve(sf, x[:N]), x[N:]])
    pc = PC(name="spike", apply=apply)
    reset_launches()
    res = solve(T, b, ksp_type="gmres", pc=pc, rtol=1e-8, restart=30,
                maxit=30)
    launches = read_launches()
    r = blocktri_matvec(T, res.x.reshape(T.nb, BLOCK)).reshape(-1) - b
    true_rel = float(torch.linalg.norm(r) / torch.linalg.norm(b))
    expected = gmres_expected(res.its, launches, "fused_sweep",
                              "blocktri_matvec", reduced=True)
    print(f"gmres+spike on the native blocks (n={N}, n_pad={npad}): "
          f"{res.its} its, {reason_str(res.reason)}, true relres (f32) "
          f"{true_rel:.3e}, max|x - 1| {float((res.x - 1).abs().max()):.3e}"
          f"; launches {nonzero(launches)}, expected {nonzero(expected)}")
    check(res.reason == CONVERGED_RTOL and res.its <= NATIVE_ITS_MAX,
          f"native gmres: {res.its} its, reason {res.reason}")
    check(true_rel <= NATIVE_RELRES_MAX, f"native gmres relres {true_rel}")
    check(launches == expected, f"native gmres launches {launches}")
    paths["native_factor"] = launches
    solver_ms = time_ms(lambda: solve(T, b, ksp_type="gmres", pc=pc,
                                      rtol=1e-8, restart=30, maxit=30),
                        reps=3)
    show("native_gmres_solve", solver_ms)

    rblk = torch.nn.functional.pad(b[:N], (0, K * sf.m - N)).reshape(
        K, sf.nb, BLOCK)
    _, e1 = kernel_err(cfs.blocktri_solve_fused_cuda(sf.fact, rblk),
                       cfs.blocktri_solve_fused_cuda(sf.fact, rblk,
                                                     impl="plain"))
    x = torch.randn(npad, device=device)
    _, e7 = kernel_err(cbt.blocktri_matvec_cuda(T, x),
                       cbt.blocktri_matvec_cuda(T, x, impl="plain"))
    print(f"native path kernels against their plain versions: fused_sweep "
          f"{e1:.3e}, blocktri_matvec {e7:.3e}")
    check(max(e1, e7) <= KERNEL_TOL, "native path kernels")
    errs["fused_sweep"] = max(errs["fused_sweep"], e1)
    errs["blocktri_matvec"] = max(errs["blocktri_matvec"], e7)


def config4_matrix(n, path):
    """Config 4's matrix at ``n``, scrambled, saved uncompressed to
    ``path`` (.npz): (the CSR matrix, seconds to make it)."""
    import numpy as np
    import scipy.sparse as sp
    from spike_petsc_tpu_torch import sparse as hsp
    from spike_petsc_tpu_torch.models import problems
    t0 = time.perf_counter()
    a = problems.general_sparse(n, seed=CONFIG4_SEED)
    p = np.random.default_rng(CONFIG4_PERM_SEED).permutation(n)
    a = hsp.permute(a, p, p)
    sp.save_npz(path, a, compressed=False)
    return a, time.perf_counter() - t0


def lobpcg_event():
    from spike_petsc_tpu_torch.utils import profiling
    ev = [e for e in profiling.event_log() if e["event"] == "fiedler_lobpcg"]
    check(len(ev) == 1, f"one Fiedler LOBPCG run expected, got {ev}")
    return ev[0]


def config4_expected(rec, out, launches):
    """The launches gmres (left PC, x0 = 0) makes on config 4: the inner
    spike PC's sweeps (two an apply, the spikes not stored; #1 one launch
    a sweep, #9 two), on the kernel ``sweep_route`` picks for its factor,
    and its reduced system on the reduced kernel once an apply;
    the operator's band part on #2 where the testbed split it (one an
    operator apply), none for a CSR operator.  Returns (the expected
    launches, the inner factor, the sweep kernel's name)."""
    import torch
    from spike_petsc_tpu_torch.ops.spike import sweep_route
    sf = pc_factor(rec["pc"].inner)
    route = sweep_route(sf.fact, sf.b, torch.float32, True)
    check(route in ("fused", "sweeps"),
          f"config 4 inner spike sweep route {route}")
    sweep = "fused_sweep" if route == "fused" else "sweeps"
    per_sweep = 1 if route == "fused" else 2
    its = rec["result"].its
    expected = gmres_expected(its, launches, sweep, "band_matvec",
                              sweeps_per_apply=2 * per_sweep, reduced=True)
    if "Device operator: band+outliers split" not in out:
        expected["band_matvec"] = 0
    return expected, sf, sweep


def phase_config4(device, tmp, t, paths, errs):
    """BASELINE config 4 through the testbed CLI at n = CONFIG4_N:
    ``problems.general_sparse`` scrambled, ``-mat_ordering_type fiedler
    -mat_ordering_fiedler_method lobpcg`` (LOBPCG on the card), PCBANDED
    with the inner spike PC on the card, gmres in f32 at rtol 1e-6; the
    host stages (-log_view), LOBPCG's iterations and time, the bandwidth
    before and after; converged, the true f32 relres, the bandwidth
    reduced, and the launches held exactly; then the sweep kernel the
    path ran (#1 or #9, as ``sweep_route`` picked it) on the inner
    factor against its plain version."""
    import os
    import re
    import numpy as np
    import torch
    from spike_petsc_tpu_torch.ops.cuda import fused_sweep as cfs
    from spike_petsc_tpu_torch.ops.cuda import sweeps as csw
    from spike_petsc_tpu_torch.utils import profiling
    path = os.path.join(tmp, "config4.npz")
    a, gen_s = config4_matrix(CONFIG4_N, path)
    print(f"config 4 matrix: n={CONFIG4_N}, nnz={a.nnz}, made, scrambled "
          f"and saved in {gen_s:.1f} s (host)")
    rec = {}
    t0 = time.perf_counter()
    reset_launches()
    rc, out = run_testbed(CONFIG4_ARGV.format(path=path).split(), rec)
    launches = read_launches()
    wall = time.perf_counter() - t0
    for line in out.splitlines():
        if "KSP Residual norm" not in line:
            print(f"  testbed| {line}")
    ev = lobpcg_event()
    stages = profiling.stage_times()
    t["config4_lobpcg"] = (stages["FiedlerLOBPCG"] * 1e3, 0.0)
    for name, sec in stages.items():
        t[f"config4_stage_{name}"] = (sec * 1e3, 0.0)
    bws = re.findall(r"(?:Reduced|Increased) bandwidth from (\d+) to (\d+)",
                     out)
    res, b = rec["result"], rec["b"]
    x = res.x.double().cpu().numpy()
    bh = b.double().cpu().numpy()
    true_rel = float(np.linalg.norm(rec["operator"] @ x - bh)
                     / np.linalg.norm(bh))
    expected, sf, sweep = config4_expected(rec, out, launches)
    print(f"config 4: testbed exit code {rc}, {wall:.1f} s in all; Fiedler "
          f"LOBPCG on the card {ev['iterations']} its, "
          f"{stages['FiedlerLOBPCG'] * 1e3:.1f} ms, lambda2 "
          f"{ev['lambda2']:.6e}; bandwidth {bws}")
    print(f"gmres+banded (config 4, n={CONFIG4_N}): {res.its} its, reason "
          f"{res.reason}, true relres (f32) {true_rel:.3e}; inner spike "
          f"K={sf.K} nb={sf.nb} b={sf.b}; launches {nonzero(launches)}, "
          f"expected {nonzero(expected)}")
    check(rc == 0 and res.reason > 0, f"config 4: exit code {rc}, reason "
          f"{res.reason}")
    check(ev["device"].startswith("cuda"), f"config 4 LOBPCG ran on "
          f"{ev['device']}")
    check(len(bws) == 1 and int(bws[0][1]) < int(bws[0][0]),
          f"config 4 bandwidth not reduced: {bws}")
    check(true_rel <= CONFIG4_RELRES_MAX, f"config 4 relres {true_rel}")
    check(launches == expected, f"config 4 launches {launches}")
    paths["config4"] = launches
    os.remove(path)

    kern = cfs.blocktri_solve_fused_cuda if sweep == "fused_sweep" \
        else csw.blocktri_solve_batched_cuda
    rblk = torch.nn.functional.pad(
        b.to(device, torch.float32), (0, sf.K * sf.m - b.numel())).reshape(
            sf.K, sf.nb, sf.b)
    _, err = kernel_err(kern(sf.fact, rblk), kern(sf.fact, rblk,
                                                  impl="plain"))
    print(f"config 4 inner factor (K={sf.K} nb={sf.nb} b={sf.b}): {sweep} "
          f"against its plain version {err:.3e}")
    check(err <= KERNEL_TOL, f"config 4 {sweep}: {err}")
    if sweep == "fused_sweep":
        name = "fused_sweep_cuda_config4"
        shower(t)(name, time_ms(lambda: kern(sf.fact, rblk), iters=20))
        bms, bby = sweep_bound(sf.fact)
        plan = cfs.fused_sweep_cluster(sf.K, sf.nb, sf.b,
                                       cfs.device_sms(device))
        print(f"  fused_sweep (config 4 inner factor, c={plan}): bound "
              f"{bms:.4f} ms ({bby}), bound / time "
              f"{bms / t[name][0]:.3f}; the first design in a lab call "
              f"(experiments/torch_lab_fused_sweep.py, PERF.md) "
              f"{FUSED_BEFORE_MS['config4']} ms")
    errs[sweep] = max(errs[sweep], err)
    return launches


def phase_config4_reference(device, tmp):
    """Config 4 at n = CONFIG4_REF_N through the testbed: the card in f32
    against the CPU in f64, the iterations within 1, LOBPCG's iterations
    within CONFIG4_REF_LOBPCG_ITS and its lambda2 within
    CONFIG4_REF_LAM2_TOL."""
    import os
    path = os.path.join(tmp, "config4_ref.npz")
    config4_matrix(CONFIG4_REF_N, path)
    argv = CONFIG4_ARGV.format(path=path).split()
    got, ref = {}, {}
    rc_card, _ = run_testbed(argv, got)
    ev_card = lobpcg_event()
    rc_cpu, _ = run_testbed(argv + ["-x64", "1", "-platform", "cpu"], ref)
    ev_cpu = lobpcg_event()
    dl = abs(ev_card["lambda2"] - ev_cpu["lambda2"])
    print(f"config 4 n={CONFIG4_REF_N}: card f32 {got['result'].its} its, "
          f"LOBPCG {ev_card['iterations']} its, lambda2 "
          f"{ev_card['lambda2']:.8e}; CPU f64 {ref['result'].its} its, "
          f"LOBPCG {ev_cpu['iterations']} its, lambda2 "
          f"{ev_cpu['lambda2']:.8e}; |d lambda2| {dl:.3e}")
    check(rc_card == rc_cpu == 0 and got["result"].x.is_cuda
          and ev_card["device"].startswith("cuda")
          and ev_cpu["device"] == "cpu", "config 4 reference runs")
    check(abs(got["result"].its - ref["result"].its) <= 1
          and abs(ev_card["iterations"] - ev_cpu["iterations"])
          <= CONFIG4_REF_LOBPCG_ITS and dl <= CONFIG4_REF_LAM2_TOL,
          "config 4: card and CPU reference disagree")
    os.remove(path)


def auction_run(n, device, t):
    """One ``auction_match`` on config 3's matrix at ``n`` on the card:
    (rounds, seconds); checked against MC64 job 5 (native engine)."""
    import numpy as np
    import torch
    from spike_petsc_tpu_torch.models import problems
    from spike_petsc_tpu_torch.ordering import mc64
    from spike_petsc_tpu_torch.parallel import auction_match
    from spike_petsc_tpu_torch.parallel.matching_dev import csc_to_ell
    a = problems.illscaled_nonsym(n, 6, 6)
    rows, _, _ = csc_to_ell(a)
    ell_bytes = rows.size * 16                # int64 rows, f64 benefits
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = auction_match(a, device=device)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    rounds, eps = res.info["rounds"], res.info["eps"]
    exact = mc64(a, job=5)
    lp = float(np.sum(np.log(np.abs(res.apply(a).diagonal()))))
    lp_exact = float(np.sum(np.log(np.abs(exact.apply(a).diagonal()))))
    t[f"auction_{n}"] = (sec * 1e3, 0.0)
    print(f"auction_match (config 3's matrix, n={n}, dmax={rows.shape[1]}):"
          f" {rounds} rounds, {sec * 1e3:.1f} ms (host clock, synchronized;"
          f" the ELL arrays built and sent to the card and the host's "
          f"scalings included), {sec * 1e3 / max(rounds, 1):.3f} ms a "
          f"round with them; log-product "
          f"{lp:.6f} against MC64 job 5's {lp_exact:.6f} (n*eps "
          f"{n * eps:.1e}); card memory peak {peak / 2**20:.1f} MiB over "
          f"the ELL arrays' {ell_bytes / 2**20:.1f} MiB; info {res.info}")
    check(np.array_equal(np.sort(res.rperm), np.arange(n)),
          f"auction n={n}: not a permutation")
    check(lp >= lp_exact - n * eps - 1e-9 * abs(lp_exact),
          f"auction n={n}: log-product {lp} below MC64's {lp_exact}")
    check(peak >= ell_bytes, f"auction n={n}: the ELL arrays were not on "
          f"the card (peak {peak} bytes)")
    return rounds, sec


def phase_auction(device, t):
    """``auction_match`` on config 3's matrix at AUCTION_N[0], then at
    AUCTION_N[1] where its rounds x per-round time x the size ratio
    predicts under AUCTION_BUDGET_S.  Returns the first run's (rounds,
    seconds)."""
    n0, n1 = AUCTION_N
    rounds, sec = auction_run(n0, device, t)
    first = (rounds, sec)
    predicted = rounds * (sec / max(rounds, 1)) * (n1 / n0)
    print(f"auction at n={n1} predicted {predicted:.1f} s (rounds of "
          f"n={n0} x its per-round time x {n1 // n0}; budget "
          f"{AUCTION_BUDGET_S:.0f} s)")
    if predicted < AUCTION_BUDGET_S:
        auction_run(n1, device, t)
    else:
        print(f"auction at n={n1}: cut (predicted over the budget)")
    return first


# ---------------------------------------------------------------------------
# The distributed path (parallel/) at one rank: the NCCL binding and every
# local kernel of the mesh solves at full width
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def one_rank_group(tmp, name):
    """A one-rank default group, gloo for CPU tensors and NCCL for CUDA
    ones, on a file store in ``tmp``; destroyed on the way out."""
    import torch.distributed as dist
    dist.init_process_group(backend="cpu:gloo,cuda:nccl",
                            init_method=f"file://{tmp}/{name}_store",
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def dist_gmres_expected(its, matvec):
    """Left-PC gmres on the mesh from x0 = 0, stored spikes (one #1 sweep
    a PC apply): ``gmres_expected`` with ``matvec`` the operator's kernel."""
    return gmres_expected(its, {"fused_sweep": 0, matvec: 0},
                          "fused_sweep", matvec)


def held(label, launches, expected):
    """Check the launches of a path against the count read from the code
    (kernels not named must not run)."""
    want = {name: expected.get(name, 0) for name in launches}
    print(f"{label}: launches {nonzero(launches)}, expected "
          f"{nonzero(want)}")
    check(launches == want, f"{label}: launches {launches}, expected "
          f"{want}")


def dist_solve_run(label, solve, b, band, x_true, t, its_max):
    """One mesh Krylov solve with its launches, reason, true f32 relres
    and error against ``x_true``."""
    import torch
    from spike_petsc_tpu_torch.ops.band import banded_matvec
    from spike_petsc_tpu_torch.solvers.types import reason_str
    reset_launches()
    res = solve(b)
    launches = read_launches()
    true_rel = float(torch.linalg.norm(banded_matvec(band, res.x) - b)
                     / torch.linalg.norm(b))
    xerr = float((res.x - x_true).abs().max())
    print(f"{label}: {res.its} its, {reason_str(res.reason)}, true relres "
          f"(f32) {true_rel:.3e}, max|x - x_true| {xerr:.3e}")
    check(res.reason > 0 and res.its <= its_max,
          f"{label}: {res.its} its, reason {res.reason}")
    check(res.x.shape == x_true.shape and bool(torch.isfinite(res.x).all()),
          f"{label}: solution shape / finiteness")
    check(xerr <= 1e-3 and true_rel <= 1e-4, f"{label}: accuracy")
    return res, launches


def dist_times(label, fn, t):
    """Wall (CUDA events), device busy (torch.profiler) and idle share of
    one call of ``fn``; returns (wall, busy) in ms."""
    show = shower(t)
    show(label, time_ms(fn, reps=3))
    busy, top = device_profile(fn)
    wall = t[label][0]
    print(f"  {label}: device busy {busy:.3f} ms of {wall:.3f} ms wall: "
          f"idle share {1 - busy / wall:.3f}; top {top[:3]}")
    return wall, busy


def phase_dist_flagship(band, rhs, device, t, bounds, errs, single_its,
                        tmp):
    """The flagship on a one-rank mesh: ``dist_spike_factor`` (K = 64, b =
    128, bf16 spikes, newton_fixed), ``make_dist_solver`` gmres on the
    band route (#2) and on the blocks route (#7 through the chunked entry),
    ``dist_spike_solve_many`` at r = 32 (#4), and bicg with
    ``dist_spike_transpose`` (#1 on the regular-form transposed factor);
    launches held exactly, times beside the single-device path's."""
    import dataclasses
    import torch
    from spike_petsc_tpu_torch.ops.band import banded_matvec
    from spike_petsc_tpu_torch.ops.cuda import blocktri_matvec as cbt
    from spike_petsc_tpu_torch.parallel import (dist_spike_factor,
                                                dist_spike_solve_many,
                                                dist_spike_transpose,
                                                make_dist_solver, make_mesh)
    paths = {}
    ones = torch.ones(N, device=device)
    with one_rank_group(tmp, "dist_flagship"):
        mesh = make_mesh(1, device=device)

        def factor():
            return dist_spike_factor(
                band, mesh, block_b=BLOCK, parts_per_device=K,
                store_spikes=True, spike_dtype=torch.bfloat16,
                inverter="newton_fixed")
        t0 = time.perf_counter()
        dsf = factor()
        torch.cuda.synchronize()
        print(f"dist_spike_factor (flagship, one rank, K={dsf.K}, "
              f"ppd={dsf.ppd}, b={dsf.b}): first call "
              f"{time.perf_counter() - t0:.2f} s; reduced system "
              f"{type(dsf.red_fact).__name__}; matvec route "
              f"{dsf.matvec_route}")
        check(dsf.matvec_route == "banded_cuda",
              f"the flagship mesh factor took route {dsf.matvec_route}")
        check(type(dsf.red_fact).__name__ == "CRFactor",
              "K - 1 = 63 reduced block rows must take cyclic reduction "
              "on the mesh (JAX's threshold 33)")
        solver = make_dist_solver(dsf, mesh, ksp_type="gmres", rtol=1e-8,
                                  restart=30, maxit=30)
        res, launches = dist_solve_run("dist gmres+spike (flagship, "
                                       "banded route)", solver, rhs, band,
                                       ones, t, GMRES_ITS_MAX)
        check(res.its == single_its,
              f"dist gmres {res.its} its, single-device {single_its}")
        held("dist gmres (banded route)", launches,
             dist_gmres_expected(res.its, "band_matvec"))
        paths["dist_gmres"] = launches
        f_wall, f_busy = dist_times("dist_factor", factor, t)
        s_wall, s_busy = dist_times("dist_gmres_solve",
                                    lambda: solver(rhs), t)
        print(f"dist vs single device (flagship): factor {f_wall:.2f} ms "
              f"(single {t['factor'][0]:.2f} ms), gmres solve "
              f"{s_wall:.3f} ms (single {t['gmres_solve'][0]:.3f} ms), "
              f"{res.its} its both")

        # the blocks route: the same factor without the band rows
        dsf_b = dataclasses.replace(dsf, mv_prep=None)
        solver_b = make_dist_solver(dsf_b, mesh, ksp_type="gmres",
                                    rtol=1e-8, restart=30, maxit=30)
        res_b, launches = dist_solve_run("dist gmres+spike (flagship, "
                                         "blocks route)", solver_b, rhs,
                                         band, ones, t, GMRES_ITS_MAX)
        held("dist gmres (blocks route)", launches,
             dist_gmres_expected(res_b.its, "blocktri_matvec"))
        paths["dist_gmres_blocks"] = launches
        dist_times("dist_gmres_solve_blocks", lambda: solver_b(rhs), t)
        # #7 through the chunked entry against its plain version
        x = torch.randn((K, dsf.nb, BLOCK), device=device)
        y = cbt.blocktri_matvec_chunked_cuda(dsf.blocks, x)
        ref = cbt.blocktri_matvec_chunked_cuda(dsf.blocks, x, impl="plain")
        err, rel = kernel_err(y, ref)
        print(f"blocktri_matvec chunked entry {tuple(dsf.blocks.D.shape)}: "
              f"max|kernel - plain| {err:.3e} (relative {rel:.3e})")
        check(rel <= KERNEL_TOL, f"chunked blocktri matvec: {rel}")
        errs["blocktri_matvec"] = max(errs["blocktri_matvec"], err)
        show = shower(t)
        show("blocktri_matvec_chunked_cuda", time_ms(
            lambda: cbt.blocktri_matvec_chunked_cuda(dsf.blocks, x),
            iters=20))
        nbytes = 3 * dsf.blocks.D.numel() * 4 + 2 * x.numel() * 4
        bounds["blocktri_matvec_chunked"] = roofline(
            nbytes, 2 * 3 * dsf.blocks.D.numel())
        print(f"  bound {bounds['blocktri_matvec_chunked'][0]:.4f} ms "
              f"({bounds['blocktri_matvec_chunked'][1]})")
        del dsf_b, solver_b, x, y, ref

        # serving: the multi-RHS direct solve, factors streamed once (#4)
        gen = torch.Generator(device=device).manual_seed(SEED + 41)
        X = torch.randn((N, NRHS), generator=gen, device=device)
        B = banded_matvec(band, X)
        reset_launches()
        Xs = dist_spike_solve_many(dsf, B, mesh)
        launches = read_launches()
        relres = float((torch.linalg.norm(banded_matvec(band, Xs) - B, dim=0)
                        / torch.linalg.norm(B, dim=0)).max())
        print(f"dist_spike_solve_many r={NRHS}: per-column true relres "
              f"(f32) max {relres:.3e}")
        check(relres <= SPIKE_RELRES_MAX, f"dist solve_many relres {relres}")
        held("dist_spike_solve_many", launches, {"fused_sweep_many": 1})
        paths["dist_solve_many"] = launches
        dist_times("dist_solve_many_r32",
                   lambda: dist_spike_solve_many(dsf, B, mesh), t)
        del X, B, Xs

        # the transpose on the same factors, distributed bicg
        t0 = time.perf_counter()
        dsft = dist_spike_transpose(dsf, mesh)
        torch.cuda.synchronize()
        print(f"dist_spike_transpose (flagship): "
              f"{(time.perf_counter() - t0) * 1e3:.1f} ms, factor "
              f"{type(dsft.fact).__name__} {dsft.fact.method}, matvec "
              f"route {dsft.matvec_route}")
        bicg = make_dist_solver(dsf, mesh, ksp_type="bicg",
                                dsf_transpose=dsft, rtol=1e-8, maxit=30)
        res_t, launches = dist_solve_run("dist bicg+spike (flagship)", bicg,
                                         rhs, band, ones, t, GMRES_ITS_MAX)
        # two PC applies before the loop and two an iteration (#1 forward
        # and on the transposed factor); A by #2 an iteration and for the
        # final residual, A^T by #7 (the transpose's blocks) an iteration
        held("dist bicg", launches, {"fused_sweep": 2 * res_t.its + 2,
                                     "band_matvec": res_t.its + 1,
                                     "blocktri_matvec": res_t.its})
        paths["dist_bicg"] = launches
        dist_times("dist_bicg_solve", lambda: bicg(rhs), t)
        del dsft, bicg, dsf, solver
    torch.cuda.empty_cache()
    return paths


def phase_dist_config2(band, rhs, device, t, tmp):
    """Config 2 on a one-rank mesh (bandwidth 33, K = 16, b = 64,
    truncated, ``method='spd'``, stored spikes): mesh cg (#3, #2) and
    ``make_dist_solver_batched`` cg serving on a (1, 1) mesh at r = 32
    (#5); launches held exactly."""
    import torch
    from spike_petsc_tpu_torch.ops.band import banded_matvec
    from spike_petsc_tpu_torch.parallel import (dist_spike_factor,
                                                make_dist_solver,
                                                make_dist_solver_batched,
                                                make_mesh, make_mesh_2d)
    paths = {}
    ones = torch.ones(SPD_N, device=device)
    with one_rank_group(tmp, "dist_config2"):
        mesh = make_mesh(1, device=device)
        dsf = dist_spike_factor(band, mesh, method="spd", truncated=True,
                                block_b=SPD_BLOCK, parts_per_device=SPD_K,
                                store_spikes=True)
        cg = make_dist_solver(dsf, mesh, ksp_type="cg", rtol=1e-8, maxit=50)
        res, launches = dist_solve_run("dist cg+spd spike (config 2)", cg,
                                       rhs, band, ones, t, CG_ITS_MAX)
        # one PC apply before the loop and one an iteration; the operator
        # an iteration and for the final residual
        held("dist cg (config 2)", launches,
             {"fused_sweep_spd": res.its + 1, "band_matvec": res.its + 1})
        paths["dist_cg_config2"] = launches
        dist_times("dist_cg_solve", lambda: cg(rhs), t)

        mesh2 = make_mesh_2d((1, 1), axes=("rhs", "p"), device=device)
        serve = make_dist_solver_batched(dsf, mesh2, ksp_type="cg",
                                         rtol=1e-8, maxit=50)
        gen = torch.Generator(device=device).manual_seed(SEED + 43)
        X = torch.randn((SPD_N, NRHS), generator=gen, device=device)
        B = banded_matvec(band, X).T.contiguous()               # [R, n]
        reset_launches()
        Xs = serve(B)
        launches = read_launches()
        relres = float((torch.linalg.norm(banded_matvec(band, Xs.T) - B.T,
                                          dim=0)
                        / torch.linalg.norm(B.T, dim=0)).max())
        print(f"dist batched cg serving (1, 1) mesh r={NRHS}: per-column "
              f"true relres (f32) max {relres:.3e}, max|x - X| "
              f"{float((Xs.T - X).abs().max()):.3e}")
        check(relres <= SERVE_RELRES_MAX, f"dist cg serving relres {relres}")
        # cg_many: one PC apply before the loop and one a trip; the
        # multi-RHS matvec is the batched block product (no kernel)
        spd_launches = launches["fused_sweep_many_spd"]
        check(spd_launches >= 2, f"dist cg serving: {launches}")
        held("dist cg serving", launches,
             {"fused_sweep_many_spd": spd_launches})
        print(f"  {spd_launches - 1} trips (solve_many's serving path: "
              f"{CG_SERVE_ITS} its a column)")
        check(spd_launches - 1 <= CG_ITS_MAX,
              f"dist cg serving took {spd_launches - 1} trips")
        paths["dist_cg_serve"] = launches
        dist_times("dist_cg_serve_r32", lambda: serve(B), t)
        del dsf, cg, serve, X, B, Xs
    torch.cuda.empty_cache()
    return paths


def phase_dist_reference(device, tmp):
    """``make_dist_solver`` gmres on a small band, on the card (f32,
    kernels) and on a CPU mesh (f64, plain versions) in one process: equal
    iteration counts, and x within the reference phases' tolerance.  At
    rtol 1e-8 f32 needs a second iteration that f64 does not (the first
    leaves ~1e-7 in f32), so the count is compared at DIST_REF_RTOL."""
    import torch
    from spike_petsc_tpu_torch import BandedMatrix
    from spike_petsc_tpu_torch.parallel import (dist_spike_factor,
                                                make_dist_solver, make_mesh)
    band, rhs = flagship_band(20_000, 20, device, seed=SEED + 7)
    cpu = BandedMatrix(data=band.data.double().cpu(), kl=20, ku=20)
    out = {}
    with one_rank_group(tmp, "dist_reference"):
        for label, a, b, dev in (("card", band, rhs, device),
                                 ("cpu", cpu, rhs.double().cpu(), "cpu")):
            mesh = make_mesh(1, device=dev)
            dsf = dist_spike_factor(a, mesh, block_b=64, parts_per_device=8)
            reset_launches()
            out[label] = make_dist_solver(dsf, mesh, ksp_type="gmres",
                                          rtol=DIST_REF_RTOL)(b)
            launches = read_launches()
            print(f"dist reference {label}: {out[label].its} its, launches "
                  f"{nonzero(launches)}")
    err = float((out["card"].x.double().cpu() - out["cpu"].x).abs().max())
    print(f"dist gmres n=20000 w=41 K=8: card {out['card'].its} "
          f"its vs CPU f64 {out['cpu'].its} its, max|x_card - x_cpu| "
          f"{err:.3e}")
    check(out["card"].its == out["cpu"].its and err <= 1e-5
          and out["card"].reason == out["cpu"].reason == 2,
          "dist card and CPU reference disagree")


# ---------------------------------------------------------------------------
# The rest of the distributed path at one rank: the multislice and 3-D
# meshes, the mesh autodiff, the elastic solves and the mesh auction
# ---------------------------------------------------------------------------

DIST_FACTOR_OPTIONS = dict(block_b=BLOCK, parts_per_device=K,
                           store_spikes=True, inverter="newton_fixed")


def dist_factor_options():
    import torch
    return dict(DIST_FACTOR_OPTIONS, spike_dtype=torch.bfloat16)


def tensors_of(obj, prefix=""):
    """``{path: tensor}`` of every tensor a (nested) dataclass holds."""
    import dataclasses
    import torch
    if isinstance(obj, torch.Tensor):
        return {prefix: obj}
    out = {}
    if dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            out.update(tensors_of(getattr(obj, f.name),
                                  f"{prefix}.{f.name}".lstrip(".")))
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            out.update(tensors_of(v, f"{prefix}[{i}]"))
    return out


def factor_difference(a, b):
    """(tensors compared, the largest max|a - b| / max|a| over them, and
    whether every pair is bit-equal) of two mesh factors."""
    ta, tb = tensors_of(a), tensors_of(b)
    check(ta.keys() == tb.keys() and all(
        ta[k].shape == tb[k].shape and ta[k].dtype == tb[k].dtype
        for k in ta), "the two factors hold different tensors")
    worst, equal = 0.0, True
    for k in ta:
        if ta[k].numel() == 0:
            continue
        x, y = ta[k].float(), tb[k].float()
        d = float((x - y).abs().max())
        worst = max(worst, d / max(float(x.abs().max()), 1e-30))
        equal &= bool(d == 0)
    return len(ta), worst, equal


def serving_relres(band, X, B):
    """The largest per-column true f32 relres of ``X`` ``[n, r]``."""
    import torch
    from spike_petsc_tpu_torch.ops.band import banded_matvec
    return float((torch.linalg.norm(banded_matvec(band, X) - B, dim=0)
                  / torch.linalg.norm(B, dim=0)).max())


def serving_run(label, serve, band, B, Bcall, t, want_of):
    """One serving call: launches, per-column relres (``serve(Bcall)``,
    ``B`` ``[n, r]``), ``want_of(launches)`` the expected launches (held),
    wall, device busy and idle share."""
    reset_launches()
    Xs = serve(Bcall)
    launches = read_launches()
    X = Xs if Xs.shape == B.shape else Xs.T
    relres = serving_relres(band, X, B)
    print(f"{label}: per-column true relres (f32) max {relres:.3e}")
    check(relres <= SERVE_RELRES_MAX and X.shape == B.shape,
          f"{label}: relres {relres}")
    held(label, launches, want_of(launches))
    dist_times(label.replace(" ", "_"), lambda: serve(Bcall), t)
    return launches


def many_trips(launches, per_trip, fixed=0, most=SERVE_ITS_MAX):
    """The #4 launches of a serving engine as ``fixed + per_trip * trips``
    with 1 <= trips <= ``most`` (the engines return x only, so the trips
    are read off the count, which must have that form)."""
    n = launches.get("fused_sweep_many", 0)
    trips = (n - fixed) // per_trip
    check(1 <= trips <= most and n == fixed + per_trip * trips,
          f"#4 launched {n} times: not {fixed} + {per_trip} a trip")
    return {"fused_sweep_many": n}


def phase_dist_multislice(band, rhs, device, t, tmp, single_its):
    """The flagship on a (1, 1) multislice mesh: the factor (its pieces
    against the 1-D mesh's on the same band: one slice, so the PC masks
    change nothing), gmres on the band route (#2) and the blocks route
    (#7) in the 1-D mesh's iterations, bicg with
    ``dist_spike_transpose_multislice``, and the serving engine at r = 32
    (richardson, #4 one a trip; bcgs, #4 two a trip); launches held, wall,
    device busy and idle share beside the 1-D mesh's of the same call."""
    import dataclasses
    import torch
    from spike_petsc_tpu_torch.ops.band import banded_matvec
    from spike_petsc_tpu_torch.parallel import (
        dist_spike_factor, dist_spike_factor_multislice,
        dist_spike_transpose_multislice, make_dist_solver_multislice,
        make_dist_solver_multislice_batched, make_mesh, make_mesh_multislice)
    paths = {}
    ones = torch.ones(N, device=device)
    opts = dist_factor_options()
    with one_rank_group(tmp, "dist_multislice"):
        mesh1 = make_mesh(1, device=device)
        mesh = make_mesh_multislice((1, 1), device=device)
        d1 = dist_spike_factor(band, mesh1, **opts)

        def factor():
            return dist_spike_factor_multislice(band, mesh, **opts)
        t0 = time.perf_counter()
        dsf = factor()
        torch.cuda.synchronize()
        count, worst, equal = factor_difference(d1, dsf)
        print(f"dist_spike_factor_multislice (flagship, (1, 1), K={dsf.K}, "
              f"ppd={dsf.ppd}): first call {time.perf_counter() - t0:.2f} s;"
              f" reduced system {type(dsf.red_fact).__name__}, matvec route "
              f"{dsf.matvec_route}; against the 1-D mesh's factor: "
              f"{count} tensors, max|d| / max|1-D| {worst:.3e}, bit-equal: "
              f"{equal}")
        check(worst <= 1e-6, f"multislice factor vs 1-D: {worst}")
        check(dsf.matvec_route == "banded_cuda"
              and type(dsf.red_fact).__name__ == "CRFactor",
              "the (1, 1) factor's route or reduced system")
        del d1
        solver = make_dist_solver_multislice(dsf, mesh, ksp_type="gmres",
                                             rtol=1e-8, restart=30, maxit=30)
        res, launches = dist_solve_run(
            "dist_ms gmres+spike (flagship, (1, 1), banded route)", solver,
            rhs, band, ones, t, GMRES_ITS_MAX)
        check(res.its == single_its, f"multislice gmres {res.its} its, "
              f"1-D mesh and single device {single_its}")
        held("dist_ms gmres (banded route)", launches,
             dist_gmres_expected(res.its, "band_matvec"))
        paths["dist_ms_gmres"] = launches
        wall, busy = dist_times("dist_ms_gmres_solve", lambda: solver(rhs), t)
        one = t["dist_gmres_solve"][0]
        print(f"multislice (1, 1) vs the 1-D mesh (flagship gmres, "
              f"{res.its} its both, same call): wall {wall:.3f} ms against "
              f"{one:.3f} ms ({wall / one:.3f}x)")

        dsf_b = dataclasses.replace(dsf, mv_prep=None)
        solver_b = make_dist_solver_multislice(dsf_b, mesh, ksp_type="gmres",
                                               rtol=1e-8, restart=30,
                                               maxit=30)
        res_b, launches = dist_solve_run(
            "dist_ms gmres+spike (flagship, (1, 1), blocks route)", solver_b,
            rhs, band, ones, t, GMRES_ITS_MAX)
        check(res_b.its == single_its, f"blocks route {res_b.its} its")
        held("dist_ms gmres (blocks route)", launches,
             dist_gmres_expected(res_b.its, "blocktri_matvec"))
        paths["dist_ms_gmres_blocks"] = launches
        dist_times("dist_ms_gmres_solve_blocks", lambda: solver_b(rhs), t)
        del dsf_b, solver_b

        t0 = time.perf_counter()
        dsft = dist_spike_transpose_multislice(dsf, mesh)
        torch.cuda.synchronize()
        print(f"dist_spike_transpose_multislice (flagship): "
              f"{(time.perf_counter() - t0) * 1e3:.1f} ms, factor "
              f"{type(dsft.fact).__name__} {dsft.fact.method}")
        bicg = make_dist_solver_multislice(dsf, mesh, ksp_type="bicg",
                                           dsf_transpose=dsft, rtol=1e-8,
                                           maxit=30)
        res_t, launches = dist_solve_run("dist_ms bicg+spike (flagship)",
                                         bicg, rhs, band, ones, t,
                                         GMRES_ITS_MAX)
        held("dist_ms bicg", launches, {"fused_sweep": 2 * res_t.its + 2,
                                        "band_matvec": res_t.its + 1,
                                        "blocktri_matvec": res_t.its})
        paths["dist_ms_bicg"] = launches
        dist_times("dist_ms_bicg_solve", lambda: bicg(rhs), t)
        del dsft, bicg

        gen = torch.Generator(device=device).manual_seed(SEED + 47)
        X = torch.randn((N, NRHS), generator=gen, device=device)
        B = banded_matvec(band, X)
        rich = make_dist_solver_multislice_batched(
            dsf, mesh, ksp_type="richardson", rtol=0.0,
            maxit=DIST_SERVE_TRIPS)
        paths["dist_ms_serve_richardson"] = serving_run(
            "dist_ms serving richardson r=32", rich, band, B, B, t,
            lambda _: {"fused_sweep_many": DIST_SERVE_TRIPS})
        bcgs = make_dist_solver_multislice_batched(dsf, mesh, ksp_type="bcgs",
                                                   rtol=1e-8, maxit=30)
        paths["dist_ms_serve_bcgs"] = serving_run(
            "dist_ms serving bcgs r=32", bcgs, band, B, B, t,
            lambda n: many_trips(n, 2))
        del X, B, dsf, solver, rich, bcgs
    torch.cuda.empty_cache()
    return paths


def phase_dist_3d(band, device, t, tmp):
    """The flagship on a (1, 1, 1) 3-D mesh: ``make_dist_solver_3d``
    richardson (#4 one a trip) and gmres (#4: two before the loop, one an
    iteration and one a cycle) at r = 32; launches held."""
    import torch
    from spike_petsc_tpu_torch.ops.band import banded_matvec
    from spike_petsc_tpu_torch.parallel import (dist_spike_factor_multislice,
                                                make_dist_solver_3d,
                                                make_mesh_3d)
    paths = {}
    with one_rank_group(tmp, "dist_3d"):
        mesh3 = make_mesh_3d((1, 1, 1), device=device)
        dsf = dist_spike_factor_multislice(band, mesh3,
                                           **dist_factor_options())
        gen = torch.Generator(device=device).manual_seed(SEED + 48)
        X = torch.randn((N, NRHS), generator=gen, device=device)
        B = banded_matvec(band, X)
        Bt = B.T.contiguous()                                    # [R, n]
        rich = make_dist_solver_3d(dsf, mesh3, ksp_type="richardson",
                                   rtol=0.0, maxit=DIST_SERVE_TRIPS)
        paths["dist_3d_richardson"] = serving_run(
            "dist_3d richardson r=32", rich, band, B, Bt, t,
            lambda _: {"fused_sweep_many": DIST_SERVE_TRIPS})
        gm = make_dist_solver_3d(dsf, mesh3, ksp_type="gmres", rtol=1e-8,
                                 restart=30, maxit=30)
        paths["dist_3d_gmres"] = serving_run(
            "dist_3d gmres r=32", gm, band, B, Bt, t,
            lambda n: many_trips(n, 1, fixed=3, most=GMRES_ITS_MAX))
        del X, B, Bt, dsf, rich, gm
    torch.cuda.empty_cache()
    return paths


def phase_dist_autodiff(band, rhs, device, t, tmp):
    """``dist_solve_banded_diff`` on the flagship (one rank, K = 64; #1
    twice a pass, as ``solve_banded_diff``) and its multislice form on a
    (1, 1) mesh (GMRES both ways at rtol DIST_DIFF_RTOL; #1 two a PC apply
    and #7 one a matvec): the gradients of sum(sin(x) x) against the
    single-device ``solve_banded_diff``'s on the same band, launches held,
    forward and backward timed."""
    import torch
    from spike_petsc_tpu_torch.ops.autodiff import solve_banded_diff
    from spike_petsc_tpu_torch.parallel import (
        dist_solve_banded_diff, dist_solve_banded_diff_multislice, make_mesh,
        make_mesh_multislice)
    show = shower(t)
    kl, ku = band.kl, band.ku
    paths = {}

    def leaves():
        return (band.data.detach().clone().requires_grad_(True),
                rhs.detach().clone().requires_grad_(True))

    def grads(fn):
        d, b = leaves()
        reset_launches()
        x = fn(d, b)
        fwd = nonzero(read_launches())
        loss = (torch.sin(x) * x).sum()
        reset_launches()
        gd, gb = torch.autograd.grad(loss, (d, b))
        return gd, gb, fwd, nonzero(read_launches())

    gd0, gb0, _, _ = grads(lambda d, b: solve_banded_diff(d, b, kl, ku, K))

    def gmres_pass(n):
        """#1 two a PC apply (no stored spikes), #7 one a matvec: with
        its iterations of one cycle, 2 (its + 2) and its + 1."""
        mv = n.get("blocktri_matvec", 0)
        return {"fused_sweep": 2 * (mv + 1), "blocktri_matvec": mv}

    with one_rank_group(tmp, "dist_autodiff"):
        mesh = make_mesh(1, device=device)
        mesh2 = make_mesh_multislice((1, 1), device=device)
        cases = (
            ("dist_diff_1d", lambda d, b: dist_solve_banded_diff(
                d, b, kl, ku, mesh, block_b=BLOCK, parts_per_device=K),
             lambda n: AUTODIFF_LAUNCHES["dist_flagship"]),
            ("dist_diff_ms", lambda d, b: dist_solve_banded_diff_multislice(
                d, b, kl, ku, mesh2, block_b=BLOCK, parts_per_device=K,
                rtol=DIST_DIFF_RTOL, maxit=DIST_DIFF_MAXIT), gmres_pass))
        for label, fn, want in cases:
            gd, gb, fwd, bwd = grads(fn)
            err_d = float((gd - gd0).abs().max() / gd0.abs().max())
            err_b = float((gb - gb0).abs().max() / gb0.abs().max())
            print(f"{label} (flagship, K={K}): launches forward {fwd}, "
                  f"backward {bwd}; against solve_banded_diff's gradients: "
                  f"data {err_d:.3e}, rhs {err_b:.3e}")
            check(max(err_d, err_b) <= DIST_DIFF_TOL
                  and bool(torch.isfinite(gd).all()),
                  f"{label}: gradients {err_d}, {err_b}")
            check(fwd == want(fwd) and bwd == want(bwd)
                  and fwd.get("fused_sweep", 0) > 0,
                  f"{label}: launches {fwd}, {bwd}")
            paths[label] = {k: fwd.get(k, 0) + bwd.get(k, 0)
                            for k in set(fwd) | set(bwd)}
            d, b = leaves()
            x = fn(d, b)
            loss = (torch.sin(x) * x).sum()
            show(f"{label}_forward", time_ms(lambda: fn(d, b), reps=3))
            show(f"{label}_backward", time_ms(lambda: torch.autograd.grad(
                loss, (d, b), retain_graph=True), reps=3))
            del x, loss, d, b
    torch.cuda.empty_cache()
    return paths


def phase_elastic(band, rhs, device, t, tmp):
    """The elastic drills on one rank: ``resilient_solve`` on the flagship
    in segments of one iteration with a fault after segment 0 (the default
    policy's same-size retry), its checkpoint to ``tmp``, then a resume
    from that file to convergence; ``resilient_serve`` at r = 32 on (1, 1)
    and (1, 1, 1) with one fault each.  Checks failures, meshes_used, the
    iterations, segments, attempts and x; launches read (#1 and #2 for the
    solve, #4 alone for the serving engines)."""
    import os
    import torch
    from spike_petsc_tpu_torch.ops.band import banded_matvec
    from spike_petsc_tpu_torch.parallel import (SolveCheckpoint,
                                                resilient_serve,
                                                resilient_solve)
    from spike_petsc_tpu_torch.solvers.types import (CONVERGED_RTOL,
                                                     DIVERGED_ITS)
    paths = {}

    def once(message):
        fired = []

        def inject(index):
            if index == 0 and not fired:
                fired.append(True)
                raise RuntimeError(message)
        return inject

    with one_rank_group(tmp, "elastic"):
        path = os.path.join(tmp, "elastic_ckpt.npz")
        common = dict(block_b=BLOCK, parts_per_device=K, rtol=1e-8,
                      segment_its=1, ckpt_path=path, device=device)
        reset_launches()
        t0 = time.perf_counter()
        r1 = resilient_solve(band, rhs, maxit=1, fault_injector=once(
            "injected: transient fault after segment 0"), **common)
        t1 = time.perf_counter()
        st = SolveCheckpoint.load(path)
        r2 = resilient_solve(band, rhs, maxit=30, resume=True, **common)
        t2 = time.perf_counter()
        launches = read_launches()
        x = torch.as_tensor(r2.x, device=device)
        relres = float(torch.linalg.norm(banded_matvec(band, x) - rhs)
                       / torch.linalg.norm(rhs))
        xerr = float((x - 1).abs().max())
        print(f"resilient_solve (flagship, segments of 1 it, a fault after "
              f"segment 0): its {r1.its}, segments {r1.segments}, failures "
              f"{r1.failures}, meshes {r1.meshes_used}, reason {r1.reason}; "
              f"checkpoint its_done {st.its_done}, segments {st.segments}; "
              f"resumed: its {r2.its}, segments {r2.segments}, failures "
              f"{r2.failures}, reason {r2.reason}, true relres (f32) "
              f"{relres:.3e}, max|x - 1| {xerr:.3e}; host clock "
              f"{(t1 - t0) * 1e3:.1f} ms and {(t2 - t1) * 1e3:.1f} ms (the "
              f"factor each); launches {nonzero(launches)}")
        check(r1.failures == 1 and r1.meshes_used == [(1,)]
              and r1.its == 1 and r1.segments == 1
              and r1.reason == DIVERGED_ITS, "resilient_solve drill")
        check(st.its_done == 1 and st.segments == 1, "the checkpoint")
        check(r2.reason == CONVERGED_RTOL and r2.failures == 0
              and r2.its == r2.segments and 1 < r2.its <= 2 * GMRES_ITS_MAX
              and relres <= ELASTIC_RNORM_MAX and xerr <= 1e-3,
              "resilient_solve resumed")
        check(set(nonzero(launches)) == {"fused_sweep", "band_matvec"},
              f"resilient_solve launches {launches}")
        paths["resilient_solve"] = launches

        gen = torch.Generator(device=device).manual_seed(SEED + 49)
        X = torch.randn((N, NRHS), generator=gen, device=device)
        B = banded_matvec(band, X)
        Bt = B.T.contiguous()
        for shape in ((1, 1), (1, 1, 1)):
            tag = f"resilient_serve_{len(shape)}d"
            reset_launches()
            t0 = time.perf_counter()
            res = resilient_serve(band, Bt, mesh_shape=shape, block_b=BLOCK,
                                  parts_per_device=K, ksp_type="bcgs",
                                  rtol=1e-8, maxit=30, device=device,
                                  fault_injector=once("injected: replica "
                                                      "fault"))
            sec = time.perf_counter() - t0
            launches = read_launches()
            Xs = torch.as_tensor(res.X, device=device).T
            relres = serving_relres(band, Xs, B)
            print(f"{tag} {shape} r={NRHS} (bcgs, a fault after attempt 0):"
                  f" attempts {res.attempts}, failures {res.failures}, "
                  f"meshes {res.meshes_used}, per-column true relres (f32) "
                  f"max {relres:.3e}; host clock {sec * 1e3:.1f} ms; "
                  f"launches {nonzero(launches)}")
            check(res.attempts == 2 and res.failures == 1
                  and res.meshes_used == [shape]
                  and relres <= SERVE_RELRES_MAX, f"{tag} drill")
            # no stored spikes: two #4 a PC apply, two applies a trip, the
            # batch served twice
            check(set(nonzero(launches)) == {"fused_sweep_many"}
                  and launches["fused_sweep_many"] % 8 == 0,
                  f"{tag} launches {launches}")
            paths[tag] = launches
        del X, B, Bt
    torch.cuda.empty_cache()
    return paths


def phase_dist_ms_reference(device, tmp):
    """``make_dist_solver_multislice`` gmres and ``make_dist_solver_3d``
    gmres (two right-hand sides) on a small band, on the card (f32,
    kernels) and on a CPU mesh (f64, plain versions) in one process: equal
    iterations and x within 1e-5."""
    import torch
    from spike_petsc_tpu_torch import BandedMatrix
    from spike_petsc_tpu_torch.parallel import (dist_spike_factor_multislice,
                                                make_dist_solver_3d,
                                                make_dist_solver_multislice,
                                                make_mesh_3d,
                                                make_mesh_multislice)
    band, rhs = flagship_band(20_000, 20, device, seed=SEED + 7)
    cpu = BandedMatrix(data=band.data.double().cpu(), kl=20, ku=20)
    out, out3 = {}, {}
    with one_rank_group(tmp, "dist_ms_reference"):
        for label, a, b, dev in (("card", band, rhs, device),
                                 ("cpu", cpu, rhs.double().cpu(), "cpu")):
            mesh = make_mesh_multislice((1, 1), device=dev)
            dsf = dist_spike_factor_multislice(a, mesh, block_b=64,
                                               parts_per_device=8)
            reset_launches()
            out[label] = make_dist_solver_multislice(
                dsf, mesh, ksp_type="gmres", rtol=DIST_REF_RTOL)(b)
            mesh3 = make_mesh_3d((1, 1, 1), device=dev)
            d3 = dist_spike_factor_multislice(a, mesh3, block_b=64,
                                              parts_per_device=8)
            out3[label] = make_dist_solver_3d(
                d3, mesh3, ksp_type="gmres", rtol=DIST_REF_RTOL)(
                    torch.stack([b, 2 * b]))
            print(f"dist_ms reference {label}: {out[label].its} its, "
                  f"launches {nonzero(read_launches())}")
    err = float((out["card"].x.double().cpu() - out["cpu"].x).abs().max())
    err3 = float((out3["card"].double().cpu() - out3["cpu"]).abs().max()
                 / out3["cpu"].abs().max())
    print(f"dist_ms gmres n=20000 w=41 K=8 (1, 1): card {out['card'].its} "
          f"its vs CPU f64 {out['cpu'].its} its, max|x_card - x_cpu| "
          f"{err:.3e}; make_dist_solver_3d gmres (1, 1, 1), 2 columns: "
          f"max|X_card - X_cpu| / max|X_cpu| {err3:.3e}")
    check(out["card"].its == out["cpu"].its and err <= 1e-5
          and err3 <= 1e-5 and out["card"].reason == out["cpu"].reason == 2,
          "multislice / 3-D card and CPU reference disagree")


def phase_dist_auction(device, t, tmp, single):
    """``auction_match_dist`` on a one-rank mesh on config 3's matrix at
    AUCTION_N[0]: a permutation within n eps of MC64 job 5's log-product,
    its rounds and time beside ``auction_match``'s (``single``: rounds,
    seconds)."""
    import numpy as np
    import torch
    from spike_petsc_tpu_torch.models import problems
    from spike_petsc_tpu_torch.ordering import mc64
    from spike_petsc_tpu_torch.parallel import auction_match_dist, make_mesh
    n = AUCTION_N[0]
    a = problems.illscaled_nonsym(n, 6, 6)
    with one_rank_group(tmp, "dist_auction"):
        mesh = make_mesh(1, device=device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = auction_match_dist(a, mesh)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
    rounds, eps = res.info["rounds"], res.info["eps"]
    lp = float(np.sum(np.log(np.abs(res.apply(a).diagonal()))))
    lp_exact = float(np.sum(np.log(np.abs(mc64(a, job=5).apply(a)
                                          .diagonal()))))
    t[f"auction_dist_{n}"] = (sec * 1e3, 0.0)
    print(f"auction_match_dist (one rank, config 3's matrix, n={n}): "
          f"{rounds} rounds, {sec * 1e3:.1f} ms (host clock, as "
          f"auction_match's {single[0]} rounds, {single[1] * 1e3:.1f} ms), "
          f"{sec * 1e3 / max(rounds, 1):.3f} ms a round; log-product "
          f"{lp:.6f} against MC64 job 5's {lp_exact:.6f} (n*eps "
          f"{n * eps:.1e}); info {res.info}")
    check(np.array_equal(np.sort(res.rperm), np.arange(n)),
          "auction_match_dist: not a permutation")
    check(lp >= lp_exact - n * eps - 1e-9 * abs(lp_exact),
          f"auction_match_dist: log-product {lp} below MC64's {lp_exact}")


def main() -> int:
    import tempfile
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    # the tuner's record and config 4's matrices go to a scratch directory
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        return run(tmp)


def run(tmp) -> int:
    import torch
    from spike_petsc_tpu_torch.ops.spike import spike_factor
    device = torch.device("cuda", 0)
    t_start = time.perf_counter()

    smi = phase_card()
    phase_build()
    band, rhs = flagship_band(N, HALF_BW, device)
    sf = spike_factor(band, K=K, block_b=BLOCK, store_spikes=True,
                      spike_dtype=torch.bfloat16, inverter="newton_fixed")
    errs = phase_kernels(band, rhs, sf, device)
    errs.update(phase_alternate_kernels(band, rhs, sf, device))
    phase_accuracy(band, rhs, sf)
    from spike_petsc_tpu_torch.ops.cuda import fused_sweep_many as cfm
    phase_carry(sf, device, cfm, "flagship: factors f32, spikes bf16")
    res, launches = phase_main_path(band, rhs, device)
    bt_launches = phase_blocktri_route(band, rhs, res.its)
    serve_launches = phase_serving(band, device)
    phase_reference(device)
    phase_reference_many(device)
    # f64-grade refinement (path A) and the alternate kernels (path B)
    a64, b64 = f64_band(band)
    refine_launches = phase_refine(a64, b64)
    phase_refine_reference(device)
    alt_launches = phase_alternate_path(band, rhs, sf)
    t, bounds = phase_timing(band, rhs, sf, device)
    phase_reduced(sf, device, t, bounds, errs)
    phase_band_many(device, t, bounds, errs)
    bounds.update(phase_alternate_timing(band, a64, b64, rhs, sf, device, t))
    del a64, b64
    torch.cuda.empty_cache()

    # the transpose-free KSP types on the flagship, the spike PC built once
    from spike_petsc_tpu_torch import Options
    from spike_petsc_tpu_torch.solvers.pc import make_pc
    tk = time.perf_counter()
    pc = make_pc("spike", band, Options(dict(PC_OPTIONS)))
    phase_ksp_types(band, rhs, pc, KSP_TYPE_CASES,
                    ("fused_sweep", "band_matvec"))
    print(f"KSP types on the flagship: {time.perf_counter() - tk:.1f} s")
    # the transpose stack on the flagship, the same PC
    tt = time.perf_counter()
    phase_transpose_flagship(band, rhs, sf, pc, device, t)
    print(f"transpose phases on the flagship: {time.perf_counter() - tt:.1f} "
          f"s")
    # the rest of the factor surface on the flagship: K = 512 (a CR
    # reduced system), the lu, cr and newton_pan PCs, the grouped factor
    tf = time.perf_counter()
    errs["fused_sweep"] = max(errs["fused_sweep"],
                              phase_cr_flagship(band, rhs, device, t, bounds))
    print(f"  K={CR_K} phase: {time.perf_counter() - tf:.1f} s")
    tm = time.perf_counter()
    phase_methods_flagship(band, rhs, device, t)
    print(f"  methods phase: {time.perf_counter() - tm:.1f} s")
    tm = time.perf_counter()
    phase_grouped(band, rhs, device)
    print(f"  grouped phase: {time.perf_counter() - tm:.1f} s")
    # the remaining PCs on the flagship: asm, composite, ksp
    tp = time.perf_counter()
    paths = phase_pcs_flagship(band, rhs, device, t, bounds, errs)
    print(f"PC phases on the flagship: {time.perf_counter() - tp:.1f} s")
    # gmres_many's right PC and CGS refinements, ops/autodiff.py, the
    # factor health check and checkpoints
    tg = time.perf_counter()
    paths["gmres_many_right"] = phase_gmres_many_options(band, device, t)
    print(f"gmres_many phase: {time.perf_counter() - tg:.1f} s")
    tg = time.perf_counter()
    paths.update(phase_autodiff(band, rhs, device, t))
    print(f"autodiff phase: {time.perf_counter() - tg:.1f} s")
    tg = time.perf_counter()
    phase_checks(band, rhs, sf, device, t)
    print(f"check and checkpoint phase: {time.perf_counter() - tg:.1f} s")
    # the distributed path at one rank (NCCL), then its CPU reference
    tg = time.perf_counter()
    paths.update(phase_dist_flagship(band, rhs, device, t, bounds, errs,
                                     res.its, tmp))
    phase_dist_reference(device, tmp)
    print(f"distributed flagship phases: {time.perf_counter() - tg:.1f} s")
    # the multislice and 3-D meshes, the mesh autodiff, the elastic drills
    tg = time.perf_counter()
    paths.update(phase_dist_multislice(band, rhs, device, t, tmp, res.its))
    paths.update(phase_dist_3d(band, device, t, tmp))
    paths.update(phase_dist_autodiff(band, rhs, device, t, tmp))
    paths.update(phase_elastic(band, rhs, device, t, tmp))
    phase_dist_ms_reference(device, tmp)
    print(f"multislice, 3-D, mesh autodiff and elastic phases: "
          f"{time.perf_counter() - tg:.1f} s")
    del band, rhs, sf, res, pc
    torch.cuda.empty_cache()
    tc = time.perf_counter()
    phase_complex(device, t)
    torch.cuda.empty_cache()
    print(f"complex phase: {time.perf_counter() - tc:.1f} s")
    tt = time.perf_counter()
    phase_transpose_reference(device)
    print(f"transpose reference: {time.perf_counter() - tt:.1f} s")
    tm = time.perf_counter()
    phase_factor_surface_reference(device)
    print(f"factor-surface phases (flagship and references): "
          f"{time.perf_counter() - tf:.1f} s (references "
          f"{time.perf_counter() - tm:.1f} s)")

    # BASELINE config 3 through the testbed CLI
    t3 = time.perf_counter()
    rec3, _ = phase_config3(device)
    phase_config3_reference(device)
    phase_config3_timing(rec3, device, t)
    del rec3
    torch.cuda.empty_cache()
    print(f"config 3 phases: {time.perf_counter() - t3:.1f} s")
    tt = time.perf_counter()
    phase_transpose_config3(device)
    torch.cuda.empty_cache()
    print(f"config 3 transposed (bicg): {time.perf_counter() - tt:.1f} s")

    # BASELINE config 1 (gmres + lu) through the testbed CLI: #9 at K = 1
    t1 = time.perf_counter()
    phase_config1(device, t, bounds)
    phase_config1_reference(device)
    phase_transpose_config1(device, t)
    torch.cuda.empty_cache()
    print(f"config 1 phases: {time.perf_counter() - t1:.1f} s")
    tp = time.perf_counter()
    paths["mg_config1"] = phase_pcs_config1(device, t, bounds, errs)
    torch.cuda.empty_cache()
    print(f"mg phase (config 1): {time.perf_counter() - tp:.1f} s")

    # the reference's zero-diagonal scenario with pivot shifts, n = 1e6
    tz = time.perf_counter()
    phase_zerodiag(device, t, bounds)
    torch.cuda.empty_cache()
    print(f"zero-diagonal phase: {time.perf_counter() - tz:.1f} s")

    # the SPD path (BASELINE config 2)
    from spike_petsc_tpu_torch.ops.cuda import fused_sweep_many_spd as cfms
    sband, srhs = spd_band(SPD_N, SPD_HALF_BW, device)
    ssf = spd_factor(sband)
    errs.update(phase_spd_kernels(srhs, ssf, device))
    phase_carry(ssf, device, cfms, "config 2: spd factors f32, truncated",
                seed=SEED + 16)
    cg_launches = phase_spd_main_path(sband, srhs)
    cg_serve_launches = phase_spd_serving(sband, device)
    phase_spd_reference(device)
    spd_t, spd_bounds = phase_spd_timing(sband, srhs, ssf, device)
    t.update(spd_t)
    bounds.update(spd_bounds)
    tg = time.perf_counter()
    paths.update(phase_dist_config2(sband, srhs, device, t, tmp))
    print(f"distributed config 2 phase: {time.perf_counter() - tg:.1f} s")
    tk = time.perf_counter()
    spc = make_pc("cholesky", sband, Options(dict(SPD_OPTIONS)))
    phase_ksp_types(sband, srhs, spc, SPD_KSP_TYPE_CASES,
                    ("fused_sweep_spd", "band_matvec"))
    phase_transpose_config2(sband, srhs, spc)
    del ssf, spc
    torch.cuda.empty_cache()
    tp = time.perf_counter()
    paths.update(phase_pcs_config2(sband, srhs, device, t, bounds, errs))
    print(f"SOR phases (config 2): {time.perf_counter() - tp:.1f} s")
    del sband, srhs
    torch.cuda.empty_cache()
    phase_ksp_types_reference(device)
    print(f"KSP types on config 2 and the references: "
          f"{time.perf_counter() - tk:.1f} s")
    tp = time.perf_counter()
    paths["fieldsplit_testbed2"] = phase_pcs_testbed2(device, t, bounds,
                                                    errs)
    torch.cuda.empty_cache()
    phase_pcs_reference(device)
    print(f"testbed2 fieldsplit and the PC references: "
          f"{time.perf_counter() - tp:.1f} s")

    # the route tuner, the native assembly, config 4 and the auction
    tn = time.perf_counter()
    phase_tuning(device, tmp, t)
    torch.cuda.empty_cache()
    print(f"tuning phase: {time.perf_counter() - tn:.1f} s")
    tp = time.perf_counter()
    phase_native_factor(device, t, errs, paths)
    torch.cuda.empty_cache()
    print(f"native-assembly phase: {time.perf_counter() - tp:.1f} s")
    tp = time.perf_counter()
    phase_config4(device, tmp, t, paths, errs)
    phase_config4_reference(device, tmp)
    torch.cuda.empty_cache()
    print(f"config 4 phases: {time.perf_counter() - tp:.1f} s")
    tp = time.perf_counter()
    single_auction = phase_auction(device, t)
    torch.cuda.empty_cache()
    phase_dist_auction(device, t, tmp, single_auction)
    print(f"auction phases: {time.perf_counter() - tp:.1f} s")
    print(f"tuner, native-assembly, config 4 and auction phases: "
          f"{time.perf_counter() - tn:.1f} s")

    # each kernel's launches from the run of the path it carries; the
    # library call where one PyTorch call computes the same function
    kernels = []
    for name, path_launches, (ms, plain), library in (
            ("band_matvec", launches,
             ("band_matvec_cuda", "band_matvec_plain"),
             "band_matvec_library"),
            ("fused_sweep", launches,
             ("fused_sweep_cuda_f32", "fused_sweep_plain_f32"), None),
            ("fused_sweep_many", serve_launches,
             ("fused_sweep_many_cuda_f32", "fused_sweep_many_plain_f32"),
             None),
            ("blocktri_matvec", bt_launches,
             ("blocktri_matvec_cuda", "blocktri_matvec_plain"),
             "blocktri_matvec_library"),
            ("fused_sweep_spd", cg_launches,
             ("fused_sweep_spd_cuda_f32", "fused_sweep_spd_plain_f32"), None),
            ("fused_sweep_many_spd", cg_serve_launches,
             ("fused_sweep_many_spd_cuda_f32",
              "fused_sweep_many_spd_plain_f32"), None),
            ("band_matvec_f64", refine_launches,
             ("band_matvec_f64_cuda", "band_matvec_f64_plain"),
             "band_matvec_f64_library"),
            ("sweeps", alt_launches, ("sweeps_cuda_f32", "sweeps_plain_f32"),
             None),
            ("blocktri_matvec_grid", alt_launches,
             ("blocktri_matvec_grid_cuda", "blocktri_matvec_grid_plain"),
             "blocktri_matvec_library"),
            ("reduced_thomas", serve_launches,
             ("reduced_thomas_cuda_f32", "reduced_thomas_plain_f32"),
             None),
            ("band_matvec_many", serve_launches,
             ("band_matvec_many_cuda_w201", "band_matvec_many_plain_w201"),
             None)):
        bound_ms, bound_by = bounds[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"spike_petsc_tpu_torch/csrc/{name}.cu",
            "replaces": REPLACES[name], "launches": path_launches[name],
            "max_abs_err": errs[name], "ms": t[ms][0],
            "plain_ms": t[plain][0], "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": t[library][0] if library else None,
            "path_launches": {path: n[name] for path, n in paths.items()
                              if n.get(name)}})
    check(all(k["launches"] > 0 for k in kernels),
          f"a kernel ran no time on its path: {kernels}")
    print(json.dumps({"kernels": kernels}))
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
