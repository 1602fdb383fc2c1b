"""Seeded generators of the configurations' matrices, one file each.

``problems/<generator>.py`` gives two functions:

- ``make(cfg, seed, device)``: the matrix, made from the seed, in the form
  the configuration's reference reads;
- ``program_operator(port, cfg, matrix, device)``: what the program's
  ``make_pc`` and ``make_solver`` or ``make_solver_many`` are given, built
  from that matrix: (the operator, which is the PC matrix too, the keyword
  arguments that place it on the run's device and dtype).
"""
