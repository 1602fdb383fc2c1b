"""Plain references the check holds the program's answers against.

``reference/<reference>.py`` gives two functions, each taking the
configuration and the matrix as its generator makes it:

- ``matvec(cfg, matrix, X)``: A X in float64 for ``X [n, r]``, the pool's
  right-hand sides;
- ``solve(cfg, matrix, B, *, dtype=torch.float64, tf32_products=False)``:
  X with A X = B for ``B [n, r]``, in ``dtype``; ``dtype=torch.float32,
  tf32_products=True`` is the control, the same solve with every product's
  operands rounded to TF32.

A reference imports nothing of the program and takes nothing it made.
"""
