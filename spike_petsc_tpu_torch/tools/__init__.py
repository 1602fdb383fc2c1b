"""Standalone tools mirroring the reference's executables
(reference/src/makefile:1-15): the wbm matching tool (the testbed is
../testbed.py)."""
