"""Standalone tools mirroring the reference's executables
(reference/src/makefile:1-15): the wbm matching tool and the spectral
partitioning tool, both host work (the testbed is ../testbed.py)."""
