"""Krylov iterations a right-hand side: ``KSPResult.its`` over every
column of the window."""


def read(run):
    return sum(run.its) / len(run.its) if run.its else None
