"""The preconditioner's set-up: the synchronized ``make_pc`` call, s."""


def read(run):
    return run.pc_setup_s
