"""What a band generator hands the program: the band's entries as the
program's ``BandedMatrix``."""


def program_operator(port, cfg: dict, data, device):
    """(the operator and PC matrix that ``make_pc`` and ``make_solver``
    or ``make_solver_many`` are given, the keyword arguments that place
    it): the band already lies on the run's device in its dtype, so
    none."""
    return port.BandedMatrix(data=data, kl=cfg["kl"], ku=cfg["ku"]), {}
