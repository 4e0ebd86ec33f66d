"""apply_roofline.gs: the Hamiltonian apply's share of its roofline in
ground-state cells (``work.roofline_percent``); moves e0_s."""

from portbench.work import roofline_percent


def read(context):
    return roofline_percent(context, "e0_s")
