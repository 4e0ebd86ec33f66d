"""apply_roofline.ftlm: the Hamiltonian apply's share of its roofline in
FTLM cells (``work.roofline_percent``); moves ftlm_s."""

from portbench.work import roofline_percent


def read(context):
    return roofline_percent(context, "ftlm_s")
