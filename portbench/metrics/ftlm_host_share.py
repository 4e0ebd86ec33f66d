"""ftlm_host_share: the seconds of the estimates' host part (the port's
``ftlm.host`` spans: the tridiagonal eigensolves and the Boltzmann sums)
over those of the estimates (``ftlm.estimate``), in % of the traced part,
in FTLM cells (``program.share_percent``); moves ftlm_s."""

from portbench.program import share_percent


def read(context):
    return share_percent(context, "ftlm_s", "ftlm.host", "ftlm.estimate")
