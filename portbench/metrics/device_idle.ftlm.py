"""device_idle.ftlm: share of the traced window with nothing on the card,
in FTLM cells (``tracing.idle_percent``); moves ftlm_s."""

from portbench.tracing import idle_percent


def read(context):
    return idle_percent(context, "ftlm_s")
