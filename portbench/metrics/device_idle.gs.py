"""device_idle.gs: share of the traced window with nothing on the card,
in ground-state cells (``tracing.idle_percent``); moves e0_s."""

from portbench.tracing import idle_percent


def read(context):
    return idle_percent(context, "e0_s")
