"""host_reads_per_step: the solver's reads to the host (the port's
``lanczos.host_reads``, every alpha and norm read by ``.item()``) over its
steps (``lanczos.steps``), over the run's solves, in ground-state cells
(``program.per``); moves e0_s."""

from portbench.program import per


def read(context):
    return per(context, "e0_s", "lanczos.host_reads", "lanczos.steps")
