"""reorth_per_step: the solver's Gram-Schmidt passes (the port's
``lanczos.reorth_passes``) over its steps (``lanczos.steps``), over the
run's solves, in ground-state cells (``program.per``); moves e0_s."""

from portbench.program import per


def read(context):
    return per(context, "e0_s", "lanczos.reorth_passes", "lanczos.steps")
