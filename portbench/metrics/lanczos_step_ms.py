"""lanczos_step_ms: milliseconds over the Lanczos steps (``SolveInfo.steps``
summed) of the solves in the traced run's untraced part, the units that
start once the profiler has stopped; moves e0_s."""


def read(context):
    part = context["untraced"]
    if context["metric"] != "e0_s" or not part or not part["steps"]:
        return None
    return 1e3 * part["seconds"] / part["steps"]
