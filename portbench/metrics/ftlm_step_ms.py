"""ftlm_step_ms: milliseconds over the block steps (each estimate R vectors
by M steps) of the FTLM estimates in the traced run's untraced part, the
units that start once the profiler has stopped; moves ftlm_s."""


def read(context):
    part = context["untraced"]
    if context["metric"] != "ftlm_s" or not part or not part["steps"]:
        return None
    return 1e3 * part["seconds"] / part["steps"]
