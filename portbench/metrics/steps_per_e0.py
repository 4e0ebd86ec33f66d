"""steps_per_e0: Lanczos steps summed over the solves completed in the
window, over their number; moves e0_s."""


def read(context):
    if context["metric"] != "e0_s":
        return None
    return context["steps"] / context["units"]
