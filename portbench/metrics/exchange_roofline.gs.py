"""exchange_roofline.gs: the diagonal-and-exchange kernel's share of its
roofline in ground-state cells: 100 x the least time of the window's
applies (``work.least_s``: the state read and written once a row, which
this kernel must do alone) over the device seconds of the traced ops whose
name holds ``ell_spmv`` (the trace's breakdown, its ten longest ops by
name).  None where the trace, the table of peaks or such an op is missing;
moves e0_s."""


def read(context):
    trace = context.get("trace")
    least = context.get("least_apply_s")
    if context["metric"] != "e0_s" or not trace or not least:
        return None
    seconds = sum(s for name, s in trace["breakdown"]["device_ops"]
                  if "ell_spmv" in name)
    if not seconds:
        return None
    return 100.0 * least[0] / seconds
