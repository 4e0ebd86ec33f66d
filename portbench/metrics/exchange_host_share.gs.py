"""exchange_host_share.gs: the seconds of the port's ``hamiltonian.ell``
spans (the diagonal-and-ELL launch inside ``Hamiltonian.matmat_t``) over
those of its ``hamiltonian.apply`` spans, in % of the traced part, in
ground-state cells (``program.share_percent``).  None for a port without
``hamiltonian.ell`` spans; moves e0_s."""

from portbench.program import share_percent, totals


def read(context):
    if "hamiltonian.ell" not in (totals() or {}):
        return None
    return share_percent(context, "e0_s", "hamiltonian.ell",
                         "hamiltonian.apply")
