"""build_s: host seconds from the parsed input to the sector Hamiltonian
on the card (``sector.build``), every cell; moves setup_s."""


def read(context):
    return context["build_s"]
