"""The plain reference that decides a run's ``correct``.

Plain PyTorch and NumPy only: nothing here imports ``jax``, the JAX
package or the port.  Each model module (named in a configuration's
``reference`` key) rebuilds the sector from the configuration's input text
and applies its Hamiltonian to a batch-major block; ``solvers`` holds the
plain Lanczos ground-state energy, the eigenpair residual and the FTLM
estimate the port's answers are held against.
"""

import importlib


def sector(name: str, text: str, device):
    """The sector operator of reference model module `name` for the input
    `text`, built on `device`."""
    module = importlib.import_module(f"portbench.reference.{name}")
    return module.Sector(text, device)
