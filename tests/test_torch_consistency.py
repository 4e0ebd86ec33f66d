"""The port's consistency and spin-orbital command lines
(cli/consistency_main.py, cli/spin_orbital_main.py) held against the JAX
package's on the CPU in float64, on inline input texts: input0, a 10-site
Heisenberg ring (dense branch) and a 17-site ring with 8 up spins (dim
24 310, past the dense branch's 20 000: the T=inf energy is the mean of
the diagonal).  Every printed value agrees to 1e-10 (relative to its
scale), and the T=inf energies equal their closed forms: a Heisenberg
ring of L sites with magnetization M = N_up - N_dn has <Sz_i Sz_j> =
(M^2 - L) / (4 L (L - 1)) on every bond, a Hubbard chain U N_up N_dn / L.
The spin-orbital chains (3, 1), (2, 2) and (4, 2) agree with the JAX CLI
to 1e-10, and twiceJ = 3 exits in both."""

import re

import numpy as np
import pytest
import torch

from lanczosplusplus_tpu.cli import consistency_main as jax_consistency
from lanczosplusplus_tpu.cli import spin_orbital_main as jax_spin_orbital
from lanczosplusplus_tpu_torch.cli import consistency_main, spin_orbital_main
from test_torch_host import E0_INPUT0, INPUT0, hubbard_chain_text
from test_torch_inputs import heisenberg_text

torch.set_num_threads(2)

LABELS = ("Lanczos: lowest eigenvalue=", "Lapack: lowest eigenvalue=",
          "|difference|=", "T=infinity energy=")


def heisenberg_tinf(nsite, nup):
    m = 2 * nup - nsite
    return nsite * (m * m - nsite) / (4.0 * nsite * (nsite - 1))


CASES = {  # name: (text, T=inf closed form, dense branch)
    "input0": (INPUT0, 0.0, True),
    "hubbard6_u4": (hubbard_chain_text(6, 4.0), 4.0 * 3 * 3 / 6, True),
    "heisenberg10": (heisenberg_text(10, 1, 5), heisenberg_tinf(10, 5),
                     True),
    "heisenberg17_nup8": (heisenberg_text(17, 1, 8),
                          heisenberg_tinf(17, 8), False),
}


def printed(out):
    """{label: value} of the lines the consistency CLI printed."""
    return {label: float(re.search(re.escape(label) + r" (\S+)",
                                   out).group(1))
            for label in LABELS if label in out}


@pytest.mark.parametrize("name", sorted(CASES))
def test_consistency_matches_jax(tmp_path, capsys, name):
    text, tinf, dense = CASES[name]
    path = tmp_path / "input.inp"
    path.write_text(text)
    e = consistency_main.run(["-f", str(path), "--tinf", "--device", "cpu"])
    ours = printed(capsys.readouterr().out)
    je = jax_consistency.run(["-f", str(path), "--tinf"])
    theirs = printed(capsys.readouterr().out)
    assert sorted(ours) == sorted(theirs)
    assert ("Lapack: lowest eigenvalue=" in ours) == dense
    for label, want in theirs.items():
        scale = 1.0 if label == "|difference|=" else max(abs(want), 1.0)
        assert abs(ours[label] - want) <= 1e-10 * scale, label
    assert abs(e - je) <= 1e-10 * abs(je)
    assert abs(ours["T=infinity energy="] - tinf) <= 1e-10
    if dense:
        assert ours["|difference|="] <= 1e-10
    if name == "input0":
        assert abs(e - E0_INPUT0) <= 1e-12


def test_consistency_without_tinf_prints_no_tinf(tmp_path, capsys):
    path = tmp_path / "input.inp"
    path.write_text(INPUT0)
    consistency_main.run(["-f", str(path), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "Lapack: lowest eigenvalue=" in out
    assert "T=infinity" not in out


@pytest.mark.parametrize("nsites,twice_j", [(3, 1), (2, 2), (4, 2)])
def test_spin_orbital_matches_jax(capsys, nsites, twice_j):
    args = [str(nsites), str(twice_j)]
    ours = spin_orbital_main.run([*args, "--device", "cpu"])
    out = capsys.readouterr().out
    theirs = jax_spin_orbital.run(args)
    jout = capsys.readouterr().out
    for got, want in zip(ours, theirs):
        assert abs(got - want) <= 1e-10 * max(abs(want), 1.0)
    assert abs(ours[0] - ours[1]) <= 1e-9 * abs(ours[1])
    # the same lines, to the digits both print
    assert out == jout
    assert re.search(r"^Lanczos energy=\S+\nLAPACK energy=\S+\n$", out)


def test_spin_orbital_default_twice_j(capsys):
    assert spin_orbital_main.run(["2", "--device", "cpu"]) == \
        pytest.approx(spin_orbital_main.run(["2", "2", "--device", "cpu"]),
                      rel=1e-12)
    capsys.readouterr()


def test_spin_orbital_twice_j_three_exits_in_both():
    with pytest.raises(SystemExit, match="not Hermitian"):
        spin_orbital_main.run(["2", "3", "--device", "cpu"])
    with pytest.raises(SystemExit, match="not Hermitian"):
        jax_spin_orbital.run(["2", "3"])
