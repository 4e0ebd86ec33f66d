"""The port's sector files (io_/sector_files.py) held against the JAX
package's on the CPU in float64: both write the sweep of the reference
test's 2-site Hubbard input (U = 3, tests/test_sector_files.py), and the
two files agree: the same sectors and labels in the same order,
eigenvalues to 1e-12, eigenvectors up to the basis each eigensolver picks
within a degenerate level (that level's projector to 1e-10), operator
matrices exactly, and the grand-canonical Z read from each file equal to
``GrandCanonical.partition`` to 1e-9.  Each package's reader reads the
other's file as its own."""

import numpy as np
import pytest
import torch

from lanczosplusplus_tpu.engine.thermal import (
    GrandCanonical as JaxGrandCanonical)
from lanczosplusplus_tpu.geometry import Geometry as JaxGeometry
from lanczosplusplus_tpu.io_ import sector_files as jax_sector_files
from lanczosplusplus_tpu.io_.input_parser import parse_input as jax_parse
from lanczosplusplus_tpu.models import build_model as jax_build_model
from lanczosplusplus_tpu_torch.engine.thermal import GrandCanonical
from lanczosplusplus_tpu_torch.geometry import Geometry
from lanczosplusplus_tpu_torch.io_ import sector_files
from lanczosplusplus_tpu_torch.io_.input_parser import parse_input
from lanczosplusplus_tpu_torch.models import build_model
from test_torch_host import INPUT0

torch.set_num_threads(2)

# tests/test_sector_files.py's edit of TestSuite input0: 2 sites, U = 3
TWO_SITE = (INPUT0.replace("TotalNumberOfSites=4", "TotalNumberOfSites=2")
            .replace("hubbardU 4 0 0 0 0", "hubbardU 2 3 3")
            .replace("potentialV 8 0 0 0 0 0 0 0 0", "potentialV 4 0 0 0 0"))
BETA, MU = 1.1, 0.3


def models(text):
    inp, jinp = parse_input(text), jax_parse(text)
    return (build_model(inp, Geometry(inp)),
            jax_build_model(jinp, JaxGeometry(jinp)))


def z_of(sectors):
    return sum(np.exp(BETA * (MU * sum(s["parts"]) - s["evals"])).sum()
               for s in sectors)


def projectors(evals, evecs, tol=1e-9):
    """One projector a degenerate level (eigenvalues within tol)."""
    out, start = [], 0
    for i in range(1, len(evals) + 1):
        if i == len(evals) or evals[i] - evals[start] > tol:
            v = evecs[:, start:i]
            out.append(v @ v.T)
            start = i
    return out


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sectors")
    model, jmodel = models(TWO_SITE)
    ours, theirs = str(tmp / "torch.dat"), str(tmp / "jax.dat")
    n = sector_files.write_all_sectors(ours, model, 2, device="cpu")
    jn = jax_sector_files.write_all_sectors(theirs, jmodel, 2)
    return model, jmodel, ours, theirs, n, jn


def test_sector_files_match_jax(written):
    model, jmodel, ours, theirs, n, jn = written
    assert n == jn == 9
    mine = sector_files.read_sectors(ours)
    jax = jax_sector_files.read_sectors(theirs)
    assert len(mine) == len(jax) == n
    for s, js in zip(mine, jax):
        assert s["parts"] == js["parts"]
        np.testing.assert_allclose(s["evals"], js["evals"], rtol=0,
                                   atol=1e-12)
        for p, jp in zip(projectors(s["evals"], s["evecs"]),
                         projectors(js["evals"], js["evecs"])):
            np.testing.assert_allclose(p, jp, rtol=0, atol=1e-10)
        assert s["operators"].keys() == js["operators"].keys()
        for key, (dest, m) in s["operators"].items():
            jdest, jm = js["operators"][key]
            assert dest == jdest
            np.testing.assert_array_equal(m, jm)
    # the same labels, in the same order, and the same lines wherever no
    # eigendata is written
    lines = open(ours).read().splitlines()
    jlines = open(theirs).read().splitlines()
    def label_lines(text):
        return [ln for ln in text if ln.startswith("#")
                and not ln.startswith("#Eigenvalues")]
    assert label_lines(lines) == label_lines(jlines)
    assert len(lines) == len(jlines)


def test_sector_files_partition(written):
    model, jmodel, ours, theirs, _, _ = written
    z = GrandCanonical(model, nsite=2, device="cpu").partition(BETA, MU)
    jz = JaxGrandCanonical(jmodel, nsite=2).partition(BETA, MU)
    assert z == pytest.approx(jz, rel=1e-12)
    assert z_of(sector_files.read_sectors(ours)) == pytest.approx(z, rel=1e-9)
    assert z_of(jax_sector_files.read_sectors(theirs)) == \
        pytest.approx(z, rel=1e-9)
    # tests/test_sector_files.py's operator check: c_0 of (1, 1) lands in
    # (0, 1) and has a row a state
    s11 = next(s for s in sector_files.read_sectors(ours)
               if s["parts"] == (1, 1))
    dest, c0 = s11["operators"][("c", 0, 0)]
    assert dest == (0, 1) and c0.shape[0] == 4


def test_sector_file_readers_agree(written):
    """Each package's reader gives the same data from either file."""
    _, _, ours, theirs, _, _ = written
    for path in (ours, theirs):
        mine = sector_files.read_sectors(path)
        jax = jax_sector_files.read_sectors(path)
        for s, js in zip(mine, jax):
            assert s["parts"] == js["parts"]
            np.testing.assert_array_equal(s["evals"], js["evals"])
            np.testing.assert_array_equal(s["evecs"], js["evecs"])
            assert s["operators"].keys() == js["operators"].keys()
            for key, (dest, m) in s["operators"].items():
                assert dest == js["operators"][key][0]
                np.testing.assert_array_equal(m, js["operators"][key][1])


def test_write_all_sectors_skips_only_impossible_sectors(tmp_path,
                                                         monkeypatch):
    """A sector whose basis the model cannot hold (IndexError, ValueError)
    is skipped; any other error propagates instead of being swallowed."""
    model, _ = models(TWO_SITE)
    create = model.create_basis

    def refusing(error, parts_refused):
        def create_basis(parts):
            if parts == parts_refused:
                raise error("sector")
            return create(parts)
        return create_basis
    path = str(tmp_path / "s.dat")
    for error in (IndexError, ValueError):
        monkeypatch.setattr(model, "create_basis", refusing(error, (2, 2)))
        assert sector_files.write_all_sectors(path, model, 2,
                                              device="cpu") == 8
        assert (2, 2) not in [s["parts"] for s in
                              sector_files.read_sectors(path)]
    monkeypatch.setattr(model, "create_basis", refusing(RuntimeError,
                                                        (2, 2)))
    with pytest.raises(RuntimeError, match="sector"):
        sector_files.write_all_sectors(path, model, 2, device="cpu")


@pytest.mark.parametrize("kind", ["float64", "complex128", "int64",
                                  "float32"])
def test_matrix_text_is_the_jax_writers(kind):
    """A matrix block is written byte for byte as the JAX package writes
    it: the real part of every entry as repr(float)."""
    import io
    rng = np.random.default_rng(3)
    m = rng.standard_normal((5, 7)) * 10.0 ** rng.integers(-8, 8, (5, 7))
    if kind == "complex128":
        m = m + 1j * rng.standard_normal((5, 7))
    m = m.astype(kind)
    ours, theirs = io.StringIO(), io.StringIO()
    sector_files._write_matrix(ours, m)
    jax_sector_files._write_matrix(theirs, m)
    assert ours.getvalue() == theirs.getvalue()
