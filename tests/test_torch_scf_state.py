"""The SCF driver's state keywords in the PyTorch port (plain versions, on
the CPU), against the JAX package where it runs them:

- ``oei_cache``: a hit loads S/T/V instead of building them;
- ``checkpoint`` / ``restart``: the restart converges to the same energy
  within 1e-10 Eh; a checkpoint of another basis or another geometry is
  refused (ValueError, the JAX package's messages);
- ``fdiff`` (incremental Fock) and ``fdiff_f32`` (its f32 increments with
  the forced f64 resync) on dense DF and on conventional water: within
  1e-8 Eh of the JAX package in the same number of iterations;
- ``wall_deadline`` in the past stops after iteration 1 with "Deadline Hit",
  as in the JAX package; ``bench_fock_reps`` records its ``fock_rep``
  markers.
"""

import time

import numpy as np
import pytest

import juliachem_jl_tpu as jx
import juliachem_jl_tpu_torch as tc
from juliachem_jl_tpu_torch.models import scf as tc_scf
from tests._torch_parity import CPU, WATER


def _inp(extra, scf_type="df", basis="6-31G", molecule=WATER):
    scf = {"scf_type": scf_type, "niter": 60, "dele": 1e-9, "rmsd": 1e-7,
           "guess": "sad", **extra}
    model = {"method": "RHF", "basis": basis}
    if scf_type == "df":
        model["auxiliary_basis"] = "cc-pVDZ-JKFIT"
    return {"molecule": molecule, "model": model, "keywords": {"scf": scf}}


def _port(inp):
    return tc.run_spec(tc.io.parse_input(inp), device=CPU)["Energy"]


def _jax(inp):
    return jx.run_spec(jx.io.parse_input(inp))["Energy"]


def test_oei_cache_hit_skips_the_one_electron_build(tmp_path, monkeypatch):
    inp = _inp({"oei_cache": str(tmp_path / "c")})
    first = _port(inp)
    assert (tmp_path / "c_torch_oei.npz").exists()

    def refuse(*args, **kw):
        raise AssertionError("the cache hit built S/T/V")

    monkeypatch.setattr(tc_scf, "overlap_kinetic_nuclear", refuse)
    second = _port(inp)
    assert second["Energy"] == first["Energy"]


def test_restart_from_checkpoint_converges_to_the_same_energy(tmp_path):
    """The restart from a converged checkpoint runs without the f32 phase
    (mixed_precision false): its f32 first iteration would move the density
    by the f32 noise, and the loop would have to converge again from there."""
    ckpt = str(tmp_path / "ckpt.npz")
    first = _port(_inp({"checkpoint": ckpt, "checkpoint_every": 2}))
    again = _port(_inp({"restart": ckpt, "mixed_precision": False}))
    assert again["Converged?"]
    assert again["Iterations"] <= 2
    assert abs(again["Energy"] - first["Energy"]) <= 1e-10


def test_restart_refuses_another_system(tmp_path):
    ckpt = str(tmp_path / "ckpt.npz")
    _port(_inp({"checkpoint": ckpt, "niter": 3}))
    with pytest.raises(ValueError, match="fingerprint mismatch"):
        _port(_inp({"restart": ckpt}, basis="6-31G*"))
    z = np.load(ckpt)
    fp = bytes(z["fingerprint"]).decode()
    with pytest.raises(ValueError, match="nuclear repulsion"):
        tc_scf.load_checkpoint(ckpt, CPU, fp, float(z["e_nuc"]) + 1e-3)


@pytest.mark.parametrize("scf_type", ["df", "rhf"], ids=["dense-df", "conventional"])
@pytest.mark.parametrize("f32", [False, True], ids=["fdiff", "fdiff-f32"])
def test_fdiff_matches_jax(scf_type, f32):
    inp = _inp({"fdiff": True, "fdiff_f32": f32}, scf_type=scf_type)
    ref, got = _jax(inp), _port(inp)
    assert got["Converged?"] and ref["Converged?"]
    assert got["Iterations"] == ref["Iterations"]
    assert abs(got["Energy"] - ref["Energy"]) <= 1e-8
    plain = _port(_inp({}, scf_type=scf_type))
    assert abs(got["Energy"] - plain["Energy"]) <= 1e-8


def test_wall_deadline_in_the_past_stops_after_iteration_1():
    inp = _inp({"wall_deadline": time.time() - 1.0})
    ref, got = _jax(inp), _port(inp)
    assert got["Deadline Hit"] and ref["Deadline Hit"]
    assert got["Iterations"] == ref["Iterations"] == 1
    assert not got["Converged?"]


def test_bench_fock_reps_are_marked():
    got = _port(_inp({"bench_fock_reps": 2}))
    tm = got["Timings"].timings
    it = got["Iterations"]
    assert [k for k in tm if k.startswith("fock_rep-")] == [
        f"fock_rep-{it + 1}", f"fock_rep-{it + 2}"]
    assert f"fock_time-{it + 2}" in tm
