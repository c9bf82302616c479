"""The port stands alone: it never imports jax, and its data files are
byte-identical copies of the JAX package's."""

import filecmp
import json
import pathlib
import re
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]

_CODE = """
import json, sys
import juliachem_jl_tpu_torch as jc
dev = jc.initialize("cpu")
spec = jc.io.parse_input({
    "molecule": {"symbols": ["H", "H"], "geometry": [0, 0, 0, 0, 0, 0.74]},
    "model": {"method": "RHF", "basis": "6-31G",
              "auxiliary_basis": "cc-pVDZ-JKFIT"},
    "keywords": {"scf": {"niter": 30, "dele": 1e-9, "rmsd": 1e-7,
                         "guess": "sad"},
                 "prop": {"mulliken": True}}})
out = jc.run_spec(spec)
jc.finalize()
bad = sorted(m for m in sys.modules
             if m in ("jax", "jaxlib", "juliachem_jl_tpu")
             or m.startswith(("jax.", "jaxlib.", "juliachem_jl_tpu.")))
print("RESULT:" + json.dumps({"bad": bad, "energy": out["Energy"]["Energy"],
                              "converged": out["Energy"]["Converged?"],
                              "lib_loaded": jc.ops.kernels._lib is not None}))
"""


def test_port_runs_without_jax():
    proc = subprocess.run([sys.executable, "-c", _CODE], capture_output=True,
                          text=True, cwd=REPO, timeout=300)
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT:")]
    assert line, proc.stderr[-3000:]
    out = json.loads(line[0][len("RESULT:"):])
    assert out["bad"] == []
    assert out["converged"]
    assert -1.2 < out["energy"] < -1.1
    # CPU tensors take the plain versions: the CUDA library is never loaded
    assert not out["lib_loaded"]


@pytest.mark.parametrize("rel", ["basis/data/basis_library.json",
                                 "data/eatom.json"])
def test_data_copies_identical(rel):
    a = REPO / "juliachem_jl_tpu" / rel
    b = REPO / "juliachem_jl_tpu_torch" / rel
    assert filecmp.cmp(a, b, shallow=False)


def test_package_sources_never_import_jax():
    pat = re.compile(r"^\s*(from|import)\s+\.*(jax|jaxlib|juliachem_jl_tpu)\b"
                     r"(?!_torch)", re.M)
    files = [*(REPO / "juliachem_jl_tpu_torch").rglob("*.py"),
             REPO / "chip_smoke.py", REPO / "tests" / "test_torch_cuda.py",
             REPO / "tools" / "run_water_cluster.py",
             REPO / "tools" / "make_water_clusters.py",
             REPO / "tools" / "stv_times.py", REPO / "tools" / "oei_rehearsal.py",
             REPO / "tools" / "stv_candidates.py",
             REPO / "tools" / "grad_rehearsal.py",
             REPO / "tools" / "grad_fit_variants.py"]
    scanned = {f.relative_to(REPO).as_posix() for f in files}
    for module in ("models/uhf.py", "models/rohf.py", "models/mp2.py",
                   "models/df_screened_jk.py", "interop.py",
                   "models/linalg.py", "models/df_screened.py",
                   "models/scf.py", "basis/spherical.py",
                   "models/gradient.py", "models/optimize.py",
                   "models/hessian.py", "ops/oei_grad.py", "ops/eri_grad.py",
                   "ops/oei.py", "ops/kernels.py"):
        assert f"juliachem_jl_tpu_torch/{module}" in scanned
    offenders = [str(f) for f in files if pat.search(f.read_text())]
    assert offenders == []


def _h2_spec(jc):
    return jc.io.parse_input({
        "molecule": {"symbols": ["H", "H"], "geometry": [0, 0, 0, 0, 0, 0.74]},
        "model": {"method": "RHF", "basis": "6-31G"},
        "keywords": {"scf": {"scf_type": "rhf", "guess": "sad"}}})


def test_initialize_defaults_to_the_card():
    """initialize() with no argument selects CUDA and raises without it; it
    never falls back to the CPU.  finalize() restores the card default."""
    import torch

    import juliachem_jl_tpu_torch as jc

    if torch.cuda.is_available():
        assert jc.initialize().type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            jc.initialize()
    assert jc.initialize("cpu").type == "cpu"
    jc.finalize()
    assert jc.config.resolve_device("cpu").type == "cpu"
    assert jc.config._default_device.type == "cuda"


def test_run_spec_without_a_device_needs_the_card():
    """run_spec with no device and no initialize runs on the card: without
    CUDA it raises instead of running on the CPU."""
    import torch

    import juliachem_jl_tpu_torch as jc

    jc.finalize()
    if torch.cuda.is_available():
        out = jc.run_spec(_h2_spec(jc))
        assert out["Energy"]["Density"].is_cuda
    else:
        with pytest.raises(RuntimeError):
            jc.run_spec(_h2_spec(jc))
    out = jc.run_spec(_h2_spec(jc), device="cpu")
    assert out["Energy"]["Converged?"]
    assert not out["Energy"]["Density"].is_cuda

