"""Keyword constants registry.

Parity with reference src/shared/Constants.jl (SCF_Keywords namespaces).  The
string keys are kept identical so reference JSON inputs run unmodified; the
semantics of a few GPU/MPI-specific knobs are re-interpreted for the TPU mesh
(documented per-field).
"""


class SCFType:
    """Constants.jl:4-8."""

    key = "scf_type"
    rhf = "rhf"
    density_fitting = "df"


class Screening:
    """Constants.jl:10-19."""

    df_exchange_n_blocks = "df_exchange_n_blocks"  # 0 = auto
    df_exchange_n_blocks_default = 0
    df_screening_sigma = "df_sigma"
    df_screening_sigma_default = 1e-5
    df_screen_exchange = "df_exchange_screen"
    df_screen_exchange_default = True  # TPU default: masks are cheap


class Guess:
    """Constants.jl:21-27."""

    key = "guess"
    default = "hcore"
    hcore = "hcore"
    sad = "sad"
    density_fitting = "df"


class Convergence:
    """Constants.jl:29-43."""

    density_fitting_energy_delta_change = "df_dele"
    density_fitting_density_rms_change = "df_rmsd"
    energy_delta_change = "dele"
    energy_delta_change_default = 1e-3
    density_rms_change = "rmsd"
    density_rms_change_default = 1e-3
    max_iterations = "niter"
    max_iterations_default = 50
    df_max_iterations = "df_niter"
    df_max_iterations_default = 50


class ContractionMode:
    """Constants.jl:45-50.  'dense' keeps full padded tensors; 'screened'
    applies Schwarz block masks (the TPU analog of sparse pq indexing)."""

    key = "contraction_mode"
    default = "default"   # auto: dense DF while B fits HBM, else screened/packed
    dense = "dense"
    screened = "screened"


class IntegralLoad:
    """Constants.jl:52-57.  On TPU all modes lower to static SPMD sharding:
    the reference's dynamic coordinator-worker scheduler has no SPMD analog
    (SURVEY.md §5)."""

    key = "load"
    default = "static"
    sequential = "sequential"
    static = "static"
    dynamic = "dynamic"


class DeviceAlgorithms:
    """Constants.jl:59-75 (GPUAlgorithms).  num_devices selects the mesh size
    for sharded DF builds."""

    df_force_dense = "df_force_dense"
    df_use_adaptive = "df_use_adaptive"
    num_devices = "num_devices"
    df_use_K_sym = "df_use_K_sym"
    df_K_sym_type = "df_K_sym_type"


# Misc flags read directly from scf keywords in the reference driver
# (SCF.jl:20-25).
NDIIS = "ndiis"
NDIIS_DEFAULT = 8
FDIFF = "fdiff"
FDIFF_DEFAULT = False
# f32 incremental-Fock: build fdiff increments in f32 (their absolute error
# scales with ||F(dD)||, not ||F||), full-f64 resync every FDIFF_RESYNC
# increments and before any convergence declaration
FDIFF_F32 = "fdiff_f32"
FDIFF_F32_DEFAULT = False
FDIFF_RESYNC = "fdiff_resync"
FDIFF_RESYNC_DEFAULT = 10
DEBUG = "debug"
DAMP = "damp"
