"""Typed SCF options resolved from keyword dicts.

Parity with reference src/shared/SCFOptions.jl:2-139 (`SCFOptions` struct and
`create_scf_options`).
"""

from dataclasses import dataclass, asdict

from . import constants as C


@dataclass
class SCFOptions:
    scf_type: str = C.SCFType.rhf
    guess: str = C.Guess.default
    contraction_mode: str = C.ContractionMode.default
    load: str = C.IntegralLoad.default
    energy_convergence: float = C.Convergence.energy_delta_change_default
    density_convergence: float = C.Convergence.density_rms_change_default
    df_energy_convergence: float = C.Convergence.energy_delta_change_default
    df_density_convergence: float = C.Convergence.density_rms_change_default
    max_iterations: int = C.Convergence.max_iterations_default
    df_max_iterations: int = C.Convergence.df_max_iterations_default
    df_exchange_n_blocks: int = C.Screening.df_exchange_n_blocks_default
    df_screening_sigma: float = C.Screening.df_screening_sigma_default
    df_screen_exchange: bool = C.Screening.df_screen_exchange_default
    df_force_dense: bool = False
    df_use_adaptive: bool = True
    num_devices: int = 1
    ndiis: int = C.NDIIS_DEFAULT
    fdiff: bool = C.FDIFF_DEFAULT
    # f32 incremental Fock (see constants.FDIFF_F32); requires fdiff and a
    # builder with an f32 phase.  The increment F(dD) carries f32 error
    # relative to ||F(dD)|| — vanishing as dD -> 0 — so the accumulated G
    # stays f64-accurate between the periodic full-f64 resyncs, and the
    # convergence test only ever accepts a resync-built (untainted) Fock.
    fdiff_f32: bool = C.FDIFF_F32_DEFAULT
    fdiff_resync: int = C.FDIFF_RESYNC_DEFAULT
    damp: bool = True
    # virtual-orbital level shift (Eh): F <- F + shift * (S - S D S / 2),
    # i.e. the virtual projector in the S metric.  Raises virtual
    # eigenvalues by ~shift, damping occupied-virtual rotations on systems
    # whose DIIS limit-cycles (S22 S17 DF).  Auto-released once the density
    # step is inside the convergence basin, so converged energies match the
    # unshifted fixed point.  Extension beyond the reference (which has no
    # level shifting and simply fails such cases).
    level_shift: float = 0.0
    # the large-system chain: disk-cache path prefixes for the folded B (and
    # its raw 3-center checkpoint) and for S/T/V; "f32" stores the packed B
    # in f32 (models/df_screened.py)
    df_b_cache: str = ""
    oei_cache: str = ""
    df_b_dtype: str = "f64"
    # project the auxiliary fitting space onto real solid harmonics before
    # the metric fold (models/df.py::fitted_metric_and_rows): removes the
    # Cartesian contaminant directions that make even-tempered (AutoAux)
    # metrics numerically singular (cond 1e17 -> Cholesky-clean), shrinks
    # naux ~10-20%, and matches what every production DF code fits in.
    # The reference fits in raw Cartesians (its JKFIT tables are sparse
    # enough to survive); energies differ only within the DF fit error.
    df_spherical_aux: bool = True
    debug: bool = False
    # mixed-precision SCF: f32 Fock builds far from convergence, guaranteed
    # f64 for the final iterations (TPU-native optimization; no reference
    # analog — CUDA hardware had native f64)
    mixed_precision: bool = True
    # switch f32 -> f64 when the density rms step drops below this (density
    # is scale-free; total-energy deltas grow with system size and drown in
    # f32 noise)
    mixed_precision_switch: float = 1.0e-3
    # record per-phase (J/K) fock timings on the sharded DF path
    # (JCTiming per-iteration J/K keys analog; costs a second pass over B)
    profile_fock: bool = False
    # absolute epoch deadline: the SCF loop stops before an iteration that
    # would end past it (models/scf.py); 0 for none
    wall_deadline: float = 0.0

    def to_dict(self):
        return asdict(self)


def create_scf_options(scf_flags: dict | None) -> SCFOptions:
    """Keyword-or-default resolution; reference SCFOptions.jl:47-139."""
    f = dict(scf_flags or {})
    opts = SCFOptions()
    opts.scf_type = str(f.get(C.SCFType.key, opts.scf_type)).lower()
    if opts.scf_type in ("density_fitting", "density fitting"):
        opts.scf_type = C.SCFType.density_fitting
    opts.guess = str(f.get(C.Guess.key, opts.guess)).lower()
    opts.contraction_mode = str(f.get(C.ContractionMode.key, opts.contraction_mode)).lower()
    if opts.contraction_mode == "default":
        opts.contraction_mode = C.ContractionMode.default
    opts.load = str(f.get(C.IntegralLoad.key, opts.load)).lower()
    opts.energy_convergence = float(f.get(C.Convergence.energy_delta_change, opts.energy_convergence))
    opts.density_convergence = float(f.get(C.Convergence.density_rms_change, opts.density_convergence))
    opts.df_energy_convergence = float(
        f.get(C.Convergence.density_fitting_energy_delta_change, opts.energy_convergence)
    )
    opts.df_density_convergence = float(
        f.get(C.Convergence.density_fitting_density_rms_change, opts.density_convergence)
    )
    opts.max_iterations = int(f.get(C.Convergence.max_iterations, opts.max_iterations))
    opts.df_max_iterations = int(f.get(C.Convergence.df_max_iterations, opts.df_max_iterations))
    opts.df_exchange_n_blocks = int(f.get(C.Screening.df_exchange_n_blocks, opts.df_exchange_n_blocks))
    opts.df_screening_sigma = float(f.get(C.Screening.df_screening_sigma, opts.df_screening_sigma))
    opts.df_screen_exchange = bool(f.get(C.Screening.df_screen_exchange, opts.df_screen_exchange))
    opts.df_force_dense = bool(f.get(C.DeviceAlgorithms.df_force_dense, opts.df_force_dense))
    opts.df_use_adaptive = bool(f.get(C.DeviceAlgorithms.df_use_adaptive, opts.df_use_adaptive))
    opts.num_devices = int(f.get(C.DeviceAlgorithms.num_devices, opts.num_devices))
    opts.ndiis = int(f.get(C.NDIIS, opts.ndiis))
    opts.df_b_cache = str(f.get("df_b_cache", opts.df_b_cache))
    opts.oei_cache = str(f.get("oei_cache", opts.oei_cache))
    opts.df_b_dtype = str(f.get("df_b_dtype", opts.df_b_dtype))
    opts.df_spherical_aux = bool(f.get("df_spherical_aux",
                                       opts.df_spherical_aux))
    opts.mixed_precision = bool(f.get("mixed_precision", opts.mixed_precision))
    opts.mixed_precision_switch = float(
        f.get("mixed_precision_switch", opts.mixed_precision_switch))
    opts.profile_fock = bool(f.get("profile_fock", opts.profile_fock))
    opts.fdiff = bool(f.get(C.FDIFF, opts.fdiff))
    opts.fdiff_f32 = bool(f.get(C.FDIFF_F32, opts.fdiff_f32))
    opts.fdiff_resync = int(f.get(C.FDIFF_RESYNC, opts.fdiff_resync))
    opts.damp = bool(f.get(C.DAMP, opts.damp))
    opts.level_shift = float(f.get("level_shift", opts.level_shift))
    opts.wall_deadline = float(f.get("wall_deadline", opts.wall_deadline))
    opts.debug = bool(f.get(C.DEBUG, opts.debug))
    return opts


def print_scf_options(opts: SCFOptions, printer=print) -> None:
    """Reference SCFOptions.jl:141-176."""
    printer("-" * 40)
    printer("SCF options:")
    for k, v in opts.to_dict().items():
        printer(f"  {k:28s} = {v}")
    printer("-" * 40)
