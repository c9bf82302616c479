from . import df, df_screened, guess, linalg, properties, rhf, scf  # noqa: F401
