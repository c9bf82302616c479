from . import boys, class_tables, eri, eri3c, kernels, mcmurchie, oei, schwarz  # noqa: F401
