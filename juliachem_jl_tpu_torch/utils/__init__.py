from . import constants, elements, options, timings  # noqa: F401
