from .input_parser import read_input, parse_input, InputSpec  # noqa: F401
from .xyz import xyz_to_molecule_dict  # noqa: F401
