from .run import init, fit, preproc, read_data, write_data  # noqa: F401
from .structs import Obs, Chan  # noqa: F401
