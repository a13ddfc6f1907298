from .cg import cg, cg_batched  # noqa: F401
from .admm import make_admm_step, make_compute_nll, step_size  # noqa: F401
