from .proj_op import ProjOp, proj_info  # noqa: F401
from .forward import proj_apply, check_adjoint  # noqa: F401
