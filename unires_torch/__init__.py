"""unires_torch: unified super-resolution / denoising of 3D medical images
in PyTorch, with hand-written CUDA kernels for NVIDIA Hopper.

The port of ``unires_tpu`` (JAX), which stays the reference it is tested
against. Public API as the JAX package's: ``Settings``, ``proj_info``,
``proj_apply``, ``check_adjoint``, ``init``, ``fit``, ``preproc``.
"""

__version__ = "0.1.0"

from .settings import Settings, settings  # noqa: F401
from .models.proj_op import ProjOp, proj_info  # noqa: F401
from .models.forward import proj_apply, check_adjoint  # noqa: F401
from .pipeline.run import init, fit, preproc  # noqa: F401
