from .resample import pull, push, pull_grad, affine_to_M  # noqa: F401
from .finite_diff import im_gradient, im_divergence  # noqa: F401
from .conv import blur_down_sep, blur_up_sep  # noqa: F401
from .scaling import apply_scaling  # noqa: F401
