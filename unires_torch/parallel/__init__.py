"""Fits that span several subjects or devices."""
from .fit_batch import (assign_devices, check_homogeneous,  # noqa: F401
                        fit_batch)
