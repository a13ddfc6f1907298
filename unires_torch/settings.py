"""Algorithm settings (reference: unires/struct.py:57-111).

Every field name and default of ``unires_tpu.settings`` is kept, except
``device``, which names a torch device and defaults to ``"cuda"``. Settings
the port does not cover yet raise ``NotImplementedError`` when a run reaches
them (:func:`check_supported`).

Flag names and defaults are kept identical to the reference ``settings``
class so a UniRes user can port call-sites unchanged. Fields documented as
"derived" are populated by the pipeline itself (reference mutates them at
unires/_core.py:192-195, 258-264, 305 and unires/run.py:240-245).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional


@dataclasses.dataclass
class Settings:
    alpha: float = 1.0  # relaxation parameter (0,2); <1 under-, >1 over-relaxation
    atlas_rigid: bool = False  # rigid, else rigid+isotropic-scale, atlas alignment
    bids: bool = False  # add BIDS '_space-unires_' tag to outputs
    bound: str = "zero"  # boundary condition for resampling/gradients
    cgs_max_iter: int = 20  # max CG iterations in the y-update
    cgs_tol: float = 1e-3  # CG gain tolerance
    cgs_verbose: bool = False  # per-CG-iteration residual prints
    clean_fov: bool = False  # zero recon voxels outside all low-res FOVs
    coreg_params: dict = dataclasses.field(
        default_factory=lambda: dict(cost_fun="nmi", group="SE", samp=1, fwhm=7.0, mean_space=False)
    )
    coreg_gauge: str = "mean"  # common-frame anchor for co-registration:
    # 'mean' places the aligned frame at the Lie-mean of all input frames
    # (each scanner-pose error enters at weight 1/N — consistent with the
    # mean-space output grid and the fit's mean-centred pose gauge);
    # 'fix' reproduces the reference (frame = image sett.fix, which then
    # carries that image's full pose error into the output placement).
    crop: bool = False  # crop recon FOV to atlas box
    common_output: bool = False  # same output grid across subjects
    ct: bool = False  # input may be CT (negative values meaningful)
    device: str = "cuda"  # torch device of every volume ('cuda'|'cpu');
    # 'cuda' on a machine without CUDA raises, it never falls back to the CPU
    diff: str = "forward"  # finite-difference type (forward|backward|central)
    dir_out: Optional[str] = None  # output directory (None -> alongside input)
    do_coreg: bool = True  # initial NMI co-registration
    do_atlas_align: bool = False  # initial atlas alignment
    do_print: int = 1  # verbosity 0-3
    do_proj: Optional[bool] = None  # derived: use projection operators?
    do_res_origin: bool = False  # reset origin for CT
    fix: int = 0  # fixed image index for registration
    force_inplane_res: bool = False  # downsample in-plane axes finer than vx
    fov: str = "brain"  # crop FOV ('brain'|'head')
    gap: float = 0.0  # slice gap in [0,1)
    interpolation: int = 1  # API-compat field: the reference itself reads it
    # only in commented-out code (unires/run.py:180); both pipelines are
    # trilinear end-to-end (reset_origin/in-plane reslice take it directly)
    label: Optional[tuple] = None  # (path, (channel, repeat)) of manual labels
    mat: Optional[Any] = None  # affine for 4D array input
    max_iter: int = 512  # max outer (ADMM) iterations
    noise_model: str = "gaussian"  # background-noise fit: gaussian|rician
    method: Optional[str] = None  # derived: 'super-resolution'|'denoising'
    plot_conv: bool = False  # matplotlib live convergence plot
    pow: int = 0  # round output dims up to powers of 2/3 capped at pow
    prefix: str = "u_"  # output filename prefix
    profile_ip: int = 2  # in-plane slice profile (0 rect|1 tri|2 gauss)
    profile_tp: int = 0  # through-plane slice profile
    reg_scl: Any = 4.0  # regularisation scaling (list -> explicit schedule)
    rho: Optional[float] = None  # ADMM step size (None -> estimate)
    rho_scl: float = 1.0  # scaling of estimated rho
    rigid_basis: Optional[Any] = None  # derived: se(3) basis
    rigid_mod: int = 1  # update rigid every rigid_mod iterations
    rigid_gauge_anchor: bool = True  # True (default): mean-centre the pose
    # gauge each rigid round (subtract the mean q, the reference's
    # mean_correct semantics, unires/_update.py:243-265). False: free gauge
    # (the reference fit loop's literal mean_correct=False at run.py:131).
    # See unires_tpu.settings for why the default anchors the gauge.
    pose_budget: float = 0.02  # JAX package only: rigid drift allowance
    # (radians) of its Pallas window plans; the CUDA kernels need no plan
    precond: str = "dct"  # CG preconditioner: 'dct' (this rebuild's
    # DCT-diagonal membrane inverse), 'jacobi' (the reference's
    # shipped-but-disabled voxel-diagonal _precond, unires/_update.py:80-102,
    # for A/B parity runs), or 'none'.
    replan_margin: float = 0.0  # JAX package only (Pallas window re-plans)
    budget_escalate: bool = True  # JAX package only (window-plan escalation)
    rigid_samp: int = 1  # sub-sampling (mm) for rigid updates
    scaling: bool = False  # optimise even/odd slice scaling
    sched_num: int = 3  # number of coarse-to-fine lambda scalings
    show_hyperpar: bool = False
    show_jtv: bool = False
    tolerance: float = 1e-4  # outer-loop gain tolerance (0 -> run to max_iter)
    unified_rigid: bool = False  # joint rigid registration during fitting
    vx: Optional[float] = 1.0  # recon voxel size (0/None -> denoise)
    write_jtv: bool = False  # write JTV volume
    write_out: bool = True  # write reconstructions to disk

    # not in the reference: the JAX fit loop runs chunk_iters outer
    # iterations per device call; the port keeps it as the cadence at which
    # the CG preconditioner's data-term diagonal is recomputed
    chunk_iters: int = 16
    shard: str = ""  # multi-device sharding (not in the reference): ""
    # = off; "batch" fits a batch of subjects data-parallel in the JAX
    # package (not ported yet)
    profile_dir: Optional[str] = None  # write a profiler trace of fit here

    # checkpoint/resume (not in the reference, SURVEY §5 rebuild note)
    checkpoint_every: int = 0  # save solver state every N iterations (0=off)
    checkpoint_path: Optional[str] = None  # where to save/load the state
    resume: bool = False  # resume from checkpoint_path if it exists

    force_y_space: Optional[Any] = None  # (mat, dim): reconstruct on this
    # exact output grid instead of the data-derived mean space. Batch mode
    # sets it to subject 0's grid so the batch is geometry-homogeneous; the
    # reference's cross-subject analog is common_output (atlas grid).

    # derived at runtime (not in the reference struct, kept explicit here)
    mat_coreg: Optional[Any] = None
    mat_atlas: Optional[Any] = None

    def copy(self) -> "Settings":
        return dataclasses.replace(self)


# Backwards-friendly alias matching the reference class name.
settings = Settings


# Settings this port does not cover yet, and the ROADMAP item that brings
# each (queue 1 unless stated). A run that reaches one raises: none of them
# may silently change the computation.
_UNPORTED = (
    ("do_atlas_align", "queue 1, item 11 (registration)"),
    ("common_output", "queue 1, item 11 (registration: atlas alignment)"),
    ("unified_rigid", "queue 1, item 9 (rigid Gauss-Newton) and queue 2, "
                      "item 3 (pull_grad kernel)"),
    ("scaling", "queue 1, item 9 (scaling Gauss-Newton)"),
    ("do_res_origin", "queue 1, item 11 (registration: reset_origin)"),
    ("force_inplane_res", "queue 1, item 10 (init: resample_inplane)"),
    ("label", "queue 1, item 13 (labels)"),
    ("checkpoint_every", "queue 1, item 13 (checkpoint)"),
    ("resume", "queue 1, item 13 (checkpoint)"),
    ("shard", "queue 1, item 13 (parallel)"),
    ("profile_dir", "queue 1, item 13 (profiling)"),
    ("plot_conv", "queue 1, item 13 (plots)"),
    ("show_jtv", "queue 1, item 13 (plots)"),
)


def check_supported(sett, N: int) -> None:
    """Raise NotImplementedError for a setting the port does not cover yet."""
    for name, item in _UNPORTED:
        if getattr(sett, name):
            raise NotImplementedError(
                f"Settings.{name} is not ported to unires_torch yet "
                f"(ROADMAP {item})")
    if sett.do_coreg and N > 1:
        raise NotImplementedError(
            "Settings.do_coreg with more than one image is not ported to "
            "unires_torch yet (ROADMAP queue 1, item 11; pass "
            "do_coreg=False for pre-aligned inputs)")
