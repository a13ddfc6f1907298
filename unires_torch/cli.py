"""Command-line front-end of the port, flag-compatible with
``unires_tpu.cli`` and the reference (unires/_cli.py:59-249): same flag
names, defaults and --no- pairs. ``--device`` names a torch device, ``cuda``
(default) or ``cpu``; ``cuda`` without a card raises. With ``--shard`` each
positional argument is one subject, its channels separated by commas, and
the subjects are fitted as one batch (``pipeline.run.preproc_batch``).
"""
from __future__ import annotations

from argparse import ArgumentParser

from .pipeline.run import preproc, preproc_batch
from .settings import Settings


def _preproc(pth, atlas_rigid, common_output, denoising, device, dir_out, fov,
             label_file, label_channel_index, label_repeat_index, linear,
             plot_conv, prefix, print_info, reg_scl, res_origin, scale, sched,
             show_hyperpar, show_jtv, tolerance, unified_rigid, vx, write_out,
             ct, crop, noise_model="gaussian", chunk_iters=16, shard="",
             precond="dct"):
    """Fit the model from the command line (reference _cli.py:7-56)."""
    s = Settings()
    if device:
        s.device = device
    s.dir_out = dir_out
    s.plot_conv = plot_conv
    s.do_print = print_info
    s.reg_scl = reg_scl
    if isinstance(label_file, str):
        s.label = (label_file, (label_channel_index, label_repeat_index))
    s.show_hyperpar = show_hyperpar
    s.show_jtv = show_jtv
    s.tolerance = tolerance
    s.unified_rigid = unified_rigid
    s.common_output = common_output
    s.vx = vx
    s.do_res_origin = res_origin
    s.write_out = write_out
    s.sched_num = sched
    s.prefix = prefix
    s.scaling = scale
    s.fov = fov
    s.ct = ct
    s.crop = crop
    s.atlas_rigid = atlas_rigid
    s.noise_model = noise_model
    s.chunk_iters = chunk_iters
    s.precond = precond
    if linear:
        s.max_iter = 0
    if denoising:
        s.vx = 0
    s.shard = shard

    if shard:
        # batch mode (the reference fits one subject per call): each
        # positional argument is ONE subject, its channels comma-separated
        subjects = [p.split(",") if "," in p else [p] for p in pth]
        return preproc_batch(subjects, s)
    return preproc(pth, s)


def _bool_pair(parser: ArgumentParser, name: str, default: bool, help_: str):
    parser.add_argument(f"--{name}", dest=name, action="store_true",
                        help=help_ + f" [default={default}].")
    parser.add_argument(f"--no-{name}", dest=name, action="store_false")
    parser.set_defaults(**{name: default})


def build_parser() -> ArgumentParser:
    s = Settings()
    parser = ArgumentParser(prog="unires-torch")
    parser.add_argument("pth", type=str, nargs="+",
                        help="<Required> path(s) to subject MRIs/CTs (NIfTI).")
    _bool_pair(parser, "atlas_rigid", s.atlas_rigid,
               "Rigid, else rigid+isotropic, alignment to atlas")
    _bool_pair(parser, "common_output", s.common_output,
               "Makes recons aligned with same grid, across subjects")
    _bool_pair(parser, "ct", s.ct,
               "Data could be CT (if contain negative values)")
    _bool_pair(parser, "crop", s.crop, "Crop field-of-view")
    parser.add_argument("--denoising", action="store_true", default=False,
                        help="Apply denoising to input data")
    parser.add_argument("--device", type=str, default=s.device,
                        help=f"Torch device, 'cuda' or 'cpu' [default={s.device!r}].")
    parser.add_argument("--dir_out", type=str, default=s.dir_out,
                        help="Directory to write output. Default is same as "
                             "input data.")
    parser.add_argument("--fov", type=str, default=s.fov,
                        help="If crop, uses this field-of-view ('brain'|'head')")
    parser.add_argument("--label_file", type=str, default=None,
                        help="Path to manual label file (nearest-neighbour "
                             "warped) [default=None]")
    parser.add_argument("--label_channel_index", type=int, default=0,
                        help="Channel index for label [default=0]")
    parser.add_argument("--label_repeat_index", type=int, default=0,
                        help="Repeat index for label [default=0]")
    _bool_pair(parser, "linear", False,
               "Reslice using trilinear interpolation only (no super-resolution)")
    _bool_pair(parser, "plot_conv", s.plot_conv,
               "Use matplotlib to plot convergence in real-time")
    parser.add_argument("--prefix", type=str, default=s.prefix,
                        help=f"Output image(s) prefix [default={s.prefix}].")
    parser.add_argument("--print_info", type=int, default=s.do_print,
                        help=f"Print progress to terminal [0,1,2; default={s.do_print}].")
    parser.add_argument("--reg_scl", type=float, default=s.reg_scl,
                        help=f"Scale regularisation estimate [default={s.reg_scl}].")
    _bool_pair(parser, "res_origin", s.do_res_origin,
               "Resets origin, if CT data")
    _bool_pair(parser, "scale", s.scaling, "Optimise even/odd slice scaling")
    parser.add_argument("--sched", type=int, default=s.sched_num,
                        help=f"Number of coarse-to-fine scalings [default={s.sched_num}].")
    _bool_pair(parser, "show_hyperpar", s.show_hyperpar,
               "Use matplotlib to visualise hyper-parameter estimates")
    _bool_pair(parser, "show_jtv", s.show_jtv, "Show the joint total variation")
    parser.add_argument("--tolerance", type=float, default=s.tolerance,
                        help=f"Algorithm tolerance, if zero, run to max_iter "
                             f"[default={s.tolerance}].")
    _bool_pair(parser, "unified_rigid", s.unified_rigid,
               "Do unified rigid registration")
    parser.add_argument("--vx", type=float, default=s.vx,
                        help=f"Reconstruction voxel size [default={s.vx}].")
    parser.add_argument("--noise_model", type=str, default=s.noise_model,
                        choices=("gaussian", "rician"),
                        help="Background-noise mixture for hyper-parameter "
                             f"estimation [default={s.noise_model}].")
    parser.add_argument("--chunk_iters", type=int, default=s.chunk_iters,
                        help="Outer iterations per device call "
                             f"[default={s.chunk_iters}].")
    parser.add_argument("--precond", type=str, default=s.precond,
                        choices=("dct", "jacobi", "none"),
                        help="CG preconditioner: dct (default), jacobi (the "
                             "reference's disabled _precond, for A/B parity "
                             "runs), none.")
    parser.add_argument("--shard", type=str, nargs="?", const="batch",
                        default="", choices=("", "batch"),
                        help="Fit a multi-subject batch over the CUDA "
                             "devices; each positional argument is then one "
                             "subject with its channels comma-separated, "
                             "e.g. unires-torch --shard a_t1.nii,a_t2.nii "
                             "b_t1.nii,b_t2.nii [default=off].")
    _bool_pair(parser, "write_out", s.write_out,
               "Write reconstructed output images")
    return parser


def run(argv=None):
    args = build_parser().parse_args(argv)
    _preproc(**vars(args))


if __name__ == "__main__":
    run()
