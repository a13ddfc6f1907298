"""Minimal API example of the PyTorch port (the counterpart of
demos/simple_api_use.py).

Give unires_torch a bunch of NIfTI paths (or (array, affine) pairs) and get
1 mm isotropic reconstructions back.

Run:  python demos/torch_simple_api_use.py [--device cuda|cpu] t1.nii [t2.nii ...]
"""
import sys
from argparse import ArgumentParser

sys.path.insert(0, ".")

from unires_torch import Settings, preproc  # noqa: E402

if __name__ == "__main__":
    ap = ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("paths", nargs="+", help="input NIfTI files, one per "
                    "channel or repeat")
    ap.add_argument("--device", default="cuda", help="torch device "
                    "[default=cuda; cuda without a card raises]")
    args = ap.parse_args()

    sett = Settings()
    sett.device = args.device
    sett.vx = 1.0           # reconstruction voxel size (0 -> denoise only)
    sett.do_coreg = True    # NMI rigid co-registration of the inputs
    sett.scaling = True     # estimate even/odd (interleave) intensity scaling
    sett.unified_rigid = True  # refine rigid poses during the fit

    dat_y, mat_y, pth_y = preproc(args.paths, sett)
    print("Reconstructed volumes:")
    for p in pth_y:
        print("  ", p)
