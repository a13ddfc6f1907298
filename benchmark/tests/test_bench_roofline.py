"""``metrics/kernels.resample_roofline.py`` counts the bytes of the grids
that the fit resamples: each observation's upsampled grid ``dim_yx`` as the
reader works it out (its header moved by the program's co-registration and
atlas transforms) equals the program's own ``po.dim_yx`` after ``init``, on
the CPU at 8 mm: ``brainweb_common``, whose atlas transform's scale sets
the ratio, and the CT fixture, whose
observation is finer in-plane than the recon grid (ratio 1 there)."""
import importlib.util

import numpy as np
import pytest

from harness import inputs, program, spec
from tiny_ct import SEED_CT, tiny_ct


def _reader():
    path = spec.BENCH_DIR / "metrics" / "kernels.resample_roofline.py"
    sp = importlib.util.spec_from_file_location("roofline_reader", path)
    mod = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(mod)
    return mod


def _init(cell):
    """(subject, the judge's output fields of the init, the program's
    ``po.dim_yx`` of each observation)."""
    cf = cell["config"]
    gts = inputs.ground_truths(cf, "cpu")
    subject = inputs.make_subject(cf, cell["traffic"], gts, SEED_CT, 0, 0,
                                  "cpu")
    x, y, sett = program.run_mod.init(subject["inputs"],
                                      program.settings(cf, "cpu"))
    out = dict(dim_y=tuple(y[0].dim), mat_y=np.array(y[0].mat, np.float64),
               mat_coreg=(None if sett.mat_coreg is None
                          else np.array(sett.mat_coreg, np.float64)),
               mat_atlas=(None if sett.mat_atlas is None
                          else np.array(sett.mat_atlas, np.float64)))
    return subject, out, [tuple(int(d) for d in o.po.dim_yx)
                          for xc in x for o in xc]


@pytest.mark.parametrize("name", ["common.subjects", "ct.subjects"])
def test_the_reader_counts_the_fits_upsampled_grids(tiny_cell, name):
    cell = tiny_ct() if name == "ct.subjects" else tiny_cell(name)
    subject, out, want = _init(cell)
    got = _reader().upsampled_dims(subject, out, cell["config"])
    assert [tuple(d) for d in got] == want
    if name == "common.subjects":
        # an atlas transform that scales by 0.999, as the cell's does at
        # 1 mm (0.99877 to 0.99914), makes the 8 mm voxels 8.008 mm: ratio
        # 2 where the unmoved header reads 1
        scaled = dict(out, mat_atlas=np.diag([0.999, 0.999, 0.999, 1.0]))
        big = _reader().upsampled_dims(subject, scaled, cell["config"])
        for o, b, w in zip(subject["obs"], big, want):
            ones = [d for d in range(3) if w[d] == o["x"].shape[d]]
            assert len(ones) == 2 and all(b[d] > w[d] for d in ones)
    else:
        x = subject["obs"][0]["x"]
        assert want[0][:2] == tuple(x.shape[:2])
