"""The configurations of ``BENCHMARK.json`` read as they did before the
harness took configurations of its own tissue tables, voxel sizes and CT:
at the tiny 8 mm size of the CPU tests (``conftest.tiny``,
``tiny_denoise.py``), each cell's truths, subjects (arrays, headers and
poses), the plain reference's weights and the judge's numbers of a fixed
answer equal ``RECORDED``, taken from the harness at the commit before that
change. The fixed answer (:func:`fixed_answer`) needs no fit: each truth
scaled, on the truth's grid moved by part of a voxel, with made-up registration transforms and
rigids that nearly undo them, so every number of the judge is exercised.
"""
import hashlib

import numpy as np
import pytest
import torch

from harness import inputs, judge
from reference.forward import affine_matrix_classic
from tiny_denoise import SEED_TINY, tiny_denoise3


def _sha(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:24]


def fixed_answer(subject, config, gts) -> dict:
    """An output as ``harness.program`` gives it, made without the program."""
    cs = config["contrasts"]
    n = len(subject["obs"])
    coreg = np.stack([affine_matrix_classic(
        [0.3 * i, -0.2, 0.1, 0.01 * i, 0.0, -0.005]) for i in range(n)])
    atlas = affine_matrix_classic([1.0, -2.0, 0.5, 0.01, 0.0, -0.02])
    shift = np.eye(4)
    shift[:3, 3] = [0.5, 0.25, -0.5]  # voxels: the judge interpolates
    rigids = []
    for i, o in enumerate(subject["obs"]):
        moved = np.linalg.solve(atlas, np.linalg.solve(coreg[i], o["header"]))
        off = affine_matrix_classic([0.2 * i, 0.1, -0.3, 0.0, 0.004 * i, 0.0])
        rigids.append(off @ o["pose"] @ np.linalg.inv(moved))
    return dict(
        ys=torch.stack([gts[c] * (1.0 + 0.01 * (k + 1))
                        for k, c in enumerate(cs)]),
        mat_y=inputs.output_frame(config) @ shift,
        dim_y=tuple(config["phantom"]["dim"]),
        scls=[0.1 + 0.001 * i for i in range(n)], rigids=rigids,
        chan=[o["c"] for o in subject["obs"]], mat_coreg=coreg,
        mat_atlas=atlas, obj_last=[0.0, 1.0, 1.0], n_iter=10, max_iter=60)


def fingerprint(cell) -> dict:
    """Hashes of a tiny cell's truths and first subject, and the exact
    weights and judge numbers of :func:`fixed_answer`."""
    cf = cell["config"]
    gts = inputs.ground_truths(cf, "cpu")
    subject = inputs.make_subject(cf, cell["traffic"], gts, SEED_TINY, 0, 0,
                                  "cpu")
    taus, lams = judge.subject_weights(subject, cf)
    nums = judge.subject_numbers(subject, fixed_answer(subject, cf, gts), cf,
                                 gts)
    return dict(
        truths=_sha(*[gts[c] for c in cf["contrasts"]]),
        inputs=_sha(*[a for pair in subject["inputs"] for a in pair]),
        obs=_sha(*[a for o in subject["obs"]
                   for a in (o["x"], o["header"], o["pose"])]),
        shapes=[list(o["x"].shape) for o in subject["obs"]],
        taus=[repr(t) for t in taus], lams=[repr(v) for v in lams],
        numbers={k: repr(v) for k, v in sorted(nums.items())})


@pytest.fixture(scope="module")
def cells(tiny_cell):
    return {"sr3.subjects": tiny_cell("sr3.subjects"),
            "common.subjects": tiny_cell("common.subjects"),
            "denoise3.subjects": tiny_denoise3()}


@pytest.mark.parametrize("name", ["sr3.subjects", "common.subjects",
                                  "denoise3.subjects"])
def test_an_existing_configuration_reads_as_before(cells, name):
    assert fingerprint(cells[name]) == RECORDED[name]


# taken with the harness of the parent commit, on the CPU (one thread)
RECORDED = {'common.subjects': {'inputs': 'e807cd642f264adb4830d4c9',
                     'lams': ['0.0026091278094066365',
                              '0.0033409080885739855',
                              '0.0021353963216342205'],
                     'numbers': {'data_rel': '0.9999818334843109',
                                 'frame_mm': '0.8966997461123252',
                                 'grid': '6',
                                 'pose_mm': '0.7149873062984413',
                                 'prior_rel': '0.9997342456866933',
                                 'recon_rel': '0.536220222849066',
                                 'scale_err': '0.0020000000000000018',
                                 'unfinished': '0'},
                     'obs': 'a812fa2c3bdd43a0e4b11093',
                     'shapes': [[23, 28, 6], [23, 7, 23], [6, 28, 23]],
                     'taus': ['0.0003200075048652967',
                              '0.0003886114616589959',
                              '0.000335692391112284'],
                     'truths': '8597c71d9f6817f155309bca'},
 'denoise3.subjects': {'inputs': '349e5077e7df2d467b1c5f21',
                       'lams': ['0.0022031447227710177',
                                '0.002888672955575478',
                                '0.0016301899119376428'],
                       'numbers': {'data_rel': '0.9999979873599312',
                                   'frame_mm': '1.3546120180103751',
                                   'pose_mm': '1.1463251032155923',
                                   'prior_rel': '0.9996821348268593',
                                   'recon_rel': '0.536220222849066',
                                   'scale_err': '0.10200000000000001',
                                   'unfinished': '0'},
                       'obs': '6a6045ab73017f03794a885c',
                       'shapes': [[23, 28, 23], [23, 28, 23], [23, 28, 23]],
                       'taus': ['0.00037928307772856085',
                                '0.0005435060886317803',
                                '0.00018966189734206183'],
                       'truths': '8597c71d9f6817f155309bca'},
 'sr3.subjects': {'inputs': '29a60cdfb4aa8b15bba187d1',
                  'lams': ['0.0026091278094066365',
                           '0.0033409080885739855',
                           '0.0021353963216342205'],
                  'numbers': {'data_rel': '0.9999792276029749',
                              'frame_mm': '1.3546120180103751',
                              'pose_mm': '1.1463251032155923',
                              'prior_rel': '0.9997342456866933',
                              'recon_rel': '0.536220222849066',
                              'scale_err': '0.0020000000000000018',
                              'unfinished': '0'},
                  'obs': '748089a6d8af6565f54e71d1',
                  'shapes': [[23, 28, 6], [23, 7, 23], [6, 28, 23]],
                  'taus': ['0.0003200075048652967',
                           '0.0003886114616589959',
                           '0.000335692391112284'],
                  'truths': '8597c71d9f6817f155309bca'}}
