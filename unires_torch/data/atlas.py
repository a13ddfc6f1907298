"""Bundled MNI-space T1-like template for atlas alignment.

A numpy copy of ``unires_tpu.data.atlas`` (the port imports nothing of the
JAX package): the same volume and affine, to the bit.

The reference's ``atlas_align`` registers the fixed image to a packaged T1
atlas (unires/_core.py:340-353; the volume lives in nitorch's data and is not
redistributable here). This module provides a PROCEDURAL stand-in: a smooth,
anatomically-scaled T1-weighted head phantom generated on demand in MNI-ish
RAS space (AC at the origin) at 2 mm isotropic, consistent with the
``geometry.bb_atlas`` bounding boxes ('brain'/'head').

NMI-based registration needs matching GEOMETRY (head position, brain shape,
tissue-boundary gradients), not photorealism: the phantom models the scalp,
skull, CSF layer, cortical GM ribbon, WM core, ventricles, cerebellum and
brainstem with T1-typical intensity ordering (WM > GM > CSF), which anchors
the rigid(+iso-scale) alignment that ``--common_output``/``--crop`` need.
A real template can always be supplied via the UNIRES_ATLAS env var or the
``atlas_path`` argument (pipeline.registration.atlas_align).
"""
from __future__ import annotations

import numpy as np

# 2 mm RAS grid covering the 'head' box of geometry.bb_atlas:
# world = [-90, 90] x [-126, 90] x [-90, 126] mm, AC at voxel (45, 63, 45)
_DIM = (91, 109, 109)
_VX = 2.0
_ORIGIN = np.array([-90.0, -126.0, -90.0])


def _mat() -> np.ndarray:
    mat = np.eye(4)
    mat[:3, :3] = np.diag([_VX] * 3)
    mat[:3, 3] = _ORIGIN
    return mat


def _soft_ellipsoid(X, Y, Z, centre, semi, softness=4.0):
    """Smooth inside-mask of an ellipsoid (1 inside, 0 outside, ~softness mm
    transition) — smooth boundaries give registration usable gradients."""
    r2 = (((X - centre[0]) / semi[0]) ** 2
          + ((Y - centre[1]) / semi[1]) ** 2
          + ((Z - centre[2]) / semi[2]) ** 2)
    # signed distance proxy in mm: (1 - r) * mean(semi)
    d = (1.0 - np.sqrt(np.maximum(r2, 1e-12))) * float(np.mean(semi))
    return 1.0 / (1.0 + np.exp(-d / (softness / 4.0)))


def default_atlas():
    """(dat, mat): the bundled template volume (f32) and its 4x4 affine."""
    ii, jj, kk = np.meshgrid(*(np.arange(d) for d in _DIM), indexing="ij")
    X = _ORIGIN[0] + _VX * ii
    Y = _ORIGIN[1] + _VX * jj
    Z = _ORIGIN[2] + _VX * kk

    # head/brain centre sits above+behind the AC (MNI brain: roughly
    # x in [-72, 72], y in [-106, 73], z in [-60, 85])
    cbrain = (0.0, -18.0, 18.0)
    scalp = _soft_ellipsoid(X, Y, Z, (0, -14, 6), (82, 102, 92), 6.0)
    skull = _soft_ellipsoid(X, Y, Z, (0, -15, 8), (76, 96, 86), 5.0)
    csf = _soft_ellipsoid(X, Y, Z, cbrain, (72, 90, 78), 5.0)
    gm = _soft_ellipsoid(X, Y, Z, cbrain, (68, 86, 74), 5.0)
    wm = _soft_ellipsoid(X, Y, Z, cbrain, (58, 74, 62), 6.0)

    # lateral ventricles: two CSF-dark lobes around the midline
    vent = np.maximum(
        _soft_ellipsoid(X, Y, Z, (-14, -28, 20), (10, 34, 12), 3.0),
        _soft_ellipsoid(X, Y, Z, (14, -28, 20), (10, 34, 12), 3.0))
    # interhemispheric fissure: thin dark plane near x=0, upper brain only
    fissure = (np.exp(-0.5 * (X / 2.5) ** 2)
               * _soft_ellipsoid(X, Y, Z, cbrain, (70, 88, 76), 5.0)
               * (1.0 / (1.0 + np.exp(-(Z - 25.0) / 6.0))))
    # cerebellum (posterior-inferior) and brainstem (descending)
    cereb = _soft_ellipsoid(X, Y, Z, (0, -62, -28), (42, 30, 24), 4.0)
    stem = _soft_ellipsoid(X, Y, Z, (0, -30, -28), (12, 14, 34), 4.0)

    # compose T1-like intensities (arbitrary units ~[0, 1000])
    t1 = np.zeros(_DIM, np.float64)
    t1 += 400.0 * scalp                      # scalp/soft tissue
    t1 -= 320.0 * skull                      # skull: dark in T1
    t1 += 150.0 * csf                        # CSF layer base
    t1 += 380.0 * gm                         # cortical GM ribbon on top
    t1 += 250.0 * wm                         # WM core brightest
    t1 += 480.0 * np.maximum(cereb, stem)    # posterior fossa structures
    t1 -= 520.0 * vent                       # ventricles: dark
    t1 -= 260.0 * fissure                    # midline fissure
    t1 = np.clip(t1, 0.0, None)
    return t1.astype(np.float32), _mat()
