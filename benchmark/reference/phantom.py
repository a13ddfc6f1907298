"""The benchmark's brain phantom, made on the device from a seed.

A frozen copy of the repository's numpy phantom (nested tissue shells with
plateau intensities, a folded GM/WM interface, ventricles and mild texture,
one geometry shared by every contrast), written in torch so that it is made
on the card in a few large calls. Its band-limited noise comes from a
``torch.Generator`` on the volume's device, so a seed gives one anatomy per
device type. The grid starts at the BrainWeb MNI placement (-90, -126, -72)
mm and has ``vx`` mm voxels, so a coarse grid still holds the whole head.
"""
from __future__ import annotations

import math

import torch

ORIGIN_MM = (-90.0, -126.0, -72.0)

# tissue intensity per class, as fractions of the amplitude: 0 background,
# 1 CSF, 2 GM, 3 WM, 4 scalp, 5 skull
CLASS_INTENSITY = {
    "t1": (0.0, 0.18, 0.62, 1.00, 0.45, 0.08),
    "t2": (0.0, 1.00, 0.55, 0.36, 0.30, 0.05),
    "pd": (0.0, 1.00, 0.95, 0.80, 0.50, 0.05),
}


def _smooth_noise(dim, sigma_vox, gen, device):
    """Unit-std noise low-passed by a gaussian of ``sigma_vox`` voxels."""
    n = torch.randn(dim, generator=gen, device=device, dtype=torch.float32)
    f = torch.fft.rfftn(n)
    for d in range(3):
        k = (torch.fft.fftfreq(dim[d], device=device) if d < 2
             else torch.fft.rfftfreq(dim[d], device=device))
        shape = [1, 1, 1]
        shape[d] = k.numel()
        f = f * torch.exp(-2.0 * (math.pi * k * sigma_vox) ** 2).reshape(shape)
    s = torch.fft.irfftn(f, s=dim)
    return s / s.std().clamp_min(1e-12)


def brain_phantom(dim, vx, contrasts, amplitude, seed, texture, device):
    """{contrast: (dim) float32 volume} on ``device``; one anatomy for all."""
    dim = tuple(int(d) for d in dim)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    axes = [ORIGIN_MM[d] + vx * torch.arange(dim[d], device=device,
                                             dtype=torch.float32)
            for d in range(3)]
    X = axes[0][:, None, None]
    Y = axes[1][None, :, None]
    Z = axes[2][None, None, :]

    def rho(centre, semi):
        return torch.sqrt(((X - centre[0]) / semi[0]) ** 2
                          + ((Y - centre[1]) / semi[1]) ** 2
                          + ((Z - centre[2]) / semi[2]) ** 2)

    folds = _smooth_noise(dim, 4.0 / vx, gen, device)
    r_eff = rho((0.0, -18.0, 18.0), (72.0, 90.0, 78.0)) + 0.045 * folds
    cls = torch.zeros(dim, dtype=torch.int64, device=device)
    cls[rho((0.0, -14.0, 6.0), (82.0, 102.0, 92.0)) <= 1.0] = 4  # scalp
    cls[rho((0.0, -15.0, 8.0), (76.0, 96.0, 86.0)) <= 1.0] = 5  # skull
    cls[r_eff <= 1.00] = 1  # CSF rim
    cls[r_eff <= 0.92] = 2  # GM ribbon
    cls[r_eff <= 0.80] = 3  # WM core
    vent = torch.minimum(rho((-14.0, -28.0, 20.0), (10.0, 34.0, 12.0)),
                         rho((14.0, -28.0, 20.0), (10.0, 34.0, 12.0)))
    cls[(vent <= 1.0) & (cls == 3)] = 1  # ventricles
    tex = (1.0 + texture * _smooth_noise(dim, 1.5 / vx, gen, device)
           if texture else 1.0)
    out = {}
    for c in contrasts:
        table = torch.tensor(CLASS_INTENSITY[c], dtype=torch.float32,
                             device=device) * float(amplitude)
        out[c] = torch.clamp(table[cls] * tex, min=0.0).contiguous()
    return out
