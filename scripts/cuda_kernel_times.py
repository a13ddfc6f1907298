"""Time the pull, push and pull_grad kernels of a checkout of this repository
on one card.

    python3 scripts/cuda_kernel_times.py [--tree PATH] [--label NAME] [--warm]

Loads ``--tree``'s own ``chip_smoke.py`` (default: this checkout), which
binds that tree's ``unires_torch``, so that the kernels of two commits (for
example an unpacked ``git archive`` of the parent) are timed in one call,
each by its own cases (``kernel_cases``) and timing (``_time_ms``: CUDA
events around each call, L2 flushed before it; ``_host_ms``: synchronised
calls as a caller sees them). For each case of phase 3 (``kernel_cases``,
then the FOV = true cases of ``fov_kernel_cases`` and each kernel's batched
launch of ``KERNEL_BATCH`` volumes at the fit's shapes, as this tree's
``chip_smoke.batch_case`` makes them, where the tree has them, then pull at
the misaligned bench fit's own maps, as this tree's
``chip_smoke.bench_pull_cases`` makes them, then the finite-difference
stencils of ``chip_smoke.stencil_cases`` and the blur's passes of
``chip_smoke.blur_cases`` and the rigid GN statistics of
``chip_smoke.gn_cases`` where the tree has them, each beside the plain
chain it replaced) it prints the max abs difference
between kernel and plain version (must be 0; for the GN statistics the
largest difference relative to a moment's sum of |terms|, which the
float64 sums' order makes ~1e-16), the kernel's device ms per
call three times, and its host ms. A tree whose kernels read
their maps from device memory (``ops.resample.push_plan`` exists) is given
the maps as CUDA tensors and push its plan, as its fit chunk launches them;
an older tree takes the host maps it was written for. ``--warm`` leaves
L2 unflushed before each call (the tree's ``_flush_l2`` replaced by a no-op),
so that a kernel reads inputs that the previous call left in L2, as the
kernels of the fit's captured graph mostly do.
"""
import argparse
import importlib.util
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(HERE))
    ap.add_argument("--label", default="this")
    ap.add_argument("--warm", action="store_true")
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  tree / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)  # binds the tree's unires_torch
    if args.warm:
        cs._flush_l2 = lambda: None
        args.label += " warm"

    import torch
    from unires_torch.ops import resample as tr

    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: the timing needs a GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"[times {args.label}] {smi} | unires_torch from "
          f"{Path(tr.__file__).parents[2]}")
    funcs = {"pull": (tr.pull, tr.pull_plain), "push": (tr.push, tr.push_plain),
             "pull_grad": (tr.pull_grad, tr.pull_grad_plain)}
    device_maps = hasattr(tr, "push_plan")
    cases = list(cs.kernel_cases("cuda"))
    if hasattr(cs, "fov_kernel_cases"):
        cases += cs.fov_kernel_cases("cuda")
    for name, case, inp, Mc, out_dim, kw in cases:
        kern_fn, plain_fn = funcs[name]
        M, kwk = Mc, dict(kw)
        if device_maps:
            M = torch.from_numpy(tr._as_map(Mc)).cuda()
            if name == "push":
                Minv = kw.get("Minv")
                kwk["Minv"] = tr.push_plan(
                    M, None if Minv is None
                    else torch.from_numpy(tr._as_map(Minv)).cuda(),
                    kw.get("order", 1), tuple(inp.shape), out_dim)
        kern = lambda: kern_fn(inp, M, out_dim, **kwk)  # noqa: E731
        err = float((kern() - plain_fn(inp, Mc, out_dim, **kw)).abs().max())
        report(cs, args.label, f"{name}/{case}", kern, err,
               "device" if device_maps else "host")
    if hasattr(cs, "KERNEL_BATCH") and device_maps:
        for name in ("pull", "push", "pull_grad"):
            kern, err = batch_case(funcs, name)
            report(cs, args.label, f"{name}/batch{cs.KERNEL_BATCH}", kern,
                   err, "device")
    for name, case, inp, Mc, out_dim, kw in here().bench_pull_cases("cuda"):
        M = torch.from_numpy(tr._as_map(Mc)).cuda() if device_maps else Mc
        kern = lambda: tr.pull(inp, M, out_dim)  # noqa: E731
        err = float((kern() - tr.pull_plain(inp, Mc, out_dim)).abs().max())
        report(cs, args.label, f"{name}/{case}", kern, err,
               "device" if device_maps else "host")
    for entry, case, kern, plain, _ in (cs.stencil_cases("cuda") if hasattr(
            cs, "stencil_cases") else ()):
        err = float((kern() - plain()).abs().max())
        report(cs, args.label, f"stencil {entry}/{case}", kern, err, "device")
        report(cs, args.label, f"plain chain {entry}/{case}", plain, 0.0,
               "device")
    for direction, case, kern, plain, *_ in (cs.blur_cases("cuda") if hasattr(
            cs, "blur_cases") else ()):
        err = float((kern() - plain()).abs().max())
        report(cs, args.label, f"blur {direction}/{case}", kern, err,
               "device")
        report(cs, args.label, f"plain chain {direction}/{case}", plain, 0.0,
               "device")
    for case, kern, plain, absolute, _ in (cs.gn_cases("cuda") if hasattr(
            cs, "gn_cases") else ()):
        err = float(((kern() - plain()).abs() / absolute()).max())
        report(cs, args.label, f"gn_stats {case}", kern, err, "device")
        report(cs, args.label, f"plain chain gn_stats {case}", plain, 0.0,
               "device")


def report(cs, label, case, kern, err, maps):
    ms = [cs._time_ms(kern, reps=21) for _ in range(3)]
    host = cs._host_ms(kern, reps=21)
    print(f"[times {label}] {case} ({maps} map): max_abs_err {err:.3e} | "
          f"kernel ms " + " ".join(f"{t:.4f}" for t in ms)
          + f" | host ms {host:.4f}")


def here():
    """This tree's ``chip_smoke``, loaded once, its cases built with the
    timed tree's ``unires_torch`` (the one imported first)."""
    if "chip_smoke_here" not in sys.modules:
        spec = importlib.util.spec_from_file_location("chip_smoke_here",
                                                      HERE / "chip_smoke.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules["chip_smoke_here"] = mod
    return sys.modules["chip_smoke_here"]


def batch_case(funcs, name):
    """The batched launch of phase 3, its inputs built by this tree's
    ``chip_smoke.batch_case`` with the timed tree's ``unires_torch`` (the
    one imported first): the launch, and its max abs difference from the
    plain version."""
    import numpy as np
    import torch

    inp, Ms, kw, out_dim, plain = here().batch_case(name)
    Md = torch.from_numpy(np.ascontiguousarray(Ms)).cuda()
    kern = lambda: funcs[name][0](inp, Md, out_dim, **kw)  # noqa: E731
    want = torch.stack([plain(b) for b in range(len(Ms))])
    return kern, float((kern() - want).abs().max())


if __name__ == "__main__":
    main()
