"""Time the pull, push and pull_grad kernels of a checkout of this repository
on one card.

    python3 scripts/cuda_kernel_times.py [--tree PATH] [--label NAME]

Loads ``--tree``'s own ``chip_smoke.py`` (default: this checkout), which
binds that tree's ``unires_torch``, so that the kernels of two commits (for
example an unpacked ``git archive`` of the parent) are timed in one call,
each by its own cases (``kernel_cases``) and timing (``_time_ms``: CUDA
events around each call, L2 flushed before it; ``_host_ms``: synchronised
calls as a caller sees them). For each case it prints the max abs
difference between kernel and plain version (must be 0), the kernel's
device ms per call three times, and its host ms. A tree whose kernels read
their maps from device memory (``ops.resample.push_plan`` exists) is given
the maps as CUDA tensors and push its plan, as its fit chunk launches them;
an older tree takes the host maps it was written for.
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
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  tree / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)  # binds the tree's unires_torch

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
    for name, case, inp, Mc, out_dim, kw in cs.kernel_cases("cuda"):
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
        ms = [cs._time_ms(kern, reps=21) for _ in range(3)]
        host = cs._host_ms(kern, reps=21)
        print(f"[times {args.label}] {name}/{case} "
              f"({'device' if device_maps else 'host'} map): max_abs_err "
              f"{err:.3e} | "
              f"kernel ms " + " ".join(f"{t:.4f}" for t in ms)
              + f" | host ms {host:.4f}")


if __name__ == "__main__":
    main()
