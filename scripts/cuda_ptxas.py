"""Registers, spills and shared memory of every kernel of a checkout's
``unires_torch/csrc/resample.cu``, as ``nvcc -Xptxas -v`` reports them.

    python3 scripts/cuda_ptxas.py [--tree PATH] [--label NAME] [--source F]

Compiles the tree's source with the port's own flags
(``unires_torch/ops/cuda_build.py``) into a scratch object under
``build/ptxas/`` and prints one line per kernel instantiation, its name
demangled by ``cu++filt`` where the toolkit has it. Run it on the parent
and the change in one call to compare their kernels. ``--source`` names
another file of the tree (``scripts/batch_launch_variants.cu``).
"""
import argparse
import re
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(HERE))
    ap.add_argument("--label", default="this")
    ap.add_argument("--source", default="unires_torch/csrc/resample.cu")
    args = ap.parse_args()
    sys.path.insert(0, str(HERE))
    from unires_torch.ops import cuda_build

    tree = Path(args.tree).resolve()
    src = tree / args.source
    out = HERE / "build" / "ptxas" / f"{args.label}.o"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [cuda_build.nvcc_path(), *cuda_build._COMPILE, "-Xptxas", "-v",
           "-o", str(out), str(src)]
    log = subprocess.run(cmd, capture_output=True, text=True, check=True)
    text = log.stdout + log.stderr
    filt = shutil.which("cu++filt") or str(
        Path(cuda_build.nvcc_path()).parent / "cu++filt")
    name, spills = None, ""
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            try:
                name = subprocess.run([filt, name], capture_output=True,
                                      text=True, check=True).stdout.strip()
            except (OSError, subprocess.CalledProcessError):
                pass
            continue
        if name and "spill" in line:
            spills = line.strip()
        elif name and "Used" in line:
            print(f"[ptxas {args.label}] {name}: "
                  f"{line.split(':', 1)[1].strip()} | {spills}")
            name = None


if __name__ == "__main__":
    main()
