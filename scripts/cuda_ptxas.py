"""Registers, spills and shared memory of every kernel of a checkout's
``unires_torch/csrc/resample.cu``, as ``nvcc -Xptxas -v`` reports them.

    python3 scripts/cuda_ptxas.py [--tree PATH] [--label NAME] [--source F]
                                  [--sass]

Compiles the tree's source with the port's own flags
(``unires_torch/ops/cuda_build.py``) into a scratch object under
``build/ptxas/`` and prints one line per kernel instantiation, its name
demangled by ``cu++filt`` where the toolkit has it. Run it on the parent
and the change in one call to compare their kernels. ``--source`` names
another file of the tree (``scripts/batch_launch_variants.cu``).
``--sass`` also prints, per kernel, a hash of its machine code
(``cuobjdump -sass``, instructions only): two trees whose kernel prints the
same hash compiled it to the same instructions.
"""
import argparse
import hashlib
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
    ap.add_argument("--sass", action="store_true")
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
            name = demangle(filt, m.group(1))
            continue
        if name and "spill" in line:
            spills = line.strip()
        elif name and "Used" in line:
            print(f"[ptxas {args.label}] {name}: "
                  f"{line.split(':', 1)[1].strip()} | {spills}")
            name = None
    if args.sass:
        print_sass(out, filt, args.label)


def demangle(filt, name):
    try:
        return subprocess.run([filt, name], capture_output=True, text=True,
                              check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return name


def print_sass(obj, filt, label):
    """One line per kernel of ``obj``: its demangled name and the sha256 of
    its instructions (addresses and encodings dropped)."""
    from unires_torch.ops import cuda_build

    cuobjdump = Path(cuda_build.nvcc_path()).parent / "cuobjdump"
    text = subprocess.run([str(cuobjdump), "-sass", str(obj)],
                          capture_output=True, text=True, check=True).stdout
    for body in re.split(r"\n\s*Function : ", text)[1:]:
        name, rest = body.split("\n", 1)
        ins = re.findall(r"/\*[0-9a-f]{4,}\*/\s+([^;]*);", rest)
        digest = hashlib.sha256("\n".join(
            " ".join(i.split()) for i in ins).encode()).hexdigest()[:16]
        print(f"[sass {label}] {demangle(filt, name.strip())}: "
              f"{len(ins)} instructions, sha256 {digest}")


if __name__ == "__main__":
    main()
