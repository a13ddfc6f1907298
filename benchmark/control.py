"""The readings that the limits of ``correct`` are set from, on one card.

    python3 benchmark/control.py --workload <cell> --seeds <a,b,...> \
        [--faults <name,...> --fault-seeds <a,b,...>] [--out <file.jsonl>]

One process: the cell's set-up once, then for each seed the first unit of
the window that seed gives (its subjects, init and fit, as ``run.py`` runs
them) and the numbers that ``correct`` compares, three times: for the
program; with the control in the program's place (the reference computed
in float32 with TF32 operands in its matrix products: ``data_rel`` and
``prior_rel``); and with the answer altered where it is produced (the
first channel scaled by 1.001). Then, for each fault of
``harness/faults.py`` named, the program's numbers with that fault planted
on each fault seed. One JSON line per reading on standard output (and in
``--out``). The benchmark's own runs run none of this.
"""
import time

T_BEGIN = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]


def readings(cell, seeds, device, out=None, fault_names=(),
             fault_seeds=()):
    """Yields a row of numbers per seed, then per fault and fault seed."""
    from harness import faults, inputs, judge, program

    config, traffic = cell["config"], cell["traffic"]
    program.build_kernels(device)
    gts = inputs.ground_truths(config, device)
    warm = inputs.unit_subjects(config, traffic, gts, seeds[0],
                                inputs.WARM_UP_UNIT, device)
    program.run_unit(config, warm, device, max_iter=2)
    del warm
    runs = [(None, s) for s in seeds] + [
        (f, s) for f in fault_names for s in fault_seeds]
    for fault, seed in runs:
        subjects = inputs.unit_subjects(config, traffic, gts, seed, 0,
                                        device)
        with (faults.FAULTS[fault]() if fault else contextlib.nullcontext()):
            t_init, t_fit, outs = program.run_unit(config, subjects, device)
        pairs = list(zip(subjects, outs))
        refs = [judge.reference_objective(s, o, config) for s, o in pairs]
        nums, failed, per = judge.readings(pairs, config, gts, refs)
        row = dict(seed=seed, fault=fault, program=nums, failed=failed,
                   per=per, n_iter=[o["n_iter"] for o in outs],
                   init_s=t_init, fit_s=t_fit)
        if fault is None:
            row["control"] = judge.control_readings(pairs, config, refs)
            altered = []
            for s_, o in pairs:
                ys = o["ys"].clone()
                ys[0] *= 1.001
                altered.append((s_, dict(o, ys=ys)))
            row["altered"] = judge.readings(altered, config, gts)[0]
        if out is not None:
            out.write(json.dumps(row) + "\n")
            out.flush()
        yield row


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--out")
    args = ap.parse_args()
    import torch

    from harness import spec

    if not torch.cuda.is_available():
        print("[control] needs a CUDA device", file=sys.stderr)
        return 2
    cell = spec.cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    with contextlib.ExitStack() as stack:
        out = stack.enter_context(open(args.out, "a")) if args.out else None
        for row in readings(cell, seeds, "cuda", out,
                            [f for f in args.faults.split(",") if f],
                            [int(x) for x in args.fault_seeds.split(",")
                             if x]):
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
