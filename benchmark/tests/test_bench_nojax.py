"""Nothing the benchmark runs loads JAX or the JAX package, compared by the
whole top-level name of each module."""
import subprocess
import sys
from pathlib import Path

from harness.main import forbidden_modules

BENCH = Path(__file__).resolve().parents[1]


def test_forbidden_names_compare_the_whole_top_level_name():
    names = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
             "unires_tpu", "unires_tpu.ops.resample", "unires_torch",
             "unires_torch.ops", "jaxtyping", "flaxen", "unires_tpu_x"]
    assert forbidden_modules(names) == [
        "flax.linen", "jax", "jax.numpy", "jaxlib.xla_client", "unires_tpu",
        "unires_tpu.ops.resample"]


def test_the_harness_and_the_program_load_no_jax():
    code = ("import sys; sys.path[:0] = [%r, %r]; "
            "import run, control; "
            "from harness import inputs, judge, main, program, spec, trace; "
            "from reference import forward, grid, phantom; "
            "print(main.forbidden_modules(sys.modules))"
            % (str(BENCH), str(BENCH.parent)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(BENCH.parent))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
