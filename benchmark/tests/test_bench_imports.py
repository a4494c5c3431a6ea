"""Nothing the harness imports is the JAX stack or the JAX package, compared
by whole top-level name (``rpnet_tpu_torch`` begins with ``rpnet_tpu``)."""

import json
import subprocess
import sys

from conftest import BENCH, ROOT

import harness


def test_whole_names_are_compared():
    assert harness.forbidden_modules({"rpnet_tpu_torch", "rpnet_tpu_torch.ops"}) == []
    assert harness.forbidden_modules({"rpnet_tpu.cli", "jax._src", "jaxlib", "flax",
                                      "optax", "orbax.checkpoint", "jaxtyping"}) == [
        "flax", "jax", "jaxlib", "optax", "orbax", "rpnet_tpu"]


def test_a_run_loads_no_jax():
    script = ("import sys, json; sys.path[:0] = [%r, %r, %r]\n"
              "import conftest, pathlib, tempfile, harness\n"
              "res = conftest.run_tiny('lgca_v3.eval', pathlib.Path(tempfile.mkdtemp()))\n"
              "print(json.dumps({'bad': harness.forbidden_modules(), 'correct': res['correct'],\n"
              "                  'port': 'rpnet_tpu_torch' in sys.modules}))\n"
              % (f"{BENCH}/tests", f"{BENCH}/metrics", BENCH))
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"bad": [], "correct": True, "port": True}
