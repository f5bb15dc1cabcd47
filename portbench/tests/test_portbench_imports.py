"""No run loads JAX or the JAX package, and the reference loads nothing of
the port. Top-level names are compared whole: the port's name begins with
the JAX package's."""

import json
import subprocess
import sys

from conftest import ROOT
from portbench import harness


def test_forbidden_names_compare_whole():
    assert harness.forbidden_modules(["rein48_tpu_torch", "rein48_tpu_torch.engine", "torch"]) == []
    assert harness.forbidden_modules(["rein48_tpu"]) == ["rein48_tpu"]
    assert harness.forbidden_modules(["rein48_tpu.engine.core", "jax.numpy", "flax", "jaxlib"]) == [
        "flax", "jax.numpy", "jaxlib", "rein48_tpu.engine.core"]


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json; print(json.dumps(sorted(sys.modules)))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_drivers_load_no_jax():
    code = (
        "from portbench import harness, calibrate, faults\n"
        "import glob, os\n"
        "for f in sorted(glob.glob('portbench/drivers/*.py')):\n"
        "    harness.load_module('drivers', os.path.basename(f)[:-3])\n"
        "from rein48_tpu_torch.train import ppo, ntuple, evaluate, afterstate\n"
    )
    loaded = _loaded(code)
    assert "rein48_tpu_torch" in loaded
    assert harness.forbidden_modules(loaded) == []


def test_reference_loads_no_port():
    code = "from portbench.reference import engine, ntuple, philox, ppo, resnet, search\nfrom portbench import flops, events\n"
    loaded = _loaded(code)
    tops = {m.split(".")[0] for m in loaded}
    assert "rein48_tpu_torch" not in tops
    assert harness.forbidden_modules(loaded) == []
