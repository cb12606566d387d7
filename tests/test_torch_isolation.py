"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points refuse to run on the CPU unless asked to."""

import json
import os
import subprocess
import sys

import pytest
import torch

from moonsuperresolution_tpu_torch.config import DSRConfig
from moonsuperresolution_tpu_torch.infer.engine import (
    DEMSuperResolution,
    load_model_fn,
)

torch.set_num_threads(2)

# Run in a fresh interpreter: this one has imported jax (tests/conftest.py).
_PROBE = r"""
import importlib, json, pkgutil, sys
import moonsuperresolution_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax")
             or m == "moonsuperresolution_tpu"
             or m.startswith("moonsuperresolution_tpu."))
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True,
                          text=True, timeout=120, cwd=root)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "moonsuperresolution_tpu_torch.infer.engine" in out["modules"]
    assert "moonsuperresolution_tpu_torch.ops.patches" in out["modules"]
    assert out["bad"] == []


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("entry", ["engine", "load_model_fn"])
def test_entry_points_default_to_the_card_and_raise_without_one(no_card,
                                                                 entry):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry == "engine":
            DEMSuperResolution(DSRConfig(image_size=64, stride=16,
                                         tile_size=128))
        else:
            load_model_fn("", "gaugan", 64)


def test_cpu_only_when_asked(no_card):
    eng = DEMSuperResolution(DSRConfig(image_size=64, stride=16,
                                       tile_size=128), device="cpu")
    assert eng.device.type == "cpu"
    assert load_model_fn("", "gaugan", 64, device="cpu") is None
