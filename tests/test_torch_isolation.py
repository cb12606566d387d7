"""The port stands alone: it imports neither JAX, nor the JAX package, nor
OpenCV, nor (at import) matplotlib, h5py, TensorFlow or tensorboardX, and
its entry points refuse to run on the CPU unless asked to."""

import json
import os
import subprocess
import sys

import pytest
import torch

from moonsuperresolution_tpu_torch.cli import (
    compare_maps,
    convert_vgg,
    make_h5,
    merge_maps,
    process_full_tiles,
    tile_wac,
)
from moonsuperresolution_tpu_torch.cli import train as cli_train
from moonsuperresolution_tpu_torch.config import (
    DSRConfig,
    ModelConfig,
    TrainConfig,
)
from moonsuperresolution_tpu_torch.infer.engine import (
    DEMSuperResolution,
    load_model_fn,
)
from moonsuperresolution_tpu_torch.parallel.distributed import initialize
from moonsuperresolution_tpu_torch.parallel.mesh import make_mesh
from moonsuperresolution_tpu_torch.train.loop import train

torch.set_num_threads(2)

# Run in a fresh interpreter: this one has imported jax (tests/conftest.py).
_PROBE = r"""
import importlib, json, pkgutil, sys
import moonsuperresolution_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax",
                                    "cv2", "matplotlib", "h5py",
                                    "tensorflow", "keras", "tensorboardX")
             or m == "moonsuperresolution_tpu"
             or m.startswith("moonsuperresolution_tpu."))
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    """Nor cv2 nor h5py: the machine with the card has neither (the port
    reads and writes the tile store with its own data/hdf5.py); nor
    matplotlib, absent there too, or at import TensorFlow (the Keras
    importer imports it to read a SavedModel) or tensorboardX (the logger
    imports it when asked to log)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True,
                          text=True, timeout=120, cwd=root)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    for name in ("infer.engine", "ops.patches", "ops.qconv", "models.quant",
                 "geo.tiff", "geo.lzw",
                 "infer.fill", "infer.lr_synth", "infer.merge",
                 "infer.streaming", "cli.process_full_tiles",
                 "cli.merge_maps", "train.trainers", "train.loop", "losses",
                 "models.vgg", "data.sampler", "utils.checkpoint",
                 "utils.colorize", "ops.gradients", "cli.train",
                 "data.hdf5", "data.h5_builder", "data.wac_tiler",
                 "cli.make_h5", "cli.tile_wac", "cli.compare_maps",
                 "models.pix2pix", "cli.convert_vgg",
                 "parallel.distributed", "parallel.mesh",
                 "parallel.collectives", "utils.profiling"):
        assert f"moonsuperresolution_tpu_torch.{name}" in out["modules"]
    assert out["bad"] == []


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


CFG = dict(image_size=64, stride=16, tile_size=128)
TRAIN_CFG = TrainConfig(model=ModelConfig(image_size=64, latent_dim=16,
                                          channel_plan=(16,) * 6,
                                          encoder_filters=4, disc_filters=4),
                        batch_size=2)


def _enter(entry, tmp_path, cpu):
    dev = {"device": "cpu"} if cpu else {}
    flag = ["--device", "cpu"] if cpu else []
    if entry == "train":
        return train(TRAIN_CFG, synthetic=False, log=False, **dev)
    if entry in ("cli.train", "cli.train pix2pix"):
        recipe = ["--recipe", "pix2pix"] if entry.endswith("pix2pix") else []
        return cli_train.run(["--output_path", str(tmp_path), "--no_log",
                               *recipe, *flag])
    if entry == "engine":
        return DEMSuperResolution(DSRConfig(**CFG), **dev)
    if entry == "process_map":
        return DEMSuperResolution(DSRConfig(
            **CFG, source_folder_path=str(tmp_path)), **dev).process_map()
    if entry == "load_model_fn":
        return load_model_fn("", "gaugan", 64, **dev)
    if entry == "make_mesh":
        return make_mesh((1, 1), **dev)
    if entry == "initialize":
        # Refused before any rendezvous: the process's device comes first.
        return initialize("localhost:1", 2, 1, **dev)
    return process_full_tiles.run([
        "--source_folder_path", str(tmp_path), "--map_name", "m",
        "--save_path", str(tmp_path), "--image_size", "64", "--stride", "16",
        "--tile_size", "128", *flag])


ENTRIES = ["engine", "process_map", "load_model_fn", "process_full_tiles",
           "train", "cli.train", "cli.train pix2pix", "make_mesh",
           "initialize"]


@pytest.mark.parametrize("entry", ENTRIES)
def test_entry_points_default_to_the_card_and_raise_without_one(
        no_card, tmp_path, entry):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _enter(entry, tmp_path, cpu=False)


def test_cpu_only_when_asked(no_card, tmp_path):
    """With the CPU asked for, each entry point gets past the device; the
    map entry points then fail only on what this empty directory lacks,
    and the training ones on the tile store's paths, which they were not
    given (runs on the CPU: tests/test_torch_train_loop.py)."""
    assert _enter("engine", tmp_path, cpu=True).device.type == "cpu"
    assert _enter("load_model_fn", tmp_path, cpu=True) is None
    assert _enter("make_mesh", tmp_path, cpu=True).device.type == "cpu"
    for entry in ("process_map", "process_full_tiles"):
        with pytest.raises(ValueError, match="not found"):
            _enter(entry, tmp_path, cpu=True)
    for entry in ("train", "cli.train", "cli.train pix2pix"):
        with pytest.raises(ValueError, match="h5_path, train_pkl and val_pkl"):
            _enter(entry, tmp_path, cpu=True)


@pytest.mark.parametrize("flags", [[], ["--streaming"]])
def test_merge_maps_needs_no_card(no_card, tmp_path, flags):
    """The merge is host numpy: without a card it gets as far as the
    missing manifests, and it has no --device to ask for one."""
    args = ["--save_path", str(tmp_path), "--map_name", "m", *flags]
    with pytest.raises(ValueError, match="no (streaming )?shard manifests"):
        merge_maps.run(args)
    with pytest.raises(SystemExit):
        merge_maps.parse(args + ["--device", "cpu"])


@pytest.mark.parametrize("cli,argv,error", [
    (make_h5, ["--data_path", "{d}"], FileNotFoundError),
    (tile_wac, ["--mosaic", "{d}/wac.tif", "--output_path", "{d}"],
     FileNotFoundError),
    (compare_maps, ["--a", "{d}/a.tif", "--b", "{d}/b.tif"],
     FileNotFoundError),
    (convert_vgg, ["--input", "{d}/vgg19.pth", "--output", "{d}/vgg19.npz"],
     FileNotFoundError),
])
def test_data_clis_need_no_card(no_card, tmp_path, cli, argv, error):
    """The dataset tools, the map comparison and the VGG19 converter are
    host code: without a card they get as far as the missing inputs, and
    they have no --device to ask for one."""
    argv = [a.format(d=tmp_path) for a in argv]
    with pytest.raises(error):
        cli.run(argv)
    with pytest.raises(SystemExit):
        cli.parse(argv + ["--device", "cpu"])
