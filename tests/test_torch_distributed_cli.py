"""The CLIs in two gloo processes on the CPU (``--distributed --device
cpu``): the trainer on a DP mesh with a profile of step 1 in each
process; the map, one tile-list shard per process, merged by
``merge_maps`` into the single-process map's files, byte for byte."""

import os
import subprocess
import sys

import numpy as np
import torch

from moonsuperresolution_tpu_torch.cli import merge_maps
from tests.test_torch_map import _cli, _synthetic_pair
from tests.torch_dist_cases import ROOT, free_port, launch

torch.set_num_threads(2)


def test_train_cli_in_two_processes(tmp_path):
    out = tmp_path / "run"
    outs = launch("cli_train", 2, tmp_path, argv=[
        "--recipe", "spade_256", "--synthetic", "--small", "--device", "cpu",
        "--no_log", "--mesh", "2,1", "--batch_size", "4", "--epochs", "1",
        "--max_steps_per_epoch", "2", "--output_path", str(out),
        "--profile_dir", str(tmp_path / "prof")])
    for o in outs:
        assert o["step"] == 2 and o["device"] == "cpu"
        (h,), (h0,) = o["history"], outs[0]["history"]
        assert (h["train"], h["val"]) == (h0["train"], h0["val"])
    assert np.isfinite(outs[0]["history"][0]["train"]["gen_loss"])
    assert outs[0]["writes"] == ["latest.pt", "epoch_0.pt"]
    assert outs[1]["writes"] == []
    assert sorted(os.listdir(tmp_path / "prof")) == ["train_step_0.json",
                                                     "train_step_1.json"]


def test_map_cli_in_two_processes_merges_to_the_single_map(tmp_path, rng):
    td = str(tmp_path)
    _synthetic_pair(td, rng, holes=True)
    _cli(td, "one")
    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    argv = ["--source_folder_path", td, "--map_name", "toy", "--save_path",
            os.path.join(td, "two"), "--image_size", "64", "--stride", "8",
            "--tile_size", "128", "--batch_size", "32", "--fill_workers",
            "1", "--device", "cpu", "--distributed", "--coordinator",
            f"localhost:{port}", "--num_processes", "2"]
    procs = [subprocess.Popen(
        [sys.executable, "-m",
         "moonsuperresolution_tpu_torch.cli.process_full_tiles", *argv,
         "--process_id", str(i)], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(2)]
    logs = [p.communicate(timeout=120)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], logs
    for i, log in enumerate(logs):
        assert "'tiles': 6" in log, log     # 12 tiles, 6 a process
    merge_maps.run(["--save_path", os.path.join(td, "two"), "--map_name",
                    "toy", "--num_shards", "2"])
    for k in ("mean", "std", "good"):
        with open(os.path.join(td, "one", f"toy_{k}.tiff"), "rb") as a, \
                open(os.path.join(td, "two", f"toy_{k}.tiff"), "rb") as b:
            assert a.read() == b.read(), k
