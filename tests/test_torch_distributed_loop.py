"""The training loop in two gloo processes on the CPU: on a DP mesh (2, 1)
and a TP mesh (1, 2), synthetic terrain, 2 steps an epoch, then resumed
for a third and fourth step.

- Both processes run the same steps and report the same losses.
- Process 0 alone writes: ``latest.pt`` and ``epoch_N.pt`` once a run,
  none by process 1.
- The files hold the whole state: the same keys and shapes as a
  one-process run's (a TP run gathers its sharded parameters and Adam
  moments before saving and re-slices them on restore).

The TP case's plan opens with two 512-channel blocks (and a 512-wide
latent dense), so the default ``min_dim`` 512 shards them.
"""

import glob
import os
import warnings

import numpy as np
import torch

from moonsuperresolution_tpu_torch.config import ModelConfig, TrainConfig
from moonsuperresolution_tpu_torch.train.loop import train
from moonsuperresolution_tpu_torch.utils.checkpoint import restore_params
from tests.torch_dist_cases import launch

torch.set_num_threads(2)

PLANS = {"dp": (32, 32, 16, 16, 8, 8), "tp": (512, 512, 16, 16, 8, 8)}


def cfg(plan, out):
    return TrainConfig(model=ModelConfig(image_size=64, latent_dim=16,
                                         channel_plan=plan, encoder_filters=4,
                                         disc_filters=4),
                       batch_size=4, epochs=1, output_path=str(out))


def layout(path):
    """Keys and shapes of a saved file's tensors, nested dicts walked."""
    def walk(obj, prefix=""):
        if isinstance(obj, torch.Tensor):
            return {prefix: tuple(obj.shape)}
        if isinstance(obj, dict):
            out = {}
            for k, v in obj.items():
                out.update(walk(v, f"{prefix}/{k}"))
            return out
        if isinstance(obj, (list, tuple)):
            out = {}
            for i, v in enumerate(obj):
                out.update(walk(v, f"{prefix}/{i}"))
            return out
        return {prefix: type(obj).__name__}
    return walk(torch.load(path, map_location="cpu", weights_only=True))


def test_two_process_loop_resumes_and_saves_whole(tmp_path):
    hold_two_process_loop(tmp_path, (2, 1), "dp")


def hold_two_process_loop(tmp_path, mesh, plan):
    """The checks of the module docstring on ``mesh``
    (tests/test_torch_distributed_loop_tp.py runs the TP case)."""
    run = tmp_path / "run"
    torch.save({"cfg": cfg(PLANS[plan], run), "mesh": mesh},
               tmp_path / "in.pt")
    outs = launch("loop", 2, tmp_path, timeout=150)
    for o in outs:
        assert o["first"]["step"] == 2 and o["resumed"]["step"] == 4
        assert [h["epoch"] for h in o["resumed"]["history"]] == [1]
        for key in ("first", "resumed"):
            assert o[key]["history"][0]["train"] == \
                outs[0][key]["history"][0]["train"]
            assert o[key]["history"][0]["val"] == \
                outs[0][key]["history"][0]["val"]
    if plan == "tp":
        assert set(outs[0]["sharded"]) == {
            "generator.dense.weight", "generator.resblock_0.conv_1.weight",
            "generator.resblock_0.conv_2.weight",
            "generator.resblock_1.conv_1.weight",
            "generator.resblock_1.conv_2.weight"}
    else:
        assert not outs[0]["sharded"]
    assert outs[0]["writes"] == ["latest.pt", "epoch_0.pt", "latest.pt",
                                 "epoch_1.pt"]
    assert outs[1]["writes"] == []
    h = outs[0]["first"]["history"][0]
    assert all(np.isfinite(v) for part in ("train", "val")
               for v in h[part].values())

    one = tmp_path / "one"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # the random-VGG warning
        tr, _ = train(cfg(PLANS[plan], one), synthetic=True,
                      max_steps_per_epoch=2, log=False, device="cpu")
    assert layout(run / "checkpoints" / "latest.pt") == \
        layout(one / "checkpoints" / "latest.pt")
    (e0,) = glob.glob(str(run / "models" / "*" / "epoch_0.pt"))
    (e1,) = glob.glob(str(run / "models" / "*" / "epoch_1.pt"))
    (o0,) = glob.glob(str(one / "models" / "*" / "epoch_0.pt"))
    assert layout(e0) == layout(e1) == layout(o0)
    assert set(restore_params(e1)) == set(tr.nets.state_dict())
    assert not glob.glob(str(run / "**" / "*.tmp"), recursive=True)
    assert sorted(os.listdir(run)) == ["checkpoints", "models"]
