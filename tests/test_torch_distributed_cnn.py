"""The cnn_spade variant's train step in 2 gloo processes (DP 2 x 1, 4 rows
each of a global batch of 8) against the JAX trainer's single-device step
and the port's single-process step, with the bounds of
tests/test_torch_distributed.py (no latent draw: cnn_spade's latent is
deterministic; no discriminator)."""

import jax
import torch

from moonsuperresolution_tpu_torch.models.vgg import init_vgg
from moonsuperresolution_tpu_torch.train.trainers import make_trainer
from moonsuperresolution_tpu_torch.utils.convert import (
    export_params,
    load_params,
)
from tests.test_torch_distributed import (
    batch,
    hold,
    jax_gaugan_step,
    port_cfg,
    run_mesh,
    start_weights,
)
from tests.test_torch_train import nchw

torch.set_num_threads(2)


def test_cnn_spade_dp_step_matches_jax(tmp_path):
    cfg = port_cfg("cnn_spade")
    flat = start_weights(cfg, seed=4)
    assert not any(k.startswith("discriminator/") for k in flat)
    vgg = init_vgg(torch.Generator().manual_seed(5))
    src, tgt = batch(seed=1)
    want = jax_gaugan_step("cnn_spade", flat, vgg, src, tgt,
                           jax.random.PRNGKey(6))
    tr = make_trainer(cfg, vgg=vgg, device="cpu")
    load_params(tr.nets, flat)
    m, _ = tr.train_step(nchw(src), nchw(tgt))
    single = ({k: float(v) for k, v in m.items()}, export_params(tr.nets))
    metrics, weights, grads, sharded = run_mesh(
        tmp_path, cfg, flat, src, tgt, {}, (2, 1), vgg=vgg)
    assert not sharded and "total_loss" in metrics
    hold(metrics, weights, grads, want, flat, single, cfg.optimizer)
