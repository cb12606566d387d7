"""pix2pix's train step in 2 gloo processes (DP 2 x 1, 2 rows each of a
global batch of 4 (the batch of
tests/test_torch_pix2pix.py), U-Net depth 6, image 64) against the JAX trainer's
single-device step and the port's single-process step.  JAX's dropout
masks for the global batch are captured (as tests/test_torch_pix2pix.py's
``jax_masks`` captures them, through one jitted apply) and fed whole: each process takes its rows, as it takes its
rows of a draw.  The BatchNorms' moments are the global batch's.  Bounds
of tests/test_torch_distributed.py."""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import torch

from moonsuperresolution_tpu.models.pix2pix import Pix2PixGenerator as JGen

from moonsuperresolution_tpu_torch.train.trainers import make_trainer
from moonsuperresolution_tpu_torch.utils.convert import (
    export_params,
    flatten_tree,
    load_params,
)
from tests.test_torch_distributed import hold, run_mesh
from tests.test_torch_pix2pix import (
    DEPTH,
    IMG,
    jax_state,
    jax_trainer,
    port_cfg,
)
from tests.test_torch_train import nchw, nest

torch.set_num_threads(2)

BATCH = 4


def jax_masks_jit(gen_params, src, key):
    """``jax_masks`` through one jitted apply: the outputs of the flax
    generator's Dropout layers (``capture_intermediates``), kept where not
    zero, NCHW bool in up-block order."""
    @jax.jit
    def outputs(p, x, k):
        _, state = JGen(depth=DEPTH).apply(
            {"params": p}, x, False, rngs={"dropout": k},
            capture_intermediates=lambda m, _: isinstance(m, fnn.Dropout),
            mutable=["intermediates"])
        return state["intermediates"]

    tree = jax.device_get(outputs(gen_params, jnp.asarray(src), key))
    ups = sorted(k for k in tree if k.startswith("up_"))
    return [torch.from_numpy(np.moveaxis(
        np.asarray(tree[k]["Dropout_0"]["__call__"][0]) != 0, -1, 1).copy())
        for k in ups]


def test_pix2pix_dp_step_matches_jax(tmp_path):
    cfg = dataclasses.replace(port_cfg(), batch_size=BATCH)
    tr = make_trainer(cfg, device="cpu").init(torch.Generator().manual_seed(7))
    gen = torch.Generator().manual_seed(8)
    with torch.no_grad():
        for name, p in tr.nets.named_parameters():
            if name.endswith(("bias", "scale")):
                p.add_(0.1 * torch.randn(p.shape, generator=gen))
    flat = export_params(tr.nets)
    rng = np.random.default_rng(2)
    src = rng.uniform(-0.5, 0.5, (BATCH, IMG, IMG, 2)).astype(np.float32)
    tgt = np.tanh(rng.standard_normal((BATCH, IMG, IMG, 1))
                  ).astype(np.float32)

    jtr = jax_trainer()
    key = jax.random.PRNGKey(9)
    masks = jax_masks_jit(nest(flat)["generator"], src, key)
    assert all(m.shape[0] == BATCH for m in masks)
    new, metrics, _ = jtr.train_step(jax_state(jtr, flat), jnp.asarray(src),
                                     jnp.asarray(tgt), key)
    want = dict(
        weights=flatten_tree(jax.device_get(new.params)),
        metrics={k: float(v) for k, v in metrics.items()},
        grads=flatten_tree(jax.device_get(
            {"generator": new.gen_opt_state[0],
             "discriminator": new.disc_opt_state[0]})))

    single = make_trainer(cfg, device="cpu")
    load_params(single.nets, flat)
    m, _ = single.train_step(nchw(src), nchw(tgt), masks=masks)
    single = ({k: float(v) for k, v in m.items()},
              export_params(single.nets))
    got = run_mesh(tmp_path, cfg, flat, src, tgt, {"masks": masks}, (2, 1))
    metrics, weights, grads, sharded = got
    assert not sharded
    hold(metrics, weights, grads, want, flat, single, cfg.optimizer)
