"""The training loop: epochs, validation, TensorBoard, checkpoint and resume
(counterpart of moonsuperresolution_tpu/train/loop.py; reference:
train_spade_256.py:70-114 and its five siblings).

The cadence is the JAX loop's.  From the HDF5 tile store (``cfg.data``):
per epoch the whole shuffled training set in augmented batches, then the
whole validation set, whatever ``max_steps_per_epoch`` says (it sets only
the logging interval and the epoch a resume starts from; by default it is
the number of whole global batches in the training set).  On synthetic
terrain: ``steps`` training batches and ``steps // 10`` (at least one)
validation batches.  Validation uses a fixed per-epoch draw (GauGAN's
latent, pix2pix's dropout masks); every ``checkpoint_every_epochs`` the
loop writes the whole state (``checkpoints/latest.pt``, for resume) and
the weights of every network (``models/<run>/epoch_<e>.pt``;
``infer.engine.load_model_fn`` serves a GauGAN-family one).  Batches are
made as NHWC numpy on the host by a prefetch thread and go to the card as
pinned NCHW tensors.

One difference from the JAX loop: a training set with fewer samples than
one batch raises a ValueError before training starts (the JAX loop fails
with an IndexError after its empty epoch).

TensorBoard tags follow the reference (train/ and test/ writers, a scalar
per loss, GT / pred / input_hmap / input_image panels in ``jet``).  As in
the JAX loop, ``norm_loss`` is the surface-normal loss and ``grad_loss``
the image-gradient loss; the reference logs them under each other's name
(model.py:84-85).
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from moonsuperresolution_tpu_torch.config import TrainConfig
from moonsuperresolution_tpu_torch.data.sampler import (
    BatchPrefetcher,
    SyntheticSampler,
    TileSampler,
    augment_batch,
)
from moonsuperresolution_tpu_torch.device import resolve_device
from moonsuperresolution_tpu_torch.train.trainers import make_trainer
from moonsuperresolution_tpu_torch.utils.checkpoint import (
    restore_checkpoint,
    save_checkpoint,
    save_params,
)
from moonsuperresolution_tpu_torch.utils.colorize import colorize

SYNTHETIC_STEPS = 8     # steps per epoch of a synthetic run (as in JAX)


class TBLogger:
    """A tensorboardX writer, or nothing when ``log_dir`` is None.
    tensorboardX is imported only here, when logging is asked for."""

    def __init__(self, log_dir: Optional[str]):
        self.writer = None
        if log_dir:
            try:
                from tensorboardX import SummaryWriter
            except ImportError as e:
                raise RuntimeError("logging needs tensorboardX; pass "
                                   "log=False (--no_log) to train without "
                                   "it") from e
            self.writer = SummaryWriter(log_dir)

    def scalars(self, metrics: dict, step: int):
        if self.writer:
            for k, v in metrics.items():
                self.writer.add_scalar(k, float(v), step)

    def images(self, x, y_true, y_pred, step: int, max_outputs: int = 3):
        """The reference's four panels (train_spade_256.py:80-90), from NHWC
        numpy batches."""
        if not self.writer:
            return
        for i in range(min(max_outputs, x.shape[0])):
            for tag, img in (("GT", colorize(y_true[i])),
                             ("pred", colorize(y_pred[i])),
                             ("input_hmap", colorize(x[i][..., 1])),
                             ("input_image",
                              np.clip(x[i][..., :1] + 0.5, 0, 1))):
                self.writer.add_image(f"{tag}/{i}", img, step,
                                      dataformats="HWC")

    def flush(self):
        if self.writer:
            self.writer.flush()

    def close(self):
        if self.writer:
            self.writer.close()


def _mean_metrics(acc: list[dict]) -> dict:
    return {k: float(np.mean([float(m[k]) for m in acc])) for k in acc[0]}


def to_device(a: np.ndarray, dev) -> torch.Tensor:
    """NHWC numpy -> NCHW float32 on ``dev``, through pinned memory."""
    t = torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))
    if torch.device(dev).type != "cuda":
        return t
    return t.pin_memory().to(dev, non_blocking=True)


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).float().cpu().numpy()


def train(cfg: TrainConfig, resume: bool = False, synthetic: bool = False,
          max_steps_per_epoch: Optional[int] = None, log: bool = True,
          device=None):
    """Runs the recipe; returns (trainer, history), one history entry (mean
    train and validation metrics, seconds) per epoch."""
    dev = resolve_device(device)
    trn, val = _samplers(cfg, synthetic)
    run_name = time.strftime("%Y%m%d-%H%M%S")
    out = cfg.output_path
    model_dir = os.path.join(out, "models", run_name)
    latest = os.path.join(out, "checkpoints", "latest.pt")
    tb_train = TBLogger(os.path.join(out, "tensorboard", run_name, "train")
                        if log else None)
    tb_val = TBLogger(os.path.join(out, "tensorboard", run_name, "test")
                      if log else None)

    trainer = make_trainer(cfg, device=dev)
    trainer.init(torch.Generator(dev).manual_seed(cfg.seed))
    # The latent draws of the training steps; its state is checkpointed.
    gen = torch.Generator(dev).manual_seed(cfg.seed + 1)
    resumed = resume and os.path.isfile(latest)
    if resumed:
        restore_checkpoint(latest, trainer, gen)

    bs = cfg.batch_size
    steps = max_steps_per_epoch or _steps_per_epoch(cfg, synthetic, trn)
    start_epoch = trainer.step // steps if resumed else 0
    if resumed:
        print(f"resumed from step {trainer.step} (epoch {start_epoch})")
    log_every = max(1, int(steps * cfg.log_every_frac))
    aug_rng = np.random.default_rng(cfg.seed)
    history = []

    for epoch in range(start_epoch, cfg.epochs):
        t0 = time.time()
        train_acc = []
        for step, (x, y) in enumerate(
                BatchPrefetcher(_epoch_batches(trn, bs, steps, synthetic),
                                depth=4)):
            x, y = augment_batch(x, y, aug_rng)
            metrics, fake = trainer.train_step(
                to_device(x, dev), to_device(y, dev), generator=gen)
            train_acc.append(metrics)
            if step % log_every == 0:
                m = {k: float(v) for k, v in metrics.items()}
                print(f"epoch {epoch + 1} step {step}/{steps} "
                      + " ".join(f"{k}={v:.4f}" for k, v in m.items()),
                      flush=True)
                tb_train.scalars(m, trainer.step)
                tb_train.images(x, y, nhwc(fake), trainer.step)
                tb_train.flush()

        # Validation with a fixed draw per epoch.
        val_gen = torch.Generator(dev).manual_seed(
            cfg.seed * 2**32 + 2**31 + epoch)
        val_acc = []
        val_it = _epoch_batches(val, bs, max(1, steps // 10), synthetic)
        for vx, vy in BatchPrefetcher(val_it, depth=2):
            vm, vf = trainer.val_step(to_device(vx, dev), to_device(vy, dev),
                                      generator=val_gen)
            val_acc.append(vm)
        if val_acc:     # a validation set smaller than a batch has none
            vmean = _mean_metrics(val_acc)
            print(f"epoch {epoch + 1} VAL "
                  + " ".join(f"{k}={v:.4f}" for k, v in vmean.items()),
                  flush=True)
            tb_val.scalars(vmean, trainer.step)
            tb_val.images(vx, vy, nhwc(vf), trainer.step, max_outputs=9)
            tb_val.flush()
            history.append({"epoch": epoch, "train": _mean_metrics(train_acc),
                            "val": vmean, "seconds": time.time() - t0})

        if (epoch + 1) % cfg.checkpoint_every_epochs == 0:
            save_checkpoint(latest, trainer, gen)
            save_params(os.path.join(model_dir, f"epoch_{epoch}.pt"),
                        trainer.nets)
    tb_train.close()
    tb_val.close()
    if not synthetic:
        trn.close()
        val.close()
    return trainer, history


def _samplers(cfg: TrainConfig, synthetic: bool):
    """The training and validation samplers, seeded ``cfg.seed`` and
    ``cfg.seed + 1``."""
    size = cfg.model.image_size
    if synthetic:
        return (SyntheticSampler(hw=size, seed=cfg.seed),
                SyntheticSampler(hw=size, seed=cfg.seed + 1))
    d = cfg.data
    if not (d.h5_path and d.train_pkl and d.val_pkl):
        raise ValueError("training from the HDF5 tile store needs "
                         "cfg.data's h5_path, train_pkl and val_pkl "
                         "(--path_h5, --path_trn, --path_val), or "
                         "synthetic=True (--synthetic)")
    kw = dict(hw=size, upscaling=cfg.model.upscaling_factor)
    trn = TileSampler(d.h5_path, d.train_pkl, seed=cfg.seed, **kw)
    if trn.num_samples < cfg.batch_size:
        trn.close()
        raise ValueError(f"{d.train_pkl} holds {trn.num_samples} training "
                         f"samples, fewer than one batch of "
                         f"{cfg.batch_size}")
    return trn, TileSampler(d.h5_path, d.val_pkl, seed=cfg.seed + 1, **kw)


def _steps_per_epoch(cfg: TrainConfig, synthetic: bool, sampler) -> int:
    """Synthetic: ``SYNTHETIC_STEPS``.  From the store: the whole global
    batches in the global sample count, floored to the shortest process's
    share (JAX loop.py:257-267)."""
    if synthetic:
        return SYNTHETIC_STEPS
    pc = sampler.process_count
    return max(1, sampler.global_num_samples // pc // (cfg.batch_size // pc))


def _epoch_batches(sampler, bs: int, steps: int, synthetic: bool):
    """One epoch's batches: ``steps`` of synthetic terrain, or the whole
    shuffled set from the store (``steps`` does not bound it)."""
    if synthetic:
        return sampler.batches(bs, steps)
    return sampler.batches(bs, shuffle=True)
