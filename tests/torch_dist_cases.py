"""Multi-process cases of the port's tests, on the CPU with gloo.

``launch(case, world, workdir)`` starts ``world`` processes of this file,
each running ``CASES[case](rank, workdir, *argv)`` in a process group on a
free local port (the ``cli_train`` case lets the CLI join it), and
returns what each wrote (``workdir/out_<rank>.pt``).  The inputs are
``workdir/in.pt``.  The workers import torch and the port, never JAX; each
join has a timeout.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(case: str, world: int, workdir, timeout: float = 90.0,
           argv=()) -> list:
    """Runs the case in ``world`` processes; returns their outputs (None
    for a process that wrote none).  A process that fails or outlives
    ``timeout`` fails the call, with every process's output."""
    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), case, str(rank),
         str(world), str(port), str(workdir), *argv],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for rank in range(world)]
    logs, failed = [], False
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, _ = p.communicate()
            failed = True
        logs.append(out)
        failed |= p.returncode != 0
    if failed:
        raise AssertionError(f"{case}: a worker failed:\n" + "\n".join(
            f"--- rank {r} (rc {p.returncode}) ---\n{log[-4000:]}"
            for r, (p, log) in enumerate(zip(procs, logs))))
    outs = []
    for rank in range(world):
        path = os.path.join(workdir, f"out_{rank}.pt")
        outs.append(torch.load(path, weights_only=False)
                    if os.path.exists(path) else None)
    return outs


# ------------------------------------------------------------------ cases


def _inputs(workdir):
    return torch.load(os.path.join(workdir, "in.pt"), weights_only=False)


def _save(workdir, rank, obj):
    torch.save(obj, os.path.join(workdir, f"out_{rank}.pt"))


def train_step(rank, workdir):
    """One trainer step on a mesh: the inputs' ``cfg``, ``weights`` (a
    whole state dict), ``vgg``, global ``src``/``tgt`` and the step's
    global draws (``eps_d``/``eps_g`` or ``masks``); writes the metrics,
    the whole updated weights and the whole (averaged) gradients."""
    from moonsuperresolution_tpu_torch.parallel.collectives import (
        gather_whole,
    )
    from moonsuperresolution_tpu_torch.parallel.mesh import (
        make_mesh,
        shard_batch,
        shard_state_for_dp_tp,
        whole_state,
    )
    from moonsuperresolution_tpu_torch.train.trainers import make_trainer

    a = _inputs(workdir)
    mesh = make_mesh(a["mesh"], device="cpu")
    cfg = a["cfg"]
    kw = {} if cfg.model.variant == "pix2pix" else {"vgg": a["vgg"]}
    tr = make_trainer(cfg, device="cpu", **kw)
    tr.nets.load_state_dict(a["weights"])
    shard_state_for_dp_tp(tr, mesh, min_dim=a["min_dim"])
    src, tgt = shard_batch((a["src"], a["tgt"]), mesh)
    metrics, fake = tr.train_step(src, tgt, **a["draws"])
    grads = {}
    for name, p in tr.nets.named_parameters():
        g = p.grad
        if name in tr.sharded:
            g = gather_whole(g, mesh.model, tr.sharded[name])
        grads[name] = g
    state = whole_state(tr)
    out = {"metrics": {k: float(v) for k, v in metrics.items()},
           "fake": fake}
    if rank == 0:
        out.update(weights=state["nets"], grads=grads,
                   sharded=dict(tr.sharded))
    _save(workdir, rank, out)


def _count_writes():
    """Counts the checkpoint files this process writes."""
    from moonsuperresolution_tpu_torch.utils import checkpoint

    writes, real = [], checkpoint._save

    def counting(obj, path):
        writes.append(os.path.basename(path))
        real(obj, path)

    checkpoint._save = counting
    return writes


def loop(rank, workdir):
    """``train`` on the inputs' ``mesh`` (synthetic, 2 steps an epoch) for
    ``cfg.epochs``, then resumed for one epoch more; writes each run's step
    and history, the sharded parameters and the files this process
    wrote."""
    import dataclasses
    import warnings

    from moonsuperresolution_tpu_torch.parallel.mesh import make_mesh
    from moonsuperresolution_tpu_torch.train.loop import train

    a = _inputs(workdir)
    writes = _count_writes()
    out = {}
    cfg = a["cfg"]
    for key, resume in (("first", False), ("resumed", True)):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")     # the random-VGG warning
            tr, history = train(cfg, resume=resume, synthetic=True,
                                max_steps_per_epoch=2, log=False,
                                device="cpu",
                                mesh=make_mesh(a["mesh"], device="cpu"))
        out[key] = {"step": tr.step, "history": history}
        cfg = dataclasses.replace(cfg, epochs=cfg.epochs + 1)
    out.update(sharded=dict(tr.sharded), writes=writes)
    _save(workdir, rank, out)


def cli_train(rank, workdir, *argv):
    """The training CLI in this process of the run (``argv`` and the
    process group's flags); writes its step, history and the files this
    process wrote."""
    from moonsuperresolution_tpu_torch.cli import train as cli

    writes = _count_writes()
    tr, history = cli.run(list(argv))
    _save(workdir, rank, {"step": tr.step, "history": history,
                          "writes": writes, "device": str(tr.device)})


def moments(rank, workdir):
    """SPADE and BatchNorm normalisation of this process's rows, with the
    moments over the data axis: outputs and the input's gradient of
    ``sum(out * w)`` for the inputs' ``x`` and ``w`` (global)."""
    from moonsuperresolution_tpu_torch.models.layers import spade_normalize
    from moonsuperresolution_tpu_torch.models.pix2pix import BatchStatNorm
    from moonsuperresolution_tpu_torch.parallel.mesh import make_mesh

    a = _inputs(workdir)
    mesh = make_mesh(device="cpu")
    sl = mesh.data.part(a["x"].shape[0])
    out = {}
    bn = BatchStatNorm(a["x"].shape[1])
    bn.data_axis = mesh.data
    for name, fn in (("spade", lambda x: spade_normalize(
            x, "batch", torch.float32, mesh.data)), ("bn", bn)):
        x = a["x"][sl].clone().requires_grad_(True)
        y = fn(x)
        (y * a["w"][sl]).sum().backward()
        out[name] = (y.detach(), x.grad)
    _save(workdir, rank, out)


CASES = {"train_step": train_step, "loop": loop, "cli_train": cli_train,
         "moments": moments}


def main(argv):
    case, rank, world, port, workdir, *rest = argv
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    if case == "cli_train":     # the CLI joins the group itself
        rest = list(rest) + ["--distributed",
                             "--coordinator", f"localhost:{port}",
                             "--num_processes", str(world),
                             "--process_id", str(rank)]
    else:
        from moonsuperresolution_tpu_torch.parallel.distributed import (
            initialize,
        )

        initialize(f"localhost:{port}", world, rank, device="cpu")
    try:
        CASES[case](rank, workdir, *rest)
    finally:
        from moonsuperresolution_tpu_torch.parallel.distributed import (
            shutdown,
        )

        shutdown()


if __name__ == "__main__":
    main(sys.argv[1:])
