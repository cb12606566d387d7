#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (moonsuperresolution_tpu_torch) on one
NVIDIA card: the quickest proof that the port builds, starts and is right.

    python3 chip_smoke.py [--seed 0]

Run from the repository root on a machine with a card and the CUDA toolkit.
Without a card, or without the repository around it, it exits non-zero and
prints no result.  Phases; any failure exits non-zero:

  1. The card's name and power limit (nvidia-smi), then every kernel of
     csrc/ built from source, one nvcc per source, all started together.
     What ptxas says of the int8 conv (registers, spills, warnings) and its
     shared memory are printed and kept; a spill store or a warning fails.
  2. Each kernel against its plain PyTorch version at the main path's
     shapes: agreement, kernel time, plain time and the card's bound.  The
     int8 conv (csrc/qconv.cu: wgmma s8 tensor cores fed by a TMA ring from
     a producer warp, on a persistent grid) at every distinct shape of the
     int8 generator's 30 launches per chunk (batch 16, full width) and one
     small width, in each epilogue mode (int32 sum, sum rounded to bf16, s8
     requantize), equal to its plain version bit for bit; each row keeps
     its time, its bound and its share of the bound; the yardstick is the
     bf16 cuDNN conv of the same shape, which the port never calls.
  3. The main path: full-width GauGAN in bf16 (seeded random weights)
     through ``pad_inputs``, ``generate_tile_list``, ``run_tiles_serial`` and
     the commits over a synthetic raster of two production tiles (image
     512, stride 64, tile 1024, batch 16) with nodata in it.  Every
     launch counter is set to 0 just before and read just after; a kernel
     of the path that never launched fails the run.  Then an interior tile
     (every patch valid) is timed, and profiled once: device time by kind
     of kernel and the card's idle share.
     b. The same for the int8 generator quantized from the same weights
        (``quantize_model``), ``int8`` and ``int8_static`` (which calibrates
        once, on real patches of the first tile): the tile loop's coverage
        equals the bf16 loop's, 30 qconv launches per chunk (1,020 per
        interior tile), and on 16 valid patches the int8 output is within a
        relative RMSE of 0.03 of the bf16 model's (the JAX engine's bound,
        tests/test_quant.py:153).
  4. The output checked: the main path's maps finite where covered and
     no_value elsewhere; the identity model over the same raster gives the
     DEM back where covered; a small float32 model's tile on the card
     agrees with the same tile on the CPU; a small float32 int8_static
     generator's quantize, calibration and static forward on the card
     agree with the same on the CPU.
  5. Full map, through the port's CLIs (``run(argv)`` in this process) on
     a synthetic 2048 x 3072 GeoTIFF pair (6 production tiles) with small
     fillable holes, a large hole and a nodata band:
     a. phase 3's seeded bf16 GauGAN, exported with ``export_params``,
        over the whole map in RAM: georeferencing kept, mean and std finite
        where covered and no_value elsewhere, std >= 0, no nodata pixel
        covered, the small holes filled and covered; preprocess, tile and
        save times and peak device memory;
     b. the identity model in RAM against ``--streaming``: identical
        GeoTIFF files;
     c. the identity model in 2 shards merged by the merge CLI, in RAM and
        streaming, against the whole runs of b: identical GeoTIFF files;
     d. the preprocessing's area /4 and cubic-up resizes of the map's DEM
        on the card against the CPU: equal bit for bit;
     e. the same weights with ``--quantize int8_static --streaming``: the
        checks of a, calibrated once, the coverage of a.
     Each map run is driven with the launch counters set to 0 and read
     after; every kernel of its path must have launched.

  6. Training (no kernel of csrc/ runs on this path; the launch counts
     of the timed steps must stay 0):
     a. spade_256 at full width (GauGAN, image 256, batch 16, default
        widths, float32 parameters) on the port's SyntheticSampler, in
        float32 compute (TF32 off) and in bf16: 2 warm-up steps, 5 timed
        to a host readback of the losses; ms/step, samples/s, peak memory,
        model TFLOP/s (FlopCounterMode over one step), one step profiled
        (device ms by kind, idle share); every loss finite and the
        encoder, generator and discriminator all moved;
     b. ``train`` (loop, validation, checkpoint) at a small width, the
        checkpoint restored bit for bit, then ``resume=True``: step 2 -> 4;
     c. one step of a small float32 gaugan trainer, card against CPU from
        the same weights, batch and latent noise (see train_card_vs_cpu).
  7. The real-data path, without h5py or OpenCV (it fails if either was
     imported):
     a. two tile stores written by the port's HDF5 writer and read back
        equal byte for byte: ``build_h5_dataset`` from a synthetic region
        pair (float32 DEM ``.img``, float32 ortho ``.npy`` shrunk onto the
        DEM grid by INTER_AREA at 0.845), 8 tiles; and ``tile_pair`` of a
        3000 x 8500 pair, 80 tiles of 1000 px, with this script's pickles:
        64 to train on, 16 to validate;
     b. ``TileSampler`` at hw 256 on the host: samples/s called directly
        and through ``BatchPrefetcher``;
     c. ``train(synthetic=False)``: spade_256 at full width in bf16 from the
        store, one epoch (4 steps, one validation batch); ms per step over
        steps 2-4 and the card's idle share there (profiled), beside phase
        6a's bf16 step on batches already on the card; every loss finite,
        every network moved, no kernel launched;
     d. the epoch's ``epoch_0.pt`` served at image 256 (stride 32, tile
        1024, batch 16): by ``load_model_fn`` and ``DEMSuperResolution``
        over a synthetic raster of 2 tiles, and by the map CLI over phase
        5's map; maps finite where covered and no_value elsewhere, the patch
        kernel launched in each (counters set to 0 before, read after);
     e. ``compare_maps`` of the served mean map against itself (rmse 0)
        and against a copy 1 m higher (bias -1 within 1e-6).

  8. pix2pix and the Keras import (no kernel of csrc/ runs in 8a-8c):
     a. the pix2pix recipe at full width (U-Net depth 8, image 256, batch
        64, Adam 2e-4 with beta1 0.5, float32, TF32 off) on the port's
        SyntheticSampler, timed as 6a (0 launches of either kernel); the
        output [64, 1, 256, 256] and the PatchGAN's logits [64, 1, 30, 30];
     b. pix2pix through ``train`` at depth 6 / image 64 as 6b: restored bit
        for bit, ``epoch_0.pt`` holding the generator and discriminator,
        resumed from step 2 to 4;
     c. one step of that small pix2pix, card against CPU from the same
        weights, batch and dropout masks, held as 6c;
     d. full-width GauGAN weights in the Keras order and naming of the
        reference's SavedModels (from ``--seed``) through the port's
        importer and ``save_npz``, served by the map CLI in bf16 over
        phase 5's map with the patch kernel counted; the same tree through
        ``load_params`` and the engine gives the same mean map bit for
        bit; a stream with two same-shape convs swapped is refused.

  9. The multi-device layer on the one card (parallel/):
     a. a process group of one on NCCL (local TCP store) and
        ``make_mesh((1, 1))``: full-width spade_256 in bf16, batch 16,
        through the data-parallel code (moment all-reduces, gradient and
        metric averages), equal to the same step without a group within
        6c's bounds; its ms per step beside the group-free trainer's;
     b. gloo on CUDA tensors probed by two processes, then the training
        CLI (``--distributed --backend gloo``) in two processes sharing
        the card, full-width spade_256 bf16 on synthetic terrain: on a DP
        mesh 2,1 (8 rows each) and a TP mesh 1,2 (the 1024-wide blocks
        sharded); each first step held to the one-process step on the
        same global batch at rtol 2e-3 / atol 1e-4, later steps timed;
     c. the map CLI in two processes (one tile-list shard each) over
        phase 5's map with phase 5a's weights, merged by the merge CLI:
        equal to 5a's map bit for bit, or within rtol 1e-3 (said which);
        each worker's patch-kernel launches (at least the 6 tiles);
     d. ``DEMSuperResolution(mesh=make_mesh((2, 1), devices=[cuda:0,
        cuda:0]))`` over phase 3's raster, bf16 and int8_static: the maps
        of the serial loop bit for bit, both kernels counted;
     e. the tile loop's and the train loop's ``profile_dir`` traces, the
        tile's naming the patch kernel.
     The workers of b and c are this script (``--worker``), each a
     subprocess with a time limit.

Before it exits, the script (and each worker) stops and reaps every
process it started that still runs: the fill's fork server and resource
tracker, and anything a worker left behind (the script is their subreaper).
A process it cannot stop fails the run.

The line before the last is the kernels' JSON record (launches summed over
phase 3's tile loops, every map run, phase 7d, phase 8d, and phase 9c's
and 9d's); the last line is ``{"ok": true, "device": {...}}``.  ``--out
FILE`` also writes the whole record (every qconv shape's row) to FILE.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import copy
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12          # float32 outside the tensor cores
H100_BF16_FLOPS = 989e12        # dense bf16 tensor cores
H100_INT8_OPS = 1979e12         # dense int8 tensor cores

NO_VALUE = -32768.0
PROD = dict(image_size=512, stride=64, tile_size=1024, batch_size=16,
            no_value=NO_VALUE, compute_dtype="bfloat16")
N_TILES = 2


class PhaseError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def cuda_ms(fn, reps=20, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# --------------------------------------------------------- child processes


def adopt_orphans():
    """Make this process the subreaper of everything it starts (Linux
    ``PR_SET_CHILD_SUBREAPER``): a process whose parent ends first, such as
    a worker's fork server, is then re-parented here, so that
    ``stop_children`` still finds it."""
    import ctypes

    libc = ctypes.CDLL(None, use_errno=True)
    check(libc.prctl(36, 1, 0, 0, 0) == 0,  # 36: PR_SET_CHILD_SUBREAPER
          f"prctl(PR_SET_CHILD_SUBREAPER) failed: errno {ctypes.get_errno()}")


def descendants():
    """(pid, state, command name) of every process below this one, from
    /proc, parents before children."""
    children = {}
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as f:
                stat = f.read()
        except OSError:  # ended meanwhile
            continue
        state, ppid = stat[stat.rindex(")") + 2:].split()[:2]
        comm = stat[stat.index("(") + 1 : stat.rindex(")")]
        children.setdefault(int(ppid), []).append((int(name), state, comm))
    out, todo = [], [os.getpid()]
    while todo:
        for child in children.get(todo.pop(0), []):
            out.append(child)
            todo.append(child[0])
    return out


def stop_children(grace=5.0):
    """Stop and reap every process this one started that still runs, and
    print what it stopped.  The fill's process pools leave
    multiprocessing's fork server and resource tracker behind; each lives
    until its parent ends, so both are stopped through their own shutdown
    (the server first: it holds the tracker's pipe).  Anything else gets
    SIGTERM, and SIGKILL after ``grace`` seconds."""
    import multiprocessing.forkserver as forkserver
    import multiprocessing.resource_tracker as resource_tracker
    import signal

    def live():
        return [(pid, comm) for pid, state, comm in descendants()
                if state != "Z"]

    def signal_all(procs, sig, name):
        for pid, comm in procs:
            stopped.append(f"{comm} {pid} ({name})")
            try:
                os.kill(pid, sig)
            except ProcessLookupError:
                pass

    def wait_for(procs, seconds):
        end = time.monotonic() + seconds
        while procs and time.monotonic() < end:
            time.sleep(0.05)
            now = {pid for pid, _ in live()}
            procs = [p for p in procs if p[0] in now]
        return procs

    stopped = []
    server = forkserver._forkserver
    if server._forkserver_pid is not None:
        stopped.append(f"fork server {server._forkserver_pid}")
        try:
            server._stop()
        except ChildProcessError:  # already reaped
            pass
    tracker = resource_tracker._resource_tracker
    others = [p for p in live() if p[0] != tracker._pid]
    signal_all(others, signal.SIGTERM, "SIGTERM")
    signal_all(wait_for(others, grace), signal.SIGKILL, "SIGKILL")
    if tracker._pid is not None:
        stopped.append(f"resource tracker {tracker._pid}")
        try:
            tracker._stop()
        except ChildProcessError:
            pass
    end = time.monotonic() + 2.0
    while True:  # reap what was re-parented here and has ended
        try:
            while os.waitpid(-1, os.WNOHANG)[0]:
                pass
        except ChildProcessError:
            pass
        left = [f"{comm} {pid}" for pid, _, comm in descendants()]
        if not left or time.monotonic() > end:
            break
        time.sleep(0.05)
    print(f"[processes] stopped at the end: {', '.join(stopped) or 'none'}; "
          f"left: {', '.join(left) or 'none'}", file=sys.stderr, flush=True)
    return left


# ----------------------------------------------------------------- phase 1


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def build_all():
    """Every kernel source built, one nvcc each, all started together.
    Returns what ptxas said of the int8 conv when its library was built
    (now, or before in this checkout): per instantiation its
    registers, spills and barriers, any warning (a setmaxnreg that was
    ignored, serialised wgmma), and its dynamic shared memory."""
    import ctypes

    from moonsuperresolution_tpu_torch import build

    names = build.sources()
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        logs = dict(zip(names, pool.map(build.build, names)))
    for name, log in logs.items():
        print(f"[build] {name}: {log.strip()}", file=sys.stderr)
    print(f"[build] {len(names)} kernel sources in "
          f"{time.perf_counter() - t0:.2f} s: {', '.join(names)}")
    ptxas = [line.strip() for line in logs["qconv"].splitlines()
             if any(key in line for key in ("Compiling entry", "registers",
                                            "spill", "smem", "warning"))]
    fn = build.load("qconv").qconv3x3_s8_smem_bytes
    fn.argtypes, fn.restype = [], ctypes.c_int
    ptxas.append(f"dynamic shared memory: {fn()} bytes")
    for line in ptxas:
        print(f"[build] qconv ptxas: {line}")
    spills = [int(n) for line in ptxas
              for n in re.findall(r"(\d+) bytes spill stores", line)]
    check(len(spills) == 3 and not any(spills)
          and not any("warning" in line.lower() for line in ptxas),
          "qconv: ptxas reports spill stores or a warning")
    return ptxas


# ----------------------------------------------------------------- phase 2


def patches_case(dev, seed):
    """The patch-prep kernel at the main path's shape: L = 1920, G = 23,
    P = 512, s = 64, with a nodata hole."""
    import torch

    from moonsuperresolution_tpu_torch.infer.engine import TileGeometry
    from moonsuperresolution_tpu_torch.ops import patches as tp

    g = TileGeometry(512, 64, 1024)
    gen = torch.Generator(dev).manual_seed(seed)
    img = torch.randn((g.slab, g.slab), generator=gen, device=dev) * 30 + 128
    dem = torch.randn((g.slab, g.slab), generator=gen, device=dev) * 50 + 1500
    dem[700:900, 1000:1100] = NO_VALUE
    args = (img, dem, (g.grid, g.grid), g.stride, g.image_size, NO_VALUE)

    got = tp.extract_normalize_patches(*args)
    torch.cuda.synchronize()
    want = tp.extract_normalize_patches_plain(*args)
    check(bool((got[1] == want[1]).all()), "patches: valid differs")
    check(0 < int(want[1].sum()) < g.grid ** 2,
          "patches: the hole should reject some patches, not all")
    err = max(float((a - b).abs().max()) for a, b in
              ((got[0], want[0]), (got[2], want[2]), (got[3], want[3])))
    check(err <= 1e-6, f"patches: max abs error {err} > 1e-6")

    n, p = g.grid ** 2, g.image_size
    moved = 2 * g.slab ** 2 * 4 + n * 2 * p * p * 4 + 3 * n * 4
    ops = 3 * n * 2 * p * p           # subtract, divide, subtract per value
    bytes_ms = moved / H100_BYTES_PER_S * 1e3
    ops_ms = ops / H100_F32_FLOPS * 1e3
    return dict(
        name="extract_normalize_patches", route="cuda",
        source="moonsuperresolution_tpu_torch/csrc/patches.cu",
        replaces="moonsuperresolution_tpu/ops/pallas/patches.py:119",
        wrapper=tp.extract_normalize_patches,
        max_abs_err=err,
        ms=cuda_ms(lambda: tp.extract_normalize_patches(*args)),
        plain_ms=cuda_ms(lambda: tp.extract_normalize_patches_plain(*args)),
        bound_ms=max(bytes_ms, ops_ms),
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        # No single PyTorch call computes grid extraction + min-max
        # normalisation + validity.
        library_ms=None)


FULL_PLAN = (1024, 1024, 1024, 512, 256, 128)
SPADE_HIDDEN = 128
SMALL_QCONV = (2, 12, 16, 24)   # B, S, C, Cout: a ragged K, partial tiles
# mode -> (acc dtype, requantize to s8); the generator's dtype, bf16, is
# the output type otherwise.
QCONV_MODES = {"int32": ("int32", False), "bf16 acc": ("bfloat16", False),
               "bf16 acc, s8 out": ("bfloat16", True)}


def generator_qconvs(plan=FULL_PLAN, size=512, batch=16):
    """The int8 generator's qconv launches in one call, in order: (site, B,
    S, C, Cout).  A block (cin -> ch) runs spade_1's gamma/beta conv (SPADE
    hidden width -> 2 cin), conv_1 (cin -> ch), spade_2's (-> 2 ch), conv_2
    (ch -> ch) and, when cin != ch, spade_3's (-> 2 cin) and conv_3."""
    out, cin = [], plan[0]
    for i, ch in enumerate(plan):
        s = size // 64 * 2 ** i
        sites = [("spade_1.gb", SPADE_HIDDEN, 2 * cin), ("conv_1", cin, ch),
                 ("spade_2.gb", SPADE_HIDDEN, 2 * ch), ("conv_2", ch, ch)]
        if cin != ch:
            sites += [("spade_3.gb", SPADE_HIDDEN, 2 * cin),
                      ("conv_3", cin, ch)]
        out += [(f"r{i}.{name}", batch, s, c, n) for name, c, n in sites]
        cin = ch
    return out


def qconv_bound(b, s, c, n, out_bytes):
    """(bound ms, what bounds it): 2 M N K operations at the int8 peak, or
    the s8 input, the weights, the output and the per-channel vectors once
    each at the memory rate."""
    m, k = b * s * s, 9 * c
    ops_ms = 2 * m * n * k / H100_INT8_OPS * 1e3
    bytes_ms = (m * c + n * k + m * n * out_bytes + 12 * n + 4) \
        / H100_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms \
        else "bytes"


def qconv_case(dev, seed):
    """The int8 conv against its plain version, bit for bit, at every
    distinct shape of the generator's 30 launches per chunk and one small
    width, in each epilogue mode.  Timed per shape and mode: the kernel,
    the bf16 cuDNN conv of the same shape (channels_last; the yardstick,
    never called by the port) and, once per shape in the mode int8_static
    runs it in, the plain version.  The record's numbers are sums over one
    chunk's 30 launches in that mode (the gamma/beta convs requantize to
    s8, the others write bf16; sums rounded to bf16)."""
    import torch
    import torch.nn.functional as F

    from moonsuperresolution_tpu_torch.ops import qconv as qc

    launches = generator_qconvs()
    check(len(launches) == 30, f"{len(launches)} qconv launches per chunk")
    shapes = sorted({site[1:] for site in launches}, key=lambda t: t[1:])
    static_mode = {}  # shape -> the mode int8_static runs it in
    for site, *shape in launches:
        static_mode[tuple(shape)] = ("bf16 acc, s8 out" if site.endswith(".gb")
                                     else "bf16 acc")
    rows, err_max = [], 0.0
    for shape in shapes + [SMALL_QCONV]:
        b, s, c, n = shape
        gen = torch.Generator(dev).manual_seed(seed)
        x = torch.randint(-127, 128, (b, s, s, c), generator=gen, device=dev,
                          dtype=torch.int16).to(torch.int8)
        w = torch.randint(-127, 128, (n, 3, 3, c), generator=gen, device=dev,
                          dtype=torch.int16).to(torch.int8)
        s_x = torch.tensor(0.0123, device=dev)
        # y about N(0, 1): a product of two uniform codes has a std of ~5418.
        w_scale = (torch.rand(n, generator=gen, device=dev) + 0.5) \
            / (0.0123 * 5418 * (9 * c) ** 0.5)
        bias = torch.randn(n, generator=gen, device=dev) * 0.1
        inv = torch.full((n,), 127 / 3, device=dev)   # clips beyond 3 sigma
        xb = x.permute(0, 3, 1, 2).to(torch.bfloat16)       # channels_last
        wb = w.permute(0, 3, 1, 2).to(torch.bfloat16)
        lib_ms = cuda_ms(lambda: F.conv2d(xb, wb, padding=1), reps=10)
        del xb, wb
        for mode, (acc, requant) in QCONV_MODES.items():
            args = (x, w, s_x, w_scale, bias, getattr(torch, acc),
                    torch.bfloat16, inv if requant else None)
            got = qc.qconv(*args)
            torch.cuda.synchronize()
            want = qc.qconv_plain(*args)
            check(got.dtype == want.dtype and got.shape == want.shape
                  and got.is_contiguous(memory_format=torch.channels_last),
                  f"qconv {shape} {mode}: {got.dtype} {tuple(got.shape)}")
            err = float((got.float() - want.float()).abs().max())
            err_max = max(err_max, err)
            check(err == 0, f"qconv {shape} {mode}: max abs err {err}")
            del got, want
            bound, by = qconv_bound(b, s, c, n, 1 if requant else 2)
            ms = cuda_ms(lambda: qc.qconv(*args), reps=10)
            plain = (cuda_ms(lambda: qc.qconv_plain(*args), reps=1, warmup=0)
                     if static_mode.get(shape) == mode else None)
            rows.append(dict(
                shape=f"B{b} S{s} K{9 * c}->N{n}", mode=mode, ms=ms,
                bound_ms=bound, bound_by=by, bound_share=bound / ms,
                tops=2 * b * s * s * n * 9 * c / ms / 1e9, plain_ms=plain,
                library_ms=lib_ms, max_abs_err=err))
            print(f"[qconv] {rows[-1]['shape']:24s} {mode:17s} {ms:9.4f} ms"
                  f" (bound {bound:.4f} {by}, {100 * bound / ms:.1f} % of "
                  f"it, {rows[-1]['tops']:.0f} TOP/s)"
                  f"  bf16 conv {lib_ms:.4f} ms  plain "
                  f"{'-' if plain is None else f'{plain:.2f}'} ms",
                  file=sys.stderr)
        del x, w
        torch.cuda.empty_cache()
    by_key = {(r["shape"], r["mode"]): r for r in rows}
    chunk = [by_key[f"B{b} S{s} K{9 * c}->N{n}", static_mode[(b, s, c, n)]]
             for _, b, s, c, n in launches]
    share = {"operations": 0.0, "bytes": 0.0}   # of the chunk's bound
    for r in chunk:
        share[r["bound_by"]] += r["bound_ms"]
    return dict(
        name="qconv3x3_s8", route="cuda",
        source="moonsuperresolution_tpu_torch/csrc/qconv.cu",
        replaces="moonsuperresolution_tpu/models/quant.py:94",
        wrapper=qc.qconv, max_abs_err=err_max,
        ms=sum(r["ms"] for r in chunk),
        plain_ms=sum(r["plain_ms"] for r in chunk),
        bound_ms=sum(share.values()), bound_by=max(share, key=share.get),
        # bf16 cuDNN conv of the same shapes: no PyTorch call computes an
        # s8 x s8 conv on the card.
        library_ms=sum(r["library_ms"] for r in chunk),
        rows=rows, chunk_top=sum(2 * b * s * s * n * 9 * c
                                 for _, b, s, c, n in launches) / 1e12)


def counted_run(kernels, fn, need, what):
    """``fn()`` with every launch counter set to 0 just before; each
    kernel's launches in it are added to its total, and each kernel named
    in ``need`` must have launched.  Returns (fn's result, launches)."""
    for k in kernels:
        k["wrapper"].launches = 0
    out = fn()
    got = {k["name"]: k["wrapper"].launches for k in kernels}
    for k in kernels:
        k["launches"] += got[k["name"]]
    for name in need:
        check(got[name] > 0, f"{name} never launched in {what}")
    return out, got


PATCHES, QCONV = "extract_normalize_patches", "qconv3x3_s8"


# ----------------------------------------------------------------- phase 3


def terrain(h, w, seed):
    """Smooth terrain with noise and an ortho shading of it, float32."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    dem = (1500 + 300 * np.sin(x / 170) * np.cos(y / 230)
           + 40 * np.sin(x / 37 + y / 53)
           + rng.standard_normal((h, w)) * 2).astype(np.float32)
    gy, gx = np.gradient(dem)
    img = (128 + 60 * np.tanh(gx - gy) + rng.standard_normal((h, w)) * 3
           ).astype(np.float32)
    return img, dem


def synthetic_raster(h, w, seed):
    """``terrain`` with nodata on a band and a hole."""
    img, dem = terrain(h, w, seed)
    dem[:, w - w // 4 :] = NO_VALUE              # a band of nodata
    img[h // 2 : h // 2 + h // 5, w // 8 : w // 8 + h // 5] = NO_VALUE  # a hole
    return img, dem


def run_map(eng, img, dem, profile_dir=None):
    """The tile loop over an in-RAM raster (``run_tiles``: serial, or
    tile-parallel on the engine's mesh); returns the tiles and the maps."""
    eng.img, eng.dem, eng.dem_shape = img.copy(), dem.copy(), dem.shape
    eng.pad_inputs()
    tiles = eng.generate_tile_list()
    maps = (np.full(dem.shape, NO_VALUE, np.float32),
            np.full(dem.shape, NO_VALUE, np.float32),
            np.zeros(dem.shape, np.uint8))

    def commit(px, py, out):
        eng._commit_tile((px, py, out), *maps)

    eng.run_tiles(tiles, commit, profile_dir=profile_dir)
    return tiles, maps


def full_width_model(dev, seed):
    import torch

    from moonsuperresolution_tpu_torch.config import ModelConfig
    from moonsuperresolution_tpu_torch.models.gaugan import GauGAN
    from moonsuperresolution_tpu_torch.models.layers import init_params

    cfg = ModelConfig(variant="gaugan", image_size=512, latent_dim=256,
                      compute_dtype="bfloat16")
    with torch.device(dev):
        model = GauGAN(cfg)
    init_params(model, torch.Generator(dev).manual_seed(seed))
    return model.to(torch.bfloat16).eval()


def flops_per_patch(model, dev, batch):
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    size = PROD["image_size"]
    src = torch.zeros((batch, 2, size, size), dtype=torch.bfloat16,
                      device=dev)
    with torch.inference_mode(), FlopCounterMode(display=False) as fc:
        model(src, generator=torch.Generator(dev).manual_seed(0))
    return fc.get_total_flops() / batch


def valid_slabs(side, seed):
    """Slabs without nodata: every patch of the tile goes to the model, as
    in the interior tiles that make up most of a map."""
    rng = np.random.default_rng(seed)
    return tuple(rng.random((side, side), np.float32) * 50 + base
                 for base in (100.0, 1500.0))


def check_tile_maps(mean, std, good, dem, what):
    """Mean and std finite where covered, no_value elsewhere, std >= 0, no
    nodata DEM pixel covered; returns the coverage mask."""
    cover = good > 0
    check(np.isfinite(mean[cover]).all() and np.isfinite(std[cover]).all(),
          f"{what}: mean/std not finite where covered")
    check((mean[~cover] == NO_VALUE).all() and (std[~cover] == NO_VALUE).all(),
          f"{what}: mean/std not no_value where uncovered")
    check((std[cover] >= 0).all(), f"{what}: negative std")
    check(not cover[dem <= NO_VALUE].any(), f"{what}: nodata DEM pixels covered")
    return cover


def main_path(dev, seed, kernels):
    import torch

    from moonsuperresolution_tpu_torch.config import DSRConfig
    from moonsuperresolution_tpu_torch.infer.engine import DEMSuperResolution

    model = full_width_model(dev, seed)
    batches = []

    def counted(source, generator=None):
        batches.append(source.shape[0])
        return model(source, generator=generator)

    eng = DEMSuperResolution(DSRConfig(seed=seed, **PROD), model=counted,
                             device=dev)
    t = PROD["tile_size"]
    img, dem = synthetic_raster(t, t * N_TILES, seed)

    # Warm-up (cuDNN plans, allocator) on one tile, outside the counts.
    eng.img_padded, eng.dem_padded = valid_slabs(eng.geom.slab, seed)
    eng.process_tile(0, 0)
    torch.cuda.synchronize()

    batches.clear()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    (tiles, (mean, std, good)), _ = counted_run(
        kernels, lambda: run_map(eng, img, dem), [PATCHES],
        "the bf16 tile loop")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)

    check(len(tiles) == N_TILES, f"tile list {tiles}")
    cover = check_tile_maps(mean, std, good, dem, "bf16 tile loop")
    check(0.3 < cover.mean() < 0.9, f"coverage {cover.mean():.3f}")

    n_patches = len(tiles) * eng.geom.grid ** 2
    model_patches = sum(batches)          # valid patches plus batch padding
    fpp = flops_per_patch(model, dev, PROD["batch_size"])
    return eng, model, img, dem, good, dict(
        tiles=len(tiles), patches=n_patches, model_patches=model_patches,
        tiles_s=dt, tile_s=dt / len(tiles), patches_per_s=n_patches / dt,
        peak_mem_gib=peak / 2 ** 30,
        params=sum(p.numel() for p in model.parameters()),
        model_gflop_per_patch=fpp / 1e9,
        model_tflop_per_s=model_patches * fpp / dt / 1e12,
        coverage=float(cover.mean()))


KERNEL_KINDS = (  # (category, substrings of the CUDA kernel's name)
    ("int8 conv (csrc/qconv.cu)", ("qconv3x3",)),
    ("optimizer (Adam)", ("multi_tensor_apply", "adam")),
    # cuDNN's FFT convolutions: fft kernels and the complex products.
    ("conv/gemm", ("conv", "xmma", "gemm", "cudnn", "cutlass", "wgrad",
                   "fft", "_complex")),
    ("fold (col2im)", ("col2im", "im2col")),
    ("patch prep (csrc/patches.cu)", ("patches_block_minmax",
                                      "patches_normalize")),
    ("reductions", ("reduce",)),
    ("copies", ("memcpy", "memset", "copy")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def kernel_kind(name):
    low = name.lower()
    for kind, keys in KERNEL_KINDS:
        if any(k.lower() in low for k in keys):
            return kind
    return "other"


def profile_device(fn, what):
    """``fn()`` once under the profiler: device ms by kind of kernel, the
    wall time to a synchronise, the busy ms and the number of device
    kernels; the top kernels go to stderr."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_kind, busy, n_kernels = device_summary(prof, what)
    return by_kind, wall, busy, n_kernels


def device_summary(prof, what):
    """A finished profile: device ms by kind, busy ms and the number of
    device kernels; the top kernels go to stderr."""
    import torch

    by_kind, rows = {}, []
    for ev in prof.key_averages():
        us = ev.self_device_time_total
        if us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            kind = kernel_kind(ev.key)
            by_kind[kind] = by_kind.get(kind, 0.0) + us / 1e3
            rows.append((us / 1e3, ev.count, kind, ev.key))
    print(f"[profile] {what}, top device kernels (ms, calls, kind):",
          file=sys.stderr)
    for ms, count, kind, key in sorted(rows, reverse=True)[:20]:
        print(f"[profile] {ms:10.3f} {count:6d}  {kind:28s} {key[:110]}",
              file=sys.stderr)
    by_kind = dict(sorted(by_kind.items(), key=lambda kv: -kv[1]))
    return by_kind, sum(by_kind.values()), sum(r[1] for r in rows)


def full_tile(eng, fpp, seed, kernels, reps=3):
    """An interior tile (all 529 patches valid): its time, each kernel's
    launches per tile, and a profile of one more run: device time by kind
    of kernel, and the card's idle share of the tile's wall time."""
    import torch

    eng.img_padded, eng.dem_padded = valid_slabs(eng.geom.slab, seed)
    for k in kernels:
        k["wrapper"].launches = 0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        eng.process_tile(0, 0)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    by_kind, wall, busy, _ = profile_device(
        lambda: eng.process_tile(0, 0), "one interior tile")
    n = eng.geom.grid ** 2
    tile_s = sum(times) / len(times)
    return dict(
        full_tile_launches={k["name"]: k["wrapper"].launches / (reps + 1)
                            for k in kernels},
        full_tile_s=tile_s, full_tile_s_runs=times,
        full_tile_patches_per_s=n / tile_s,
        full_tile_model_tflop_per_s=n * fpp / tile_s / 1e12,
        full_tile_bf16_peak_share=n * fpp / tile_s / H100_BF16_FLOPS,
        profiled_tile_s=wall, device_busy_ms=busy,
        device_idle_share=max(0.0, 1 - busy / 1e3 / wall),
        device_ms_by_kind=by_kind)


def rel_rmse(got, want):
    """RMSE of ``got - want`` over the span of ``want``."""
    d = (got.float() - want.float()).pow(2).mean().sqrt()
    return float(d / (want.max() - want.min()).clamp_min(1e-9))


def int8_paths(dev, seed, model, kernels, img, dem, bf16_good, fpp):
    """Phase 3b: the int8 generator, quantized from phase 3's weights, on
    the main path in each mode.  The tile loop over phase 3's raster (with
    the counters set to 0 just before), an interior tile timed, counted and
    profiled, and 16 valid patches against the bf16 model."""
    import torch

    from moonsuperresolution_tpu_torch.config import DSRConfig
    from moonsuperresolution_tpu_torch.infer.engine import (
        DEMSuperResolution,
        quantize_model,
    )
    from moonsuperresolution_tpu_torch.ops.patches import (
        extract_normalize_patches,
    )

    g = DEMSuperResolution(DSRConfig(**PROD), device=dev).geom
    slabs = [torch.from_numpy(a).to(dev) for a in valid_slabs(g.slab, seed)]
    x = extract_normalize_patches(*slabs, (g.grid, g.grid), g.stride,
                                  g.image_size, NO_VALUE)[0]
    src16 = x[:PROD["batch_size"]].permute(0, 3, 1, 2).to(torch.bfloat16)
    del x, slabs
    with torch.inference_mode():
        ref = model(src16, generator=torch.Generator(dev).manual_seed(seed))

    stats = {}
    for mode in ("int8", "int8_static"):
        t0 = time.perf_counter()
        qmodel = quantize_model(model, mode, device=dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        calls, cal = [], []
        hook = qmodel.register_forward_pre_hook(
            lambda m, a: calls.append(a[0].shape[0]))
        if mode == "int8_static":
            real = qmodel.calibrate_on

            def counting(batch, real=real):
                cal.append(batch.shape[0])
                return real(batch)

            qmodel.calibrate_on = counting
        eng = DEMSuperResolution(DSRConfig(seed=seed, **PROD), model=qmodel,
                                 device=dev)
        eng.img_padded, eng.dem_padded = valid_slabs(eng.geom.slab, seed)
        eng.process_tile(0, 0)          # warm-up, outside the counts
        torch.cuda.synchronize()
        calls.clear()
        t0 = time.perf_counter()
        (tiles, (mean, std, good)), got = counted_run(
            kernels, lambda: run_map(eng, img, dem), [PATCHES, QCONV],
            f"the {mode} tile loop")
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        chunks = len(calls)
        check(len(cal) == (mode == "int8_static") and all(
            1 <= n <= 8 for n in cal), f"{mode}: calibrations {cal}")
        check(got[QCONV] == 30 * (chunks + len(cal)),
              f"{mode}: {got[QCONV]} qconv launches for {chunks} chunks "
              f"and {len(cal)} calibrations")
        # One patch prep per tile, and one for the calibration's patches.
        check(got[PATCHES] == len(tiles) + len(cal),
              f"{mode}: {got[PATCHES]} patch preps for {len(tiles)} tiles "
              f"and {len(cal)} calibrations")
        check_tile_maps(mean, std, good, dem, f"{mode} tile loop")
        check((good == bf16_good).all(),
              f"{mode}: coverage differs from the bf16 tile loop's")

        st = full_tile(eng, fpp, seed, kernels)
        per_tile = st["full_tile_launches"]
        check(per_tile[QCONV] == 30 * -(-g.grid ** 2 // PROD["batch_size"])
              and per_tile[PATCHES] == 1,
              f"{mode}: launches per interior tile {per_tile}")
        with torch.inference_mode():
            out = qmodel(src16,
                         generator=torch.Generator(dev).manual_seed(seed))
        rel = rel_rmse(out, ref)
        check(torch.isfinite(out).all() and rel < 0.03,
              f"{mode}: relative RMSE {rel} against the bf16 model")
        hook.remove()
        stats.update({f"{mode}_{k}": v for k, v in st.items()})
        stats.update({f"{mode}_load_s": load_s, f"{mode}_tiles_s": dt,
                      f"{mode}_chunks": chunks,
                      f"{mode}_calibrations": cal,
                      f"{mode}_tile_loop_launches": got,
                      f"{mode}_rel_rmse_vs_bf16": rel})
        print(f"[{mode}] load {load_s:.3f} s; tile loop {len(tiles)} tiles "
              f"in {dt:.3f} s; interior tile {st['full_tile_s']:.3f} s = "
              f"{st['full_tile_patches_per_s']:.2f} patches/s, card idle "
              f"{100 * st['device_idle_share']:.1f} %, qconv "
              f"{per_tile[QCONV]:.0f} launches per tile; relative RMSE "
              f"against bf16 on 16 patches {rel:.5f}")
        print(f"[{mode}] device ms by kind: " + ", ".join(
            f"{k} {v:.1f}" for k, v in st["device_ms_by_kind"].items()))
        del eng, qmodel
        torch.cuda.empty_cache()
    return stats


# ----------------------------------------------------------------- phase 4


def identity_check(dev, img, dem):
    """The reference's dry run: the identity model returns the low-res DEM,
    so the blended mean is the DEM wherever a valid patch covers it, and
    the spread is rounding noise.  Bound: 32 float32 ulps of the elevation
    (4e-6 relative), for a normalise / denormalise round trip and a
    weighted fold of up to 49 generations."""
    from moonsuperresolution_tpu_torch.config import DSRConfig
    from moonsuperresolution_tpu_torch.infer.engine import DEMSuperResolution

    eng = DEMSuperResolution(DSRConfig(**PROD), model=None, device=dev)
    _, (mean, std, good) = run_map(eng, img, dem)
    cover = good > 0
    check(cover.any(), "identity: nothing covered")
    bound = 4e-6 * np.abs(dem[cover])
    err = np.abs(mean[cover] - dem[cover])
    check((err <= bound).all(),
          f"identity: mean differs from the DEM by up to {err.max()} m")
    check((std[cover] <= bound).all(),
          f"identity: std up to {std[cover].max()} m")
    return dict(identity_max_err_m=float(err.max()),
                identity_max_std_m=float(std[cover].max()))


def small_model_check(dev, seed):
    """One tile of a small float32 cnn_spade (image 64, stride 16, tile 128,
    batch 4) on the card against the same tile on the CPU, TF32 off.
    Bound: rtol 1e-4 / atol 1e-3 m, for convolutions summed in other orders
    on DEMs of +-150 m."""
    import torch

    from moonsuperresolution_tpu_torch.config import DSRConfig, ModelConfig
    from moonsuperresolution_tpu_torch.infer.engine import DEMSuperResolution
    from moonsuperresolution_tpu_torch.models.gaugan import GauGAN
    from moonsuperresolution_tpu_torch.models.layers import init_params

    cfg = ModelConfig(variant="cnn_spade", image_size=64, latent_dim=16,
                      channel_plan=(64, 64, 32, 32, 16, 8), encoder_filters=8)
    cpu_model = init_params(GauGAN(cfg), torch.Generator().manual_seed(seed))
    card_model = GauGAN(cfg).to(dev)
    card_model.load_state_dict(cpu_model.state_dict())
    geom = dict(image_size=64, stride=16, tile_size=128, batch_size=4,
                no_value=NO_VALUE, compute_dtype="float32")
    rng = np.random.default_rng(seed)
    img = (rng.standard_normal((224, 224)) * 30 + 128).astype(np.float32)
    dem = (rng.standard_normal((224, 224)) * 40).astype(np.float32)
    dem[60:140, 60:140] = NO_VALUE
    outs = []
    for model, d in ((cpu_model.eval(), "cpu"), (card_model.eval(), dev)):
        eng = DEMSuperResolution(DSRConfig(**geom), model=model, device=d)
        eng.img_padded, eng.dem_padded = img, dem
        outs.append([a.cpu().numpy() for a in eng.process_tile(0, 0)])
    (m0, s0, g0), (m1, s1, g1) = outs
    check((g0 == g1).all() and 0 < (g0 > 0).mean() < 1,
          "small model: coverage differs")
    err = 0.0
    for a, b in ((m1, m0), (s1, s0)):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-3)
        err = max(err, float(np.abs(a - b).max()))
    return dict(small_model_card_vs_cpu_max_err_m=err)


def small_int8_check(dev, seed):
    """The int8 generator's own code on the card against the CPU: the
    int8_static generator in float32 at a small config (image 64, latent
    16, channel plan 64-64-32-32-16-16; the kernel takes widths that are
    multiples of 16), TF32 off.

    - Weight quantize and the per-tensor activation quantize, same inputs:
      equal bit for bit.  Each is a fixed sequence of IEEE float32
      operations, with its divisors device tensors.
    - Calibration, same inputs: every scale within 2 % of the CPU's.  Its
      forward quantizes with dynamic scales, so a float32 sum taken in
      another order on the card (mask convs, SPADE moments, the Dense)
      flips a code now and then, and a flipped code moves every later
      maximum a little.  A lost margin (5 %) does not pass.
    - The static forward with the CPU's scales on both sides: relative
      RMSE over the output span under 2e-3, the bound that holds the port
      to JAX (a tenth of the quantization error's).  It cannot be as tight
      as the float model's: a code flipped by one float32 ulp moves the
      result by a whole quantization step."""
    import torch

    from moonsuperresolution_tpu_torch.config import ModelConfig
    from moonsuperresolution_tpu_torch.models.gaugan import GauGAN
    from moonsuperresolution_tpu_torch.models.layers import init_params
    from moonsuperresolution_tpu_torch.models.quant import (
        QuantizedSpadeGenerator,
        _quant_act_per_tensor,
    )

    plan, size = (64, 64, 32, 32, 16, 16), 64
    cfg = ModelConfig(variant="cnn_spade", image_size=size, latent_dim=16,
                      channel_plan=plan, encoder_filters=8)
    gen = init_params(GauGAN(cfg),
                      torch.Generator().manual_seed(seed)).generator.eval()
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((4, 16)).astype(np.float32)
    cal, src = (rng.uniform(-0.5, 0.5, (4, 2, size, size)).astype(np.float32)
                for _ in range(2))
    act = (rng.standard_normal((4, 64, 16, 16)) * 3).astype(np.float32)
    q, scales, acts = {}, {}, {}
    for d in ("cpu", dev):
        q[d] = QuantizedSpadeGenerator(
            size, channel_plan=plan, dtype=torch.float32).quantize(
                copy.deepcopy(gen).to(d))
        acts[d] = [t.cpu() for t in
                   _quant_act_per_tensor(torch.from_numpy(act).to(d))]
        scales[d] = {k: v.cpu() for k, v in q[d].calibrate(
            torch.from_numpy(z).to(d), torch.from_numpy(cal).to(d)).items()}
    card = q[dev].state_dict()
    for k, v in q["cpu"].state_dict().items():
        check(torch.equal(card[k].cpu(), v),
              f"small int8: quantized {k} differs, card against CPU")
    check(all(torch.equal(a, b) for a, b in zip(acts["cpu"], acts[dev])),
          "small int8: activation quantize differs, card against CPU")
    check(scales["cpu"].keys() == scales[dev].keys(),
          "small int8: calibrated sites differ, card against CPU")
    scale_err = max(float(((scales[dev][k] - v) / v).abs().max())
                    for k, v in scales["cpu"].items())
    check(scale_err < 0.02, f"small int8: calibrated scales differ by up to "
          f"{scale_err:.4f} relative, card against CPU")
    q[dev].act_scales = {k: v.to(dev) for k, v in scales["cpu"].items()}
    outs = []
    with torch.no_grad():
        for d in ("cpu", dev):
            outs.append(q[d](torch.from_numpy(z).to(d),
                             torch.from_numpy(src).to(d)).cpu())
    want, got = outs
    rel = rel_rmse(got, want)
    check(got.shape == (4, 1, size, size) and bool(torch.isfinite(got).all())
          and rel < 2e-3, f"small int8: static forward differs by a "
          f"relative RMSE of {rel}, card against CPU")
    return dict(small_int8_scale_max_rel_diff=scale_err,
                small_int8_card_vs_cpu_rel_rmse=rel)


# ----------------------------------------------------------------- phase 5

MAP_HW = (2048, 3072)                # 2 x 3 production tiles; both % 4 == 0
MAP_GT = (1_000_000.0, 5.0, 0.0, 2_000_000.0, 0.0, -5.0)
MAP_PROJ = ('PROJCS["Moon2000_Equirectangular",GEOGCS["GCS_Moon_2000",'
            'DATUM["D_Moon_2000",SPHEROID["Moon_2000_IAU_IAG",1737400.0,0.0]]'
            ',PRIMEM["Reference_Meridian",0.0],UNIT["Degree",'
            '0.0174532925199433]],PROJECTION["Equirectangular"],'
            'UNIT["Meter",1.0]]')
# Small holes inside the fill sweeps' interiors (the sweeps leave the
# raster's outer 128 px as they are).  The ortho fill takes blobs under 8 px,
# so its holes are 2 x 2; the DEM's 3 x 3 holes become 1-4 px holes at
# quarter resolution, where the fill takes blobs under 24 px.
ORTHO_HOLES = ((400, 1200), (600, 1800), (1700, 2000))
DEM_HOLES = ((300, 1500), (800, 2000), (1600, 1000))


def synthetic_map(td, seed):
    """Writes run-DRG.tif and run-DEM.tif with the port's writer; returns
    the masks of the nodata that must stay uncovered and of the small holes
    that must be filled."""
    from moonsuperresolution_tpu_torch.geo.tiff import write_geotiff

    h, w = MAP_HW
    img, dem = synthetic_raster(h, w, seed)   # a DEM band and a large hole
    stays = (img <= NO_VALUE) | (dem <= NO_VALUE)
    filled = np.zeros(MAP_HW, bool)
    for (y, x), n, plane in [(c, 2, img) for c in ORTHO_HOLES] + \
            [(c, 3, dem) for c in DEM_HOLES]:
        plane[y : y + n, x : x + n] = NO_VALUE
        filled[y : y + n, x : x + n] = True
    check(not (stays & filled).any(), "small holes overlap the large ones")
    for name, plane in (("run-DRG.tif", img), ("run-DEM.tif", dem)):
        write_geotiff(os.path.join(td, name), plane, MAP_GT, MAP_PROJ,
                      NO_VALUE)
    return stays, filled


def run_cli(kernels, module, argv, what, need=(PATCHES,)):
    """One CLI run through ``counted_run``: returns its result and the
    launches of each kernel in it."""
    return counted_run(kernels, lambda: module.run(argv), need,
                       f"the {what} map run")


def read_triple(path, name):
    from moonsuperresolution_tpu_torch.geo.tiff import read_geotiff

    out = {}
    for k in ("mean", "std", "good"):
        g = read_geotiff(os.path.join(path, f"{name}_{k}.tiff"))
        check(g.geo_transform == MAP_GT and g.projection == MAP_PROJ
              and g.nodata == NO_VALUE,
              f"{name}_{k}.tiff lost its georeferencing")
        out[k] = g.data.squeeze()
    return out


def same_files(a, b, what):
    for k in ("mean", "std", "good"):
        with open(os.path.join(a, f"map_{k}.tiff"), "rb") as fa, \
                open(os.path.join(b, f"map_{k}.tiff"), "rb") as fb:
            check(fa.read() == fb.read(), f"{what}: map_{k}.tiff differs")


def resizes_card_vs_cpu(dev, dem_path):
    """The preprocessing's resizes of the map's DEM on the card against the
    same functions on the CPU: area /4 (also of a crop whose boxes are
    clipped at the far edges), area /4 again, and the cubic up to the full
    raster in the engine's row bands.  Each output element is a fixed
    sequence of IEEE float32 operations, so the two must agree bit for bit,
    NaN masks included.  Returns the largest difference of each."""
    import torch

    from moonsuperresolution_tpu_torch.geo.tiff import read_geotiff
    from moonsuperresolution_tpu_torch.infer.engine import DEMSuperResolution
    from moonsuperresolution_tpu_torch.ops.resize import (
        area_downscale4,
        resize_cubic,
    )

    dem = torch.from_numpy(
        read_geotiff(dem_path).data.squeeze().astype(np.float32))
    dem = torch.where(dem <= NO_VALUE, torch.nan, dem)
    rows = DEMSuperResolution.CUBIC_BAND_ROWS
    outs = []
    for where in ("cpu", dev):
        x = dem.to(where)
        q = area_downscale4(x)
        s16 = area_downscale4(q)
        up = torch.cat([resize_cubic(s16, MAP_HW, a, min(MAP_HW[0], a + rows))
                        for a in range(0, MAP_HW[0], rows)])
        clipped = area_downscale4(x[:2047, :3070])
        outs.append([t.cpu().numpy() for t in (q, clipped, s16, up)])
    errs = {}
    for name, a, b in zip(("area /4", "area /4 clipped", "area /16",
                           "cubic up"), *outs):
        check(a.shape == b.shape
              and np.array_equal(np.isnan(a), np.isnan(b)),
              f"{name}: shape or NaN mask differs, card against CPU")
        ok = ~np.isnan(a)
        errs[name] = float(np.abs(a[ok] - b[ok]).max())
        check(errs[name] == 0, f"{name}: card differs from CPU by "
              f"{errs[name]}")
    return errs


def check_map(m, res, stays, filled, what):
    """A whole map's three planes: shape, coverage, finite mean and std
    where covered and no_value elsewhere, std >= 0, no nodata pixel
    covered, the small holes filled and covered."""
    cover = m["good"] > 0
    check(m["good"].shape == MAP_HW and res["tiles"] == 6,
          f"{what}: map shape {m['good'].shape}, {res['tiles']} tiles")
    check(0.3 < cover.mean() < 0.9, f"{what}: coverage {cover.mean():.3f}")
    check(np.isfinite(m["mean"][cover]).all()
          and np.isfinite(m["std"][cover]).all(),
          f"{what}: mean/std not finite where covered")
    check((m["mean"][~cover] == NO_VALUE).all()
          and (m["std"][~cover] == NO_VALUE).all(),
          f"{what}: mean/std not no_value where uncovered")
    check((m["std"][cover] >= 0).all(), f"{what}: negative std")
    check(not cover[stays].any(), f"{what}: nodata pixels covered")
    check(cover[filled].all(), f"{what}: small holes not filled and covered")
    return cover


def full_map(dev, model, kernels, seed, td):
    """Phase 5 in ``td``, which keeps the map, the weights' ``gaugan.npz``
    and 5a's output (``model/``) for phase 9c."""
    import torch

    from moonsuperresolution_tpu_torch.cli import merge_maps
    from moonsuperresolution_tpu_torch.cli import process_full_tiles as cli
    from moonsuperresolution_tpu_torch.models.gaugan import (
        StaticQuantizedGauGAN,
    )
    from moonsuperresolution_tpu_torch.utils.convert import (
        export_params,
        save_npz,
    )

    stats, launches = {}, {}
    stays, filled = synthetic_map(td, seed + 1)
    geom = ["--source_folder_path", td]
    for key in ("image_size", "stride", "tile_size", "batch_size"):
        geom += [f"--{key}", str(PROD[key])]

    # a. the real model through the real CLI
    npz = os.path.join(td, "gaugan.npz")
    save_npz(npz, export_params(model))
    torch.cuda.reset_peak_memory_stats(dev)
    out = os.path.join(td, "model")
    model_argv = geom + ["--map_name", "map", "--model_path", npz,
                         "--model_kind", "gaugan"]
    res, launches["model in RAM"] = run_cli(
        kernels, cli, model_argv + ["--save_path", out], "bf16 model")
    torch.cuda.synchronize()
    stats.update({f"map_{k}": v for k, v in res.items()})
    stats["map_peak_mem_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    m = read_triple(out, "map")
    cover = check_map(m, res, stays, filled, "bf16 map")
    stats["map_coverage"] = float(cover.mean())

    # e. the same weights, int8_static, streaming: calibrated once
    out_q = os.path.join(td, "int8_static")
    cal, real = [], StaticQuantizedGauGAN.calibrate_on

    def counting(self, batch):
        cal.append(batch.shape[0])
        return real(self, batch)

    StaticQuantizedGauGAN.calibrate_on = counting
    try:
        res, launches["int8_static streaming"] = run_cli(
            kernels, cli, model_argv + [
                "--save_path", out_q, "--quantize", "int8_static",
                "--streaming"], "int8_static streaming", (PATCHES, QCONV))
    finally:
        StaticQuantizedGauGAN.calibrate_on = real
    torch.cuda.synchronize()
    stats.update({f"map_int8_static_{k}": v for k, v in res.items()})
    check(len(cal) == 1 and 1 <= cal[0] <= 8,
          f"int8_static map: calibrations {cal}")
    q = read_triple(out_q, "map")
    check_map(q, res, stays, filled, "int8_static map")
    check((q["good"] == m["good"]).all(),
          "int8_static map: coverage differs from the bf16 map's")
    stats["map_int8_static_mean_abs_diff_vs_bf16_m"] = float(
        np.abs(q["mean"][cover] - m["mean"][cover]).mean())

    # b. identity model, in RAM against streaming: the same files
    ident = geom + ["--map_name", "map"]
    for mode, flags in (("ram", []), ("st", ["--streaming"])):
        _, launches[f"identity {mode}"] = run_cli(
            kernels, cli, ident + ["--save_path",
                                   os.path.join(td, mode)] + flags,
            f"identity {mode}")
    a = read_triple(os.path.join(td, "ram"), "map")
    check((a["good"] > 0).mean() > 0.3, "identity map: little coverage")
    same_files(os.path.join(td, "ram"), os.path.join(td, "st"),
               "streaming against in RAM")

    # c. identity model, 2 shards merged against the whole runs
    for mode, flags in (("ram", []), ("st", ["--streaming"])):
        sh = os.path.join(td, f"{mode}_shards")
        for i in range(2):
            _, launches[f"identity {mode} shard {i}"] = run_cli(
                kernels, cli, ident + ["--save_path", sh,
                                       "--shard_index", str(i),
                                       "--num_shards", "2"] + flags,
                f"identity {mode} shard {i}")
        merge_maps.run(["--save_path", sh, "--map_name", "map",
                        "--num_shards", "2"] + flags)
        same_files(os.path.join(td, mode), sh, f"{mode} shards")

    # d. the resizes of the map's preprocessing, card against CPU
    stats["resize_card_vs_cpu_max_abs_err"] = resizes_card_vs_cpu(
        dev, os.path.join(td, "run-DEM.tif"))
    stats["map_launches"] = launches
    return stats


# ----------------------------------------------------------------- phase 6

# The small trainer of 6b and 6c (image 64, the test plan, widths 16).
TRAIN_SMALL = dict(image_size=64, latent_dim=16,
                   channel_plan=(64, 64, 32, 32, 16, 8), encoder_filters=16,
                   disc_filters=16)
TRAIN_TIMED, TRAIN_WARMUP = 5, 2


def synthetic_batches(size, batch, n, seed, dev):
    """``n`` batches of the port's SyntheticSampler as NCHW tensors."""
    from moonsuperresolution_tpu_torch.data.sampler import SyntheticSampler
    from moonsuperresolution_tpu_torch.train.loop import to_device

    return [(to_device(x, dev), to_device(y, dev)) for x, y in
            SyntheticSampler(hw=size, seed=seed).batches(batch, n)]


def groups_moved(before, after):
    """Which of the trainer's networks (encoder, generator, discriminator)
    changed."""
    groups = {k.split(".")[0] for k in before}
    return {g: any(not bool((after[k] == v).all())
                   for k, v in before.items() if k.startswith(g + "."))
            for g in sorted(groups)}


def train_full_width(dev, seed, kernels, compute_dtype):
    """6a: spade_256 at full width (GauGAN, image 256, batch 16, default
    widths, float32 parameters) in ``compute_dtype``, timed by
    ``timed_training``."""
    import dataclasses

    import torch

    from moonsuperresolution_tpu_torch.config import RECIPES
    from moonsuperresolution_tpu_torch.train.trainers import make_trainer

    cfg = RECIPES["spade_256"]
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, compute_dtype=compute_dtype))
    tr = make_trainer(cfg, device=dev).init(
        torch.Generator(dev).manual_seed(seed))
    batches = synthetic_batches(cfg.model.image_size, cfg.batch_size, 2,
                                seed, dev)
    out = timed_training(dev, seed, kernels, tr, batches, compute_dtype)
    del tr, batches
    torch.cuda.empty_cache()
    return out


def timed_training(dev, seed, kernels, tr, batches, what):
    """A trainer's steps on two batches already on the card: 2 warm-up
    steps, 5 timed steps to a host readback of their losses, model FLOPs of
    one step (``FlopCounterMode``), one step profiled.  Fails unless every
    loss is finite and every network moved; counts launches of the kernels
    (none may launch on the training paths)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    gen = torch.Generator(dev).manual_seed(seed)
    before = {k: v.clone() for k, v in tr.nets.state_dict().items()}

    def step(i):
        return tr.train_step(*batches[i % 2], generator=gen)[0]

    for i in range(TRAIN_WARMUP):
        step(i)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)

    def timed():
        out = [step(i) for i in range(TRAIN_TIMED)]
        return [{k: float(v) for k, v in o.items()} for o in out]

    t0 = time.perf_counter()
    losses, launches = counted_run(kernels, timed, [], "training")
    dt = (time.perf_counter() - t0) / TRAIN_TIMED
    check(not any(launches.values()),
          f"training launched a TPU-kernel port: {launches}")
    peak = torch.cuda.max_memory_allocated(dev)
    check(all(np.isfinite(v) for o in losses for v in o.values()),
          f"{what} training: a loss is not finite: {losses[-1]}")
    moved = groups_moved(before, tr.nets.state_dict())
    check(all(moved.values()), f"{what} training: moved {moved}")
    del before
    with FlopCounterMode(display=False) as fc:
        step(0)
    flops = fc.get_total_flops()
    by_kind, wall, busy, n_kernels = profile_device(
        lambda: step(1), f"one full-width {what} training step")
    params = sum(p.numel() for p in tr.nets.parameters())
    batch = batches[0][0].shape[0]
    return dict(ms_per_step=dt * 1e3, samples_per_s=batch / dt,
                peak_mem_gib=peak / 2 ** 30, params=params,
                tflop_per_step=flops / 1e12,
                model_tflop_per_s=flops / dt / 1e12,
                profiled_step_s=wall, device_busy_ms=busy,
                device_idle_share=max(0.0, 1 - busy / 1e3 / wall),
                device_kernels_per_step=n_kernels,
                device_ms_by_kind=by_kind, last_losses=losses[-1],
                launches=launches)


def train_loop_resume(dev, seed, cfg=None):
    """6b (and 8b with a pix2pix ``cfg``): ``train`` on the card at a small
    width for one epoch of 2 steps, the checkpoint restored into a fresh
    trainer (bit for bit), ``epoch_0.pt`` holding every network, then
    ``resume=True`` for a second epoch: the step goes on from 2 to 4."""
    import dataclasses
    import glob

    import torch

    from moonsuperresolution_tpu_torch.config import ModelConfig, TrainConfig
    from moonsuperresolution_tpu_torch.train.loop import train
    from moonsuperresolution_tpu_torch.train.trainers import make_trainer
    from moonsuperresolution_tpu_torch.utils.checkpoint import (
        restore_checkpoint,
        restore_params,
    )

    if cfg is None:
        cfg = TrainConfig(model=ModelConfig(**TRAIN_SMALL), batch_size=4)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as td:
        cfg = dataclasses.replace(cfg, epochs=1, output_path=td, seed=seed)
        tr, history = train(cfg, synthetic=True, max_steps_per_epoch=2,
                            log=False, device=dev)
        (weights,) = glob.glob(os.path.join(td, "models", "*",
                                            "epoch_0.pt"))
        groups = {k.split(".")[0] for k in restore_params(weights)}
        check(groups == set(tr.nets), f"loop: epoch_0.pt holds {groups}")
        fresh = make_trainer(cfg, device=dev)
        gen = torch.Generator(dev)
        step = restore_checkpoint(os.path.join(td, "checkpoints",
                                               "latest.pt"), fresh, gen)
        check(step == tr.step == 2, f"loop: step {tr.step}, restored {step}")
        saved = tr.nets.state_dict()
        check(all(torch.equal(v, saved[k])
                  for k, v in fresh.nets.state_dict().items()),
              "loop: restored weights differ from the saved ones")
        for opt in ("gen_opt", "disc_opt"):
            a = getattr(tr, opt).state_dict()["state"]
            b = getattr(fresh, opt).state_dict()["state"]
            check(all(torch.equal(v, b[i][k]) for i, st in a.items()
                      for k, v in st.items()),
                  f"loop: restored {opt} state differs")
        tr2, history2 = train(dataclasses.replace(cfg, epochs=2),
                              resume=True, synthetic=True,
                              max_steps_per_epoch=2, log=False, device=dev)
        check(tr2.step == 4 and [h["epoch"] for h in history2] == [1],
              f"resume: step {tr2.step}, epochs {history2}")
        check(all(np.isfinite(v) for h in history + history2
                  for part in ("train", "val") for v in h[part].values()),
              "loop: a loss is not finite")
    return dict(loop_val_gen_loss=history2[0]["val"]["gen_loss"],
                loop_seconds=[h["seconds"] for h in history + history2])


def adam_first_step(g, lr, eps):
    """Adam's first update: m / (1 - beta1) = g and v / (1 - beta2) = g^2
    for any beta1 (0 in the GauGAN recipes, 0.5 in pix2pix's)."""
    return -lr * g / (np.abs(g) + eps)


def normalised_biases(m) -> list[str]:
    """The generator biases whose gradient is zero in exact arithmetic, for
    ModelConfig ``m``: every path from them to a loss passes a SPADE
    normalisation, which removes any per-channel constant.  Each block's
    ``conv_1`` bias (spade_2 normalises its output), the ``conv_2`` and
    ``conv_3`` biases of a block whose output meets a normalisation on every
    path to the head (only identity skips carry a block's output past the
    next block), and the Dense bias where the Dense output is 1 x 1.  Their
    gradients are rounding noise, which Adam (g / (|g| + eps)) turns into
    moves of up to the learning rate in either direction, on the card as on
    the CPU: 6c holds these to lr (1 + 1e-3)."""
    plan = m.channel_plan
    n = len(plan)
    reaches = [True] * n    # block i's output reaches the head unnormalised
    for i in range(n - 2, -1, -1):
        reaches[i] = plan[i + 1] == plan[i] and reaches[i + 1]
    names = []
    for i, ch in enumerate(plan):
        names.append(f"generator.resblock_{i}.conv_1.bias")
        if not reaches[i]:
            names.append(f"generator.resblock_{i}.conv_2.bias")
            if i and ch != plan[i - 1]:
                names.append(f"generator.resblock_{i}.conv_3.bias")
    if m.image_size // 64 == 1 and not reaches[0]:
        names.append("generator.dense.bias")
    return names


def train_card_vs_cpu(dev, seed):
    """6c: one step of a small float32 gaugan trainer (image 64, latent 16,
    plan 64-64-32-32-16-8, encoder and discriminator width 16, batch 4) on
    the card and on the CPU, from the same weights, VGG19, batch and latent
    noise, TF32 off.  Losses to rtol 1e-4.  Parameters: Adam's first step
    is about lr times the sign of the gradient, so an element whose
    gradient lies within float32 noise of zero moves by +lr on one side
    and -lr on the other, and a plain atol 1e-5 cannot hold for every
    element (the count beyond it and the largest difference are reported).
    The bound: the card's update is within 1e-5 of Adam's step of some
    gradient within 1e-4 |g| + 1e-3 max|g| (over its group) of the CPU's
    own gradient; the biases whose gradient vanishes in exact arithmetic
    (``normalised_biases``) move by at most lr.  Batch 4, not 2: at batch 2
    the first SPADE's moments over two 1 x 1 maps amplify float32 noise
    about fifty-fold (tests/test_torch_train.py)."""
    import torch

    from moonsuperresolution_tpu_torch.config import ModelConfig, TrainConfig
    from moonsuperresolution_tpu_torch.models.vgg import init_vgg
    from moonsuperresolution_tpu_torch.train.trainers import make_trainer

    cfg = TrainConfig(model=ModelConfig(variant="gaugan", **TRAIN_SMALL),
                      batch_size=4)
    vgg = init_vgg(torch.Generator().manual_seed(seed))
    cpu = make_trainer(cfg, vgg=vgg, device="cpu").init(
        torch.Generator().manual_seed(seed))
    card = make_trainer(cfg, vgg=vgg, device=dev)
    card.nets.load_state_dict(cpu.nets.state_dict())
    start = {k: v.clone() for k, v in cpu.nets.state_dict().items()}
    ((src, tgt),) = synthetic_batches(64, 4, 1, seed, "cpu")
    gen = torch.Generator().manual_seed(seed)
    eps_d, eps_g = (torch.randn((4, 16), generator=gen) for _ in range(2))
    want, _ = cpu.train_step(src, tgt, eps_d, eps_g)
    got, _ = card.train_step(src.to(dev), tgt.to(dev), eps_d.to(dev),
                             eps_g.to(dev))
    loss_err = max(abs(float(got[k]) - float(v)) / abs(float(v))
                   for k, v in want.items())
    check(loss_err <= 1e-4, f"card vs CPU: losses differ by {loss_err} "
          f"relative ({ {k: float(v) for k, v in got.items()} } against "
          f"{ {k: float(v) for k, v in want.items()} })")

    raw_max, over, n = updates_near_cpu(card, cpu, start, cfg.optimizer,
                                        set(normalised_biases(cfg.model)))
    return dict(train_card_vs_cpu_loss_max_rel_err=loss_err,
                train_card_vs_cpu_param_max_abs_diff=raw_max,
                train_card_vs_cpu_params_over_1e5=over,
                train_card_vs_cpu_params_checked=n)


def updates_near_cpu(card, cpu, start, o, noisy):
    """6c's and 8c's bound on the card's first update: within 1e-5 of Adam's
    step (any beta1) of some gradient within 1e-4 |g| + 1e-3 max|g| (over
    its network) of the CPU trainer's own; the parameters named in
    ``noisy`` move by at most lr.  Returns the largest raw difference, the
    count beyond 1e-5 and the count checked."""
    return updates_near(
        {k: v.cpu() for k, v in card.nets.state_dict().items()},
        {n: (p.detach(), p.grad) for n, p in cpu.nets.named_parameters()},
        start, o, noisy)


def updates_near(card_params, ref, start, o, noisy):
    """``updates_near_cpu`` on CPU tensors: the card side's updated
    parameters, and the reference side's (updated parameter, gradient) by
    name."""
    gmax = {}
    for name, (_, grad) in ref.items():
        if name not in noisy:
            g = name.split(".")[0]
            gmax[g] = max(gmax.get(g, 0.0), float(grad.abs().max()))
    over, n, raw_max = 0, 0, 0.0
    for name, (param, grad) in ref.items():
        g = grad.double().numpy()
        lr = o.disc_lr if name.startswith("discriminator.") else o.gen_lr
        u = (card_params[name].double() - start[name].double()).numpy()
        diff = np.abs(card_params[name].numpy() - param.numpy())
        if name in noisy:
            check(np.abs(u).max() <= lr * (1 + 1e-3),
                  f"card vs CPU: {name} moved by {np.abs(u).max()}")
            continue
        over += int((diff > 1e-5).sum())
        n += diff.size
        raw_max = max(raw_max, float(diff.max()))
        d = 1e-4 * np.abs(g) + 1e-3 * gmax[name.split(".")[0]]
        lo = adam_first_step(g + d, lr, o.eps) - 1e-5
        hi = adam_first_step(g - d, lr, o.eps) + 1e-5
        check(bool(((lo <= u) & (u <= hi)).all()),
              f"card vs CPU: {name}'s update is not Adam's step of a "
              "gradient near the CPU's")
    return raw_max, over, n


# ----------------------------------------------------------------- phase 7

# 7a: one SLDEM-style region cut to 1536 x 2560 px (2 x 4 tiles), its ortho
# at 0.845 of the size, as the 100 m WAC is onto the 256 px/deg grid.
REGION_DEM = (1536, 2560)
REGION_ORT = (1818, 3030)
# 7a-c: the training store, 5 x 16 = 80 tiles of 1000 px: 64 to train on (4
# steps of 16), 16 to validate (one batch).
STORE_HW = (3000, 8500)
STORE_TRAIN = 64
SAMPLER_TIMED = 32
# 7d: the trained model served at its own size, stride image / 8.
SERVE_GEOM = dict(image_size=256, stride=32, tile_size=1024, batch_size=16)


def store_equals(h5_path, tiles, what):
    """Every dataset of the store read back by the port's reader equals
    ``tiles`` (name -> array) byte for byte, and the store has no other."""
    from moonsuperresolution_tpu_torch.data.hdf5 import H5Reader

    with H5Reader(h5_path) as f:
        check(sorted(f) == sorted(tiles), f"{what}: names differ")
        for k, v in tiles.items():
            got = f[k]
            check(got.dtype == v.dtype and got.shape == v.shape
                  and got.tobytes() == v.tobytes(), f"{what}: {k} differs")
    return len(tiles)


def build_stores(td, seed):
    """7a: a store through ``build_h5_dataset`` from a region pair (a
    float32 DEM ``.img`` and a float32 ortho ``.npy``), and the training
    store through ``tile_pair`` with this script's pickles; both written by
    the port's HDF5 writer and read back equal."""
    import pickle

    from moonsuperresolution_tpu_torch.data import h5_builder as hb
    from moonsuperresolution_tpu_torch.data.hdf5 import H5Writer

    key = hb.REGIONS[0]
    rng = np.random.default_rng(seed)
    data = os.path.join(td, "regions")
    os.makedirs(data)
    _, dem = terrain(*REGION_DEM, seed)
    dem.tofile(os.path.join(data, hb.DEM_FILES[key]))
    np.save(os.path.join(data, hb.ORT_FILES[key]),
            (rng.random(REGION_ORT) * 255).astype(np.float32))
    t0 = time.perf_counter()
    h5_path, n_train, n_val = hb.build_h5_dataset(
        data, os.path.join(td, "built"), regions=[key], seed=seed,
        dem_rows=REGION_DEM[0])
    build_s = time.perf_counter() - t0
    want = {}
    hb.tile_pair(*hb.load_pair(data, key, REGION_DEM[0]), key, want, {})
    n_built = store_equals(h5_path, want, "build_h5_dataset's store")
    check(n_train + n_val == n_built // 2 == 8,
          f"build_h5_dataset: {n_train} + {n_val} tiles")

    img, dem = terrain(*STORE_HW, seed + 1)
    ort = np.clip(img, 0, 255).astype(np.uint8)
    store = os.path.join(td, "store")
    os.makedirs(store)
    h5_path, dct, want = os.path.join(store, "MoonORTO2DEM.hdf5"), {}, {}
    t0 = time.perf_counter()
    with H5Writer(h5_path) as h5:
        hb.tile_pair(ort, dem, "R", h5, dct)
    write_s = time.perf_counter() - t0
    hb.tile_pair(ort, dem, "R", want, {})
    n = store_equals(h5_path, want, "tile_pair's store") // 2
    check(n == 80, f"tile_pair: {n} tiles")
    keys = list(dct)
    paths = {}
    for part, ks in (("train", keys[:STORE_TRAIN]),
                     ("val", keys[STORE_TRAIN:])):
        paths[part] = os.path.join(store, f"MoonORTO2DEM_{part}.pkl")
        with open(paths[part], "wb") as f:
            pickle.dump({k: dct[k] for k in ks}, f)
    return (h5_path, paths["train"], paths["val"]), dict(
        store_build_h5_dataset_s=build_s, store_tiles=n,
        store_write_s=write_s,
        store_bytes=os.path.getsize(h5_path))


def sampler_rate(store, seed):
    """7b: ``TileSampler`` at hw 256 on the host: samples/s called on this
    thread, and through ``BatchPrefetcher`` as the loop drives it."""
    import torch

    from moonsuperresolution_tpu_torch.data.sampler import (
        BatchPrefetcher,
        TileSampler,
    )

    s = TileSampler(store[0], store[1], hw=256, seed=seed)
    keys = s.keys[:SAMPLER_TIMED]
    s.sample(keys[0])                                   # warm-up
    t0 = time.perf_counter()
    for k in keys:
        s.sample(k)
    direct = SAMPLER_TIMED / (time.perf_counter() - t0)
    t0 = time.perf_counter()
    n = sum(x.shape[0] for x, _ in BatchPrefetcher(s.batches(16), depth=4))
    prefetched = n / (time.perf_counter() - t0)
    s.close()
    return dict(sampler_samples_per_s=direct,
                sampler_prefetched_samples_per_s=prefetched,
                sampler_torch_threads=torch.get_num_threads())


def train_from_store(dev, seed, kernels, store, td):
    """7c: ``train(synthetic=False)``, spade_256 at full width in bf16 from
    the store, one epoch (4 steps, one validation batch).  Each step's
    start is clocked; the steps after the first are profiled to the first
    validation step (device busy time against the wall: the card's idle
    share, the host sampler's pace included).  Every loss finite, every
    network moved, no kernel of csrc/ launched; returns the epoch's
    weights."""
    import dataclasses
    import glob

    import torch
    from torch.profiler import ProfilerActivity, profile

    from moonsuperresolution_tpu_torch.config import RECIPES, DataConfig
    from moonsuperresolution_tpu_torch.train import loop

    cfg = RECIPES["spade_256"]
    cfg = dataclasses.replace(
        cfg, epochs=1, seed=seed, output_path=os.path.join(td, "run"),
        data=DataConfig(*store),
        model=dataclasses.replace(cfg.model, compute_dtype="bfloat16"))
    clock = dict(starts=[], before=None, prof=None, end=None)
    make_trainer = loop.make_trainer

    def clocked(cfg, device):
        tr = make_trainer(cfg, device=device)
        step, val_step = tr.train_step, tr.val_step

        def train_step(*a, **kw):
            if not clock["starts"]:
                clock["before"] = {k: v.clone()
                                   for k, v in tr.nets.state_dict().items()}
            if len(clock["starts"]) == 1:
                torch.cuda.synchronize()
                clock["prof"] = profile(activities=[ProfilerActivity.CPU,
                                                    ProfilerActivity.CUDA])
                clock["prof"].__enter__()
            clock["starts"].append(time.perf_counter())
            return step(*a, **kw)

        def first_val_step(*a, **kw):
            if clock["end"] is None:
                torch.cuda.synchronize()
                clock["end"] = time.perf_counter()
                clock["prof"].__exit__(None, None, None)
            return val_step(*a, **kw)
        tr.train_step, tr.val_step = train_step, first_val_step
        return tr

    loop.make_trainer = clocked
    try:
        t0 = time.perf_counter()
        (tr, history), launches = counted_run(
            kernels, lambda: loop.train(cfg, synthetic=False, log=False,
                                        device=dev), [], "training")
        epoch_s = time.perf_counter() - t0
    finally:
        loop.make_trainer = make_trainer
    starts = clock["starts"]
    check(tr.step == len(starts) == STORE_TRAIN // cfg.batch_size,
          f"store training: {tr.step} steps, {len(starts)} clocked")
    check(not any(launches.values()),
          f"store training launched a TPU-kernel port: {launches}")
    check(len(history) == 1 and all(
        np.isfinite(v) for part in ("train", "val")
        for v in history[0][part].values()),
        f"store training: history {history}")
    moved = groups_moved(clock["before"], tr.nets.state_dict())
    check(all(moved.values()), f"store training: moved {moved}")
    wall = clock["end"] - starts[1]
    by_kind, busy, n_kernels = device_summary(
        clock["prof"], "steps 2-4 of spade_256 bf16 from the store")
    (weights,) = glob.glob(os.path.join(cfg.output_path, "models", "*",
                                        "epoch_0.pt"))
    del tr, clock
    torch.cuda.empty_cache()
    return weights, dict(
        store_train_ms_per_step=wall / (len(starts) - 1) * 1e3,
        store_train_first_step_s=starts[1] - starts[0],
        store_train_epoch_s=epoch_s,
        store_train_device_idle_share=max(0.0, 1 - busy / 1e3 / wall),
        store_train_device_ms_by_kind=by_kind,
        store_train_device_kernels=n_kernels,
        store_train_losses=history[0]["train"],
        store_val_losses=history[0]["val"], store_train_launches=launches)


def serve_trained(dev, seed, kernels, weights, td):
    """7d: the epoch's ``epoch_0.pt`` served at image 256 (stride 32, tile
    1024, batch 16, bf16): by ``load_model_fn`` and ``DEMSuperResolution``
    over a synthetic raster of 2 tiles, and by the map CLI over phase 5's
    synthetic map; each with the launch counters set to 0 just before and
    the patch kernel required; maps finite where covered and no_value
    elsewhere.  Returns the CLI map's directory and the stats."""
    import torch

    from moonsuperresolution_tpu_torch.cli import process_full_tiles as cli
    from moonsuperresolution_tpu_torch.config import DSRConfig
    from moonsuperresolution_tpu_torch.infer.engine import (
        DEMSuperResolution,
        load_model_fn,
    )

    geom = SERVE_GEOM
    model = load_model_fn(weights, "gaugan", geom["image_size"], device=dev)
    eng = DEMSuperResolution(DSRConfig(seed=seed, no_value=NO_VALUE,
                                       compute_dtype="bfloat16", **geom),
                             model=model, device=dev)
    img, dem = synthetic_raster(geom["tile_size"], 2 * geom["tile_size"],
                                seed + 2)
    t0 = time.perf_counter()
    (tiles, (mean, std, good)), engine_launches = counted_run(
        kernels, lambda: run_map(eng, img, dem), [PATCHES],
        "the trained model's tile loop")
    torch.cuda.synchronize()
    tiles_s = time.perf_counter() - t0
    cover = check_tile_maps(mean, std, good, dem, "trained model, engine")
    check(len(tiles) == 2 and cover.mean() > 0.3,
          f"trained model: {len(tiles)} tiles, coverage {cover.mean():.3f}")
    del eng, model

    stays, filled = synthetic_map(td, seed + 1)
    out = os.path.join(td, "served")
    argv = ["--source_folder_path", td, "--map_name", "map", "--save_path",
            out, "--model_path", weights]
    for k, v in geom.items():
        argv += [f"--{k}", str(v)]
    res, cli_launches = run_cli(kernels, cli, argv, "trained model")
    m = read_triple(out, "map")
    check_map(m, res, stays, filled, "trained model map")
    torch.cuda.empty_cache()
    return out, dict(serve_tiles_s=tiles_s, serve_coverage=float(cover.mean()),
                     serve_launches=engine_launches,
                     serve_map={k: v for k, v in res.items()},
                     serve_map_launches=cli_launches)


def compare_served(out):
    """7e: ``compare_maps.run`` of the served mean map against itself and
    against a copy 1 m higher where covered."""
    from moonsuperresolution_tpu_torch.cli import compare_maps
    from moonsuperresolution_tpu_torch.geo.tiff import (
        read_geotiff,
        write_geotiff,
    )

    mean = os.path.join(out, "map_mean.tiff")
    same = compare_maps.run(["--a", mean, "--b", mean])
    check(same["rmse"] == 0 and same["coverage"] > 0,
          f"compare_maps, map against itself: {same}")
    m = read_geotiff(mean).data.squeeze()
    higher = np.where(m > NO_VALUE, m + np.float32(1), m)
    shifted = os.path.join(out, "map_mean_plus_1m.tiff")
    write_geotiff(shifted, higher, MAP_GT, MAP_PROJ, NO_VALUE)
    diff = compare_maps.run(["--a", mean, "--b", shifted])
    check(abs(diff["bias"] + 1) <= 1e-6 and diff["coverage"] == same[
        "coverage"], f"compare_maps, map against map + 1 m: {diff}")
    return dict(compare_self=same, compare_plus_1m=diff)


def real_data_path(dev, seed, kernels):
    """Phase 7: store -> sampler -> training -> serving -> comparison."""
    stats = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_store_") as td:
        store, st = build_stores(td, seed)
        stats.update(st)
        stats.update(sampler_rate(store, seed))
        weights, st = train_from_store(dev, seed, kernels, store, td)
        stats.update(st)
        out, st = serve_trained(dev, seed, kernels, weights, td)
        stats.update(st)
        stats.update(compare_served(out))
    bad = sorted(m for m in ("h5py", "cv2") if m in sys.modules)
    check(not bad, f"the real-data path imported {bad}")
    return stats


# ----------------------------------------------------------------- phase 8

# The small pix2pix of 8b and 8c: the JAX tests' depth 6 at image 64.
P2P_SMALL = dict(image_size=64, pix2pix_depth=6)
P2P_LOGITS = 30         # the PatchGAN's logit map at 256 px


def pix2pix_cfg(**model):
    import dataclasses

    from moonsuperresolution_tpu_torch.config import RECIPES

    cfg = RECIPES["pix2pix"]
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model,
                                                              **model))


def train_pix2pix_full_width(dev, seed, kernels):
    """8a: the pix2pix recipe unchanged (U-Net depth 8, image 256, batch
    64, Adam 2e-4 with beta1 0.5, float32 with TF32 off), timed by
    ``timed_training`` on SyntheticSampler batches already on the card;
    the generator's output and the PatchGAN's logits have their shapes."""
    import torch

    from moonsuperresolution_tpu_torch.train.trainers import make_trainer

    cfg = pix2pix_cfg()
    m = cfg.model
    tr = make_trainer(cfg, device=dev).init(
        torch.Generator(dev).manual_seed(seed))
    batches = synthetic_batches(m.image_size, cfg.batch_size, 2, seed, dev)
    out = timed_training(dev, seed, kernels, tr, batches, "pix2pix float32")
    with torch.no_grad():
        fake = tr.forward(batches[0][0])
        logits = tr.discriminator(batches[0][0], fake)
    b, size = cfg.batch_size, m.image_size
    check(list(fake.shape) == [b, 1, size, size]
          and list(logits.shape) == [b, 1, P2P_LOGITS, P2P_LOGITS],
          f"pix2pix: output {list(fake.shape)}, logits "
          f"{list(logits.shape)}")
    out.update(depth=m.pix2pix_depth, batch=b, image_size=size,
               output_shape=list(fake.shape),
               logits_shape=list(logits.shape))
    del tr, batches, fake, logits
    torch.cuda.empty_cache()
    return out


def pix2pix_card_vs_cpu(dev, seed):
    """8c: one step of a small float32 pix2pix trainer (depth 6, image 64,
    batch 4) on the card and on the CPU, from the same weights, batch and
    dropout masks.  Losses to rtol 1e-4; parameters to 6c's bound on Adam's
    first step (``updates_near_cpu``)."""
    import dataclasses

    import torch

    from moonsuperresolution_tpu_torch.train.trainers import make_trainer

    cfg = dataclasses.replace(pix2pix_cfg(**P2P_SMALL), batch_size=4)
    cpu = make_trainer(cfg, device="cpu").init(
        torch.Generator().manual_seed(seed))
    card = make_trainer(cfg, device=dev)
    card.nets.load_state_dict(cpu.nets.state_dict())
    start = {k: v.clone() for k, v in cpu.nets.state_dict().items()}
    ((src, tgt),) = synthetic_batches(64, 4, 1, seed, "cpu")
    masks = cpu.generator.draw_masks(src, torch.Generator().manual_seed(seed))
    want, _ = cpu.train_step(src, tgt, masks=masks)
    got, _ = card.train_step(src.to(dev), tgt.to(dev),
                             masks=[m.to(dev) for m in masks])
    loss_err = max(abs(float(got[k]) - float(v)) / abs(float(v))
                   for k, v in want.items())
    check(loss_err <= 1e-4, f"pix2pix card vs CPU: losses differ by "
          f"{loss_err} relative ({ {k: float(v) for k, v in got.items()} } "
          f"against { {k: float(v) for k, v in want.items()} })")
    raw_max, over, n = updates_near_cpu(card, cpu, start, cfg.optimizer,
                                        set())
    return dict(p2p_card_vs_cpu_loss_max_rel_err=loss_err,
                p2p_card_vs_cpu_param_max_abs_diff=raw_max,
                p2p_card_vs_cpu_params_over_1e5=over,
                p2p_card_vs_cpu_params_checked=n)


def keras_streams(seed, image_size, latent=256):
    """Full-width Keras-order weight streams of the reference's encoder and
    SPADE generator (networks.py:8-57), as two SavedModels would hold them:
    each tensor under Keras' auto-name (``conv2d``, ``conv2d_1``, ...,
    ``dense``, ``instance_normalization``) in creation order.  Kernels are
    glorot normal, biases and betas 0, gammas 1.  Returns {"encoder": (names,
    values), "generator": (names, values)}."""
    rng = np.random.default_rng(seed)

    def stream(layers):
        made, names, values = {}, [], []
        for family, leaves in layers:
            i = made.get(family, 0)
            made[family] = i + 1
            layer = f"{family}_{i}" if i else family
            for leaf, value in leaves:
                names.append(f"{layer}/{leaf}:0")
                values.append(value)
        return names, values

    def kernel(*shape):
        receptive = int(np.prod(shape[:-2]))
        std = np.sqrt(2.0 / (receptive * (shape[-2] + shape[-1])))
        return rng.standard_normal(shape, np.float32) * np.float32(std)

    def conv(k, cin, cout, bias=True):
        leaves = [("kernel", kernel(k, k, cin, cout))]
        if bias:
            leaves.append(("bias", np.zeros(cout, np.float32)))
        return "conv2d", leaves

    def dense(cin, cout):
        return "dense", [("kernel", kernel(cin, cout)),
                         ("bias", np.zeros(cout, np.float32))]

    enc = []
    for i, (cin, cout) in enumerate(((2, 64), (64, 128), (128, 256),
                                     (256, 512), (512, 512))):
        enc.append(conv(3, cin, cout, bias=False))
        if i:
            enc.append(("instance_normalization",
                        [("gamma", np.ones(cout, np.float32)),
                         ("beta", np.zeros(cout, np.float32))]))
    flat = (image_size // 32) ** 2 * 512
    enc += [dense(flat, latent), dense(flat, latent)]

    def spade(f):       # the mask conv, then gamma's and beta's
        return [conv(3, 2, SPADE_HIDDEN), conv(3, SPADE_HIDDEN, f),
                conv(3, SPADE_HIDDEN, f)]

    sw = image_size // 64
    gen = [dense(latent, 16 * sw * sw * 64)]
    for cin, cout in zip(FULL_PLAN[:1] + FULL_PLAN[:-1], FULL_PLAN):
        gen += spade(cin) + spade(cout) + [conv(3, cin, cout),
                                            conv(3, cout, cout)]
        if cin != cout:
            gen += spade(cin) + [conv(3, cin, cout)]
    gen.append(conv(4, FULL_PLAN[-1], 1))
    return {"encoder": stream(enc), "generator": stream(gen)}


def serve_imported(dev, seed, kernels):
    """8d: full-width reference weights, in the Keras order and naming of
    the authors' SavedModels (made from ``seed``), through the port's
    ``encoder_params_from_weights`` / ``generator_params_from_weights`` and
    ``save_npz``, served by the map CLI (``--model_path`` that file, bf16)
    over phase 5's synthetic map with the patch kernel counted (at least
    one launch per tile); the maps checked as in phase 5; the same tree
    loaded by ``load_params`` into a GauGAN and served by the engine gives
    the same mean map bit for bit; the stream with resblock 0's conv_1 and
    conv_2 (same shape) swapped is refused."""
    import torch

    from moonsuperresolution_tpu_torch.cli import process_full_tiles as cli
    from moonsuperresolution_tpu_torch.config import DSRConfig, ModelConfig
    from moonsuperresolution_tpu_torch.infer.engine import DEMSuperResolution
    from moonsuperresolution_tpu_torch.models.gaugan import GauGAN
    from moonsuperresolution_tpu_torch.utils.checkpoint import (
        encoder_params_from_weights,
        generator_params_from_weights,
    )
    from moonsuperresolution_tpu_torch.utils.convert import (
        flatten_tree,
        load_params,
        save_npz,
    )

    size = PROD["image_size"]
    t0 = time.perf_counter()
    streams = keras_streams(seed, size)
    tree = {"encoder": encoder_params_from_weights(*streams["encoder"]),
            "generator": generator_params_from_weights(
                *streams["generator"])}
    import_s = time.perf_counter() - t0
    n_params = sum(v.size for v in flatten_tree(tree).values())
    names, values = (list(x) for x in streams["generator"])
    i, j = names.index("conv2d_6/kernel:0"), names.index("conv2d_7/kernel:0")
    check(values[i].shape == values[j].shape == (3, 3, 1024, 1024),
          f"stream: {values[i].shape}, {values[j].shape}")
    for a, b in ((i, j), (i + 1, j + 1)):
        names[a], names[b] = names[b], names[a]
        values[a], values[b] = values[b], values[a]
    try:
        generator_params_from_weights(names, values)
    except ValueError as e:
        check("creation order" in str(e), f"swapped stream: {e}")
    else:
        raise PhaseError("the stream with two same-shape convs swapped "
                         "was imported")
    del streams, names, values

    with tempfile.TemporaryDirectory(prefix="chip_smoke_import_") as td:
        stays, filled = synthetic_map(td, seed + 1)
        npz = os.path.join(td, "imported.npz")
        save_npz(npz, tree)
        geom = {k: PROD[k] for k in ("image_size", "stride", "tile_size",
                                     "batch_size")}
        out = os.path.join(td, "imported")
        argv = ["--source_folder_path", td, "--map_name", "map",
                "--save_path", out, "--model_path", npz]
        for k, v in geom.items():
            argv += [f"--{k}", str(v)]
        res, cli_launches = run_cli(kernels, cli, argv, "imported weights")
        check(cli_launches[PATCHES] >= res["tiles"],
              f"imported weights: {cli_launches[PATCHES]} patch kernel "
              f"launches for {res['tiles']} tiles")
        m = read_triple(out, "map")
        cover = check_map(m, res, stays, filled, "imported weights map")
        os.remove(npz)

        cfg = ModelConfig(image_size=size, compute_dtype="bfloat16")
        model = load_params(GauGAN(cfg), tree).to(
            device=dev, dtype=torch.bfloat16).eval()
        direct = os.path.join(td, "direct")
        eng = DEMSuperResolution(DSRConfig(
            source_folder_path=td, map_name="map", save_path=direct,
            no_value=NO_VALUE, compute_dtype="bfloat16", **geom),
            model=model, device=dev)
        res_direct, direct_launches = counted_run(
            kernels, eng.process_map, [PATCHES],
            "the imported tree served by the engine")
        d = read_triple(direct, "map")
        check(np.array_equal(d["mean"], m["mean"])
              and np.array_equal(d["good"], m["good"]),
              "imported weights: the map CLI and load_params + the engine "
              "give different mean maps")
        del eng, model
    torch.cuda.empty_cache()
    return dict(import_params=n_params, import_stream_s=import_s,
                import_map={k: v for k, v in res.items()},
                import_map_coverage=float(cover.mean()),
                import_map_launches=cli_launches,
                import_direct_tiles_s=res_direct["tiles_s"],
                import_direct_launches=direct_launches)


def pix2pix_and_import(dev, seed, kernels):
    """Phase 8: pix2pix training (8a-8c) and imported weights served
    (8d)."""
    import dataclasses

    stats = {"train_pix2pix": train_pix2pix_full_width(dev, seed, kernels)}
    small = dataclasses.replace(pix2pix_cfg(**P2P_SMALL), batch_size=4)
    stats.update({f"p2p_{k}": v
                  for k, v in train_loop_resume(dev, seed, small).items()})
    stats.update(pix2pix_card_vs_cpu(dev, seed))
    stats.update(serve_imported(dev, seed, kernels))
    check("tensorflow" not in sys.modules,
          "phase 8 imported TensorFlow (the importer reads numpy streams)")
    return stats


# ----------------------------------------------------------------- phase 9

DP_RTOL, DP_ATOL = 2e-3, 1e-4       # tests/test_torch_distributed.py
STEPS_9B = 5                        # step 0 held, steps 2-4 timed
WORKER_TIMEOUT = 420


def free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def spade_256(compute_dtype="bfloat16"):
    import dataclasses

    from moonsuperresolution_tpu_torch.config import RECIPES

    cfg = RECIPES["spade_256"]
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, compute_dtype=compute_dtype))


def ms_per_step(tr, batches, gen):
    """2 warm-up steps, then 5 timed to a host readback of the losses."""
    import torch

    for i in range(TRAIN_WARMUP):
        tr.train_step(*batches[i % 2], generator=gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = [tr.train_step(*batches[i % 2], generator=gen)[0]
           for i in range(TRAIN_TIMED)]
    check(all(np.isfinite(float(v)) for o in out for v in o.values()),
          "a loss is not finite")
    return (time.perf_counter() - t0) / TRAIN_TIMED * 1e3


def nccl_world_one(dev, seed, kernels):
    """9a: a process group of one on NCCL (a local TCP store), the trainer
    on ``make_mesh((1, 1))``: full-width spade_256 in bf16, batch 16,
    through the data-parallel code (every SPADE moment all-reduced, the
    gradients averaged, the metrics averaged), against the same trainer
    without a group from the same weights, batch and draws: losses within
    rtol 1e-4 and the updates within 6c's bound.  A group of one changes
    no value, so the compared step runs cuDNN's deterministic algorithms
    on both sides (bf16 gradients from atomics-reducing algorithms differ
    between two runs by a bf16 ulp, beyond 6c's float32 bound), and the
    updates are also counted bit for bit.  Then ms per step of each (2 +
    5 steps, cuDNN's defaults, as 6a)."""
    import torch

    from moonsuperresolution_tpu_torch.parallel.distributed import (
        initialize,
        shutdown,
    )
    from moonsuperresolution_tpu_torch.parallel.mesh import (
        make_mesh,
        shard_state_for_dp_tp,
    )
    from moonsuperresolution_tpu_torch.train.trainers import make_trainer

    cfg = spade_256()
    ref = make_trainer(cfg, device=dev).init(
        torch.Generator(dev).manual_seed(seed))
    start = {k: v.to("cpu", copy=True)
             for k, v in ref.nets.state_dict().items()}
    batches = synthetic_batches(256, cfg.batch_size, 2, seed, dev)
    g = torch.Generator(dev).manual_seed(seed)
    eps = [torch.randn((cfg.batch_size, cfg.model.latent_dim), generator=g,
                       device=dev) for _ in range(2)]
    initialize(f"localhost:{free_port()}", 1, 0, device=dev,
               backend="nccl")
    try:
        dp = make_trainer(cfg, device=dev)
        dp.nets.load_state_dict(ref.nets.state_dict())
        shard_state_for_dp_tp(dp, make_mesh((1, 1), device=dev))
        check(dp.data_axis.group is not None
              and dp.nets["generator"].resblock_0.data_axis.group is not None,
              "9a: the trainer is not on the group")
        torch.backends.cudnn.deterministic = True
        try:
            (want, _), (got, _) = (
                tr.train_step(*batches[0], eps_d=eps[0], eps_g=eps[1])
                for tr in (ref, dp))
            torch.cuda.synchronize()
        finally:
            torch.backends.cudnn.deterministic = False
        differ = sum(not torch.equal(a, b) for a, b in zip(
            ref.nets.parameters(), dp.nets.parameters()))
        loss_err = max(abs(float(got[k]) - float(v)) / abs(float(v))
                       for k, v in want.items())
        check(loss_err <= 1e-4, f"9a: losses differ by {loss_err} relative")
        raw_max, over, n = updates_near(
            {k: v.cpu() for k, v in dp.nets.state_dict().items()},
            {k: (p.detach().cpu(), p.grad.cpu())
             for k, p in ref.nets.named_parameters()},
            start, cfg.optimizer, set(normalised_biases(cfg.model)))
        gen = torch.Generator(dev).manual_seed(seed + 1)
        ref_ms = ms_per_step(ref, batches, gen)
        dp_ms = ms_per_step(dp, batches, gen)
    finally:
        shutdown()
    del ref, dp, batches
    torch.cuda.empty_cache()
    return dict(nccl1_loss_max_rel_err=loss_err,
                nccl1_tensors_not_bit_equal=differ,
                nccl1_param_max_abs_diff=raw_max,
                nccl1_params_over_1e5=over, nccl1_params_checked=n,
                nccl1_ms_per_step=dp_ms, nccl1_no_group_ms_per_step=ref_ms)


def run_workers(kind, argvs, what):
    """``chip_smoke.py --worker kind -- argv`` once per argv, all at once,
    from this script's directory; each must exit 0 within
    ``WORKER_TIMEOUT``.  Returns each one's ``WORKER`` record and the
    seconds to the last one's end."""
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker", kind, "--",
         *argv], cwd=here, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for argv in argvs]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=WORKER_TIMEOUT))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    secs = time.perf_counter() - t0
    records = []
    for i, (p, (out, err)) in enumerate(zip(procs, outs)):
        lines = [ln for ln in out.splitlines() if ln.startswith("WORKER ")]
        if p.returncode != 0 or not lines:
            print(f"[{what}] worker {i} (rc {p.returncode}):\n{out[-3000:]}"
                  f"\n{err[-6000:]}", file=sys.stderr)
        check(p.returncode == 0 and lines,
              f"{what}: worker {i} exited {p.returncode}")
        print(f"[{what}] worker {i}: {lines[-1]}")
        records.append(json.loads(lines[-1][len("WORKER "):]))
    return records, secs


def group_flags(n, rank, port, backend="gloo"):
    return ["--distributed", "--coordinator", f"localhost:{port}",
            "--num_processes", str(n), "--process_id", str(rank),
            "--backend", backend]


def dp_reference(dev, seed, parts, compute_dtype):
    """The one-process step that a run of the training CLI on a mesh takes
    first: the loop's init (``seed``), latent generator (``seed + 1``) and
    augmentation (``default_rng(seed)`` in every process), on the global
    batch made of each data-axis process's rows (``parts``: (sampler
    seed, rows), in process order).  Returns the metrics."""
    import dataclasses

    import torch

    from moonsuperresolution_tpu_torch.data.sampler import (
        SyntheticSampler,
        augment_batch,
    )
    from moonsuperresolution_tpu_torch.train.loop import to_device
    from moonsuperresolution_tpu_torch.train.trainers import make_trainer

    cfg = dataclasses.replace(spade_256(compute_dtype), seed=seed)
    xs, ys = [], []
    for sampler_seed, rows in parts:
        x, y = next(SyntheticSampler(hw=256, seed=sampler_seed)
                    .batches(rows, 1))
        x, y = augment_batch(x, y, np.random.default_rng(seed))
        xs.append(x)
        ys.append(y)
    tr = make_trainer(cfg, device=dev).init(
        torch.Generator(dev).manual_seed(seed))
    gen = torch.Generator(dev).manual_seed(seed + 1)
    m, _ = tr.train_step(to_device(np.concatenate(xs), dev),
                         to_device(np.concatenate(ys), dev), generator=gen)
    out = {k: float(v) for k, v in m.items()}
    del tr
    torch.cuda.empty_cache()
    return out


def two_processes_on_one_card(dev, seed):
    """9b: gloo on CUDA tensors, probed first (two processes, one
    all-reduce), then the training CLI in two processes on the one card at
    full width (spade_256, synthetic, global batch 16): on a DP mesh 2,1
    (8 rows each) and a TP mesh 1,2 (min_dim 512: the four 1024-wide
    blocks, the 1024 -> 512 block and the latent dense sharded).

    Each mesh runs twice.  In float32 (TF32 off), one step, held to the
    one-process float32 step on the same global batch (``dp_reference``)
    at the DP bounds (rtol 2e-3 / atol 1e-4, a float32 bound).  With
    ``--bf16``, ``STEPS_9B`` steps, the later ones timed; its first step's
    difference from the one-process bf16 step is recorded beside the
    one-process bf16 step's own distance from the float32 one: bf16
    rounding, not the DP code, sets how far a near-zero mean such as
    ``g_hinge`` moves when the batch is split (float32 holds the bound,
    bf16 by a few 1e-4 does not)."""
    import torch

    port = free_port()
    probe, _ = run_workers("probe", [group_flags(2, r, port)
                                     for r in range(2)], "9b gloo probe")
    check(all(r["sum"] == [3.0, 3.0] for r in probe),
          f"9b: gloo all-reduce of a CUDA tensor gave {probe}")
    stats = {}
    refs = {"dp": [(seed, 8), (seed + 1000, 8)], "tp": [(seed, 16)]}
    for name, mesh in (("dp", "2,1"), ("tp", "1,2")):
        st = stats[f"gloo2_{name}"] = {"mesh": mesh}
        for dtype in ("float32", "bfloat16"):
            bf16 = dtype == "bfloat16"
            steps = STEPS_9B if bf16 else 1
            torch.cuda.empty_cache()
            with tempfile.TemporaryDirectory(prefix="chip_smoke_9b_") as td:
                port = free_port()
                argv = ["--recipe", "spade_256", "--synthetic", "--no_log",
                        "--mesh", mesh, "--batch_size", "16", "--epochs",
                        "1", "--max_steps_per_epoch", str(steps), "--seed",
                        str(seed), "--output_path", td] + (
                            ["--bf16"] if bf16 else [])
                recs, secs = run_workers(
                    "train", [argv + group_flags(2, r, port)
                              for r in range(2)], f"9b {name} {mesh} {dtype}")
            first = [r["steps"][0] for r in recs]
            check(first[0] == first[1], f"9b {name} {dtype}: the processes' "
                  f"losses differ: {first}")
            want = dp_reference(dev, seed, refs[name], dtype)
            check(set(first[0]) == set(want),
                  f"9b {name}: metrics {sorted(first[0])}")
            errs = {k: abs(first[0][k] - v) for k, v in want.items()}
            rec = dict(first_step=first[0], reference=want, abs_err=errs,
                       max_rel_err=max(errs[k] / abs(v)
                                       for k, v in want.items()),
                       peak_mem_gib=[r["peak_mem_gib"] for r in recs],
                       sharded=recs[0]["sharded"], run_s=secs)
            if bf16:
                f32 = st["float32"]["reference"]
                rec["bf16_vs_float32"] = {k: abs(f32[k] - v)
                                          for k, v in want.items()}
                rec["ms_per_step"] = [np.mean(np.diff(r["step_s"][1:])) * 1e3
                                      for r in recs]
            else:
                bad = {k: (first[0][k], v) for k, v in want.items()
                       if errs[k] > DP_ATOL + DP_RTOL * abs(v)}
                check(not bad, f"9b {name} float32: first step off the "
                      f"one-process step: {bad}")
            st[dtype] = rec
    return stats


def map_across_processes(kernels, td):
    """9c: the map CLI in two processes on the one card (``--distributed``
    with gloo: one tile-list shard each), bf16 full-width GauGAN over
    phase 5's map, merged by the merge CLI; against phase 5a's in-RAM map,
    bit for bit or else within rtol 1e-3 (and which).  Each worker prints
    its patch-kernel launches; their sum must cover the map's 6 tiles."""
    from moonsuperresolution_tpu_torch.cli import merge_maps

    out = os.path.join(td, "two_processes")
    argv = ["--source_folder_path", td, "--map_name", "map", "--save_path",
            out, "--model_path", os.path.join(td, "gaugan.npz"),
            "--model_kind", "gaugan"]
    for key in ("image_size", "stride", "tile_size", "batch_size"):
        argv += [f"--{key}", str(PROD[key])]
    port = free_port()
    recs, secs = run_workers("map", [argv + group_flags(2, r, port)
                                     for r in range(2)], "9c")
    launches = sum(r["launches"] for r in recs)
    check(launches >= 6 and sorted(r["stats"]["tiles"] for r in recs)
          == [3, 3], f"9c: {launches} patch launches, {recs}")
    kernels[0]["launches"] += launches
    merge_maps.run(["--save_path", out, "--map_name", "map",
                    "--num_shards", "2"])
    want, got = read_triple(os.path.join(td, "model"), "map"), \
        read_triple(out, "map")
    same = all(np.array_equal(got[k], want[k]) for k in got)
    if not same:
        check(np.array_equal(got["good"], want["good"]),
              "9c: coverage differs from phase 5a's")
        cover = want["good"] > 0
        for k in ("mean", "std"):
            check(np.allclose(got[k][cover], want[k][cover], rtol=1e-3,
                              atol=0), f"9c: {k} beyond rtol 1e-3")
    diff = max(float(np.abs(got[k].astype(np.float64) - want[k]).max())
               for k in ("mean", "std"))
    return dict(map2_bit_for_bit=same, map2_max_abs_diff=diff,
                map2_launches=[r["launches"] for r in recs],
                map2_tiles_s=[r["stats"]["tiles_s"] for r in recs],
                map2_preprocess_s=[r["stats"]["preprocess_s"] for r in recs],
                map2_run_s=secs)


def tile_parallel(dev, seed, kernels, model, img, dem, prof_dir):
    """9d: ``DEMSuperResolution(mesh=make_mesh((2, 1), devices=[card,
    card]))`` over phase 3's raster (2 tiles: one group, a thread and a
    stream each) against the serial loop, in bf16 and int8_static (each
    mode quantized afresh for each run, so that both calibrate once on the
    same first tile): the maps equal bit for bit; the patch kernel and,
    in int8_static, the int8 conv counted.  The bf16 serial run traces its
    second tile into ``prof_dir`` (9e)."""
    import torch

    from moonsuperresolution_tpu_torch.config import DSRConfig
    from moonsuperresolution_tpu_torch.infer.engine import (
        DEMSuperResolution,
        quantize_model,
    )
    from moonsuperresolution_tpu_torch.parallel.mesh import make_mesh

    stats = {}
    for mode in ("bf16", "int8_static"):
        maps, secs = {}, {}
        for how in ("serial", "tile-parallel"):
            m = model if mode == "bf16" else quantize_model(
                model, "int8_static", device=dev)
            mesh = (make_mesh((2, 1), devices=[dev, dev])
                    if how == "tile-parallel" else None)
            eng = DEMSuperResolution(DSRConfig(seed=seed, **PROD), model=m,
                                     device=dev, mesh=mesh)
            need = [PATCHES] + ([QCONV] if mode != "bf16" else [])
            prof = prof_dir if (mode, how) == ("bf16", "serial") else None
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            (tiles, maps[how]), launches = counted_run(
                kernels, lambda: run_map(eng, img, dem, prof), need,
                f"9d {mode} {how}")
            torch.cuda.synchronize()
            secs[how] = time.perf_counter() - t0
            stats[f"tile_parallel_{mode}_{how}_launches"] = launches
            del eng, m
        check(len(tiles) == N_TILES and all(
            np.array_equal(a, b) for a, b in zip(maps["serial"],
                                                  maps["tile-parallel"])),
            f"9d {mode}: the tile-parallel maps differ from the serial ones")
        stats[f"tile_parallel_{mode}_s"] = secs
    return stats


def train_profile(dev, seed, prof_dir):
    """9e: ``train(profile_dir=)`` at 6b's small width on the card: the
    trace of step 1."""
    from moonsuperresolution_tpu_torch.config import ModelConfig, TrainConfig
    from moonsuperresolution_tpu_torch.train.loop import train

    with tempfile.TemporaryDirectory(prefix="chip_smoke_9e_") as td:
        train(TrainConfig(model=ModelConfig(**TRAIN_SMALL), batch_size=4,
                          epochs=1, output_path=td, seed=seed),
              synthetic=True, max_steps_per_epoch=2, log=False, device=dev,
              profile_dir=prof_dir)


def profiles_written(prof_dir):
    """9e: the tile trace names the patch kernel, the train trace holds
    device kernels; how many of each trace's lead kernels it lost (see
    ``utils/profiling.py``)."""
    from moonsuperresolution_tpu_torch.utils.profiling import (
        lead_kernels_lost,
    )

    names = sorted(os.listdir(prof_dir))
    check(names == ["tile_1.json", "train_step_0.json"],
          f"9e: traces {names}")
    sizes, lost = {}, {}
    for name in names:
        with open(os.path.join(prof_dir, name)) as f:
            text = f.read()
        sizes[name] = len(text)
        check('"cat": "kernel"' in text, f"9e: {name} holds no device kernel")
        lost[name] = lead_kernels_lost(json.loads(text)["traceEvents"])
    with open(os.path.join(prof_dir, "tile_1.json")) as f:
        text = f.read()
    check("patches_block_minmax" in text or "patches_normalize" in text,
          f"9e: the tile trace does not name the patch kernel (lead "
          f"kernels lost: {lost})")
    return dict(trace_bytes=sizes, trace_lead_kernels_lost=lost)


def multi_device(dev, seed, kernels, model, img, dem, td):
    """Phase 9: the multi-device layer on the one card."""
    stats = {}
    stats.update(nccl_world_one(dev, seed, kernels))
    stats.update(two_processes_on_one_card(dev, seed))
    stats.update(map_across_processes(kernels, td))
    prof_dir = os.path.join(td, "profiles")
    stats.update(tile_parallel(dev, seed, kernels, model, img, dem,
                               prof_dir))
    train_profile(dev, seed, prof_dir)
    stats.update(profiles_written(prof_dir))
    return stats


# ---------------------------------------------------------------- workers


def worker(kind, argv):
    """One process of phase 9's runs (``--worker``); prints its record as
    one ``WORKER {json}`` line.

    - probe: joins the group of the flags, all-reduces a CUDA tensor of its
      rank + 1 (over gloo: the sum is 3 in each element).
    - train: the training CLI on ``argv``, each step's losses and end time
      (to a host readback) recorded.
    - map: the map CLI on ``argv``; its patch-kernel launches."""
    import torch

    from moonsuperresolution_tpu_torch.parallel import distributed

    if kind == "probe":
        a = dict(zip(argv[1::2], argv[2::2]))
        dev = distributed.initialize(a["--coordinator"],
                                     int(a["--num_processes"]),
                                     int(a["--process_id"]),
                                     backend=a["--backend"])
        t = torch.full((2,), float(int(a["--process_id"]) + 1), device=dev)
        torch.distributed.all_reduce(t)
        rec = {"sum": t.cpu().tolist(), "device": str(dev)}
    elif kind == "train":
        from moonsuperresolution_tpu_torch.cli import train as cli
        from moonsuperresolution_tpu_torch.train import trainers

        steps, ends, real = [], [], trainers.GauGANTrainer.train_step

        def recorded(self, *a, **kw):
            m, fake = real(self, *a, **kw)
            steps.append({k: float(v) for k, v in m.items()})
            ends.append(time.perf_counter())
            return m, fake

        trainers.GauGANTrainer.train_step = recorded
        tr, _ = cli.run(argv)
        rec = {"steps": steps, "step_s": ends,
               "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
               "sharded": sorted(tr.sharded), "device": str(tr.device)}
    else:
        from moonsuperresolution_tpu_torch.cli import process_full_tiles
        from moonsuperresolution_tpu_torch.ops import patches

        stats = process_full_tiles.run(argv)
        rec = {"launches": patches.extract_normalize_patches.launches,
               "stats": stats}
    distributed.shutdown()
    print("WORKER " + json.dumps(rec), flush=True)
    return 0


# -------------------------------------------------------------------- main


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["--worker"] and "--" in argv:
        import torch

        if not torch.cuda.is_available():
            print("chip_smoke: no CUDA device", file=sys.stderr)
            return 1
        try:
            return worker(argv[1], argv[argv.index("--") + 1 :])
        finally:
            stop_children()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and the synthetic data")
    ap.add_argument("--out", default=None,
                    help="also write the whole JSON record to this file")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        import moonsuperresolution_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e}); run "
              "from the repository root", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    phase = "1 build"
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        adopt_orphans()
        card = card_line()
        print(f"card: {card}")
        qconv_ptxas = build_all()

        phase = "2 kernels vs plain"
        kernels = [patches_case(dev, args.seed), qconv_case(dev, args.seed)]
        for k in kernels:
            k["launches"] = 0
            print(f"[kernel] {k['name']}: {k['ms']:.4f} ms, plain "
                  f"{k['plain_ms']:.4f} ms, bound {k['bound_ms']:.4f} ms "
                  f"({k['bound_by']}), max abs err {k['max_abs_err']:.3g}")

        phase = "3 main path"
        eng, model, img, dem, good, stats = main_path(dev, args.seed,
                                                      kernels)
        print(f"[main path] full-width bf16 GauGAN, {stats['params']} "
              f"params: {stats['tiles']} tiles in {stats['tiles_s']:.3f} s "
              f"= {stats['tile_s']:.3f} s/tile, "
              f"{stats['patches_per_s']:.2f} patches/s, peak memory "
              f"{stats['peak_mem_gib']:.2f} GiB, "
              f"{stats['model_patches']} patches through the model at "
              f"{stats['model_gflop_per_patch']:.1f} GFLOP each = "
              f"{stats['model_tflop_per_s']:.1f} TFLOP/s")
        print(f"[main path] launches: "
              + ", ".join(f"{k['name']}={k['launches']}" for k in kernels))

        fpp = stats["model_gflop_per_patch"] * 1e9
        stats.update(full_tile(eng, fpp, args.seed, kernels))
        print(f"[full tile] all patches valid: {stats['full_tile_s']:.3f} s "
              f"= {stats['full_tile_patches_per_s']:.2f} patches/s, model at "
              f"{stats['full_tile_model_tflop_per_s']:.1f} TFLOP/s; card "
              f"idle {100 * stats['device_idle_share']:.1f} % of the tile")
        print("[full tile] device ms by kind: " + ", ".join(
            f"{k} {v:.1f}" for k, v in stats["device_ms_by_kind"].items()))
        del eng

        phase = "3b int8 main path"
        stats.update(int8_paths(dev, args.seed, model, kernels, img, dem,
                                good, fpp))

        phase = "4 output checks"
        stats.update(identity_check(dev, img, dem))
        stats.update(small_model_check(dev, args.seed))
        stats.update(small_int8_check(dev, args.seed))
        print(f"[small int8] card against CPU: calibrated scales within "
              f"{stats['small_int8_scale_max_rel_diff']:.5f} relative, "
              f"static forward relative RMSE "
              f"{stats['small_int8_card_vs_cpu_rel_rmse']:.3g}")

        phase = "5 full map"
        stats.update(full_map(dev, model, kernels, args.seed, work))
        print(f"[full map] bf16 GauGAN over {MAP_HW[0]} x {MAP_HW[1]} px, "
              f"{stats['map_tiles']} tiles: preprocess_s "
              f"{stats['map_preprocess_s']:.3f}, tiles_s "
              f"{stats['map_tiles_s']:.3f}, save_s {stats['map_save_s']:.3f}, "
              f"{stats['map_patches_per_s']:.2f} patches/s, peak memory "
              f"{stats['map_peak_mem_gib']:.2f} GiB")
        print(f"[full map] int8_static streaming: preprocess_s "
              f"{stats['map_int8_static_preprocess_s']:.3f}, tiles_s "
              f"{stats['map_int8_static_tiles_s']:.3f}, save_s "
              f"{stats['map_int8_static_save_s']:.3f}; mean differs from the "
              f"bf16 map's by "
              f"{stats['map_int8_static_mean_abs_diff_vs_bf16_m']:.4f} m "
              f"on average")
        print("[full map] launches: " + ", ".join(
            f"{path} {sum(c.values())}"
            for path, c in stats["map_launches"].items()))
        print("[full map] resizes, card against CPU, max abs err: " + ", ".join(
            f"{k} {v}"
            for k, v in stats["resize_card_vs_cpu_max_abs_err"].items()))

        phase = "6 training"
        for dtype in ("float32", "bfloat16"):
            st = train_full_width(dev, args.seed, kernels, dtype)
            stats[f"train_spade_256_{dtype}"] = st
            print(f"[train] spade_256 full width ({st['params']} params), "
                  f"batch 16, {dtype} compute, float32 parameters: "
                  f"{st['ms_per_step']:.1f} ms/step = "
                  f"{st['samples_per_s']:.2f} samples/s, "
                  f"{st['tflop_per_step']:.2f} TFLOP/step = "
                  f"{st['model_tflop_per_s']:.1f} TFLOP/s, peak memory "
                  f"{st['peak_mem_gib']:.2f} GiB, card idle "
                  f"{100 * st['device_idle_share']:.1f} % of a step "
                  f"({st['device_kernels_per_step']} device kernels); losses "
                  + " ".join(f"{k}={v:.4f}"
                             for k, v in st["last_losses"].items()))
            print(f"[train] {dtype} device ms by kind: " + ", ".join(
                f"{k} {v:.1f}" for k, v in st["device_ms_by_kind"].items()))
        stats.update(train_loop_resume(dev, args.seed))
        print(f"[train] loop and resume on the card: epochs of "
              f"{', '.join(f'{t:.2f}' for t in stats['loop_seconds'])} s, "
              f"restored state equal bit for bit, step 2 -> 4")
        stats.update(train_card_vs_cpu(dev, args.seed))
        print(f"[train] one step card against CPU: losses within "
              f"{stats['train_card_vs_cpu_loss_max_rel_err']:.3g} relative; "
              f"parameters within "
              f"{stats['train_card_vs_cpu_param_max_abs_diff']:.3g}, "
              f"{stats['train_card_vs_cpu_params_over_1e5']} of "
              f"{stats['train_card_vs_cpu_params_checked']} beyond 1e-5 "
              f"(Adam sign flips), every update Adam's step of a gradient "
              f"near the CPU's")

        phase = "7 real-data path"
        stats.update(real_data_path(dev, args.seed, kernels))
        print(f"[store] build_h5_dataset: 8 tiles in "
              f"{stats['store_build_h5_dataset_s']:.2f} s; tile_pair: "
              f"{stats['store_tiles']} tiles, "
              f"{stats['store_bytes'] / 2**20:.1f} MiB in "
              f"{stats['store_write_s']:.2f} s; both read back equal")
        print(f"[sampler] TileSampler at hw 256: "
              f"{stats['sampler_samples_per_s']:.1f} samples/s on one "
              f"thread, {stats['sampler_prefetched_samples_per_s']:.1f} "
              f"through BatchPrefetcher ({stats['sampler_torch_threads']} "
              f"torch threads)")
        synth = stats["train_spade_256_bfloat16"]["ms_per_step"]
        print(f"[store train] spade_256 full width, bf16, batch 16, from "
              f"the store: {stats['store_train_ms_per_step']:.1f} ms/step "
              f"(steps 2-4; synthetic batches on the card, phase 6a: "
              f"{synth:.1f} ms), card idle "
              f"{100 * stats['store_train_device_idle_share']:.1f} %, "
              f"first step {stats['store_train_first_step_s']:.2f} s, epoch "
              f"with validation and checkpoints "
              f"{stats['store_train_epoch_s']:.1f} s; losses "
              + " ".join(f"{k}={v:.4f}"
                         for k, v in stats["store_train_losses"].items()))
        print(f"[serve] epoch_0.pt at image 256: 2 tiles in "
              f"{stats['serve_tiles_s']:.3f} s; the map CLI "
              f"{stats['serve_map']['tiles']} tiles, tiles_s "
              f"{stats['serve_map']['tiles_s']:.3f}; patch kernel launches "
              f"{stats['serve_launches'][PATCHES]} + "
              f"{stats['serve_map_launches'][PATCHES]}")
        print(f"[compare] map against itself: rmse "
              f"{stats['compare_self']['rmse']}, coverage "
              f"{stats['compare_self']['coverage']:.3f}; against + 1 m: bias "
              f"{stats['compare_plus_1m']['bias']}")

        phase = "8 pix2pix and imported weights"
        stats.update(pix2pix_and_import(dev, args.seed, kernels))
        st = stats["train_pix2pix"]
        print(f"[pix2pix] full width (depth {st['depth']}, image "
              f"{st['image_size']}, {st['params']} params), batch "
              f"{st['batch']}, float32: {st['ms_per_step']:.1f} ms/step = "
              f"{st['samples_per_s']:.2f} samples/s, "
              f"{st['tflop_per_step']:.2f} TFLOP/step = "
              f"{st['model_tflop_per_s']:.1f} TFLOP/s, peak memory "
              f"{st['peak_mem_gib']:.2f} GiB, card idle "
              f"{100 * st['device_idle_share']:.1f} % of a step "
              f"({st['device_kernels_per_step']} device kernels); output "
              f"{st['output_shape']}, logits {st['logits_shape']}; losses "
              + " ".join(f"{k}={v:.4f}" for k, v in st["last_losses"].items()))
        print("[pix2pix] device ms by kind: " + ", ".join(
            f"{k} {v:.1f}" for k, v in st["device_ms_by_kind"].items()))
        print(f"[pix2pix] loop and resume on the card: epochs of "
              f"{', '.join(f'{t:.2f}' for t in stats['p2p_loop_seconds'])} "
              f"s, restored state equal bit for bit, step 2 -> 4; one step "
              f"card against CPU: losses within "
              f"{stats['p2p_card_vs_cpu_loss_max_rel_err']:.3g} relative, "
              f"parameters within "
              f"{stats['p2p_card_vs_cpu_param_max_abs_diff']:.3g} "
              f"({stats['p2p_card_vs_cpu_params_over_1e5']} of "
              f"{stats['p2p_card_vs_cpu_params_checked']} beyond 1e-5)")
        print(f"[import] full-width Keras-order streams "
              f"({stats['import_params']} params) imported in "
              f"{stats['import_stream_s']:.2f} s; the map CLI over "
              f"{stats['import_map']['tiles']} tiles: tiles_s "
              f"{stats['import_map']['tiles_s']:.3f}, coverage "
              f"{stats['import_map_coverage']:.3f}, patch kernel launches "
              f"{stats['import_map_launches'][PATCHES]}; load_params + the "
              f"engine: the same mean map bit for bit "
              f"({stats['import_direct_launches'][PATCHES]} launches); the "
              f"swapped stream refused")

        phase = "9 multi-device"
        stats.update(multi_device(dev, args.seed, kernels, model, img, dem,
                                  work))
        del model
        card_tag = f"({card})"
        print(f"[9a nccl] a group of one on NCCL, spade_256 full width bf16 "
              f"batch 16: {stats['nccl1_ms_per_step']:.1f} ms/step against "
              f"{stats['nccl1_no_group_ms_per_step']:.1f} without the group "
              f"(phase 6a: "
              f"{stats['train_spade_256_bfloat16']['ms_per_step']:.1f}); "
              f"losses within {stats['nccl1_loss_max_rel_err']:.3g} "
              f"relative, parameters within "
              f"{stats['nccl1_param_max_abs_diff']:.3g} "
              f"({stats['nccl1_tensors_not_bit_equal']} tensors not bit "
              f"for bit) {card_tag}")
        for name in ("dp", "tp"):
            st = stats[f"gloo2_{name}"]
            f32, b16 = st["float32"], st["bfloat16"]
            print(f"[9b gloo] two processes on one card, mesh {st['mesh']} "
                  f"({len(f32['sharded'])} sharded tensors): float32 first "
                  f"step within {f32['max_rel_err']:.3g} relative of the "
                  f"one-process step; bf16 steps 2-4 "
                  + ", ".join(f"{v:.1f}" for v in b16["ms_per_step"])
                  + " ms/step per process, peak "
                  + ", ".join(f"{v:.2f}" for v in b16["peak_mem_gib"])
                  + " GiB; bf16 first step off the one-process bf16 step "
                  "by " + ", ".join(f"{k} {v:.3g}"
                                    for k, v in b16["abs_err"].items())
                  + " (one-process bf16 off float32 by "
                  + ", ".join(f"{k} {v:.3g}"
                              for k, v in b16["bf16_vs_float32"].items())
                  + f") {card_tag}")
        print(f"[9c map] two processes, one shard each: tiles_s "
              + ", ".join(f"{v:.3f}" for v in stats["map2_tiles_s"])
              + f" (phase 5a: {stats['map_tiles_s']:.3f}), patch launches "
              f"{stats['map2_launches']}; merged map equal to 5a's "
              + ("bit for bit" if stats["map2_bit_for_bit"] else
                 f"within rtol 1e-3 (max abs diff "
                 f"{stats['map2_max_abs_diff']:.3g})") + f" {card_tag}")
        for mode in ("bf16", "int8_static"):
            t = stats[f"tile_parallel_{mode}_s"]
            print(f"[9d tile-parallel] {mode}, 2 tiles on (cuda:0, cuda:0): "
                  f"{t['tile-parallel']:.3f} s against {t['serial']:.3f} s "
                  f"serial, the same maps bit for bit; launches "
                  f"{stats[f'tile_parallel_{mode}_tile-parallel_launches']}"
                  f" {card_tag}")
        print(f"[9e profiles] {stats['trace_bytes']}; lead kernels lost "
              f"{stats['trace_lead_kernels_lost']}")
    except Exception as e:  # any phase failing fails the run, with its trace
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: phase {phase} failed: {e}", file=sys.stderr)
        return 1
    finally:
        import shutil

        shutil.rmtree(work, ignore_errors=True)
        left = stop_children()
    if left:
        print(f"chip_smoke: processes still running at the end: {left}",
              file=sys.stderr)
        return 1

    record = {"kernels": [
        {key: k[key] for key in ("name", "route", "source", "replaces",
                                 "launches", "max_abs_err", "ms", "plain_ms",
                                 "bound_ms", "bound_by", "library_ms")}
        for k in kernels]}
    qrows = kernels[1]["rows"]
    stats["qconv_ptxas"] = qconv_ptxas
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "stats": stats, "qconv_rows": qrows,
                       **record}, f, indent=1)
    print(json.dumps({"card": card, "stats": stats}))
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
