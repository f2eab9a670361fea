"""Training API -- the reference's train_detector/Runner stack as one loop.

Counterpart of `mrcnn3d/apis/train_api.py`: epoch loop, per-iteration
train step (`entry.build_trainer`), text logging, checkpoint interval,
optional in-loop validation (`evaluate_dataset`), the LR schedule,
resume from the work dir's newest checkpoint, and a checkpoint-and-stop
on SIGTERM / SIGINT.  Under a process group (`parallel.mesh.init_dist`,
one process a card) with a mesh, the step is data-parallel: the global
batch is imgs_per_gpu times the mesh's data size, each rank loads its
rank-strided shard of every epoch, and validation runs sharded.
"""
from __future__ import annotations

import logging
import os
import signal
import time

import numpy as np
import torch

from ..data.loader import Prefetcher
from ..entry import build_trainer
from ..parallel.mesh import Mesh, get_dist_info, make_mesh
from ..train import checkpoint as ckpt
from ..utils.device import resolve_device


def get_root_logger(log_level=logging.INFO):
    logger = logging.getLogger("mrcnn3d_torch")
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(
            logging.Formatter("%(asctime)s - %(levelname)s - %(message)s")
        )
        logger.addHandler(handler)
        logger.propagate = False
    logger.setLevel(log_level)
    return logger


def set_random_seed(seed):
    """Seeds numpy's and torch's global generators.  The train state's
    weights and the samplers' draws take `seed` explicitly
    (`entry.build_trainer`); the datasets' crops their own RandomState."""
    np.random.seed(seed)
    torch.manual_seed(seed)


def train_shapes(cfg, dataset=None):
    """Static (d, h, w) train-crop shapes per scale.

    Probing one sample from the dataset is authoritative (crop size is a
    function of the volume geometry, reference extra_aug.py:166-168:
    H/4 x W/4 x D); the probe advances the dataset's RandomState as the
    JAX package's does, so the crops that follow are the same.  The
    config static_shapes.crop_size is the fallback when no dataset is
    given.
    """
    if dataset is not None and len(dataset) > 0:
        probe = dataset[0]
        shapes = [probe["imgs"].shape[:3]]
        for key in ("imgs_2", "imgs_3"):
            if key in probe:
                shapes.append(probe[key].shape[:3])
        return shapes
    ss = cfg.get("static_shapes", {})
    ch, cw, cd = ss.get("crop_size", (128, 128, 64))
    up = cfg.get("upscale_factor", 1.5)
    shapes = [(cd, ch, cw)]
    n_scales = 1 + sum(
        1 for k in ("rpn_head_2", "rpn_head_3") if k in cfg.model
    )
    for s in range(1, n_scales):
        f = up**s
        # upscaled crop padded to size_divisor 32 (depth likewise)
        d = int(cd * f)
        h = -(-int(ch * f)) // 32 * 32
        w = -(-int(cw * f)) // 32 * 32
        shapes.append((d, h, w))
    return shapes


class _StopOnSignal:
    """SIGTERM / SIGINT request a checkpoint-and-stop; the first ^C
    restores the previous handler, so a second one kills at once.  Only
    the main thread can install handlers; elsewhere this is a no-op."""

    def __init__(self):
        self.sig = None
        self.prev = {}

    def _on(self, signum, frame):
        self.sig = signum
        if signum == signal.SIGINT:
            try:
                signal.signal(signal.SIGINT, self.prev.get(
                    signal.SIGINT, signal.default_int_handler))
            except ValueError:
                pass

    def __enter__(self):
        for s in (signal.SIGTERM, signal.SIGINT):
            try:
                self.prev[s] = signal.signal(s, self._on)
            except ValueError:  # not the main thread
                pass
        return self

    def __exit__(self, *exc):
        for s, h in self.prev.items():
            try:
                signal.signal(s, h)
            except ValueError:
                pass


def train_detector(cfg, dataset, work_dir=None, seed=0, validate=False,
                   val_dataset=None, max_iters=None, mesh=None,
                   log_interval=None, profile_steps=None, device=None,
                   stats=None):
    """Main entry (reference tools/train.py -> apis/train.py path).

    device: the card unless "cpu"; the step runs in float32, as the JAX
    package's does.  mesh: a `parallel.mesh.Mesh`, "auto" (the world's
    1-D mesh when it has more than one rank) or None (one process).
    profile_steps: (start, stop) iteration
    bounds of a torch.profiler trace written to <work_dir>/profile.
    stats: optional dict, filled with iters (this run's), seconds (the
    loop's wall time), loader_wait_s (wall time spent waiting for the
    next batch), losses (the total loss of each iteration) and
    first_step_s.  Returns the train state (`train.step.TrainState`).
    """
    rank, world = get_dist_info()
    if mesh == "auto":
        mesh = make_mesh() if world > 1 else None
    if world > 1 and not isinstance(mesh, Mesh):
        raise ValueError("multi-process training needs a mesh "
                         "(parallel.mesh.make_mesh, or mesh='auto')")
    logger = get_root_logger()
    set_random_seed(seed)
    device = resolve_device(device)
    work_dir = work_dir or cfg.get("work_dir", "./work_dirs/default")

    # installed before the build: a reclaimed machine's SIGTERM then
    # checkpoints and returns at the next step boundary
    with _StopOnSignal() as stop:
        shapes = train_shapes(cfg, dataset)
        # each rank steps on imgs_per_gpu rows of the global batch
        per_rank = cfg.data.get("imgs_per_gpu", 1)
        n_data, data_rank = 1, 0
        if mesh is not None:
            n_data, data_rank = mesh.n_data, mesh.data_rank
            logger.info("data-parallel mesh: %d x %d ranks", mesh.n_data,
                        mesh.n_depth)
        iters_per_epoch = max(len(dataset) // (per_rank * n_data), 1)
        trainer = build_trainer(cfg, device=device, seed=seed,
                                iters_per_epoch=iters_per_epoch, mesh=mesh)
        state = trainer.state
        n_params = sum(p.numel() for p in state.model.parameters())
        logger.info("model built: %.1fM params; crops %s", n_params / 1e6,
                    [tuple(int(v) for v in s) for s in shapes])

        manager = ckpt.CheckpointManager(work_dir)
        if ckpt.restore(manager, state) is not None:
            logger.info("resumed from step %d", state.step)

        total_epochs = cfg.get("total_epochs", 1)
        ckpt_interval = cfg.get("checkpoint_config", {}).get("interval", 5)
        log_interval = log_interval or cfg.get("log_config", {}).get(
            "interval", 1
        )

        it = state.step
        start_it = it
        t_start = time.perf_counter()
        t_last = t_start
        wait = 0.0
        losses = []
        first_step_s = None
        prof = None
        trace_dir = os.path.join(str(work_dir), "profile")

        def stop_profile():
            prof.stop()
            os.makedirs(trace_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
            logger.info("profiler trace written to %s", trace_dir)

        def finish(reason):
            if prof is not None:
                stop_profile()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            seconds = time.perf_counter() - t_start
            if stats is not None:
                stats.update(
                    iters=it - start_it, seconds=seconds, loader_wait_s=wait,
                    first_step_s=first_step_s,
                    losses=torch.stack(losses).cpu().tolist()
                    if losses else [],
                )
            logger.info("%s at step %d after %.1fs", reason, it, seconds)
            return state

        for epoch in range(it // iters_per_epoch, total_epochs):
            loader = Prefetcher(
                dataset, per_rank, epoch=epoch, shuffle=True, seed=seed,
                rank=data_rank, world=n_data,
                num_workers=cfg.data.get("workers_per_gpu", 4),
                mode=cfg.data.get("loader_mode", "thread"), device=device,
            )
            batches = iter(loader)
            try:
                while True:
                    t0 = time.perf_counter()
                    batch = next(batches, None)
                    wait += time.perf_counter() - t0
                    if batch is None:
                        break
                    batch.pop("img_info", None)
                    if profile_steps and it == profile_steps[0] \
                            and prof is None:
                        prof = torch.profiler.profile()
                        prof.start()
                    t0 = time.perf_counter()
                    metrics = trainer.step(batch)
                    it += 1
                    if first_step_s is None:
                        first_step_s = time.perf_counter() - t0
                    if stats is not None:
                        losses.append(metrics["loss"])
                    if prof is not None and it >= profile_steps[1]:
                        stop_profile()
                        prof = None
                    if it % log_interval == 0:
                        m = {k: float(v) for k, v in metrics.items()}
                        now = time.perf_counter()
                        dt = (now - t_last) / log_interval
                        t_last = now
                        logger.info(
                            "epoch %d iter %d lr %.2e loss %.4f %.2fs/it | %s",
                            epoch, it, state.schedule(it - 1), m["loss"], dt,
                            " ".join(f"{k}:{v:.3f}" for k, v in m.items()
                                     if k != "loss"),
                        )
                    if stop.sig is not None:
                        ckpt.save(manager, state, it)
                        return finish(f"signal {stop.sig}: checkpointed and "
                                      "stopped")
                    if max_iters and it >= max_iters:
                        ckpt.save(manager, state, it)
                        return finish("max_iters reached")
            finally:
                loader.close()
            if (epoch + 1) % ckpt_interval == 0:
                ckpt.save(manager, state, it)
            if validate and val_dataset is not None and (
                (epoch + 1) % cfg.get("interval", 5) == 0
            ):
                from .test_api import evaluate_dataset

                # the rank-strided validation shard, all-gathered before
                # scoring (reference eval_hooks.py:111-149)
                stats_e = evaluate_dataset(cfg, state.model, val_dataset,
                                           rank=rank, world=world)
                logger.info("eval @ epoch %d: %s", epoch, stats_e)
        ckpt.save(manager, state, it)
        return finish("training done")
