"""Batching and the double-buffered host-to-card pipeline.

Counterpart of `mrcnn3d/data/loader.py` (the reference's torch DataLoader
+ GroupSampler + patched collate, mmdet/datasets/loader/).  Static crop
sizes make collation a plain stack; a background thread prefetches and
transfers the next batch while the card computes.

`collate` and `epoch_indices` are the JAX package's.  `Prefetcher`'s
`device_put` becomes `device`: the batch's arrays become tensors on it.
On the card the copy goes through pinned host memory, non-blocking, on a
side CUDA stream, and the consumer's stream waits on an event recorded
after the copy.  The volumes (imgs, imgs_2) arrive as NCDHW: one
`permute` of the NDHWC batch, whose strides are then channels_last_3d,
the model's storage.  In `process` mode the workers are spawned and run
numpy and the host runtime only; they never touch CUDA.

Per-host sharding mirrors DistributedGroupSampler's epoch-seeded
deterministic shard (sampler.py:166-247).
"""
from __future__ import annotations

import os
import pickle
import queue
import threading

import numpy as np
import torch

# process-pool worker state: the dataset is shipped once per worker via
# the pool initializer (pickling dataset.__getitem__ per task would
# re-serialize the whole dataset on every submit)
_WORKER_DS = None

# batch entries that stay host lists
HOST_KEYS = ("img_info", "ori_shape", "ori_shape_2", "ori_shape_3")
# channel-last volumes, permuted to NCDHW on the device
VOLUME_KEYS = ("imgs", "imgs_2", "imgs_3")


def _worker_init(ds_bytes):
    global _WORKER_DS
    _WORKER_DS = pickle.loads(ds_bytes)
    # decorrelate per-worker augmentation randomness (same caveat as
    # torch DataLoader workers / the thread pool: nondeterministic
    # across worker scheduling)
    rng = getattr(_WORKER_DS, "rng", None)
    if rng is not None:
        _WORKER_DS.rng = np.random.RandomState(os.getpid() % (2**31))
        crop = getattr(_WORKER_DS, "crop", None)
        if crop is not None:
            for t in getattr(crop, "transforms", []):
                if hasattr(t, "rng"):
                    t.rng = _WORKER_DS.rng


def _worker_get_shm(i):
    """Fetch a sample and ship its large arrays via POSIX shared memory.

    Pickling multi-MB volumes through the result pipe dominates process-
    worker cost; a shm segment turns that into one memcpy on each side.
    Returns {key: value-or-(shm_name, shape, dtype)} descriptors.
    """
    from multiprocessing import shared_memory

    sample = _WORKER_DS[i]
    out = {}
    for k, v in sample.items():
        if isinstance(v, np.ndarray) and v.nbytes >= 1 << 20:
            shm = shared_memory.SharedMemory(create=True, size=v.nbytes)
            np.ndarray(v.shape, v.dtype, buffer=shm.buf)[...] = v
            out[k] = ("__shm__", shm.name, v.shape, str(v.dtype))
            shm.close()  # consumer unlinks
        else:
            out[k] = v
    return out


def _shm_decode(sample):
    from multiprocessing import shared_memory

    out = {}
    for k, v in sample.items():
        if isinstance(v, tuple) and len(v) == 4 and v[0] == "__shm__":
            _, name, shape, dtype = v
            shm = shared_memory.SharedMemory(name=name)
            arr = np.ndarray(shape, np.dtype(dtype), buffer=shm.buf).copy()
            shm.close()
            shm.unlink()
            out[k] = arr
        else:
            out[k] = v
    return out


def collate(samples):
    """Stack a list of same-shape sample dicts into batch arrays."""
    out = {}
    for k in samples[0]:
        if k in HOST_KEYS:
            out[k] = [s[k] for s in samples]
        else:
            out[k] = np.stack([s[k] for s in samples])
    return out


def epoch_indices(n, epoch, shuffle=True, rank=0, world=1, seed=0):
    """Deterministic epoch-seeded shard (reference DistributedGroupSampler)."""
    rng = np.random.RandomState(seed + epoch)
    idx = rng.permutation(n) if shuffle else np.arange(n)
    # pad to a multiple of world so every rank sees the same count
    pad = (-len(idx)) % world
    if pad:
        idx = np.concatenate([idx, idx[:pad]])
    return idx[rank::world]


def to_device(batch, device, stream=None):
    """A collated numpy batch as tensors on `device`: arrays become
    tensors, the volumes NCDHW (a permute of the NDHWC stack); host
    entries stay lists.  On the card, `stream` (a side stream) carries
    pinned, non-blocking copies; the caller makes its stream wait."""
    out = {}
    for k, v in batch.items():
        if not isinstance(v, np.ndarray):
            out[k] = v
            continue
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            with torch.cuda.stream(stream):
                t = t.pin_memory().to(device, non_blocking=True)
        if k in VOLUME_KEYS:
            t = t.permute(0, 4, 1, 2, 3)
        out[k] = t
    return out


class Prefetcher:
    """Multi-worker batch producer with device-transfer overlap.

    A pool of sample workers (reference workers_per_gpu role) feeds a
    collator thread that stacks fixed-shape samples and moves the batch
    to `device` while the previous one is being consumed (None: numpy
    batches, as the JAX package's device_put=False).  Like torch
    DataLoader workers, augmentation randomness is nondeterministic
    across workers when num_workers > 1: the thread pool shares the
    dataset's one RandomState.
    """

    def __init__(self, dataset, batch_size, epoch=0, shuffle=True,
                 rank=0, world=1, depth=2, device=None, seed=0,
                 num_workers=4, mode="thread"):
        self.dataset = dataset
        self.batch_size = batch_size
        self.device = None if device is None else torch.device(device)
        self.stream = None
        if self.device is not None and self.device.type == "cuda":
            self.stream = torch.cuda.Stream(self.device)
        self.q = queue.Queue(maxsize=depth)
        self.indices = epoch_indices(
            len(dataset), epoch, shuffle, rank, world, seed
        )
        self.num_workers = max(1, num_workers)
        # mode="process": spawn-based worker pool -- sample prep (json,
        # np.load, crop, mask relabel) holds the GIL, so thread workers
        # stop scaling once the python share dominates; processes
        # sidestep the GIL at the cost of one dataset pickle per worker.
        # spawn (not fork): forking a process that holds a CUDA context
        # is unsafe.
        if mode not in ("thread", "process"):
            raise ValueError(f"loader mode {mode!r}: thread or process")
        self.mode = mode
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _put(self, item):
        """Queue `item` unless close() was called; returns whether it
        was queued."""
        while not self._stop.is_set():
            try:
                self.q.put(item, timeout=0.05)
                return True
            except queue.Full:
                pass
        return False

    def _work(self):
        try:
            self._produce()
        except BaseException as e:  # surface worker errors to the consumer
            self._put(e)
        else:
            self._put(None)

    def close(self, timeout=30.0):
        """Stop producing: the producer thread ends after its pending
        samples (the batches queued on the device are dropped).  For a
        consumer that stops before the epoch's end."""
        self._stop.set()
        while True:
            try:
                self.q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout)

    def _produce(self):
        from collections import deque
        from concurrent.futures import (
            ProcessPoolExecutor,
            ThreadPoolExecutor,
        )

        if self.mode == "process":
            import multiprocessing as mp

            pool = ProcessPoolExecutor(
                self.num_workers,
                mp_context=mp.get_context("spawn"),
                initializer=_worker_init,
                initargs=(pickle.dumps(self.dataset),),
            )
            submit = lambda i: pool.submit(  # noqa: E731
                _worker_get_shm, i
            )
            decode = _shm_decode
        else:
            pool = ThreadPoolExecutor(self.num_workers)
            submit = lambda i: pool.submit(  # noqa: E731
                self.dataset.__getitem__, i
            )
            decode = lambda s: s  # noqa: E731

        window = self.num_workers * 2  # bounded look-ahead
        with pool:
            pending: deque = deque()
            it = iter(self.indices)
            batch = []

            def refill():
                while len(pending) < window:
                    try:
                        i = next(it)
                    except StopIteration:
                        return
                    pending.append(submit(int(i)))

            try:
                refill()
                while pending:
                    fut = pending.popleft()
                    batch.append(decode(fut.result()))
                    refill()
                    if len(batch) == self.batch_size:
                        if not self._put(self._transfer(collate(batch))):
                            return
                        batch = []
            finally:
                # decode-and-discard any in-flight results so their
                # shared-memory segments are unlinked (process mode);
                # without this an error path leaks /dev/shm space
                for fut in pending:
                    try:
                        decode(fut.result(timeout=5))
                    except Exception:
                        pass

    def _transfer(self, batch):
        """(batch on the device, the copy's event or None)."""
        if self.device is None:
            return batch, None
        out = to_device(batch, self.device, self.stream)
        event = None
        if self.stream is not None:
            event = torch.cuda.Event()
            event.record(self.stream)
        return out, event

    def __iter__(self):
        while True:
            item = self.q.get()
            if item is None:
                return
            if isinstance(item, BaseException):
                raise item
            batch, event = item
            if event is not None:
                # the consumer's stream waits for the side stream's copy,
                # and the caching allocator learns that it uses the
                # tensors the side stream allocated
                current = torch.cuda.current_stream(self.device)
                current.wait_event(event)
                for v in batch.values():
                    if isinstance(v, torch.Tensor):
                        v.record_stream(current)
            yield batch
