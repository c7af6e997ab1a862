"""ScanNet snippet dataset + loader (port of parq_tpu/data/scannet.py).

Reads the reference's on-disk artifacts (roidb index pickle, per-scene
annotation pickles, `frame-{:06d}.color.jpg` images) and produces stacked
numpy batches through the transforms. The loader is a resumable iterator
whose state (epoch, position, seed) goes into checkpoints. Items are numpy
only: neither the prefetch thread nor the worker processes touch CUDA.
PIL is imported where the images are opened.
"""
from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional

import numpy as np

from .transforms import snippet_transform

SYM_MAPPING = {
    "__SYM_NONE": 0,
    "__SYM_ROTATE_UP_2": 1,
    "__SYM_ROTATE_UP_4": 2,
    "__SYM_ROTATE_UP_INF": 3,
}
SYM_PAD = 50  # ref: scannet_dataset.py:161


class ScanNetDataset:
    def __init__(self, data_path: str, gt_path: str,
                 num_frames_per_snippet: int = 3, image_size=(320, 240),
                 gravity_aligned: bool = True, max_cache: int = 100,
                 seed: int = 0):
        self.data_path = data_path
        self.gt_path = gt_path
        with open(gt_path, "rb") as f:
            self.item_list = pickle.load(f)
        self.anno_path = os.path.join(os.path.dirname(gt_path), "scene_anno")
        self.num_frames = num_frames_per_snippet
        self.image_size = tuple(image_size)
        self.gravity_aligned = gravity_aligned
        self._cache: Dict[str, object] = {}
        self.max_cache = max_cache
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """Epoch-dependent frame subsampling (called by SnippetLoader)."""
        self.epoch = int(epoch)

    def __len__(self):
        return len(self.item_list)

    def _read_anno(self, scene_name: str, snippet_id: int):
        if scene_name not in self._cache:
            if len(self._cache) > self.max_cache:
                self._cache = {}
            with open(os.path.join(self.anno_path, scene_name + ".pkl"),
                      "rb") as f:
                self._cache[scene_name] = pickle.load(f)
        return self._cache[scene_name][snippet_id]

    def __getitem__(self, idx: int) -> Dict:
        entry = self.item_list[idx]
        scene_name = entry["scene_name"]
        snippet_id = entry["snippet_id"]
        item = self._read_anno(scene_name, snippet_id)

        image_ids = item["image_ids"]
        T_scan_camera = item["T_scan_camera"]
        intrinsic = item["intrinsic"]

        n = len(image_ids)
        if self.num_frames != n:
            # sorted random subsample (ref: scannet_dataset.py:138-144).
            # Per-(seed, epoch, item) RNG instead of the reference's global
            # np.random: reproducible, and identical whether items are built
            # in-process, in a prefetch thread, or in worker processes.
            rng = np.random.RandomState(
                (self.seed * 1000003 + self.epoch * 7919 + idx) % (2**31 - 1))
            choose = np.sort(rng.choice(
                n, self.num_frames, replace=self.num_frames > n))
            image_ids = [image_ids[c] for c in choose]
            T_scan_camera = [T_scan_camera[c] for c in choose]
            intrinsic = [intrinsic[c] for c in choose]

        annos = item["annotations"]
        bboxes = np.asarray(annos["bboxes"])
        T_scan_object = np.asarray(annos["T_scan_object"])
        labels = np.asarray(annos["label"])
        sym_raw = list(annos["sym"])
        sym = np.full((SYM_PAD,), -1, np.int32)
        for i, s in enumerate(sym_raw[:SYM_PAD]):
            sym[i] = SYM_MAPPING.get(s, s if isinstance(s, (int, np.integer))
                                     else 0)

        from PIL import Image
        imgs = [
            Image.open(os.path.join(
                self.data_path, scene_name, "color",
                f"frame-{int(i):06d}.color.jpg"))
            for i in image_ids
        ]

        out = snippet_transform(
            imgs, [np.asarray(k) for k in intrinsic],
            np.asarray(T_scan_camera, np.float64),
            bboxes=bboxes, T_world_object=T_scan_object, labels=labels,
            image_size=self.image_size, gravity_aligned=self.gravity_aligned)
        out["sym"] = sym
        out["scene_name"] = scene_name
        out["snippet_id"] = int(snippet_id)
        return out


def collate(items: List[Dict]) -> Dict:
    """Stack numpy fields; keep strings/ints as lists (mirrors the pixloc
    collate the reference uses, utils/wrappers.py:36-82)."""
    out = {}
    for k in items[0]:
        v0 = items[0][k]
        if isinstance(v0, np.ndarray):
            out[k] = np.stack([it[k] for it in items])
        else:
            out[k] = [it[k] for it in items]
    return out


class _Prefetcher:
    """Bounded background producer of batches [start, stop_idx).

    Stoppable: an abandoned iterator's thread exits promptly instead of
    blocking forever on a full queue. Exceptions in the producer re-raise
    in the consumer."""

    _END = object()

    def __init__(self, make_batch, start: int, stop_idx: int, depth: int):
        import queue
        import threading
        self._q = queue.Queue(maxsize=max(depth, 1))
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, args=(make_batch, start, stop_idx),
            daemon=True)
        self._thread.start()

    def _run(self, make_batch, start, stop_idx):
        import queue
        try:
            for b in range(start, stop_idx):
                item = make_batch(b)
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if self._stop.is_set():
                    return
            item = self._END
        except BaseException as e:  # forwarded to the consumer
            item = e
        while not self._stop.is_set():
            import queue as _q
            try:
                self._q.put(item, timeout=0.1)
                return
            except _q.Full:
                continue

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is self._END:
                return
            if isinstance(item, BaseException):
                raise item
            yield item

    def stop(self):
        self._stop.set()


def _worker_loop(dataset, order, batch_size, epoch, task_q, res_q):
    """Worker-process body: pull batch indices, build+collate, push back.
    Module-level so the spawn context can pickle it."""
    getattr(dataset, "set_epoch", lambda e: None)(epoch)
    while True:
        b = task_q.get()
        if b is None:
            return
        try:
            idxs = order[b * batch_size:(b + 1) * batch_size]
            res_q.put((b, collate([dataset[int(i)] for i in idxs])))
        except BaseException as e:  # forwarded to the consumer
            res_q.put((b, _WorkerError(repr(e))))


class _WorkerError:
    def __init__(self, msg: str):
        self.msg = msg


class _ProcessPrefetcher:
    """Multi-process batch producer (the reference's DataLoader
    `num_workers` equivalent, ref: datasets/scannet_dataset.py:36-42).

    Batch-level parallelism: each worker builds whole batches; the parent
    reorders results so iteration order is identical to the synchronous
    path (item-level RNG is per-(seed, epoch, index), so contents match
    too). Spawn context — workers never inherit live TPU/JAX state."""

    def __init__(self, dataset, order, batch_size, epoch,
                 start: int, stop_idx: int, workers: int, depth: int):
        import multiprocessing as mp
        ctx = mp.get_context("spawn")
        self._task_q = ctx.Queue()
        self._res_q = ctx.Queue()
        self._procs = [
            ctx.Process(target=_worker_loop,
                        args=(dataset, order, batch_size, epoch,
                              self._task_q, self._res_q),
                        daemon=True)
            for _ in range(max(workers, 1))]
        for p in self._procs:
            p.start()
        self._next_submit = start
        self._stop_idx = stop_idx
        self._inflight = 0
        self._max_inflight = len(self._procs) + max(depth, 0)
        self._buffer = {}
        self._next_yield = start
        self._fill()

    def _fill(self):
        while (self._inflight < self._max_inflight
               and self._next_submit < self._stop_idx):
            self._task_q.put(self._next_submit)
            self._next_submit += 1
            self._inflight += 1

    def __iter__(self):
        try:
            while self._next_yield < self._stop_idx:
                while self._next_yield not in self._buffer:
                    b, item = self._res_q.get()
                    if isinstance(item, _WorkerError):
                        raise RuntimeError(
                            f"data worker failed on batch {b}: {item.msg}")
                    self._buffer[b] = item
                    self._inflight -= 1
                    self._fill()
                yield self._buffer.pop(self._next_yield)
                self._next_yield += 1
        finally:
            self.stop()

    def stop(self):
        for p in self._procs:
            if p.is_alive():
                p.terminate()
        for p in self._procs:
            p.join(timeout=5)
        self._procs = []


class SnippetLoader:
    """Resumable epoch iterator: shuffle, drop_last, stateful position.

    Multi-host: pass (process_index, process_count) and each host iterates
    a disjoint strided shard of the identically-seeded epoch order — the
    DistributedSampler equivalent the reference gets from Lightning
    (`replace_sampler_ddp`, ref: train.py:115). Every host sees the same
    number of batches (pad-by-wraparound)."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, seed: int = 0,
                 process_index: int = 0, process_count: int = 1,
                 prefetch: int = 2, num_workers: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.process_index = process_index
        self.process_count = max(process_count, 1)
        self.prefetch = prefetch   # background-decode queue depth; 0 = sync
        self.num_workers = num_workers  # >0: decode in worker processes
        self.epoch = 0
        self.position = 0  # batch index within epoch
        self._producer = None

    def __len__(self):
        n = len(self.dataset)
        if self.process_count > 1:
            n = -(-n // self.process_count)   # padded per-host share
        return n // self.batch_size if self.drop_last else \
            (n + self.batch_size - 1) // self.batch_size

    def _order(self):
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            order = rng.permutation(n)
        else:
            order = np.arange(n)
        if self.process_count > 1:
            from ..parallel import host_shard_indices
            order = host_shard_indices(order, self.process_index,
                                       self.process_count)
        return order

    def _make_batch(self, order, b: int):
        idxs = order[b * self.batch_size:(b + 1) * self.batch_size]
        return collate([self.dataset[int(i)] for i in idxs])

    def __iter__(self):
        getattr(self.dataset, "set_epoch", lambda e: None)(self.epoch)
        order = self._order()
        nb = len(self)
        if self._producer is not None:       # abandoned previous iterator
            self._producer.stop()
            self._producer = None
        if self.num_workers > 0:
            self._producer = _ProcessPrefetcher(
                self.dataset, order, self.batch_size, self.epoch,
                self.position, nb, self.num_workers, self.prefetch)
            for batch in self._producer:
                self.position += 1
                yield batch
            self._producer = None
        elif self.prefetch > 0:
            # background decode thread: JPEG/pickle work overlaps the
            # device step (the reference uses DataLoader worker processes;
            # a thread suffices — PIL/np release the GIL in C code).
            # `position` still counts YIELDED batches → state_dict resume
            # semantics are unchanged.
            self._producer = _Prefetcher(
                lambda b, order=order: self._make_batch(order, b),
                self.position, nb, self.prefetch)
            for batch in self._producer:
                self.position += 1
                yield batch
            self._producer = None
        else:
            while self.position < nb:
                b = self.position
                self.position += 1
                yield self._make_batch(order, b)
        self.position = 0
        self.epoch += 1

    # -- resumable state -------------------------------------------------
    def state_dict(self) -> Dict:
        return {"epoch": self.epoch, "position": self.position,
                "seed": self.seed}

    def load_state_dict(self, state: Dict):
        self.epoch = int(state["epoch"])
        self.position = int(state["position"])
        self.seed = int(state["seed"])
