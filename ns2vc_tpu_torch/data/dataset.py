# The port's copy of ns2vc_tpu/data/dataset.py: the port imports nothing of the JAX package.
"""Training/eval datasets and fixed-shape batching, in numpy.

Mirrors the reference data pipeline (dataset.py:15-180): the collator pads
every batch to a fixed geometry (max_content_frames / max_refer_frames from
TrainConfig), or with `BucketedCollator` to the smallest of a few length
buckets, so the train step sees few shapes.

Feature files: the preprocessor writes `.soft.npy` / `.f0.npy` /
`.spec.npy`; datasets preprocessed by the reference (`.soft.pt` /
`.spec.pt`) load too.

The zero-shot training trick is kept exactly (reference dataset.py:94-115
random_slice): crop to <= 400 mel frames, cut a random contiguous 1/3-2/3
span as the reference prompt, splice the remainder as content/target.

Items are time-major (T, C) in memory, flipped once at load from the
on-disk (C, T) layout; the batch dict keeps (B, T, C). Batches are
collated in f32: the trainer casts them to its compute dtype on the device.

Nothing here touches CUDA or imports torch, and the loader's worker
processes are spawned fresh: they never hold the caller's CUDA state.

Several processes (data parallelism) read through `synced_data_loader`:
every rank walks the same schedule of global batches, derived from the run
seed and the feature files' headers alone, and loads its own rows of each.
"""

from __future__ import annotations

import glob
import os
import queue
import random
import sys
import threading
from typing import Iterator, Optional

import numpy as np

from ns2vc_tpu_torch.audio.f0 import interpolate_f0
from ns2vc_tpu_torch.audio.host import repeat_expand_2d  # noqa: F401
from ns2vc_tpu_torch.config import Config
from ns2vc_tpu_torch.utils.wavio import read_wav

# Per-path npy header cache: np.load re-parses the header on every call;
# training data is immutable for the life of a run, so after the first full
# np.load later reads are one seek + fromfile.
_NPY_HEADERS: dict = {}


def _fast_npy_load(path: str) -> np.ndarray:
    info = _NPY_HEADERS.get(path)
    if info is None:
        data = np.load(path)
        try:
            with open(path, "rb") as f:
                version = np.lib.format.read_magic(f)
                header = getattr(
                    np.lib.format,
                    f"read_array_header_{version[0]}_{version[1]}")(f)
                shape, fortran, dtype = header
                if not fortran and dtype.hasobject is False:
                    _NPY_HEADERS[path] = (f.tell(), dtype, shape)
        except Exception:
            pass  # unusual layout: keep using np.load for this path
        return data
    offset, dtype, shape = info
    with open(path, "rb") as f:
        f.seek(offset)
        data = np.fromfile(f, dtype=dtype,
                           count=int(np.prod(shape, dtype=np.int64)))
    return data.reshape(shape)


def _npy_shape(path: str) -> Optional[tuple]:
    """Header-only shape of a .npy file (no data read); None when the file
    is missing or not a plain npy (the reference's .pt artifacts)."""
    info = _NPY_HEADERS.get(path)
    if info is not None:
        return info[2]
    try:
        with open(path, "rb") as f:
            version = np.lib.format.read_magic(f)
            shape, _, _ = getattr(
                np.lib.format,
                f"read_array_header_{version[0]}_{version[1]}")(f)
        return shape
    except Exception:
        return None


def _load_feature(path_no_ext: str, suffix: str) -> np.ndarray:
    """Load `<path>.<suffix>.npy` or the reference's `.pt` equivalent."""
    npy = path_no_ext + suffix + ".npy"
    if os.path.exists(npy):
        return _fast_npy_load(npy)
    pt = path_no_ext + suffix + ".pt"
    if os.path.exists(pt):
        import torch

        return torch.load(pt, map_location="cpu").numpy()
    raise FileNotFoundError(f"{npy} (or .pt)")


class VCDataset:
    """Training dataset (reference NS2VCDataset, dataset.py:53-125)."""

    def __init__(self, audio_path: str, cfg: Config, all_in_mem: bool = False,
                 seed: Optional[int] = None, load_audio: bool = True):
        self.audiopaths = sorted(
            glob.glob(os.path.join(audio_path, "**/*.wav"), recursive=True))
        self.sampling_rate = cfg.data.sampling_rate
        self.hop_length = cfg.data.hop_length
        self.rng = random.Random(seed)
        self.rng.shuffle(self.audiopaths)
        self.all_in_mem = all_in_mem
        # load_audio=False skips the wav decode: the train step never reads
        # the waveform; eval keeps it for its gt / refer audio
        self.load_audio = load_audio
        if all_in_mem:
            self.cache = [self.get_audio(p) for p in self.audiopaths]

    def __len__(self):
        return len(self.audiopaths)

    def get_audio(self, filename: str):
        """Load aligned (c, f0, spec, audio, uv) for one utterance
        (reference dataset.py:73-92)."""
        if self.load_audio:
            audio, sr = read_wav(filename)
            if audio.ndim > 1:
                audio = audio.mean(axis=0)
            if sr != self.sampling_rate:
                # numpy twin of the resampler: workers stay device-free
                from ns2vc_tpu_torch.audio.resample import resample_np

                audio = resample_np(audio, sr, self.sampling_rate)
        else:
            audio = np.zeros(0, np.float32)
        base = filename  # features live next to the wav, suffixed
        spec = _load_feature(base.replace(".wav", ""), ".spec")
        if spec.ndim == 3:
            spec = spec[0]
        spec = np.ascontiguousarray(spec.T)
        f0_raw = _fast_npy_load(filename + ".f0.npy")
        f0, uv = interpolate_f0(f0_raw)
        c = _load_feature(base, ".soft")
        if c.ndim == 3:
            c = c[0]
        c = repeat_expand_2d(np.ascontiguousarray(c.T), f0.shape[0])

        lmin = min(c.shape[0], spec.shape[0])
        assert abs(c.shape[0] - spec.shape[0]) < 3, (
            c.shape, spec.shape, filename)
        if self.load_audio:
            assert abs(audio.shape[-1] - lmin * self.hop_length) \
                < 3 * self.hop_length
        spec, c, f0, uv = spec[:lmin], c[:lmin], f0[:lmin], uv[:lmin]
        audio = audio[: lmin * self.hop_length]
        return c, f0, spec, audio, uv

    @staticmethod
    def slice_plan(n_frames: int, rng: random.Random):
        """The crop/split decisions of random_slice as a pure function of
        the item's frame count and an rng (reference dataset.py:94-115):
        None for too-short items, else (start, u, v, total) - crop
        [start, start+total), prompt span [u, v) within the crop."""
        if n_frames < 30:
            return None
        start = 0
        if n_frames > 400:
            start = rng.randint(0, n_frames - 400)
            n_frames = 400
        l = rng.randint(n_frames // 3, n_frames // 3 * 2)  # noqa: E741
        u = rng.randint(0, n_frames - l)
        return start, u, u + l, n_frames

    def random_slice(self, c, f0, spec, audio, uv, rng=None):
        """Prompt/content split (reference dataset.py:94-115) on time-major
        fields; `rng` overrides the dataset rng."""
        plan = self.slice_plan(spec.shape[0], rng or self.rng)
        if plan is None:
            return None
        start, u, v, total = plan
        if start or total != spec.shape[0]:
            end = start + total
            spec, c, f0, uv = (spec[start:end], c[start:end],
                               f0[start:end], uv[start:end])
            audio = audio[start * self.hop_length: end * self.hop_length]
        refer = spec[u:v]
        c = np.concatenate([c[:u], c[v:]], axis=0)
        f0 = np.concatenate([f0[:u], f0[v:]], axis=-1)
        spec = np.concatenate([spec[:u], spec[v:]], axis=0)
        uv = np.concatenate([uv[:u], uv[v:]], axis=-1)
        audio = np.concatenate([audio[: u * self.hop_length],
                                audio[v * self.hop_length:]], axis=-1)
        assert c.shape[0] != 0 and refer.shape[0] != 0
        return refer, c, f0, spec, audio, uv

    def __getitem__(self, index: int):
        item = (self.cache[index] if self.all_in_mem
                else self.get_audio(self.audiopaths[index]))
        return self.random_slice(*item)

    def item_frames(self, index: int) -> int:
        """Aligned frame count of item `index` from the feature files'
        headers only: get_audio truncates every field to min(len(f0), spec
        frames), so the synced schedule knows each item's length, and
        through slice_plan its post-slice geometry, without reading the
        data. Falls back to a full load for .pt artifacts."""
        if not hasattr(self, "_frames_cache"):
            self._frames_cache: dict[int, int] = {}
        n = self._frames_cache.get(index)
        if n is not None:
            return n
        path = self.audiopaths[index]
        f0_shape = _npy_shape(path + ".f0.npy")
        spec_shape = _npy_shape(path.replace(".wav", "") + ".spec.npy")
        if f0_shape is not None and spec_shape is not None:
            n = min(int(f0_shape[-1]), int(spec_shape[-1]))
        else:   # .pt artifacts: load once, keep the answer
            n = self.get_audio(path)[2].shape[0]
        self._frames_cache[index] = n
        return n

    def get_sliced(self, index: int, rng: random.Random):
        """Load item `index` and slice it with an explicit rng (the synced
        loader seeds one per schedule position, so the realized geometry is
        the one the schedule predicted on every rank)."""
        item = (self.cache[index] if self.all_in_mem
                else self.get_audio(self.audiopaths[index]))
        return self.random_slice(*item, rng=rng)


class EvalDataset(VCDataset):
    """Pairs item i with item (i+4) mod N as the reference speaker
    (reference TestDataset, dataset.py:15-50)."""

    def __getitem__(self, index: int):
        a = (self.cache[index] if self.all_in_mem
             else self.get_audio(self.audiopaths[index]))
        b_idx = (index + 4) % len(self)
        b = (self.cache[b_idx] if self.all_in_mem
             else self.get_audio(self.audiopaths[b_idx]))
        return (*a, *b)


class FixedShapeCollator:
    """Zero-pad a list of random_slice outputs to a fixed batch geometry
    (replaces the reference's dynamic max+1 padding, dataset.py:128-180).
    Returns a dict of numpy arrays in (B, T, C) layout, floats in
    `float_dtype` (f32). `include_wav=False` omits the waveform field,
    which the train step never reads."""

    def __init__(self, cfg: Config, include_wav: bool = True,
                 float_dtype=np.float32):
        self.t_c = cfg.train.max_content_frames
        self.t_r = cfg.train.max_refer_frames
        self.hop = cfg.data.hop_length
        self.include_wav = include_wav
        self.float_dtype = float_dtype

    def __call__(self, batch: list,
                 geometry: tuple[int, int] | None = None) -> dict:
        batch = [b for b in batch if b is not None]
        assert batch, "empty batch after filtering short clips"
        t_c, t_r = geometry if geometry is not None else (self.t_c, self.t_r)
        n = len(batch)
        c_dim = batch[0][1].shape[1]
        spec_dim = batch[0][3].shape[1]
        fd = self.float_dtype
        out = {
            "c": np.zeros((n, t_c, c_dim), fd),
            "refer": np.zeros((n, t_r, spec_dim), fd),
            "f0": np.zeros((n, t_c), fd),
            "spec": np.zeros((n, t_c, spec_dim), fd),
            "uv": np.zeros((n, t_c), fd),
            "lengths": np.zeros((n,), np.int32),
            "refer_lengths": np.zeros((n,), np.int32),
        }
        if self.include_wav:
            out["wav"] = np.zeros((n, t_c * self.hop), fd)
        for i, (refer, c, f0, spec, audio, uv) in enumerate(batch):
            lc = min(c.shape[0], t_c)
            lr = min(refer.shape[0], t_r)
            out["lengths"][i] = lc
            out["refer_lengths"][i] = lr
            out["c"][i, :lc] = c[:lc]
            out["refer"][i, :lr] = refer[:lr]
            out["f0"][i, :lc] = f0[:lc]
            out["spec"][i, :lc] = spec[:lc]
            out["uv"][i, :lc] = uv[:lc]
            if self.include_wav:
                lw = min(audio.shape[-1], t_c * self.hop)
                out["wav"][i, :lw] = audio[:lw]
        return out


class BucketedCollator(FixedShapeCollator):
    """Length-bucketed fixed-shape batching: pads each batch to the smallest
    (content, refer) bucket pair that fits its items instead of always
    (max_content_frames, max_refer_frames). `data_loader` groups items by
    `bucket_of`, so every batch is uniform in its pair. Refer buckets
    default to the single fixed t_r."""

    def __init__(self, cfg, buckets, refer_buckets=(),
                 include_wav: bool = True, float_dtype=np.float32):
        super().__init__(cfg, include_wav=include_wav,
                         float_dtype=float_dtype)

        def _norm(bk, name):
            out = tuple(sorted(dict.fromkeys(int(b) for b in bk)))
            assert all(b % 8 == 0 and b > 0 for b in out), \
                f"{name} must be positive multiples of 8 (UNet T % 8): {out}"
            return out

        self.buckets = _norm(buckets, "buckets")
        assert self.buckets, "BucketedCollator needs at least one bucket"
        self.refer_buckets = _norm(refer_buckets, "refer_buckets") \
            or (self.t_r,)

    @staticmethod
    def _fit(buckets, length: int, cap: int) -> int:
        """Smallest bucket >= length, clamped to the axis cap (items beyond
        the cap are cropped, as FixedShapeCollator crops them)."""
        length = min(length, cap)
        for b in buckets:
            if b >= length:
                return min(b, cap)
        return min(buckets[-1], cap)

    def bucket_of_lengths(self, content_len: int,
                          refer_len: int) -> tuple[int, int]:
        return (self._fit(self.buckets, content_len, self.t_c),
                self._fit(self.refer_buckets, refer_len, self.t_r))

    def bucket_of(self, item) -> tuple[int, int]:
        """(content, refer) geometry for one random_slice output."""
        refer, c = item[0], item[1]
        return self.bucket_of_lengths(c.shape[0], refer.shape[0])

    def geometries(self) -> list[tuple[int, int]]:
        """Every (t_c, t_r) pair this collator can emit."""
        cs = sorted({min(b, self.t_c) for b in self.buckets})
        rs = sorted({min(b, self.t_r) for b in self.refer_buckets})
        return [(tc, tr) for tc in cs for tr in rs]

    def __call__(self, batch: list,
                 geometry: tuple[int, int] | None = None) -> dict:
        items = [b for b in batch if b is not None]
        assert items, "empty batch after filtering short clips"
        if geometry is None:
            pairs = [self.bucket_of(b) for b in items]
            geometry = (max(p[0] for p in pairs), max(p[1] for p in pairs))
        return super().__call__(items, geometry=geometry)


class _Batcher:
    """Accumulates loaded items into full batches, grouped by bucket pair
    with a bucketed collator, else in one FIFO buffer."""

    def __init__(self, collator, batch_size: int):
        self.collator = collator
        self.n = batch_size
        self.bucketed = hasattr(collator, "bucket_of")
        self.bufs: dict = {}

    def add(self, item) -> Optional[dict]:
        """Returns a collated batch once one fills, else None."""
        key = self.collator.bucket_of(item) if self.bucketed else None
        buf = self.bufs.setdefault(key, [])
        buf.append(item)
        if len(buf) < self.n:
            return None
        self.bufs[key] = buf[self.n:]
        if self.bucketed:
            return self.collator(buf[: self.n], geometry=key)
        return self.collator(buf[: self.n])


def _item_seed(seed: int, epoch: int, pos: int) -> int:
    """Per-scheduled-item rng seed, the same on every rank: a function of
    the run seed and the item's (epoch, position) in the shared shuffled
    order only."""
    return (seed * 0x9E3779B1 + epoch * 0x85EBCA77 + pos * 0xC2B2AE35) \
        & 0x7FFFFFFF


def synced_schedule(dataset: "VCDataset", collator, global_batch: int,
                    seed: int = 0) -> Iterator[tuple]:
    """The same schedule on every rank: an infinite stream of (geometry,
    [(index, item_seed), ...]) global batches, `geometry` the (content,
    refer) bucket pair (None unbucketed) and `global_batch` entries of it.

    It depends only on the seed (epoch shuffle, per-item slice rng), the
    feature files' lengths (`item_frames`, headers only) and the
    collator's bucket edges: slice_plan(frames, Random(item_seed)) predicts
    each item's post-slice lengths, and the load replays that plan through
    get_sliced. So the ranks agree on the geometry of every step (the
    gradient all-reduce always meets tensors of one size) and on which
    items form each batch (their rows stay disjoint). The JAX package's
    schedule is the same arithmetic, so the two give the same stream."""
    rng = random.Random(seed)
    bucketed = hasattr(collator, "bucket_of_lengths")
    bufs: dict = {}
    epoch = -1
    order: list[int] = []
    pos = 0
    while True:
        if not order:
            epoch += 1
            pos = 0
            order = list(range(len(dataset)))
            rng.shuffle(order)
        idx = order.pop()
        iseed = _item_seed(seed, epoch, pos)
        pos += 1
        plan = VCDataset.slice_plan(dataset.item_frames(idx),
                                    random.Random(iseed))
        if plan is None:
            continue
        _, u, v, total = plan
        geom = (collator.bucket_of_lengths(total - (v - u), v - u)
                if bucketed else None)
        buf = bufs.setdefault(geom, [])
        buf.append((idx, iseed))
        if len(buf) == global_batch:
            bufs[geom] = []
            yield geom, buf


def _load_scheduled_batch(dataset, collator, entries, geometry,
                          transform=None):
    """Load and collate one rank's entries of a scheduled batch, checking
    the realized slice geometry against the schedule's prediction (a drift
    would send the ranks different shapes: fail loudly instead)."""
    items = []
    for idx, iseed in entries:
        item = dataset.get_sliced(idx, random.Random(iseed))
        assert item is not None, \
            f"schedule predicted a valid slice for item {idx} " \
            f"but the load produced none (stale feature files?)"
        items.append(item)
    if geometry is not None:
        realized = [collator.bucket_of(it) for it in items]
        assert all(r == geometry for r in realized), (
            f"slice-geometry drift: schedule said {geometry}, "
            f"load realized {sorted(set(realized))}")
    batch = collator(items, geometry=geometry)
    return transform(batch) if transform else batch


def _synced_worker(dataset, collator, transform, work_q, out_q):
    """Process-pool worker of synced_data_loader: pulls (seq, geometry,
    entries) work units, pushes (seq, batch)."""
    try:
        while True:
            seq, geom, entries = work_q.get()
            out_q.put((seq, _load_scheduled_batch(
                dataset, collator, entries, geom, transform)))
    except Exception:
        import traceback

        out_q.put(("__error__", traceback.format_exc()))


def _worker_pool(work: Iterator, worker, args: list, in_size: int,
                 out_size: int) -> Iterator:
    """Spawned worker processes, one per entry of `args`, each running
    worker(*args[i], in_q, out_q): a feeder thread puts the items of
    `work` into in_q, and this yields what the workers put into out_q, in
    the order they finish; a worker's ("__error__", traceback) raises.
    The processes are spawned, not forked, since the caller holds CUDA and
    its threads. Closing the iterator stops the feeder and the workers."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    in_q = ctx.Queue(maxsize=in_size)
    out_q = ctx.Queue(maxsize=out_size)
    procs = [ctx.Process(target=worker, args=(*a, in_q, out_q), daemon=True)
             for a in args]
    for p in procs:
        p.start()
    stop = threading.Event()

    def feeder():
        for item in work:
            while not stop.is_set():
                try:
                    in_q.put(item, timeout=0.1)
                    break
                except queue.Full:
                    continue
            if stop.is_set():
                return

    threading.Thread(target=feeder, daemon=True).start()
    try:
        while True:
            got = out_q.get()
            if isinstance(got, tuple) and got[0] == "__error__":
                raise RuntimeError(f"data worker failed:\n{got[1]}")
            yield got
    finally:
        stop.set()
        for p in procs:
            p.terminate()
        for p in procs:
            p.join(timeout=5)


def _process_group() -> tuple[int, int]:
    """(rank, world size) of torch.distributed's group when the caller has
    one, else (0, 1); torch is not imported here (the workers stay
    torch-free)."""
    dist = sys.modules.get("torch.distributed")
    if dist is not None and dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def synced_data_loader(dataset: VCDataset, collator, batch_size: int,
                       seed: int = 0, num_workers: int = 0,
                       shard_index: int | None = None,
                       shard_count: int | None = None,
                       transform=None) -> Iterator:
    """Batch iterator over the synced_schedule for several processes: every
    rank walks the same (geometry, entries) stream, and rank `shard_index`
    loads entries[i * B:(i + 1) * B] of each global batch. `batch_size` is
    per process, as in `data_loader`; the global batch is batch_size *
    shard_count items of one geometry. shard_index / shard_count default
    to torch.distributed's rank and world size (0 and 1 without a group).
    Yields what `transform` yields, in schedule order: with workers
    (spawned, as `data_loader`'s), results are re-sequenced, so every rank
    emits batch k at step k. Closing the iterator stops the workers."""
    if shard_index is None or shard_count is None:
        shard_index, shard_count = _process_group()
    schedule = synced_schedule(dataset, collator, batch_size * shard_count,
                               seed=seed)

    def my_slice(entries):
        return entries[shard_index * batch_size:
                       (shard_index + 1) * batch_size]

    if num_workers <= 0:
        for geom, entries in schedule:
            yield _load_scheduled_batch(dataset, collator, my_slice(entries),
                                        geom, transform)
        return

    work = ((seq, geom, my_slice(entries))
            for seq, (geom, entries) in enumerate(schedule))
    results = _worker_pool(work, _synced_worker,
                           [(dataset, collator, transform)] * num_workers,
                           num_workers * 4, num_workers * 4)
    pending: dict = {}
    next_seq = 0
    try:
        for seq, batch in results:
            pending[seq] = batch
            while next_seq in pending:
                yield pending.pop(next_seq)
                next_seq += 1
    finally:
        results.close()


def _process_worker(dataset, collator, batch_size, wseed, transform, idx_q,
                    out_q):
    """Process-pool worker: pulls index chunks, loads and collates whole
    batches, pushes finished batch dicts (after `transform`, if any)."""
    dataset.rng = random.Random(wseed)  # de-correlate random_slice crops
    batcher = _Batcher(collator, batch_size)
    try:
        while True:
            for i in idx_q.get():
                item = dataset[i]
                if item is None:
                    continue
                batch = batcher.add(item)
                if batch is not None:
                    out_q.put(transform(batch) if transform else batch)
    except Exception:
        import traceback

        out_q.put(("__error__", traceback.format_exc()))


def data_loader(dataset: VCDataset, collator: FixedShapeCollator,
                batch_size: int, seed: int = 0, num_workers: int = 0,
                use_processes: bool = True,
                transform=None) -> Iterator[dict]:
    """Infinite shuffled batch iterator with optional background workers:
    processes by default (threads hit the GIL on the numpy load path),
    threads with use_processes=False. The processes are spawned, not
    forked, since the caller holds CUDA and its threads: each gets the
    dataset, collator and `transform` pickled, and runs `transform` on
    each collated batch. Closing the iterator (or dropping it) stops its
    worker processes. Several processes read through
    `synced_data_loader` instead."""
    rng = random.Random(seed)
    order: list[int] = []

    def next_index():
        nonlocal order
        if not order:
            epoch = list(range(len(dataset)))
            rng.shuffle(epoch)
            order = epoch
        return order.pop()

    serial_batcher = _Batcher(collator, batch_size)

    def make_batch():
        while True:
            item = dataset[next_index()]
            if item is None:
                continue
            batch = serial_batcher.add(item)
            if batch is not None:
                return transform(batch) if transform else batch

    if num_workers <= 0:
        while True:
            yield make_batch()

    if use_processes:
        def chunks():   # index handout is trivial: the feeder thread's
            while True:
                yield [next_index() for _ in range(batch_size)]

        yield from _worker_pool(
            chunks(), _process_worker,
            [(dataset, collator, batch_size, seed * 7919 + 1000 + w,
              transform) for w in range(num_workers)],
            num_workers * 4, max(2, num_workers * 2))
        return

    q: queue.Queue = queue.Queue(maxsize=max(2, num_workers * 2))
    lock = threading.Lock()

    def worker():
        batcher = _Batcher(collator, batch_size)
        try:
            while True:
                with lock:  # the lock covers the index handout only
                    idx = next_index()
                item = dataset[idx]
                if item is None:
                    continue
                batch = batcher.add(item)
                if batch is not None:
                    q.put(transform(batch) if transform else batch)
        except Exception:  # propagate through the queue
            import traceback

            q.put(("__error__", traceback.format_exc()))

    for _ in range(num_workers):
        threading.Thread(target=worker, daemon=True).start()
    while True:
        batch = q.get()
        if isinstance(batch, tuple) and batch[0] == "__error__":
            raise RuntimeError(f"data worker failed:\n{batch[1]}")
        yield batch
