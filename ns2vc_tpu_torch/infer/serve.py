"""MicroBatcher: group concurrent inference requests into device batches
(counterpart of ns2vc_tpu/infer/serve.py).

Callers `submit()` clips from any thread and get a Future. A worker thread
drains the queue, groups requests by content-length bucket (so a short
clip is never padded to a long clip's geometry) and dispatches one
`Svc.infer_batch_async` per bucket: when `max_batch` requests of a bucket
wait, when the oldest waiting request has aged `flush_ms`, or on close.
Completer threads run each batch's `finish()` (the readback) and resolve
its futures, so batch N+1 is enqueued on the device while batch N's
readback is outstanding; `max_inflight` bounds the batches in flight. One
refer (target speaker) per MicroBatcher.

Four behaviours differ from the JAX batcher, on purpose:
- After `close()`, the worker evicts this batcher's entries from the Svc's
  device refer cache (`Svc.drop_refer_cache`) once its last dispatch is
  made, so the eviction holds even when close's deadline passes first; the
  JAX batcher leaves them resident.
- `dispatch_log` is a deque of the last `DISPATCH_LOG_LEN` dispatches; the
  JAX list grows without bound.
- `close(timeout)` is one deadline over every join; the JAX batcher gives
  each join the whole timeout.
- `readback_threads > max_inflight` raises ValueError: completers beyond
  the in-flight bound could never have work.
"""

from __future__ import annotations

import collections
import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

# one definition with Svc's padding, so one serve bucket is one geometry
from ns2vc_tpu_torch.infer.svc import _bucket

DISPATCH_LOG_LEN = 1024   # dispatches kept in MicroBatcher.dispatch_log


@dataclass
class _Request:
    content: np.ndarray
    f0: Optional[np.ndarray]
    uv: Optional[np.ndarray]
    future: Future = field(default_factory=Future)
    t_submit: float = field(default_factory=time.monotonic)


class MicroBatcher:
    def __init__(self, svc, refer_mel: np.ndarray,
                 max_batch: int = 16, flush_ms: float = 30.0,
                 bucket_step: int = 64,
                 infer_batch: Optional[Callable] = None,
                 pad_batch: Optional[str] = "pow2",
                 max_inflight: int = 2,
                 readback_threads: int = 1,
                 **infer_kwargs):
        """`svc` is an ns2vc_tpu_torch Svc, or anything exposing
        `infer_batch(clips, refer_mel, f0s=..., uvs=..., **kw) -> list`;
        `infer_batch` overrides it (an override is an opaque synchronous
        call and runs on a completer thread). `infer_kwargs` are forwarded
        per dispatch (sample_method, sampling_timesteps, output='pcm16',
        ...).

        `pad_batch` bounds the set of batch sizes: "pow2" (default) repeats
        the last clip up to the next power of two, "max" pads to
        max_batch, None keeps exact sizes. `max_inflight` bounds
        outstanding device batches (2: dispatch N+1 overlaps readback N).
        `readback_threads` (<= max_inflight) sizes the completer pool.
        `dispatch_log` keeps (n_real, n_dispatched) of the last
        DISPATCH_LOG_LEN dispatches."""
        if pad_batch not in (None, "pow2", "max"):
            raise ValueError(f"pad_batch must be None|'pow2'|'max', "
                             f"got {pad_batch!r}")
        if max_inflight < 1:
            raise ValueError(f"max_inflight must be >= 1, got {max_inflight}")
        if not 1 <= readback_threads <= max_inflight:
            raise ValueError(
                f"readback_threads must be in [1, max_inflight="
                f"{max_inflight}], got {readback_threads}")
        self.svc = svc
        self.refer_mel = refer_mel
        self.max_batch = max_batch
        self.pad_batch = pad_batch
        self.flush_s = flush_ms / 1e3
        self.bucket_step = bucket_step
        self.infer_kwargs = infer_kwargs
        self.dispatch_log: collections.deque = collections.deque(
            maxlen=DISPATCH_LOG_LEN)
        self._infer_sync: Optional[Callable] = None
        self._infer_async: Optional[Callable] = None
        if infer_batch is not None:
            self._infer_sync = infer_batch
        elif hasattr(svc, "infer_batch_async"):
            self._infer_async = svc.infer_batch_async
        else:
            self._infer_sync = svc.infer_batch
        # identity token of this batcher's entries in Svc's refer cache
        self._refer_token = object()
        self._q: queue.Queue = queue.Queue()
        self._done_q: queue.Queue = queue.Queue()
        self._inflight = threading.Semaphore(max_inflight)
        self._pending: dict[int, list[_Request]] = {}
        self._closed = False
        self._stopping = False
        # orders every submit() put before close()'s sentinel put
        self._submit_lock = threading.Lock()
        self._completers = [
            threading.Thread(target=self._complete_loop, daemon=True,
                             name=f"ns2vc-mb-readback-{i}")
            for i in range(readback_threads)]
        for t in self._completers:
            t.start()
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="ns2vc-microbatcher")
        self._worker.start()

    # -- client side ---------------------------------------------------------

    def submit(self, content: np.ndarray, f0: Optional[np.ndarray] = None,
               uv: Optional[np.ndarray] = None) -> Future:
        """Queue one clip ((T, 256) content + optional per-clip f0/uv at
        the mel frame rate). Returns a Future of the waveform (T*hop,)."""
        content = np.asarray(content)
        # validated here so a malformed clip fails only its own caller
        if content.ndim != 2:
            raise ValueError(f"content must be (T, C), got {content.shape}")
        for name, arr in (("f0", f0), ("uv", uv)):
            if arr is not None and np.shape(arr) != (content.shape[0],):
                raise ValueError(f"{name} must be ({content.shape[0]},), "
                                 f"got {np.shape(arr)}")
        req = _Request(content, f0, uv)
        with self._submit_lock:
            if self._closed:
                raise RuntimeError("MicroBatcher is closed")
            self._q.put(req)
        return req.future

    def close(self, timeout: Optional[float] = None):
        """Flush everything queued and stop the threads; the worker evicts
        this batcher's refer from the Svc's cache after its last dispatch.
        `timeout` bounds the whole call, not each join."""
        with self._submit_lock:
            self._closed = True
            self._q.put(None)  # wake the worker
        deadline = None if timeout is None else time.monotonic() + timeout
        for t in [self._worker, *self._completers]:
            t.join(None if deadline is None
                   else max(0.0, deadline - time.monotonic()))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- worker side (batch assembly + device dispatch) ----------------------

    def _oldest_deadline(self) -> Optional[float]:
        t = [reqs[0].t_submit for reqs in self._pending.values() if reqs]
        return (min(t) + self.flush_s) if t else None

    def _absorb(self, items):
        for item in items:
            if item is None:
                self._stopping = True
            else:
                b = _bucket(item.content.shape[0], self.bucket_step)
                self._pending.setdefault(b, []).append(item)

    def _drain(self):
        """Move the whole queue backlog into _pending before any dispatch
        decision, so requests that arrived while this thread was blocked
        coalesce into one batch."""
        items = []
        while True:
            try:
                items.append(self._q.get_nowait())
            except queue.Empty:
                break
        self._absorb(items)

    def _pick_bucket(self) -> Optional[int]:
        """The dispatchable bucket (full, aged out, or flushing for close)
        whose head request has waited longest; None when none is ready."""
        now = time.monotonic()
        best, best_t = None, None
        for b, reqs in self._pending.items():
            if reqs and (len(reqs) >= self.max_batch or self._stopping
                         or reqs[0].t_submit + self.flush_s <= now):
                if best_t is None or reqs[0].t_submit < best_t:
                    best, best_t = b, reqs[0].t_submit
        return best

    def _run(self):
        while True:
            deadline = self._oldest_deadline()
            try:
                wait = (None if deadline is None
                        else max(0.0, deadline - time.monotonic()))
                items = [self._q.get(timeout=wait) if not self._stopping
                         else self._q.get_nowait()]
            except queue.Empty:
                items = []
            self._absorb(items)
            self._drain()

            while True:
                if self._pick_bucket() is None:
                    break
                # claim an in-flight slot before popping the batch, so
                # arrivals during a full pipeline coalesce into it
                self._inflight.acquire()
                self._drain()
                b = self._pick_bucket()
                if b is None:
                    self._inflight.release()
                    break
                reqs = self._pending[b]
                batch, self._pending[b] = (reqs[: self.max_batch],
                                           reqs[self.max_batch:])
                if not self._start(batch):
                    self._inflight.release()
            self._pending = {b: r for b, r in self._pending.items() if r}

            if self._stopping and not self._pending and self._q.empty():
                # no dispatch follows, so none can re-cache the refer
                drop = getattr(self.svc, "drop_refer_cache", None)
                if drop is not None:
                    drop(self._refer_token)
                # one sentinel per completer, after every batch
                for _ in self._completers:
                    self._done_q.put(None)
                return

    def _padded_size(self, n: int) -> int:
        if self.pad_batch == "max":
            return self.max_batch
        if self.pad_batch == "pow2":
            return min(1 << (n - 1).bit_length(), self.max_batch)
        return n

    def _start(self, batch: list[_Request]) -> bool:
        """Assemble and dispatch one batch and hand its readback to the
        completers. False when nothing was handed off."""
        # claim each future, so a late cancel cannot break set_result;
        # cancelled requests drop out here
        batch = [r for r in batch
                 if r.future.set_running_or_notify_cancel()]
        if not batch:
            return False
        use_f0 = any(r.f0 is not None for r in batch)
        try:
            # a mixed batch dispatches as one: missing contours are zeros
            f0s = [r.f0 if r.f0 is not None
                   else np.zeros(r.content.shape[0], np.float32)
                   for r in batch] if use_f0 else None
            uvs = [r.uv for r in batch] if use_f0 else None
            clips = [r.content for r in batch]
            n_real = len(clips)
            n_disp = self._padded_size(n_real)
            if n_disp > n_real:  # repeat the last clip; outputs discarded
                clips = clips + [clips[-1]] * (n_disp - n_real)
                if use_f0:
                    f0s = f0s + [f0s[-1]] * (n_disp - n_real)
                    uvs = uvs + [uvs[-1]] * (n_disp - n_real)
            if self._infer_async is not None:
                finish = self._infer_async(
                    clips, self.refer_mel, f0s=f0s, uvs=uvs,
                    refer_cache_key=self._refer_token, **self.infer_kwargs)
            else:
                call, kw = self._infer_sync, self.infer_kwargs

                def finish(clips=clips, f0s=f0s, uvs=uvs):
                    return call(clips, self.refer_mel, f0s=f0s, uvs=uvs,
                                **kw)
        except Exception as e:  # dispatch-time failure fails this batch
            for r in batch:
                if not r.future.done():
                    r.future.set_exception(e)
            return False
        self.dispatch_log.append((n_real, n_disp))
        self._done_q.put((batch, finish, n_disp))
        return True

    # -- completer side (readback + future resolution) -----------------------

    def _complete_loop(self):
        while True:
            item = self._done_q.get()
            if item is None:
                return
            batch, finish, n_disp = item
            try:
                outs = finish()
                if len(outs) != n_disp:
                    raise RuntimeError(
                        f"infer_batch returned {len(outs)} results for "
                        f"{n_disp} clips")
                for r, out in zip(batch, outs):
                    r.future.set_result(out)
            except Exception as e:  # fail every request of the batch
                for r in batch:
                    if not r.future.done():
                        r.future.set_exception(e)
            finally:
                self._inflight.release()
