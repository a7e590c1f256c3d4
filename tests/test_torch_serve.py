"""The port's MicroBatcher (ns2vc_tpu_torch/infer/serve.py).

The scenarios of the JAX batcher's suite (tests/test_serve.py) run against
the port's batcher with the same fake backends: grouping up to max_batch,
flush on age, per-bucket isolation, order/result mapping, mixed-f0 zero
fill, error propagation, close() draining, batch padding, the
dispatch/readback pipeline and the readback pool. Then one test per
behaviour the port fixes relative to the JAX batcher (each fails on the
JAX batcher, which the test also runs where it can), and a real dispatch
through the port's Svc on the tiny configuration on the CPU. No tolerance
applies: the fake backends' outputs are exact, and the real Svc's pcm16
output is compared with its float output quantised on the host, to 1 LSB.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest
import torch

from ns2vc_tpu.infer.serve import MicroBatcher as JaxMicroBatcher
from ns2vc_tpu_torch.infer.serve import MicroBatcher


class FakeSvc:
    """Records every dispatched batch; returns per-clip identifiable
    waveforms (first content value echoed). `entered` is set when a
    dispatch reaches the backend; an optional `gate` event blocks the
    dispatch until the test releases it (deterministic overload, no
    wall-clock sleeps)."""

    def __init__(self, delay_s: float = 0.0, fail: bool = False):
        self.calls = []
        self.delay_s = delay_s
        self.fail = fail
        self.lock = threading.Lock()
        self.entered = threading.Event()
        self.gate = None

    def infer_batch(self, clips, refer_mel, f0s=None, uvs=None, **kw):
        with self.lock:
            self.calls.append({"sizes": [c.shape[0] for c in clips],
                               "f0s": f0s, "kw": kw})
        self.entered.set()
        if self.gate is not None:
            assert self.gate.wait(timeout=10)
        if self.delay_s:
            time.sleep(self.delay_s)
        if self.fail:
            raise RuntimeError("backend exploded")
        return [np.full(c.shape[0] * 4, c[0, 0], np.float32) for c in clips]


class FakeAsyncSvc:
    """Backend exposing the split dispatch/readback API
    (Svc.infer_batch_async): dispatch returns instantly, the finish
    closure blocks on `finish_gate` — lets tests observe dispatch N+1
    happening while readback N is still in flight."""

    def __init__(self):
        self.dispatched = []
        self.finish_gate = threading.Event()
        # released once per finish() ENTRY (before blocking on the gate):
        # lets tests count how many readbacks are concurrently in flight
        self.finish_entered = threading.Semaphore(0)
        self.lock = threading.Lock()

    def infer_batch_async(self, clips, refer_mel, f0s=None, uvs=None, **kw):
        with self.lock:
            self.dispatched.append([c.shape[0] for c in clips])

        def finish():
            self.finish_entered.release()
            assert self.finish_gate.wait(timeout=10)
            return [np.full(c.shape[0] * 4, c[0, 0], np.float32)
                    for c in clips]

        return finish


def make_clip(t, value=1.0):
    return np.full((t, 256), value, np.float32)


REFER = np.zeros((80, 100), np.float32)


class TestMicroBatcher:
    def test_groups_into_one_batch(self):
        svc = FakeSvc(delay_s=0.05)
        with MicroBatcher(svc, REFER, max_batch=8, flush_ms=200) as mb:
            futs = [mb.submit(make_clip(100, i)) for i in range(8)]
            outs = [f.result(timeout=10) for f in futs]
        assert len(svc.calls) == 1
        assert svc.calls[0]["sizes"] == [100] * 8
        for i, out in enumerate(outs):  # order preserved
            assert out.shape == (400,) and out[0] == i

    def test_flush_on_age_under_low_load(self):
        svc = FakeSvc()
        with MicroBatcher(svc, REFER, max_batch=16, flush_ms=30) as mb:
            fut = mb.submit(make_clip(64))
            out = fut.result(timeout=10)  # dispatched alone after ~30 ms
        assert out.shape == (256,)
        assert len(svc.calls) == 1 and svc.calls[0]["sizes"] == [64]

    def test_buckets_are_isolated(self):
        # a 40-frame and a 500-frame clip must not share a padded geometry
        svc = FakeSvc()
        with MicroBatcher(svc, REFER, max_batch=2, flush_ms=20) as mb:
            f1 = mb.submit(make_clip(40, 1.0))
            f2 = mb.submit(make_clip(500, 2.0))
            r1, r2 = f1.result(timeout=10), f2.result(timeout=10)
        assert sorted(c["sizes"][0] for c in svc.calls) == [40, 500]
        assert len(svc.calls) == 2
        assert r1[0] == 1.0 and r2[0] == 2.0

    def test_max_batch_splits(self):
        svc = FakeSvc(delay_s=0.05)
        with MicroBatcher(svc, REFER, max_batch=4, flush_ms=500) as mb:
            futs = [mb.submit(make_clip(100, i)) for i in range(10)]
            outs = [f.result(timeout=10) for f in futs]
        sizes = sorted(len(c["sizes"]) for c in svc.calls)
        assert sum(sizes) == 10 and max(sizes) <= 4
        assert [o[0] for o in outs] == list(range(10))

    def test_backlog_coalesces_under_overload(self):
        """Requests that queue up while the pipeline is full must come out
        as ONE batch, even though each is already older than flush_ms when
        the worker next gets a slot. Regression: the worker used to move a
        single request per loop iteration from the queue to the pending
        table, so an expired flush deadline always met exactly one pending
        request — measured mean_batch 1.0 at 90 clips/s offered
        (scripts/bench_serving.py, round 4). Deterministic via the
        backend gate (no wall-clock races): the first dispatch is held
        inside the backend until all 8 backlog submits are queued."""
        svc = FakeSvc()
        svc.gate = threading.Event()
        with MicroBatcher(svc, REFER, max_batch=16, flush_ms=10,
                          max_inflight=1) as mb:
            first = mb.submit(make_clip(100, 99.0))  # fills the pipeline
            assert svc.entered.wait(timeout=10)
            futs = [mb.submit(make_clip(100, i)) for i in range(8)]
            svc.gate.set()  # release dispatch 1; backlog coalesces
            assert first.result(timeout=10)[0] == 99.0
            outs = [f.result(timeout=10) for f in futs]
        assert [o[0] for o in outs] == list(range(8))
        assert sorted(len(c["sizes"]) for c in svc.calls) == [1, 8]

    def test_mixed_f0_zero_fill(self):
        svc = FakeSvc()
        with MicroBatcher(svc, REFER, max_batch=2, flush_ms=200) as mb:
            f1 = mb.submit(make_clip(100, 1.0), f0=np.full(100, 220.0))
            f2 = mb.submit(make_clip(100, 2.0))  # no f0
            f1.result(timeout=10), f2.result(timeout=10)
        (call,) = svc.calls
        assert call["f0s"] is not None and len(call["f0s"]) == 2
        assert call["f0s"][0][0] == 220.0
        assert np.all(call["f0s"][1] == 0.0)

    def test_error_propagates_to_every_future(self):
        svc = FakeSvc(fail=True)
        with MicroBatcher(svc, REFER, max_batch=2, flush_ms=50) as mb:
            futs = [mb.submit(make_clip(100)) for _ in range(2)]
            for f in futs:
                with pytest.raises(RuntimeError, match="backend exploded"):
                    f.result(timeout=10)

    def test_close_drains_pending(self):
        svc = FakeSvc()
        mb = MicroBatcher(svc, REFER, max_batch=16, flush_ms=10_000)
        futs = [mb.submit(make_clip(100, i)) for i in range(3)]
        mb.close(timeout=10)  # flush without waiting 10 s
        assert [f.result(timeout=0)[0] for f in futs] == [0, 1, 2]
        with pytest.raises(RuntimeError, match="closed"):
            mb.submit(make_clip(100))

    def test_pow2_batch_padding(self):
        """A 3-request flush dispatches as 4 clips (last repeated) so only
        power-of-two batch geometries ever compile; padded outputs are
        discarded and real results map in order."""
        svc = FakeSvc(delay_s=0.05)
        with MicroBatcher(svc, REFER, max_batch=16, flush_ms=30) as mb:
            futs = [mb.submit(make_clip(100, i)) for i in range(3)]
            outs = [f.result(timeout=10) for f in futs]
        (call,) = svc.calls
        assert len(call["sizes"]) == 4  # 3 -> next pow2
        assert [o[0] for o in outs] == [0, 1, 2]

    def test_pow2_padding_extends_f0(self):
        svc = FakeSvc(delay_s=0.05)
        with MicroBatcher(svc, REFER, max_batch=16, flush_ms=30) as mb:
            futs = [mb.submit(make_clip(100, i), f0=np.full(100, 100.0 + i))
                    for i in range(3)]
            [f.result(timeout=10) for f in futs]
        (call,) = svc.calls
        assert len(call["f0s"]) == 4
        assert call["f0s"][3][0] == 102.0  # last contour repeated

    def test_pad_to_max_batch(self):
        svc = FakeSvc()
        with MicroBatcher(svc, REFER, max_batch=8, flush_ms=30,
                          pad_batch="max") as mb:
            out = mb.submit(make_clip(64, 5.0)).result(timeout=10)
        assert len(svc.calls[0]["sizes"]) == 8
        assert out[0] == 5.0

    def test_pad_batch_none_keeps_exact_sizes(self):
        svc = FakeSvc(delay_s=0.05)
        with MicroBatcher(svc, REFER, max_batch=16, flush_ms=30,
                          pad_batch=None) as mb:
            futs = [mb.submit(make_clip(100, i)) for i in range(3)]
            [f.result(timeout=10) for f in futs]
        assert svc.calls[0]["sizes"] == [100, 100, 100]

    def test_invalid_pad_batch_rejected(self):
        with pytest.raises(ValueError, match="pad_batch"):
            MicroBatcher(FakeSvc(), REFER, pad_batch="pow3")

    def test_oldest_bucket_dispatches_first(self):
        """When several buckets are dispatchable, the one whose head
        request has waited longest goes first — a hot small-clip bucket
        must not starve long clips while the pipeline is the
        bottleneck."""
        svc = FakeSvc()
        svc.gate = threading.Event()
        with MicroBatcher(svc, REFER, max_batch=16, flush_ms=10,
                          max_inflight=1, pad_batch=None) as mb:
            hold = mb.submit(make_clip(100, 0.0))  # fills the pipeline
            assert svc.entered.wait(timeout=10)
            f_long = mb.submit(make_clip(500, 1.0))   # older, big bucket
            time.sleep(0.05)
            f_short = mb.submit(make_clip(40, 2.0))   # newer, small bucket
            time.sleep(0.05)  # both now older than flush_ms
            svc.gate.set()
            assert hold.result(timeout=10)[0] == 0.0
            assert f_long.result(timeout=10)[0] == 1.0
            assert f_short.result(timeout=10)[0] == 2.0
        sizes = [c["sizes"][0] for c in svc.calls]
        # the 500-frame head waited longer than the 40-frame one
        assert sizes == [100, 500, 40]

    def test_pipeline_overlaps_dispatch_and_readback(self):
        """With max_inflight=2, batch N+1 must DISPATCH while batch N's
        readback is still blocked — the round-5 serving pipeline (VERDICT
        r4 weak #2: dispatch and readback used to serialize on one
        thread, saturating at ~21 clips/s vs ~105 device-possible)."""
        svc = FakeAsyncSvc()
        with MicroBatcher(svc, REFER, max_batch=1, flush_ms=5,
                          pad_batch=None, max_inflight=2) as mb:
            f1 = mb.submit(make_clip(64, 1.0))
            f2 = mb.submit(make_clip(64, 2.0))
            deadline = time.monotonic() + 10
            while len(svc.dispatched) < 2 and time.monotonic() < deadline:
                time.sleep(0.005)
            # both dispatched; neither readback has completed yet
            assert len(svc.dispatched) == 2
            assert not f1.done() and not f2.done()
            svc.finish_gate.set()
            assert f1.result(timeout=10)[0] == 1.0
            assert f2.result(timeout=10)[0] == 2.0

    def test_max_inflight_bounds_outstanding_batches(self):
        """max_inflight=1 must serialize: the second dispatch cannot start
        until the first readback completes."""
        svc = FakeAsyncSvc()
        with MicroBatcher(svc, REFER, max_batch=1, flush_ms=5,
                          pad_batch=None, max_inflight=1) as mb:
            f1 = mb.submit(make_clip(64, 1.0))
            f2 = mb.submit(make_clip(64, 2.0))
            time.sleep(0.3)  # generous window for a (buggy) 2nd dispatch
            assert len(svc.dispatched) == 1
            svc.finish_gate.set()
            assert f1.result(timeout=10)[0] == 1.0
            assert f2.result(timeout=10)[0] == 2.0
        assert len(svc.dispatched) == 2

    def test_dispatch_log_records_real_and_padded(self):
        svc = FakeSvc(delay_s=0.02)
        with MicroBatcher(svc, REFER, max_batch=16, flush_ms=30) as mb:
            futs = [mb.submit(make_clip(100, i)) for i in range(3)]
            [f.result(timeout=10) for f in futs]
            assert list(mb.dispatch_log) == [(3, 4)]  # pow2-padded

    def test_invalid_max_inflight_rejected(self):
        with pytest.raises(ValueError, match="max_inflight"):
            MicroBatcher(FakeSvc(), REFER, max_inflight=0)

    def test_invalid_readback_threads_rejected(self):
        with pytest.raises(ValueError, match="readback_threads"):
            MicroBatcher(FakeSvc(), REFER, readback_threads=0)

    def test_readback_pool_overlaps_readbacks(self):
        """readback_threads=2 must let TWO batches' readbacks block
        concurrently (each on its own completer thread) — the lever past
        the single-completer serializer (with readback_threads=1, batch
        N+1's finish() is not entered until batch N's returns)."""
        svc = FakeAsyncSvc()
        with MicroBatcher(svc, REFER, max_batch=1, flush_ms=5,
                          pad_batch=None, max_inflight=2,
                          readback_threads=2) as mb:
            f1 = mb.submit(make_clip(64, 1.0))
            f2 = mb.submit(make_clip(64, 2.0))
            # both readbacks entered while both still block on the gate
            assert svc.finish_entered.acquire(timeout=10)
            assert svc.finish_entered.acquire(timeout=10)
            assert not f1.done() and not f2.done()
            svc.finish_gate.set()
            assert f1.result(timeout=10)[0] == 1.0
            assert f2.result(timeout=10)[0] == 2.0

    def test_single_readback_thread_serializes_readbacks(self):
        """Control for the pool test: with the default single completer,
        the second batch DISPATCHES (max_inflight=2) but its readback is
        not entered while the first one blocks."""
        svc = FakeAsyncSvc()
        with MicroBatcher(svc, REFER, max_batch=1, flush_ms=5,
                          pad_batch=None, max_inflight=2,
                          readback_threads=1) as mb:
            f1 = mb.submit(make_clip(64, 1.0))
            f2 = mb.submit(make_clip(64, 2.0))
            assert svc.finish_entered.acquire(timeout=10)
            assert not svc.finish_entered.acquire(timeout=0.2)
            svc.finish_gate.set()
            assert f1.result(timeout=10)[0] == 1.0
            assert f2.result(timeout=10)[0] == 2.0

    def test_readback_pool_close_drains(self):
        """close() must flush pending work through every completer and
        join the whole pool (one sentinel per thread)."""
        svc = FakeSvc()
        mb = MicroBatcher(svc, REFER, max_batch=16, flush_ms=10_000,
                          max_inflight=3, readback_threads=3)
        futs = [mb.submit(make_clip(100, i)) for i in range(3)]
        mb.close(timeout=10)
        assert [f.result(timeout=0)[0] for f in futs] == [0, 1, 2]
        assert all(not t.is_alive() for t in mb._completers)

    def test_infer_kwargs_forwarded(self):
        svc = FakeSvc()
        with MicroBatcher(svc, REFER, max_batch=1, flush_ms=50,
                          sampling_timesteps=7, sample_method="ddim") as mb:
            mb.submit(make_clip(64)).result(timeout=10)
        assert svc.calls[0]["kw"] == {"sampling_timesteps": 7,
                                      "sample_method": "ddim"}


class TestMicroBatcherRobustness:
    def test_cancelled_future_does_not_poison_batch(self):
        """A client-side cancel before dispatch must not stop the other
        co-batched requests from resolving (futures are claimed RUNNING
        at dispatch; cancelled ones drop out)."""
        svc = FakeSvc()
        with MicroBatcher(svc, REFER, max_batch=4, flush_ms=100) as mb:
            futs = [mb.submit(make_clip(100, i)) for i in range(3)]
            assert futs[1].cancel()
            outs = [futs[i].result(timeout=10) for i in (0, 2)]
        assert outs[0][0] == 0 and outs[1][0] == 2
        assert futs[1].cancelled()
        assert svc.calls[0]["sizes"] == [100, 100]  # cancelled one dropped

    def test_malformed_clip_rejected_at_submit(self):
        """Shape validation happens in submit() so one bad clip fails only
        its own caller, never a whole co-batched dispatch."""
        svc = FakeSvc()
        with MicroBatcher(svc, REFER, max_batch=4, flush_ms=50) as mb:
            with pytest.raises(ValueError, match="content"):
                mb.submit(np.zeros(100, np.float32))  # 1-D
            with pytest.raises(ValueError, match="f0"):
                mb.submit(make_clip(100), f0=np.zeros(7, np.float32))
            out = mb.submit(make_clip(100, 5.0)).result(timeout=10)
        assert out[0] == 5.0 and not svc.calls[0].get("f0s")

    def test_submit_after_close_raises(self):
        svc = FakeSvc()
        mb = MicroBatcher(svc, REFER, max_batch=4, flush_ms=50)
        mb.close()
        with pytest.raises(RuntimeError, match="closed"):
            mb.submit(make_clip(100))


# -- the four behaviours that differ from the JAX batcher --------------------

class RecordingAsyncSvc(FakeAsyncSvc):
    """FakeAsyncSvc with a refer cache keyed like Svc's."""

    def __init__(self):
        super().__init__()
        self.finish_gate.set()
        self.cache = {}

    def infer_batch_async(self, clips, refer_mel, refer_cache_key=None,
                          **kw):
        self.cache[(refer_cache_key, len(clips))] = refer_mel
        return super().infer_batch_async(clips, refer_mel, **kw)

    def drop_refer_cache(self, cache_key):
        for k in [k for k in self.cache if k[0] is cache_key]:
            del self.cache[k]


class TestPortFixes:
    def test_close_evicts_the_refer_cache(self):
        for cls, left in ((MicroBatcher, 0), (JaxMicroBatcher, 1)):
            svc = RecordingAsyncSvc()
            with cls(svc, REFER, max_batch=2, flush_ms=5) as mb:
                mb.submit(make_clip(64)).result(timeout=10)
                assert len(svc.cache) == 1
            assert len(svc.cache) == left, cls

    def test_close_past_its_deadline_still_evicts_the_refer_cache(self):
        """close(timeout) returns while the worker is still inside a slow
        dispatch, which caches the refer after close returned; the entry
        must not outlive the worker."""
        svc = RecordingAsyncSvc()
        entered, gate = threading.Event(), threading.Event()
        dispatch = svc.infer_batch_async

        def slow(clips, refer_mel, **kw):
            entered.set()
            assert gate.wait(timeout=10)
            return dispatch(clips, refer_mel, **kw)
        svc.infer_batch_async = slow
        mb = MicroBatcher(svc, REFER, max_batch=1, flush_ms=1)
        fut = mb.submit(make_clip(64, 3))
        assert entered.wait(timeout=10)
        mb.close(timeout=0.05)
        assert mb._worker.is_alive()
        gate.set()
        assert fut.result(timeout=10)[0] == 3
        mb._worker.join(timeout=10)
        assert not mb._worker.is_alive()
        assert not svc.cache

    def test_dispatch_log_is_bounded(self, monkeypatch):
        from ns2vc_tpu_torch.infer import serve

        monkeypatch.setattr(serve, "DISPATCH_LOG_LEN", 4)
        svc = FakeSvc()
        for cls in (MicroBatcher, JaxMicroBatcher):
            with cls(svc, REFER, max_batch=1, flush_ms=1) as mb:
                for i in range(10):
                    mb.submit(make_clip(64, i)).result(timeout=10)
                log = list(mb.dispatch_log)
            if cls is MicroBatcher:
                assert log == [(1, 1)] * 4
            else:
                assert len(log) == 10   # the JAX list keeps every entry

    def test_close_timeout_is_one_deadline(self):
        def run(cls):
            svc = FakeAsyncSvc()            # every readback blocks
            mb = cls(svc, REFER, max_batch=1, flush_ms=1, pad_batch=None,
                     max_inflight=3, readback_threads=3)
            futs = [mb.submit(make_clip(64, i)) for i in range(3)]
            for _ in range(3):
                assert svc.finish_entered.acquire(timeout=10)
            t0 = time.monotonic()
            mb.close(timeout=0.3)
            took = time.monotonic() - t0
            svc.finish_gate.set()
            assert [f.result(timeout=10)[0] for f in futs] == [0, 1, 2]
            for t in mb._completers:
                t.join(timeout=10)
                assert not t.is_alive()
            return took
        assert run(MicroBatcher) < 0.6
        assert run(JaxMicroBatcher) >= 0.85   # 0.3 s per blocked join

    def test_more_readback_threads_than_inflight_is_rejected(self):
        with pytest.raises(ValueError, match="readback_threads"):
            MicroBatcher(FakeSvc(), REFER, max_inflight=2, readback_threads=3)
        JaxMicroBatcher(FakeSvc(), REFER, max_inflight=2,
                        readback_threads=3).close(timeout=10)


# -- a real Svc on the CPU ----------------------------------------------------

@pytest.fixture(scope="module")
def tiny_svc():
    from ns2vc_tpu_torch.convert import init_params, init_vocos_params
    from ns2vc_tpu_torch.infer.svc import Svc
    from test_torch_slice import VOCOS_KW, tiny_config

    cfg = tiny_config(hop_length=VOCOS_KW["hop_length"])
    g = torch.Generator().manual_seed(0)
    return Svc(config=cfg, params=init_params(cfg, g),
               vocos_params=init_vocos_params(g, **VOCOS_KW), device="cpu")


def test_real_svc_batches_and_evicts(tiny_svc):
    hop = tiny_svc.hop_size
    r = np.random.default_rng(0)
    refer = r.standard_normal((24, 100)).astype(np.float32)
    clip = r.standard_normal((32, 256)).astype(np.float32)
    with MicroBatcher(tiny_svc, refer, max_batch=2, flush_ms=5_000,
                      sampling_timesteps=3) as mb:
        f1, f2 = mb.submit(clip), mb.submit(clip * 0.5)
        out1, out2 = f1.result(timeout=300), f2.result(timeout=300)
        assert len(tiny_svc._refer_cache) == 1
        assert list(mb.dispatch_log) == [(2, 2)]
    assert not tiny_svc._refer_cache
    assert out1.shape == out2.shape == (32 * hop,)
    assert np.isfinite(out1).all() and np.isfinite(out2).all()
    with MicroBatcher(tiny_svc, refer, max_batch=2, flush_ms=5_000,
                      sampling_timesteps=3, output="pcm16") as mb:
        q = mb.submit(clip).result(timeout=300)
    assert q.dtype == np.int16 and q.shape == (32 * hop,)
    expect = np.clip(np.round(out1.astype(np.float64) * 32767.0),
                     -32768, 32767).astype(np.int32)
    assert np.max(np.abs(q.astype(np.int32) - expect)) <= 1
    assert not tiny_svc._refer_cache


def test_svc_async_finish_on_cpu_has_no_event(tiny_svc):
    refer = np.zeros((20, 100), np.float32)
    clips = [np.zeros((n, 256), np.float32) for n in (10, 30)]
    finish = tiny_svc.infer_batch_async(clips, refer, sampling_timesteps=3,
                                        refer_cache_key="k")
    assert finish.done is None
    outs = finish()
    assert [o.shape for o in outs] == [(10 * tiny_svc.hop_size,),
                                       (30 * tiny_svc.hop_size,)]
    assert list(tiny_svc._refer_cache) == [("k", 2, 64)]
    tiny_svc.drop_refer_cache("k")
    assert not tiny_svc._refer_cache


def test_cuda_device_resolves_to_an_index(monkeypatch):
    """'cuda' becomes the card current at construction, so a thread whose
    own current device differs still reaches the same card."""
    from ns2vc_tpu_torch.infer.svc import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    assert resolve_device("cuda") == torch.device("cuda", 1)
    assert resolve_device("cuda:0") == torch.device("cuda", 0)
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
