"""Device programs captured as CUDA graphs: Svc's serving programs and the
Trainer's step and eval programs.

A program is a body of device work over static buffers, keyed by what the
work depends on. On a card its first call runs the body eagerly on the
owner's side stream (the warm-up, which fills what is lazy: the kernel
build, packed weights and their tensor maps, cuFFT plans, cuBLAS handles,
the optimizer's state), then captures it as a CUDA graph on the same
stream in thread-local capture mode (other threads may synchronise events
meanwhile, as the MicroBatcher's completers do); every later call replays
the graph. The graphs of one owner share one memory pool. A failed capture
raises and leaves a new pool for the next one: PyTorch's allocator takes
no further capture into the failed one. Random draws inside a body come
from generators registered with the graph, which a replay reads at their
current seed and offset.

The kernels' launch and backward counters, and the collectives' calls and
bytes (`parallel/mesh.py`), count a replay's work: a capture takes its own
counts off (it launches nothing) and each replay adds them back.
"""

from __future__ import annotations

import ctypes
import gc
import time
from typing import Callable, Optional

import torch

from ns2vc_tpu_torch.ops import flash_attention as _k1_ops
from ns2vc_tpu_torch.ops import fused_resnet as _k2_ops
from ns2vc_tpu_torch.parallel import mesh as _mesh

# the kernels' wrappers and the collectives, each with its counters
_COUNTED_OPS = (_k1_ops, _k2_ops, _mesh)


def launch_counts() -> list:
    return [ops.launch_counts() for ops in _COUNTED_OPS]


def add_launch_counts(counts: list, times: int = 1) -> None:
    for ops, delta in zip(_COUNTED_OPS, counts):
        ops.add_launch_counts(delta, times)


def graph_nodes(graph: torch.cuda.CUDAGraph) -> int:
    """The node count of a graph captured with keep_graph=True (libcuda's
    cuGraphGetNodes)."""
    get_nodes = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes
    get_nodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                          ctypes.POINTER(ctypes.c_size_t)]
    get_nodes.restype = ctypes.c_int
    n = ctypes.c_size_t(0)
    err = get_nodes(graph.raw_cuda_graph(), None, ctypes.byref(n))
    if err != 0:
        raise RuntimeError(f"cuGraphGetNodes returned CUresult {err}")
    return n.value


class GraphProgram:
    """One program: its key, the static device buffers its body reads
    (`static`) and, on a card, the CUDA graph captured over them, its
    static output, the launch counts one replay adds, the replays made, the
    capture's host time and the graph's node count."""

    def __init__(self, key, static: dict):
        self.key, self.static = key, static
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.out = None
        self.counts: Optional[list] = None
        self.replays = 0
        self.capture_ms: Optional[float] = None
        self.nodes: Optional[int] = None

    def replay(self):
        """Launch the graph on the current stream; its static output."""
        self.graph.replay()
        add_launch_counts(self.counts)
        self.replays += 1
        return self.out


class GraphCapturer:
    """The side stream one owner's programs are captured on and the memory
    pool their graphs share, both made at the first capture."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream: Optional[torch.cuda.Stream] = None
        self.pool = None

    def reset(self) -> None:
        """The next capture starts a new pool (the owner dropped its
        graphs)."""
        self.pool = None

    def capture(self, prog: GraphProgram, body: Callable, what: str,
                generators: tuple = ()):
        """A program's first call: `body()` run eagerly on the side stream
        (the warm-up, launched and counted), then captured into the shared
        pool with `generators` registered; sets the program's graph, static
        output and counts, and returns the warm-up's output. Raises if the
        capture fails."""
        if self.stream is None:
            self.stream = torch.cuda.Stream(self.device)
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        cur, side = torch.cuda.current_stream(self.device), self.stream
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            warm = body()
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            for gen in generators:
                graph.register_generator_state(gen)
            before = launch_counts()
            # a garbage collection inside the capture would destroy earlier
            # programs' unreachable graphs and generators from the capturing
            # thread, which invalidates the capture: collect before, none
            # during
            gc.collect()
            collecting = gc.isenabled()
            gc.disable()
            try:
                t0 = time.perf_counter()
                graph.capture_begin(pool=self.pool,
                                    capture_error_mode="thread_local")
                try:
                    out = body()
                except BaseException as e:
                    try:
                        graph.capture_end()
                    except RuntimeError:
                        # an invalidated capture ends with an error before
                        # the allocator stops routing to the pool: stop it
                        torch._C._cuda_endAllocateToPool(self.device.index,
                                                         self.pool)
                    # the allocator refuses any later capture into this
                    # pool: the next program starts a new one
                    self.pool = torch.cuda.graph_pool_handle()
                    raise RuntimeError(f"{what} {prog.key}: capture failed: "
                                       f"{e}") from e
                finally:
                    counts = [{k: a[k] - b[k] for k in a}
                              for a, b in zip(launch_counts(), before)]
                    add_launch_counts(counts, -1)
                graph.capture_end()
            finally:
                if collecting:
                    gc.enable()
            prog.nodes = graph_nodes(graph)
            graph.instantiate()
            prog.capture_ms = (time.perf_counter() - t0) * 1e3
        cur.wait_stream(side)
        prog.graph, prog.out, prog.counts = graph, out, counts
        return warm
