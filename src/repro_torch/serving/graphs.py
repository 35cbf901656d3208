"""CUDA graphs of the serving engines' fixed-shape programs.

The JAX package compiles each serving entry point into one device
program (``jax.jit`` of the K-tick decode dispatch, of a prefill chunk,
of the lockstep decode step). The port's counterpart is a CUDA graph: a
:class:`Program` is a function of no arguments that reads and writes
only tensors the engine allocated once (its static buffers: the slot
pool, every leaf of it, rings, (S, z) and an SSD carry and conv tail
alike, a control buffer, a token buffer), so the same device addresses
serve every call. What changes per call is copied into those buffers
before the call, outside the program.

On the card the first call runs the program eagerly, which is the
warm-up ``torch.cuda.graph`` asks for (kernel libraries built and
loaded, lazy initialisation done) and does that call's real work; the
program is then captured into a graph with its own memory pool (capture
runs no kernel), and every later call replays it. On the CPU, or with
graphing off, every call runs the program eagerly: one program either
way, so the CPU tests of the engines test what the card replays.

Python's cyclic garbage collector is run before a capture and kept off
during it: an engine that became garbage in a reference cycle (its
programs refer back to it) holds graphs, and destroying a graph while
another is being captured invalidates that capture.

A value that reaches the program as a Python number is frozen into the
graph at capture, so everything that varies between calls must come from
a static buffer; constants of the engine (temperature, seed, shapes) may
be Python values. A failed capture or replay raises: there is no eager
fallback on the card.

The kernel wrappers count their launches in ``kernels._build.LAUNCHES``
when they are called, which a replay does not do: a capture records the
launches its program made (and takes them back, since capture runs
nothing), and every replay adds them.
"""
from __future__ import annotations

import gc
import time
from typing import Callable

import torch

from repro_torch.kernels import _build


class Program:
    """``fn()`` over static buffers, replayed as one CUDA graph on the
    card after its first, eager call."""

    def __init__(self, fn: Callable[[], object], device: torch.device, *,
                 graphed: bool = True):
        self.fn = fn
        self.graphed = graphed and device.type == "cuda"
        self.graph: torch.cuda.CUDAGraph | None = None
        self.out = None                       # the graph's output tensors
        self.launches: dict[str, int] = {}    # per replay, from the capture
        self.capture_s: float | None = None

    @property
    def captured(self) -> bool:
        return self.graph is not None

    def __call__(self):
        """The program's outputs. After capture they are the graph's own
        tensors, which the next call overwrites."""
        if self.graph is None:
            out = self.fn()
            if self.graphed:
                self._capture()
            return out
        self.graph.replay()
        for name, n in self.launches.items():
            _build.LAUNCHES[name] += n
        return self.out

    def _capture(self) -> None:
        before = dict(_build.LAUNCHES)
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        gc.collect()
        enabled = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph):
                self.out = self.fn()
        finally:
            if enabled:
                gc.enable()
        self.capture_s = time.perf_counter() - t0
        self.launches = {k: n - before[k] for k, n in _build.LAUNCHES.items()
                         if n != before[k]}
        _build.LAUNCHES.update(before)
        self.graph = graph
