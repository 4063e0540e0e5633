"""Captured CUDA graphs of the sentence programs, and their cache.

The counterpart of the JAX package's compiled programs and its JIT
caches. There, a whole sentence is one compiled device program (embed,
prefill, the ``lax.while_loop`` decode, the SoVITS latent and the
HiFi-GAN vocode; a slot segment is one ``jax.jit``), compiled once per
static geometry. Here each program is a step function over STATIC
buffers: every value that changes between runs (the decode step, the
write row, the ring head, the flow noise, the valid lengths) lives in
device memory and is advanced by the program itself, so the program is
captured once per geometry as a CUDA graph and then replayed:

* :class:`Graph` holds one program's static buffers, its lock and, on the
  card, its captured graph. A caller takes the lock, copies its inputs
  into the buffers, calls :meth:`Graph.run` (a capture on the first run,
  a replay after) as often as it needs, and copies the outputs out
  before it lets go of the lock.
* :class:`GraphCache` keys the graphs of ONE parameter set (a captured
  graph reads its weights by address) on their static geometry, and
  counts hits, misses, variants and captures; :func:`cache_for` finds a
  parameter set's cache. ``runtime/engine.py::TTSEngine.warmup(..., sweep=True)``
  captures every key that serving can reach before traffic arrives.

A capture first runs the program once on the device's capture stream
(lazy work: kernel builds, library handles, convolution plans), puts the
buffers back as they were, then captures it on that stream. A program
over tp shards (``parallel/tp.py``) forks each shard's work onto a capture
stream of that tp rank's own (:func:`shard_stream`) and joins it back at
each reduction, in the warm-up run and in the capture: one graph per dp
row, replayed on the row's lead device. Its buffers and shards may span
several cards: the capture's memory on each card other than the lead
comes from a pool of the graph's own on that card, held as long as the
graph. Each graph of a T2S set (a decode geometry)
captures its programs in a private memory pool, which its variants share
(its lock runs them one at a time), so graphs that different threads
replay at once never share memory. A SoVITS set's graphs (the latent and vocode
programs: a hundred or more per set, whose activations reach hundreds of
MB at the largest buckets) form one FAMILY: they share one pool and one
lock, so they replay one at a time, each from its inputs' copy in to its
outputs' copy out, and the pool holds the largest program's temporaries
once instead of every program's. A program keeps nothing in its pool
between runs (its outputs are static buffers, made outside any capture),
so family members may replay in any order. A program writes only its
graph's static buffers (the fused kernel's output row and scratch
included), so a capture may run beside other threads' replays.
The kernel wrappers' launches made while capturing go to the graph's
record and are added to the wrappers' counts on every replay
(``ops/_build.py``), so a count is the number of kernel executions. A capture that fails raises;
nothing falls back to running eagerly. On the CPU there is no graph: the
program runs eagerly on the same buffers, with the same keys and counts.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import weakref
from typing import Callable, Dict, Hashable, List, Optional

import torch

from ..ops import _build

# one capture at a time: a capture synchronizes the card and swaps the
# allocator's pool for its stream
_capture_lock = threading.Lock()
# the stream every capture (and its warm-up run) of a device runs on: the
# allocator reuses a pool's freed blocks only on the stream that freed
# them, so captures that share a pool (a graph's variants, a family) must
# share one stream
_capture_streams: Dict[torch.device, "torch.cuda.Stream"] = {}
# the capture stream of each tp rank on its device (:func:`shard_stream`)
_shard_streams: Dict[tuple, "torch.cuda.Stream"] = {}
# set on the capturing thread for a warm-up run and a capture
_capturing = threading.local()


def shard_stream(rank: int, dev: torch.device) -> "Optional[torch.cuda.Stream]":
    """The capture stream of tp rank ``rank`` on ``dev`` while this thread
    runs a capture (or its warm-up run) and ``dev`` is a card; None
    otherwise (the shard's work then runs on the device's current
    stream). One per rank, not one per device: on a mesh that repeats a
    card, the shards' work still forks and joins."""
    if dev.type != "cuda" or not getattr(_capturing, "on", False):
        return None
    key = (dev, rank)
    s = _shard_streams.get(key)
    if s is None:
        s = _shard_streams[key] = torch.cuda.Stream(dev)
    return s


@contextlib.contextmanager
def _capturing_on():
    _capturing.on = True
    try:
        yield
    finally:
        _capturing.on = False


@contextlib.contextmanager
def on_device_stream(dev: torch.device):
    """Make ``dev`` current, its work ordered with the current stream of
    the card that was current: ``dev``'s current stream waits for it on
    entry, and it waits for ``dev``'s on exit. The copies into and out of
    a graph's buffers on another card than the lead go through this (a
    replay runs on the lead card's current stream). Nothing on the CPU or
    on the current card."""
    if dev.type != "cuda" or dev == torch.device("cuda", torch.cuda.current_device()):
        yield
        return
    here, there = torch.cuda.current_stream(), torch.cuda.current_stream(dev)
    there.wait_stream(here)
    with torch.cuda.device(dev):
        yield
    here.wait_stream(there)


def tensors_of(obj) -> List[torch.Tensor]:
    """Every tensor in a buffer object: a dataclass, a dict, a list or a
    tuple, nested."""
    out: List[torch.Tensor] = []

    def walk(o):
        if isinstance(o, torch.Tensor):
            out.append(o)
        elif dataclasses.is_dataclass(o) and not isinstance(o, type):
            for f in dataclasses.fields(o):
                walk(getattr(o, f.name))
        elif isinstance(o, dict):
            for v in o.values():
                walk(v)
        elif isinstance(o, (list, tuple)):
            for v in o:
                walk(v)

    walk(obj)
    return out


class Graph:
    """One program over its static buffers ``static``.

    ``lock`` (the family's, for a SoVITS set) is held by the caller from
    copying its inputs in to copying the outputs out. ``run(fn, variant)`` runs ``fn(static)``, which
    updates the buffers in place and reads nothing back to the host: on
    the card, a replay of the graph captured from ``fn`` on the first run
    of ``variant`` (the variants of one program share its buffers: a
    decode block of 16 steps and the single step that ends a decode at
    its cap, each with and without top-p). ``prepare(fn, variant)`` captures a variant without running
    it. ``run(..., eager=True)``, a graph of a cache set ``eager``, and a
    graph with no cache (the buffers of one call) run ``fn`` without a
    graph: a comparison's baseline, or a program that is not captured."""

    def __init__(self, cache: "Optional[GraphCache]", key: Hashable, static):
        self.key, self.static = key, static
        self.lock = (cache.family_lock if cache is not None and cache.family
                     else threading.Lock())
        self._cache = cache
        # variant -> (CUDA graph, kernel launches per replay, {device: pool
        # bytes}), or None on the CPU (nothing to capture)
        self._graphs: Dict[Hashable, Optional[tuple]] = {}
        self._pool = None        # the memory pool of this graph's captures
        # its pools on the cards other than the lead, by device
        self._device_pools: Dict[torch.device, object] = {}

    def pool_bytes_by_device(self) -> Dict[torch.device, int]:
        """Card memory the captures reserved for their pools, by card."""
        out: Dict[torch.device, int] = {}
        for g in self._graphs.values():
            for d, n in (g[2] if g is not None else {}).items():
                out[d] = out.get(d, 0) + n
        return out

    @property
    def pool_bytes(self) -> int:
        """Card memory the captures reserved for their pools."""
        return sum(self.pool_bytes_by_device().values())

    @property
    def variants(self) -> list:
        """The variants prepared (captured on the card)."""
        return list(self._graphs)

    def _on_card(self) -> bool:
        bufs = tensors_of(self.static)
        return bool(bufs) and bufs[0].is_cuda

    def prepare(self, fn: Callable, variant: Hashable = None) -> None:
        """Capture ``variant`` unless it was (on the CPU: only count it)."""
        if variant in self._graphs:
            return
        on_card = self._on_card()
        self._graphs[variant] = self._capture(fn) if on_card else None
        self._cache._prepared(self, on_card)

    def run(self, fn: Callable, variant: Hashable = None, eager: bool = False) -> None:
        if eager or self._cache is None or self._cache.eager:
            fn(self.static)
            return
        self.prepare(fn, variant)
        entry = self._graphs[variant]
        if entry is None:
            fn(self.static)
            return
        entry[0].replay()
        _build.add_launches(entry[1])

    def _capture(self, fn: Callable) -> tuple:
        bufs = tensors_of(self.static)
        dev = bufs[0].device
        devs = list(dict.fromkeys(t.device for t in bufs if t.is_cuda))
        others = [d for d in devs if d != dev]
        with _capture_lock, torch.cuda.device(dev):
            side = _capture_streams.get(dev)
            if side is None:
                side = _capture_streams[dev] = torch.cuda.Stream(dev)
            saved = [t.clone() for t in bufs]
            for d in devs:
                torch.cuda.synchronize(d)
            # the warm-up run: what is built or allocated once (kernels,
            # cuBLAS handles) happens here, outside the capture; its
            # launches are not counted. It writes only this graph's
            # buffers, so it may run beside other threads' replays.
            with torch.cuda.stream(side), _build.recording(), _capturing_on():
                fn(self.static)
            # every card's share of the run done before the buffers are put
            # back (a buffer on another card is restored on its stream there)
            for d in devs:
                torch.cuda.synchronize(d)
            for t, s in zip(bufs, saved):
                t.copy_(s)
            del saved
            for d in devs:
                torch.cuda.synchronize(d)
            before = {d: torch.cuda.memory_reserved(d) for d in devs}
            graph = torch.cuda.CUDAGraph()
            pool = self._cache.pool() if self._cache.family else self._pool
            # capture_begin / capture_end, not torch.cuda.graph: its entry
            # collects garbage and empties the allocator's cache, which
            # costs a sweep time and hides the pool's growth from the count
            with contextlib.ExitStack() as routed:
                # the capture_begin pool serves the lead card only: this
                # thread's allocations on every other card go to the
                # graph's pool there
                for d in others:
                    mp = self._device_pools.get(d)
                    if mp is None:
                        with torch.cuda.device(d):
                            mp = self._device_pools[d] = torch.cuda.MemPool()
                    routed.enter_context(torch.cuda.use_mem_pool(mp, d))
                with (_build.recording() as rec, torch.cuda.stream(side),
                      _capturing_on()):
                    graph.capture_begin(pool=pool, capture_error_mode="thread_local")
                    try:
                        fn(self.static)
                    finally:
                        graph.capture_end()
            self._pool = graph.pool()
            grown = {d: max(torch.cuda.memory_reserved(d) - n, 0) for d, n in before.items()}
            return graph, dict(rec), grown


class GraphCache:
    """The graphs of one parameter set, keyed on static geometry (route,
    B, Sx, Sp, cache length, step cap, W, read windows, top-p flag,
    dtype; the SoVITS stage, B and frame, text or window widths), and the
    objects they share (the fused kernel's packing).

    ``family``: the graphs form one family (a SoVITS set's): one memory
    pool, made at the first capture, and one lock, ``family_lock``.

    ``stats``: ``hits`` and ``misses`` count lookups of a key (a miss
    makes the graph's buffers; the capture follows on its first run),
    ``variants`` the (key, variant) programs prepared (on any device),
    ``captures`` the graphs captured on the card.

    ``eager``: run every program of the set without a graph (a
    comparison's baseline; serving never sets it)."""

    def __init__(self, family: bool = False):
        self._graphs: Dict[Hashable, Graph] = {}
        self._objects: Dict[Hashable, object] = {}
        self._lock = threading.RLock()     # a factory may ask for a shared object
        self.stats = {"hits": 0, "misses": 0, "variants": 0, "captures": 0}
        self.eager = False
        self.family = family
        self.family_lock = threading.Lock() if family else None
        self._pool = None

    def pool(self):
        """The family's memory pool handle (None: each capture's own)."""
        if self.family and self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool

    def graph(self, key: Hashable, make_static: Callable[[], object]) -> Graph:
        """The graph for ``key``; on a miss its buffers come from
        ``make_static()``."""
        with self._lock:
            g = self._graphs.get(key)
            if g is not None:
                self.stats["hits"] += 1
                return g
            self.stats["misses"] += 1
            with torch.inference_mode(False):     # updated in place in any mode
                g = Graph(self, key, make_static())
            self._graphs[key] = g
            return g

    def shared(self, name: Hashable, factory: Callable[[], object]):
        """The object ``name`` of this parameter set, made once by
        ``factory()``."""
        with self._lock:
            obj = self._objects.get(name)
            if obj is None:
                with torch.inference_mode(False):
                    obj = self._objects[name] = factory()
            return obj

    def _prepared(self, graph: Graph, captured: bool) -> None:
        with self._lock:
            self.stats["variants"] += 1
            self.stats["captures"] += captured

    def programs(self) -> list:
        """(key, variant) of every program prepared."""
        with self._lock:
            return [(k, v) for k, g in self._graphs.items() for v in g.variants]

    def keys(self) -> list:
        with self._lock:
            return list(self._graphs)

    def pool_bytes(self) -> int:
        """Card memory the captures reserved for their pools."""
        with self._lock:
            return sum(g.pool_bytes for g in self._graphs.values())

    def buffer_bytes(self) -> int:
        """Bytes of the graphs' static buffers (a persistent slot state's
        once)."""
        return sum(self.bytes_by_device()[1].values())

    def bytes_by_device(self) -> tuple:
        """({device: pool bytes}, {device: static buffer bytes}) of the
        set's graphs (a persistent slot state's buffers once)."""
        pools: Dict[torch.device, int] = {}
        bufs: Dict[torch.device, int] = {}
        with self._lock:
            seen = {id(t): t for g in self._graphs.values() for t in tensors_of(g.static)}
            for g in self._graphs.values():
                for d, n in g.pool_bytes_by_device().items():
                    pools[d] = pools.get(d, 0) + n
        for t in seen.values():
            bufs[t.device] = bufs.get(t.device, 0) + t.numel() * t.element_size()
        return pools, bufs

    def clear(self) -> None:
        """Let go of every graph and shared object: the parameter set is
        gone, and a graph refers back to its cache, so the cycle would
        otherwise wait for the next collection to free the pools."""
        self._graphs.clear()
        self._objects.clear()

    def reset_stats(self) -> None:
        with self._lock:
            for k in self.stats:
                self.stats[k] = 0


_caches: Dict[int, tuple] = {}
_caches_lock = threading.RLock()   # the drop callback may run inside cache_for


def cache_for(params) -> GraphCache:
    """The graph cache of a parameter set, found by one of its tensors
    and dropped with it: a T2S set's by ``audio_embed`` (a tp-sharded
    set's by its first shard's qkv weight, its own: its other leaves may
    be the whole set's); a SoVITS set's by ``quantizer_embed`` and a
    RoBERTa set's by ``word_embed``, each a family (one pool, one
    lock)."""
    name = next(n for n in ("audio_embed", "quantizer_embed", "word_embed") if n in params)
    family = name != "audio_embed"
    t = params[name]
    if "layer_shards" in params:
        t = params["layer_shards"][0]["qkv"]["w"]
    k = id(t)
    with _caches_lock:
        hit = _caches.get(k)
        if hit is not None and hit[0]() is t:
            return hit[1]
        cache = GraphCache(family)

        def drop(_ref, k=k):
            with _caches_lock:
                cur = _caches.get(k)
                if cur is None or cur[0] is not _ref:
                    return
                del _caches[k]
            cur[1].clear()

        _caches[k] = (weakref.ref(t, drop), cache)
        return cache
