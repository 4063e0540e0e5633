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
* :class:`GraphCache` keys the graphs of ONE configuration on their static
  geometry, and counts hits, misses, variants and captures;
  :func:`cache_for` finds a parameter set's cache by its configuration
  signature (:func:`signature`: the family kind and each leaf's path,
  shape, dtype and device, and a dp replica's row), so every character of
  a configuration shares one cache, as every character shares the JAX
  package's jitted programs (they take ``params`` as an argument). A
  captured graph reads its weights by address, so the cache owns a BANK:
  static tensors shaped like one parameter set (made from the first set
  that asks), which a caller binds (:meth:`GraphCache.bind`) before it
  runs a program: the set's tensors are copied in when the bank holds
  another set. ``runtime/engine.py::TTSEngine.warmup(..., sweep=True)``
  captures every key that serving can reach before traffic arrives, for
  every character of the configuration. Caches live as long as the
  process, as the JAX package's jit caches do (:func:`clear_caches` is
  ``jax.clear_caches``).
* :class:`Residency` is the turn-taking behind a bank, and behind a slot
  geometry's resident state (``models/slots.py``): one owner's contents
  at a time; a switch waits, on the device, for every replay of the
  resident owner (an event recorded when each hold ends) and the next
  replay waits for the switch's copies.

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
program runs eagerly on the same buffers and the same bank, with the same
keys, counts and binds.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import weakref
from typing import Callable, Dict, Hashable, List, Optional

import torch

from ..ops import _build
from ..utils.metrics import metrics

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
        if on_card:
            with metrics.span("graph_capture", key=repr(self.key), variant=repr(variant)):
                self._graphs[variant] = self._capture(fn)
        else:
            self._graphs[variant] = None
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


class Residency:
    """Static buffers that owners take turns in: a graph cache's bank of
    weights (:meth:`GraphCache.bind`), a slot geometry's resident state
    (``models/slots.py``).

    :meth:`hold` makes an owner resident and keeps it so until the hold
    ends. Holds of the resident owner go straight through, any number at
    once; a thread's holds nest. Another owner waits until no hold is
    left (and holds of the resident owner that arrive meanwhile wait
    behind it, so no owner starves), then SWITCHES: its current stream on
    ``device`` waits for the event recorded at the end of every hold since
    the last switch (so no replay of the resident owner is still queued
    on the card when its buffers are overwritten), ``save(old key)``
    copies the buffers back to the owner leaving (when ``save`` is given
    and that owner lives), ``load(data)`` copies the new owner in, and an
    event recorded after the copies is waited for by every later hold's
    stream. ``transient``: an owner whose copy lives only for the hold
    (copied in at its start and back at its end, exclusive meanwhile).
    ``switches`` counts the switches. A thread that holds one owner and
    asks for another raises (it would wait for itself)."""

    def __init__(self, device, load: Callable, save: Optional[Callable] = None):
        self.device = torch.device(device)
        self._load, self._save = load, save
        self._cv = threading.Condition()
        self._owner = None          # a weak reference to the resident owner's key
        self._holds = 0
        self._exclusive = False     # a transient owner is in
        self._wanted: list = []     # keys of the owners waiting to switch in
        self._tls = threading.local()
        self._done: Dict[object, object] = {}   # stream -> event after its last hold
        self._ready = None          # event after the last switch's copies
        self.switches = 0

    def _resident(self, key) -> bool:
        return self._owner is not None and self._owner() is key

    def _switch(self, key, data) -> None:
        on_card = self.device.type == "cuda"
        if on_card:
            cur = torch.cuda.current_stream(self.device)
            for ev in self._done.values():
                cur.wait_event(ev)
            self._done.clear()
        old = self._owner() if self._owner is not None else None
        self._owner = None
        if old is not None and self._save is not None:
            self._save(old)
        self._load(data)
        self._owner = weakref.ref(key)
        self.switches += 1
        if on_card:
            self._ready = torch.cuda.Event()
            self._ready.record(cur)

    @contextlib.contextmanager
    def hold(self, key, data=None, transient: bool = False):
        """Hold ``key``'s owner resident (``data``: what ``load`` copies
        in; the key by default)."""
        held = getattr(self._tls, "key", None)
        if held is not None:
            if held is not key:
                raise RuntimeError("a thread that holds one owner's buffers asked for "
                                   "another's: it would wait for itself")
            yield
            return
        data = key if data is None else data
        with self._cv:
            queued = False
            try:
                while True:
                    resident = not transient and self._resident(key)
                    if (resident and not self._exclusive
                            and all(k is key for k in self._wanted)):
                        break
                    if self._holds == 0 and not resident:
                        self._switch(key, data)
                        self._exclusive = transient
                        break
                    # (resident with no hold left but others waiting: they
                    # go first, and wake this thread when they are done)
                    if not queued:
                        self._wanted.append(key)
                        queued = True
                    self._cv.wait()
            finally:
                if queued:
                    del self._wanted[next(i for i, k in enumerate(self._wanted) if k is key)]
            self._holds += 1
            ready = self._ready
        self._tls.key = key
        try:
            if ready is not None:
                torch.cuda.current_stream(self.device).wait_event(ready)
            yield
        finally:
            self._tls.key = None
            with self._cv:
                try:
                    if transient:
                        self._owner, self._exclusive = None, False
                        self._save(key)
                    if self.device.type == "cuda":
                        ev = torch.cuda.Event()
                        stream = torch.cuda.current_stream(self.device)
                        ev.record(stream)
                        self._done[stream] = ev
                finally:
                    self._holds -= 1
                    self._cv.notify_all()


# derived trees of a parameter set that programs read and a bank carries
# (the fused kernel's packing, ``models/t2s.py``); every other key that
# starts with '_' is a cache the bank makes for itself (``ops/layers.py``)
BANKED = ("_packed",)
# a dp replica's row (``runtime/engine.py::TTSEngine._place``), part of its
# configuration: replicas decode at once, each on a bank of its own
DP_ROW = "_dp_row"


def tree_leaves(params) -> list:
    """(path, leaf) of every leaf of a parameter set, sorted by path: its
    tensors and those under :data:`BANKED`; other '_' keys are skipped."""
    out = []

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                k = str(k)
                if not k.startswith("_") or k in BANKED:
                    walk(v, f"{path}{k}/")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{path}{i}/")
        else:
            out.append((path[:-1], node))

    walk(params, "")
    out.sort(key=lambda e: e[0])
    return out


def _alias(t: torch.Tensor) -> tuple:
    return (t.untyped_storage().data_ptr(), t.storage_offset(), tuple(t.shape), t.stride(),
            t.dtype, t.device)


def _kind(params) -> str:
    return next(k for n, k in (("audio_embed", "t2s"), ("quantizer_embed", "sovits"),
                               ("word_embed", "roberta")) if n in params)


def signature(params) -> tuple:
    """A parameter set's configuration: the family kind, each leaf's path,
    shape, dtype and device (:func:`tree_leaves`; a tp set's shards name
    their devices), which earlier leaf each one aliases, and a dp
    replica's row. Sets of one signature share a :class:`GraphCache`."""
    seen: Dict[tuple, int] = {}
    leaves = []
    for i, (path, x) in enumerate(tree_leaves(params)):
        if isinstance(x, torch.Tensor):
            a = _alias(x)
            leaves.append((path, tuple(x.shape), x.dtype, x.device, seen.setdefault(a, i)))
        else:
            leaves.append((path, repr(x)))
    return (_kind(params), tuple(leaves), params.get(DP_ROW, 0))


def _anchor(params) -> torch.Tensor:
    """The tensor that identifies a parameter set: a T2S set's
    ``audio_embed`` (a tp-sharded set's first shard's qkv weight, its own:
    its other leaves may be the whole set's), a SoVITS set's
    ``quantizer_embed``, a RoBERTa set's ``word_embed``."""
    if "layer_shards" in params:
        return params["layer_shards"][0]["qkv"]["w"]
    return params[next(n for n in ("audio_embed", "quantizer_embed", "word_embed")
                       if n in params)]


def _clone_tree(node, seen: dict):
    """A copy of a parameter tree in tensors of its own (aliases kept),
    without the derived caches :func:`tree_leaves` skips."""
    if isinstance(node, torch.Tensor):
        a = _alias(node)
        if a not in seen:
            seen[a] = node.detach().clone()
        return seen[a]
    if isinstance(node, dict):
        return {k: _clone_tree(v, seen) for k, v in node.items()
                if not str(k).startswith("_") or k in BANKED or k == DP_ROW}
    if isinstance(node, (list, tuple)):
        return type(node)(_clone_tree(v, seen) for v in node)
    return node


class GraphCache:
    """The graphs of one configuration, keyed on static geometry (route,
    B, Sx, Sp, cache length, step cap, W, top-p flag,
    dtype; the SoVITS stage, B and frame, text or window widths), the
    objects they share (a slot geometry's resident state), and the BANK
    they read their weights from.

    ``bank``: static tensors shaped like the configuration's parameter
    sets (a copy of the first set's), read by every captured program;
    None for a cache whose programs read their one set itself (RoBERTa's,
    one per device). :meth:`bind` puts a set's tensors in it.
    ``after_bind``: functions of the bank run after a bind copied a set in
    (they redo what the bank derived from its weights: the conv layouts,
    the fused kernel's tiles).

    ``family``: the graphs form one family (a SoVITS set's): one memory
    pool, made at the first capture, and one lock, ``family_lock``.

    ``stats``: ``hits`` and ``misses`` count lookups of a key (a miss
    makes the graph's buffers; the capture follows on its first run),
    ``variants`` the (key, variant) programs prepared (on any device),
    ``captures`` the graphs captured on the card; with a bank, ``binds``
    the binds that copied a set into it and ``bind_bytes`` the bytes they
    copied.

    ``eager``: run every program of the configuration without a graph,
    on the caller's own set (a comparison's baseline; serving never sets
    it)."""

    def __init__(self, family: bool = False, bank_from=None):
        self._graphs: Dict[Hashable, Graph] = {}
        self._objects: Dict[Hashable, object] = {}
        self._lock = threading.RLock()     # a factory may ask for a shared object
        self.stats = {"hits": 0, "misses": 0, "variants": 0, "captures": 0}
        self.eager = False
        self.family = family
        self.family_lock = threading.Lock() if family else None
        self._pool = None
        self.bank = None
        self.after_bind: List[Callable] = []
        if bank_from is not None:
            self.stats.update(binds=0, bind_bytes=0)
            with torch.inference_mode(False), torch.no_grad():
                self.bank = _clone_tree(bank_from, {})
            if "_packed" in self.bank:
                self.bank["_packed"]["_from"] = self.bank["layers"]
            leaves = tree_leaves(self.bank)
            sig = signature(self.bank)[1]
            # the leaves a bind copies: tensors, each storage view once
            self._copied = [i for i, ((_, x), e) in enumerate(zip(leaves, sig))
                            if isinstance(x, torch.Tensor) and e[4] == i]
            self._bank_leaves = [leaves[i][1] for i in self._copied]
            self._residency = Residency(_anchor(self.bank).device, self._load)
            # the bank holds the first set: no copy until another binds
            self._residency._owner = weakref.ref(_anchor(bank_from))

    def bank_bytes(self) -> int:
        """Bytes of the bank's tensors (0 without a bank)."""
        if self.bank is None:
            return 0
        return sum(t.numel() * t.element_size() for t in self._bank_leaves)

    def _load(self, params) -> None:
        leaves = tree_leaves(params)
        src = [leaves[i][1] for i in self._copied]
        groups: Dict[torch.device, tuple] = {}
        for d, s_ in zip(self._bank_leaves, src):
            dst, srcs = groups.setdefault(d.device, ([], []))
            dst.append(d)
            srcs.append(s_)
        # in inference mode: what the bank derived may be inference tensors
        with torch.inference_mode():
            for dev, (dst, srcs) in groups.items():
                with on_device_stream(dev):
                    torch._foreach_copy_(dst, srcs)
            for fn in self.after_bind:
                fn(self.bank)
        with self._lock:
            self.stats["binds"] += 1
            self.stats["bind_bytes"] += self.bank_bytes()

    @contextlib.contextmanager
    def bind(self, params, eager: bool = False):
        """The parameter tree a program of this configuration reads for
        ``params``: the bank, holding ``params`` (copied in when the bank
        held another set; see :class:`Residency`) until the block ends.
        ``params`` itself when ``eager`` or the cache is eager (the
        programs then run without a graph, on the caller's set), when it
        is the bank, and for a cache without a bank."""
        if eager or self.eager or self.bank is None or params is self.bank:
            yield params
            return
        if cache_for(params) is not self:
            raise ValueError("bind: the parameter set is of another configuration")
        hold = self._residency.hold(_anchor(params), params)
        # the wait for the resident set's holds and the copy of a switch
        with metrics.span("graph_bind"):
            hold.__enter__()
        try:
            yield self.bank
        finally:
            hold.__exit__(None, None, None)

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
        """The object ``name`` of this configuration, made once by
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
        """Bytes of the graphs' static buffers (a resident slot state's
        once)."""
        return sum(self.bytes_by_device()[1].values())

    def bytes_by_device(self) -> tuple:
        """({device: pool bytes}, {device: static buffer bytes}) of the
        configuration's graphs (a resident slot state's buffers once)."""
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
        """Let go of every graph and shared object (a graph refers back to
        its cache, so the cycle would otherwise wait for the next
        collection to free the pools)."""
        self._graphs.clear()
        self._objects.clear()

    def reset_stats(self) -> None:
        with self._lock:
            for k in self.stats:
                self.stats[k] = 0


# configuration signature -> its cache
_caches: Dict[tuple, GraphCache] = {}
# (id of a set's dict, id of its anchor tensor) -> (a weak reference to the
# anchor, the ids of the dict's entries, its cache): a set seen before is
# found without computing its signature again
_known: Dict[tuple, tuple] = {}
_caches_lock = threading.RLock()   # a drop callback may run inside cache_for


def _entries(params) -> tuple:
    return tuple((k, id(v)) for k, v in params.items())


def _remember(params, cache: GraphCache, owned: bool = False) -> None:
    """Find ``cache`` for ``params`` while its anchor lives; ``owned``: the
    cache is the set's own (RoBERTa's), let go of with it."""
    anchor = _anchor(params)
    k = (id(params), id(anchor))

    def drop(ref, k=k):
        with _caches_lock:
            if _known.get(k, (None,))[0] is not ref:
                return
            del _known[k]
        if owned:
            cache.clear()

    _known[k] = (weakref.ref(anchor, drop), _entries(params), cache)


def _found(params) -> Optional[GraphCache]:
    anchor = _anchor(params)
    hit = _known.get((id(params), id(anchor)))
    if hit is not None and hit[0]() is anchor and hit[1] == _entries(params):
        return hit[2]
    return None


def _new_cache(params, kind: str) -> GraphCache:
    """The cache of a new configuration, its bank made from ``params``; a
    bind redoes the conv layouts the bank derived, and for a T2S set the
    fused kernel's tiles."""
    from ..ops import fused_decode
    from ..ops.layers import refresh_derived

    cache = GraphCache(family=kind == "sovits", bank_from=params)
    cache.after_bind.append(refresh_derived)
    if kind == "t2s" and "_packed" in cache.bank:
        cache.after_bind.append(lambda bank: fused_decode.refresh(bank["_packed"]))
    return cache


def cache_for(params) -> GraphCache:
    """The graph cache of a parameter set's configuration (:func:`signature`),
    made with its bank at the first set that asks and kept for the
    process. A whole T2S set gets the fused kernel's packing under
    ``_packed`` first (once per set, and again for a copy of the set with
    other layers: ``ops/fused_decode.py::pack_decode_params``; the bank
    carries it). A SoVITS set's cache is a
    family (one pool, one lock). A RoBERTa set's cache (one set per
    device, shared by every character) is found by its ``word_embed``,
    dropped with it, and has no bank: its programs read the set."""
    with _caches_lock:
        hit = _found(params)
        if hit is not None:
            return hit
        kind = _kind(params)
        if kind == "roberta":
            cache = GraphCache(family=True)
            _remember(params, cache, owned=True)
            return cache
        if kind == "t2s" and "layers" in params and (
                params.get("_packed", {}).get("_from") is not params["layers"]):
            from ..ops.fused_decode import pack_decode_params

            with torch.inference_mode(False), torch.no_grad():
                params["_packed"] = pack_decode_params(params)
            params["_packed"]["_from"] = params["layers"]
        sig = signature(params)
        cache = _caches.get(sig)
        if cache is None:
            cache = _caches[sig] = _new_cache(params, kind)
            _remember(cache.bank, cache)
        _remember(params, cache)
        return cache


def clear_caches() -> None:
    """Forget every configuration's cache (``jax.clear_caches``): the next
    :func:`cache_for` makes a new one, with a new bank. A RoBERTa set's
    cache stays: it is the set's own."""
    with _caches_lock:
        for c in _caches.values():
            c.clear()
        _caches.clear()
        for k in [k for k, v in _known.items() if v[2].bank is not None]:
            del _known[k]
