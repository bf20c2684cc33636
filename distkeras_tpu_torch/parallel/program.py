"""Multi-round programs: ``rounds_per_program = n`` rounds of an engine run
as one program (the port's counterpart of the JAX package's
``make_multi_round_fn``, a ``lax.scan`` of n rounds jitted into one
dispatch).

On the card a program is one ``torch.cuda.CUDAGraph`` of n rounds
(``mode == "graph"``), captured at its first use and replayed for every
block of n rounds after it:

* it reads static buffers: the engine state (every tensor of it, and its
  counters as 0-dim int64 tensors), the ``[n, ...]`` block of batches,
  and the host-number tables (``ops/host_numbers.py``) that the counters
  index; it writes the ``[n, *round_loss_shape]`` losses and copies its
  final state back into the static state, so blocks chain;
* before the capture one warm-up round runs on a side stream on scratch
  copies of the state (never the live state, so the trajectory stays the
  per-round path's); it builds and binds every kernel the round launches,
  allocates what cuBLAS and cuDNN keep, and builds the tables;
* the kernels' launch counts (``ops/kernels/build.py launch_tape``, by
  stream): the warm-up round's launches count, and count again as warm-up
  launches; the capture records its launches and every replay adds them,
  so a blocked run counts what its per-round run counts plus one round a
  capture, its warm-up;
* a round's dropout generators are the program's own, made before the
  capture (the warm-up round counts them), registered with the graph and
  seeded before each replay from the host's chain of seeds
  (``workers.SeedRef``), so the draws are the per-round path's;
* a ``device_transform`` that comes in two halves (``draw(gen, shape)``
  on the host, ``apply(draws, x, y)`` on the device, as
  ``ops/augment.py flip_crop_transform`` does) has its draws staged with
  the block: the capture reads them from buffers that the host fills from
  the same chain of seeds before each replay;
* the NaN guard is a select on the device (a round with a non-finite loss
  keeps the previous state, its loss keeps the NaN), the JAX package's
  in-program guard;
* the state a block hands out (to ``on_round`` and as the run's result)
  is a copy with its counters back as Python ints: the next replay
  overwrites the static buffers.

On the CPU, and on the card where a round cannot be captured, the program
runs the same n rounds in a host loop (``mode == "eager"``) with the same
counters, tables and in-round guard: the CPU tests hold that path to the
JAX package's. On the card that is a group whose backend is gloo (its
collectives on CUDA tensors go through the host, ``ops/collectives.py``)
and an engine whose ``device_transform`` is one opaque function (its draws
cannot be told from its work on the batch).
The mode is fixed before a run (:func:`program_mode`); a capture that
fails raises, it never becomes the host loop.
"""

from __future__ import annotations

import contextlib
import gc
import time
import weakref
from typing import Optional

import numpy as np
import torch
import torch.utils._pytree as pytree

from distkeras_tpu_torch import telemetry
from distkeras_tpu_torch.ops import host_numbers
from distkeras_tpu_torch.ops.kernels import build
from distkeras_tpu_torch.runtime import mesh
from distkeras_tpu_torch.workers import _CAPTURE_HOOKS, SeedRef

GRAPH, EAGER = "graph", "eager"

#: a tensor or counter position of a state's spec (:func:`flatten`)
_LEAF = object()


def program_mode(engine) -> str:
    """How ``engine``'s multi-round programs run: ``GRAPH`` on the card,
    ``EAGER`` on the CPU, in a gloo group (its collectives on CUDA tensors
    go through the host) and with a ``device_transform`` that does not
    come in halves (``draw`` and ``apply``: its draws are made on the host
    inside the function)."""
    if torch.device(engine._program_device()).type != "cuda":
        return EAGER
    if mesh.group_active():
        import torch.distributed as dist

        if dist.get_backend() == "gloo":
            return EAGER
    transform = getattr(engine, "device_transform", None)
    if transform is not None and not (hasattr(transform, "draw")
                                      and hasattr(transform, "apply")):
        return EAGER
    return GRAPH


# -- state trees -------------------------------------------------------------
def _is_counter(v) -> bool:
    return isinstance(v, (int, np.integer)) and not isinstance(v, bool)


def flatten(tree) -> tuple:
    """``(leaves, spec)``: the leaves of ``tree`` (``torch.utils._pytree``)
    and its structure, with every leaf that is neither a tensor nor a
    counter (an int) kept in the spec as a constant."""
    leaves, treespec = pytree.tree_flatten(tree)
    return leaves, (treespec, tuple(
        _LEAF if isinstance(v, torch.Tensor) or _is_counter(v) else v
        for v in leaves))


def unflatten(spec, leaves):
    """The tree of ``spec`` (from :func:`flatten`) over ``leaves``."""
    return pytree.tree_unflatten(leaves, spec[0])


def _table_counts(body) -> list:
    """The counters a host-number table is indexed by without a size of
    its own: the optimizer states' ``count`` entries (``ops/optimizers.py``;
    DynSGD's table over its round counter has W entries)."""
    return [int(v) for path, v in pytree.tree_flatten_with_path(body)[0]
            if path and getattr(path[-1], "key", None) == "count"
            and _is_counter(v)]


def _split_rng(state) -> tuple:
    """``(state without its rng, rng)``: every engine state is a NamedTuple
    with an ``rng`` field, which the host derives (not a counter)."""
    return state._replace(rng=None), state.rng


def select(ok: torch.Tensor, new, old):
    """``new`` where ``ok`` (a 0-dim bool tensor), else ``old``, leaf by
    leaf (the in-program NaN guard; no host read)."""
    return pytree.tree_map(
        lambda a, b: torch.where(ok, a, b)
        if isinstance(a, torch.Tensor) and a is not b else a, new, old)


def in_program() -> bool:
    """True inside a program's round (its counters are tensors)."""
    return host_numbers.active() is not None


def captured(fn):
    """Mark ``fn`` as a round that a program captures (each engine's
    ``_round_fn``); returns ``fn`` unchanged. dk-check's DK1xx rules
    (``analysis/rules_torch.py``) read the mark from the source and check
    the body as captured code: no host reads, host I/O, device-to-host
    reads, telemetry or mutation of enclosing state."""
    return fn


# -- the programs -------------------------------------------------------------
class _Seat:
    """What every program of one engine shares: the mode, the tables, and
    (graph mode) the static state buffers."""

    def __init__(self, engine):
        self.device = torch.device(engine._program_device())
        self.mode = program_mode(engine)
        self.tables: Optional[host_numbers.Tables] = None
        self.spec = None
        self.static: Optional[list] = None
        self.ints: list = []
        self.last_out = None
        self.graphs: dict = {}

    def ensure_tables(self, engine, body, xs: torch.Tensor,
                      rounds: int) -> None:
        """Tables that cover every count the run can reach: the largest
        optimizer count now (:func:`_table_counts`) plus one a step for
        the ``rounds`` rounds left."""
        top = max(_table_counts(body), default=0)
        need = top + rounds * int(engine._round_steps(xs)) + 2
        if self.tables is None or need > self.tables.count_size:
            self.tables = host_numbers.Tables(self.device, need)
            self.graphs.clear()  # their captures read the old tables

    def seat(self, leaves: list, spec) -> None:
        """Static buffers for a state of structure ``spec``."""
        self.spec = spec
        self.ints = [_is_counter(v) for v in leaves]
        self.static = [
            torch.tensor(v, dtype=torch.int64, device=self.device)
            if isint else v.detach().clone()
            if isinstance(v, torch.Tensor) else v
            for v, isint in zip(leaves, self.ints)]
        self.last_out = None
        self.graphs.clear()

    def load(self, state, leaves: list) -> None:
        """Copy a state into the static buffers (not when it is the copy
        the last replay handed out: they hold it already)."""
        if state is self.last_out:
            return
        for dst, v, isint in zip(self.static, leaves, self.ints):
            if isint:
                dst.fill_(int(v))
            elif isinstance(v, torch.Tensor):
                dst.copy_(v)

    def hand_out(self, rng):
        """A copy of the static state, its counters as Python ints."""
        ints = [t for t, isint in zip(self.static, self.ints) if isint]
        it = iter(torch.stack(ints).tolist() if ints else [])
        leaves = [next(it) if isint else t.clone()
                  if isinstance(t, torch.Tensor) else t
                  for t, isint in zip(self.static, self.ints)]
        return unflatten(self.spec, leaves)._replace(rng=rng)


class _Captured:
    """One captured graph of ``n`` rounds and its static batch buffers."""

    def __init__(self, engine, seat: _Seat, n: int, xs, ys, rng: int):
        dev = seat.device
        self.sx, self.sy = xs.clone(), ys.clone()
        # Warm-up: one round on a side stream on scratch copies of the
        # state. It builds the kernels and the tables, its launches count
        # as warm-up launches, and it counts the generators and the
        # transform's draws a round asks for (a capture takes them from
        # pools made before it).
        asked: list = []
        drawn: list = []

        def warm_generator(device, ref):
            asked.append(device)
            gen = torch.Generator(device=device)
            gen.manual_seed(ref.resolve(rng))
            return gen

        def warm_draws(transform, ref, x):
            gen = torch.Generator()
            gen.manual_seed(ref.resolve(rng))
            draws = tuple(t.to(x.device)
                          for t in transform.draw(gen, tuple(x.shape)))
            drawn.append([(t.shape, t.dtype) for t in draws])
            return draws

        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side), build.launch_tape("warmup", side), \
                host_numbers.program(seat.tables), \
                _hooks(warm_generator, warm_draws):
            scratch = unflatten(seat.spec, [
                t.clone() if isinstance(t, torch.Tensor) else t
                for t in seat.static])
            engine._round_fn(scratch._replace(rng=SeedRef()), self.sx[0],
                             self.sy[0])
            del scratch
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        seat.tables.freeze()
        self.graph = torch.cuda.CUDAGraph()
        self.pool = [torch.Generator(device=d) for _ in range(n)
                     for d in asked]
        self.draw_pool = [[torch.empty(shape, dtype=dt, device=dev)
                           for shape, dt in req]
                          for _ in range(n) for req in drawn]
        register = getattr(self.graph, "register_generator_state", None)
        for gen in self.pool if register is not None else ():
            register(gen)
        self.gens: list = []
        self.staged: list = []
        # No garbage collection inside the capture: a collected object's
        # CUDA frees (an old graph's pool, a generator) would invalidate it.
        gc.collect()
        cap = torch.cuda.Stream(dev)
        with build.launch_tape("record", cap) as tape, \
                host_numbers.program(seat.tables), \
                _hooks(self._generator, self._draws), _no_gc():
            with torch.cuda.graph(self.graph, stream=cap,
                                  capture_error_mode="thread_local"):
                st = unflatten(seat.spec, list(seat.static))
                st = st._replace(rng=SeedRef())
                losses = []
                for i in range(n):
                    st, loss = engine._round_fn(st, self.sx[i], self.sy[i])
                    losses.append(loss)
                # The graph's static output buffer: bound once at
                # capture, refilled by every replay.
                self.losses = torch.stack(losses)  # dk: disable=DK105
                body, self.out_rng = _split_rng(st)
                out, spec = flatten(body)
                if spec != seat.spec:
                    raise RuntimeError(
                        "a captured round changed the state's structure")
                self._write_back(seat, out)
        torch.cuda.synchronize(dev)
        self.tape = tape

    def _generator(self, device, ref: SeedRef) -> torch.Generator:
        if len(self.gens) == len(self.pool):
            raise RuntimeError("a captured round asked for more generators "
                               "than its warm-up round")
        gen = self.pool[len(self.gens)]
        self.gens.append((gen, ref))
        return gen

    def _draws(self, transform, ref: SeedRef, x) -> tuple:
        if len(self.staged) == len(self.draw_pool):
            raise RuntimeError("a captured round asked for more draws than "
                               "its warm-up round")
        bufs = self.draw_pool[len(self.staged)]
        self.staged.append((bufs, transform, ref, tuple(x.shape)))
        return tuple(bufs)

    @staticmethod
    def _write_back(seat: _Seat, out: list) -> None:
        static = seat.static
        moved = [p for p, t in enumerate(static)
                 if isinstance(t, torch.Tensor)]
        if not all(isinstance(out[p], torch.Tensor) for p in moved):
            raise RuntimeError("a captured round made a counter a Python "
                               "int")
        at = {id(static[p]): p for p in moved}
        # An output that is another position's static buffer is copied
        # before any buffer is written.
        srcs = {p: out[p].clone() if at.get(id(out[p]), p) != p else out[p]
                for p in moved}
        for p in moved:
            if srcs[p] is not static[p]:
                static[p].copy_(srcs[p])

    def replay(self, xs, ys, rng: int) -> dict:
        self.sx.copy_(xs)
        self.sy.copy_(ys)
        memo: dict = {}
        for gen, ref in self.gens:
            gen.manual_seed(ref.resolve(rng, memo))
        for bufs, transform, ref, shape in self.staged:
            gen = torch.Generator()
            gen.manual_seed(ref.resolve(rng, memo))
            for dst, src in zip(bufs, transform.draw(gen, shape)):
                dst.copy_(src)
        self.graph.replay()
        build.replay_launches(self.tape)
        return memo


@contextlib.contextmanager
def _no_gc():
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


@contextlib.contextmanager
def _hooks(generator, draws):
    """Where a round's generators and a transform's draws come from while
    the body runs (``workers.seeded_generator``, ``workers.staged_draws``)."""
    prev = (getattr(_CAPTURE_HOOKS, "generator", None),
            getattr(_CAPTURE_HOOKS, "draws", None))
    _CAPTURE_HOOKS.generator, _CAPTURE_HOOKS.draws = generator, draws
    try:
        yield
    finally:
        _CAPTURE_HOOKS.generator, _CAPTURE_HOOKS.draws = prev


class Program:
    """``n`` rounds of ``engine`` as one program: ``program(state, xs,
    ys, rounds_left) -> (state, losses)`` on a ``[n, ...]`` block,
    ``losses`` ``[n, *round_loss_shape]`` on the device; ``rounds_left``
    (at least n) are the rounds the run has left from this block on, which
    the count tables cover. See the module's docstring."""

    def __init__(self, engine, n: int):
        seat = getattr(engine, "_program_seat", None)
        if seat is None:
            seat = engine._program_seat = _Seat(engine)
        self.seat = seat
        # weak: the engine caches its programs (``_multi_fns``), and a
        # cycle would leave a dead engine's graphs to the garbage
        # collector, which may run inside a later capture
        self._engine = weakref.ref(engine)
        self.n = int(n)
        self.mode = seat.mode

    def __call__(self, state, xs: torch.Tensor, ys: torch.Tensor,
                 rounds_left: Optional[int] = None):
        if xs.shape[0] != self.n:
            raise ValueError(f"a program of {self.n} rounds got a block of "
                             f"{xs.shape[0]}")
        engine = self._engine()
        body, rng = _split_rng(state)
        leaves, spec = flatten(body)
        self.seat.ensure_tables(engine, body, xs,
                                max(self.n, int(rounds_left or self.n)))
        if self.mode == EAGER:
            telemetry.counter("program.blocks.eager").add(1)
            return self._eager(engine, leaves, spec, rng, xs, ys)
        telemetry.counter("program.blocks.graph").add(1)
        seat = self.seat
        if seat.static is None or spec != seat.spec:
            seat.seat(leaves, spec)
        seat.load(state, leaves)
        g = seat.graphs.get(self.n)
        if g is None:
            t0 = time.time_ns()
            with telemetry.span("program.capture"):
                g = _Captured(engine, seat, self.n, xs, ys, rng)
            seat.graphs[self.n] = g
            # the window (wall clock, ns) of the warm-up round and the
            # capture, for a profile to tell their device work from the
            # replays'
            telemetry.event("program_capture", {
                "rounds": self.n, "t0_ns": t0, "t1_ns": time.time_ns()})
        memo = g.replay(xs, ys, rng)
        out_rng = (g.out_rng.resolve(rng, memo)
                   if isinstance(g.out_rng, SeedRef) else g.out_rng)
        new = seat.last_out = seat.hand_out(out_rng)
        return new, g.losses.clone()

    def _eager(self, engine, leaves, spec, rng, xs, ys):
        dev = self.seat.device
        ints = [_is_counter(v) for v in leaves]
        st = unflatten(spec, [
            torch.tensor(v, dtype=torch.int64, device=dev) if isint else v
            for v, isint in zip(leaves, ints)])._replace(rng=rng)
        losses = []
        with host_numbers.program(self.seat.tables):
            for i in range(self.n):
                st, loss = engine._round_fn(st, xs[i], ys[i])
                losses.append(loss)
        body, out_rng = _split_rng(st)
        out, out_spec = flatten(body)
        if out_spec != spec:
            raise RuntimeError("a round changed the state's structure")
        counters = [v for v, isint in zip(out, ints) if isint]
        it = iter(torch.stack(counters).tolist() if counters else [])
        out = [next(it) if isint else v for v, isint in zip(out, ints)]
        return unflatten(spec, out)._replace(rng=out_rng), torch.stack(losses)
