"""The step as CUDA graphs (the counterpart of the JAX package's ``jax.jit`` of
``build_step_core``, ``jaybenne_tpu/step.py:94-96``, and of its spatial rounds'
``lax.while_loop``, ``jaybenne_tpu/parallel/spatial.py:454-499``).

``GraphedStep`` wraps the step of ``step.build_step_core`` on a GPU: the
single-device step on one state, or the particle decomposition's over the list of
the in-process exchange's local shards' states (one census launch over every
shard's slice, ``step.py``). Its first call runs the step eagerly: that builds
the kernel library, the forest tables and every cached constant
(``utils/device.py``), none of which a capture may do. Its second call captures
the step's ``body`` into a ``torch.cuda.CUDAGraph`` and replays it; later calls
replay. Every call first
runs the step's ``prologue`` on the host: it seeds the step's generators with
``manual_seed`` and copies the census kernel's seeds into the device tensor the
captured launch reads, so a replay draws what the eager step draws. The
generators are registered with each graph, so that a replay takes their seed and
offset as they stand.

A graph holds the pointers of the tensors it read and wrote. The captured body
ends by copying each shard's fields and ``overflow`` into that shard's own
tensors, so the states keep their tensors from replay to replay (the ledger is
updated in place anyway). Shards may share a field tensor (``local_states``
gives every shard the one set of fields, and a step leaves the fields it does
not write as they were): the shards' fields are replicated, so each copy into
it writes the same values, after every read of the body. A graph is kept by the
step's ``dt`` and the addresses and shapes of every tensor of every shard's
state: the last, shorter step, a ledger that ``Simulation._ensure_headroom``
grew and a state restored from a snapshot each capture a graph of their own. A
graph's ``StepStats`` are its own output tensor, rewritten by each replay: read
them before the next step.

A replay launches no kernel from Python, so ``cuda_lib.LAUNCHES`` would not count
it: the launches counted while a graph was captured are taken back out, and added
again at each replay. Nothing here falls back to the eager step: a capture that
fails raises.

``GraphedSpatialStep`` does the same for the spatial decomposition's step
(``parallel/spatial.py``, the in-process exchange) over the list of the local
shards' states: a graph of its head, one of a batch of ``nr`` rounds for each
batch length it meets, and one of its tail, kept together by the same key over
every shard's tensors. The rounds stay a host loop of batches: each batch's
round prologue (its fixup generators seeded, its census seeds copied to the
device), a replay, and the batch's one host read, the summed unfinished count,
made after the next batch was queued (the spatial step's ``ahead``): the prologue's
copies and a registered generator's seed are stream-ordered behind the replay
still queued, and each batch's count is copied to a pinned slot of its own.
"""

from __future__ import annotations

import collections
import dataclasses

import torch

from torch.profiler import record_function

from .ops import cuda_lib

# graphs kept per step (least recently used dropped first): the step's dt and the
# last step's shorter one, and one more while a grown ledger takes over
MAX_GRAPHS = 3


def state_tensors(state) -> list:
    """Every tensor of a state that a step reads or writes."""
    return ([getattr(state.fields, f.name) for f in dataclasses.fields(state.fields)]
            + [getattr(state.particles, f.name) for f in dataclasses.fields(state.particles)]
            + [state.overflow])


@dataclasses.dataclass
class _Captured:
    graph: torch.cuda.CUDAGraph
    out: object                   # what the captured function returned (StepStats)
    launches: collections.Counter  # kernel launches of one replay, by name


class GraphedStep:
    """``step(state, dt) -> (state, StepStats)``, or over a list of the local
    shards' states ``step(states, dt) -> (states, StepStats)``: the ``step`` of
    ``build_step_core`` run eagerly once, then captured and replayed (see the
    module docstring). ``captures`` counts the graphs captured."""

    def __init__(self, step):
        self.step = step
        self.graphs: collections.OrderedDict = collections.OrderedDict()
        self.warm = False
        self.captures = 0

    def __call__(self, states, dt):
        single = not isinstance(states, (list, tuple))
        states = [states] if single else list(states)
        self.step.prologue(states, dt)
        if not self.warm:
            new, stats = self.step.body(states, dt)
            self.warm = True
        else:
            key = _key(states, dt)
            cap = self.graphs.get(key)
            if cap is None:
                cap = self._capture(states, dt)
                self.graphs[key] = cap
                while len(self.graphs) > MAX_GRAPHS:
                    self.graphs.popitem(last=False)
            else:
                self.graphs.move_to_end(key)
            stats = _replay(cap)
            new = [dataclasses.replace(st, t=st.t + dt, cycle=st.cycle + 1) for st in states]
        return (new[0] if single else new), stats

    def _capture(self, states, dt) -> _Captured:
        def body():
            new, stats = self.step.body(states, dt)
            for st, nw in zip(states, new):
                _copy_back(st, nw)
            return stats

        self.captures += 1
        return _capture(body, self.step.generators())


def _key(states, dt) -> tuple:
    """A graph's key: the step's ``dt`` and every state tensor's address and shape."""
    return (float(dt),) + tuple((t.data_ptr(), tuple(t.shape))
                                for st in states for t in state_tensors(st))


def _capture(fn, generators) -> _Captured:
    """``fn()`` captured into a graph with ``generators`` registered; its output
    kept, and the launches counted while it was captured taken back out."""
    graph = torch.cuda.CUDAGraph()
    for gen in generators:
        graph.register_generator_state(gen)
    before = collections.Counter(cuda_lib.LAUNCHES)
    with torch.cuda.graph(graph):
        out = fn()
    launches = collections.Counter(cuda_lib.LAUNCHES) - before
    for name, n in launches.items():  # the capture launched nothing
        cuda_lib.LAUNCHES[name] -= n
    return _Captured(graph, out, launches)


def _replay(cap: _Captured):
    cap.graph.replay()
    cuda_lib.LAUNCHES.update(cap.launches)
    return cap.out


@dataclasses.dataclass
class _SpatialGraphs:
    head: _Captured    # its output: the ``StepTensors`` the batches and the tail read
    batches: dict      # rounds a batch -> _Captured
    tail: _Captured | None


class GraphedSpatialStep:
    """``step(states, dt) -> (states, StepStats)``: the spatial ``step`` of
    ``parallel.spatial.build_spatial_step_core`` run eagerly once, then as graphs
    of its head, its batches and its tail (see the module docstring).
    ``captures`` counts the graphs captured."""

    def __init__(self, step):
        self.step = step
        self.graphs: collections.OrderedDict = collections.OrderedDict()
        self.warm = False
        self.captures = 0

    def __call__(self, states, dt):
        core = self.step
        if not self.warm:
            self.warm = True
            return core(states, dt)
        key = _key(states, dt)
        g = self.graphs.get(key)
        core.prologue(states, dt)
        if g is None:
            g = _SpatialGraphs(self._capture(lambda: core.head(states, dt)), {}, None)
            self.graphs[key] = g
            while len(self.graphs) > MAX_GRAPHS:
                self.graphs.popitem(last=False)
        else:
            self.graphs.move_to_end(key)
        t = _replay(g.head)

        def run_batch(nr):
            if nr not in g.batches:
                g.batches[nr] = self._capture(lambda: core.batch(states, t, nr, dt))
            with record_function("spatial.replay"):
                _replay(g.batches[nr])

        core.run_rounds(states, t.unfinished, run_batch)
        if g.tail is None:
            def tail():
                new, stats = core.tail(states, t, dt)
                for st, nw in zip(states, new):
                    _copy_back(st, nw)
                return stats

            g.tail = self._capture(tail)
        stats = _replay(g.tail)
        return [dataclasses.replace(st, t=st.t + dt, cycle=st.cycle + 1) for st in states], stats

    def _capture(self, fn) -> _Captured:
        self.captures += 1
        return _capture(fn, self.step.generators())


def _copy_back(state, new) -> None:
    """Copy a captured body's output fields and ``overflow`` into ``state``'s own
    tensors (the body updates the ledger in place)."""
    for f in dataclasses.fields(new.fields):
        src, dst = getattr(new.fields, f.name), getattr(state.fields, f.name)
        if src is not dst:
            dst.copy_(src)
    state.overflow.copy_(new.overflow)
