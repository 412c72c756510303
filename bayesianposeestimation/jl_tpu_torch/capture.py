"""Compile-once chains: a sampler step captured as a CUDA graph and replayed.

The JAX package compiles a whole chain into one device program (``jax.jit``
over a ``lax.scan``). The port's counterpart is ``ChainRunner``: it keeps the
chain's state in static buffers and captures each step function, which reads
those buffers and writes the new state back into them, as one
``torch.cuda.CUDAGraph`` per branch of the sampler (a ``ComposedSampler``
picks one on the host each step). A step is then one replay; the host does
no other work per step. The first time a branch runs, its step runs eagerly
on the capture stream (a real step of the chain, which also does the lazy
set-up capture cannot: launch plans, face checks, library handles), and the
capture follows. On the CPU the same static-buffer step runs eagerly every
time.

Random numbers come from the runner's own ``Rngs``, reseeded per run: the
device generator is registered with every graph, so each replay draws at the
generator's current Philox offset and advances it as the eager step would.
A captured chain therefore draws what the eager chain draws.

Kernel launches and likelihood evaluations are counted through
``telemetry.count``: while a graph is captured the counts are recorded, not
reported, and every replay reports what its capture recorded. While
telemetry is on, a run is timed in spans (``runner.run``, ``runner.start``,
``runner.advance``, ``runner.gather``; ``runner.capture`` around a branch's
eager first step and capture) and ``advance`` reports, once per call, its
steps, the picks by branch and the host nanoseconds of the pick, the replay
call, the tally's re-report, ``before_step`` and the chunk copies.
"""

from __future__ import annotations

import dataclasses

import torch

from . import telemetry
from .rngs import Rngs
from .telemetry import count, recording, span

__all__ = ["ChainRunner", "StepGraph", "tree_leaves", "clone_tree", "copy_tree", "carried"]


# -- static state -------------------------------------------------------------

def _flatten(tree, leaves):
    """The structure of ``tree`` (dataclasses, dicts, tuples, tensors, None)
    with its tensors appended to ``leaves``."""
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return (tuple(tree.shape), tree.dtype)
    if dataclasses.is_dataclass(tree):
        return (type(tree), tuple((f.name, _flatten(getattr(tree, f.name), leaves))
                                  for f in dataclasses.fields(tree)))
    if isinstance(tree, dict):
        return (dict, tuple((k, _flatten(v, leaves)) for k, v in tree.items()))
    if isinstance(tree, (tuple, list)):
        return (type(tree), tuple(_flatten(v, leaves) for v in tree))
    if tree is None or isinstance(tree, (bool, int, float, str)):
        return ("const", tree)
    raise TypeError(f"a chain state holds {type(tree).__name__}, not a tensor tree")


def tree_leaves(tree):
    """(structure, tensors) of a state: two states with the same structure
    hold tensors of the same shapes and dtypes in the same places."""
    leaves = []
    return _flatten(tree, leaves), leaves


def _rebuild(tree, leaves):
    if isinstance(tree, torch.Tensor):
        return next(leaves)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{f.name: _rebuild(getattr(tree, f.name), leaves)
                                            for f in dataclasses.fields(tree) if f.init})
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(v, leaves) for v in tree)
    return tree


def clone_tree(tree):
    """``tree`` with every tensor cloned (each its own buffer, also where
    the source shares one tensor between fields)."""
    _, leaves = tree_leaves(tree)
    return _rebuild(tree, iter([x.clone() for x in leaves]))


def copy_tree(dst, src):
    """Copy the tensors of ``src`` into those of ``dst`` (same structure); a
    tensor a step passed through unchanged is its own buffer already."""
    dst_struct, dst_leaves = tree_leaves(dst)
    src_struct, src_leaves = tree_leaves(src)
    if dst_struct != src_struct:
        raise ValueError(f"the step changed the state's structure:\n{dst_struct}\n"
                         f"-> {src_struct}")
    for d, s in zip(dst_leaves, src_leaves):
        if s is not d:
            d.copy_(s)


def carried(state):
    """The part of a step's state that the next step reads: a state with a
    ``carried()`` (a multiple-try state, whose move record is reported and
    not read) gives that, any other state itself."""
    return state.carried() if hasattr(state, "carried") else state


# -- one captured step --------------------------------------------------------

_CAPTURE_STREAMS = {}


def _capture_stream(device):
    """The side stream every capture on ``device`` runs on (and its eager
    first step, so per-stream library state is set up there)."""
    key = torch.device(device).index or 0
    if key not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[key] = torch.cuda.Stream(device)
    return _CAPTURE_STREAMS[key]


class StepGraph:
    """A step function over static buffers, called once per step.

    On the card (``captured``) its first call runs ``fn`` eagerly on the
    capture stream and then captures it into a CUDA graph in ``pool`` with
    ``generator`` registered; every later call replays the graph and
    reports the events its capture recorded. A failed capture raises.
    Without ``captured`` every call runs ``fn`` eagerly."""

    def __init__(self, fn, device, generator, pool=None, captured=True):
        self.fn = fn
        self.device = torch.device(device)
        self.generator = generator
        self.pool = pool
        self.captured = captured and self.device.type == "cuda"
        self.graph = None
        self.tally = None

    def capture(self):
        """Run the step once eagerly on the capture stream, then capture it."""
        stream = _capture_stream(self.device)
        current = torch.cuda.current_stream(self.device)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            self.fn()
        current.wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.generator)
        with recording() as tally, torch.cuda.graph(graph, pool=self.pool, stream=stream):
            self.fn()
        self.graph, self.tally = graph, dict(tally)

    def __call__(self, laps=None):
        """One step. ``laps`` (``telemetry.Laps``, started at the replay by
        the caller), where given, moves to ``report`` after the replay and
        counts a first call's eager step and capture in no part."""
        if not self.captured:
            self.fn()
        elif self.graph is None:
            if laps is not None:
                laps(None)
            with span("runner.capture"):
                count(("graph", "captures"))
                self.capture()
        else:
            self.graph.replay()
            if laps is not None:
                laps("report")
            for key, n in self.tally.items():
                count(key, n)


# -- the chain runner -----------------------------------------------------------

def branches_of(sampler):
    """(the samplers one step may run, the host's pick of one): a
    ``ComposedSampler``'s sub-samplers and its ``pick``, else the sampler
    alone."""
    pick = getattr(sampler, "pick", None)
    if pick is None:
        return (sampler,), None
    subs = tuple(sampler.samplers)
    if any(hasattr(s, "pick") for s in subs):
        raise TypeError("a ComposedSampler inside a ComposedSampler picks on the host "
                        "inside a step, which a captured step cannot do")
    return subs, pick


class ChainRunner:
    """Init plus steps of ``sampler`` on the model that ``build_model()``
    returns (it is called inside every step, so a model built from static
    buffers is rebuilt as the eager chain rebuilds it; a plain model is
    returned as it is), with each step a replay of its branch's graph.

    ``run(seed, n_steps, ...)`` does what ``samplers.chain.sample_chain``
    does with ``Rngs.from_seed(seed)``; no capture depends on ``n_steps``.
    The buffers hold the state as the next step reads it (``carried``). The
    collected outputs of a step (``collect_variables`` of the buffers, and of
    the state the step returned for the rows only it reports, under the keys
    the initial state gives) are written by the step itself, at a device step
    counter, into a chunk of ``CHUNK`` rows, copied out every ``CHUNK``
    steps. ``before_step(i)``, where given, runs on the host before
    step ``i`` (0-based), e.g. to copy that step's observation into the
    model's static buffer."""

    CHUNK = 128

    def __init__(self, sampler, build_model, device, n_particles=None,
                 collect_vars=("t", "r")):
        self.sampler = sampler
        self.build_model = build_model
        self.device = torch.device(device)
        self.n_particles = n_particles
        self.collect_vars = tuple(collect_vars)
        self.captured = self.device.type == "cuda"
        self.branches, self.pick = branches_of(sampler)
        self.rngs = Rngs.from_seed(0, self.device)
        self.state = None
        self.steps = None

    def _setup(self, state):
        from .samplers.chain import collect_variables

        out = collect_variables(state, self.collect_vars)
        self.state = clone_tree(carried(state))
        self.chunk = {k: torch.empty((self.CHUNK, *v.shape), dtype=v.dtype, device=v.device)
                      for k, v in out.items()}
        self.counter = torch.zeros(1, dtype=torch.int64, device=self.device)
        pool = torch.cuda.graph_pool_handle() if self.captured else None
        self.steps = [StepGraph(self._step_fn(b), self.device, self.rngs.device, pool,
                                self.captured) for b in self.branches]

    def _step_fn(self, branch):
        """The step of ``branch`` over the static buffers (a closure over
        them, not over the runner, so that dropping the runner frees its
        graphs at once)."""
        from .samplers.chain import collect_variables

        rngs, build_model, state = self.rngs, self.build_model, self.state
        chunk, counter, size, names = self.chunk, self.counter, self.CHUNK, self.collect_vars

        def fn():
            _, new = branch.step(rngs, build_model(), state)
            copy_tree(state, carried(new))
            # the carried state read from its buffers; what the step only reports, from ``new``
            out = {**collect_variables(new, names), **collect_variables(state, names)}
            slot = torch.remainder(counter, size)
            for k, c in chunk.items():
                c.index_copy_(0, slot, out[k].unsqueeze(0))
            counter.add_(1)

        return fn

    def start(self, seed):
        """Reseed, init the chain and load its state into the static buffers."""
        self.rngs.reseed(seed)
        _, state = self.sampler.init(self.rngs, self.build_model(), self.n_particles)
        if self.state is None:
            self._setup(state)
        else:
            copy_tree(self.state, carried(state))
        self.counter.zero_()

    def advance(self, n, before_step=None):
        """``n`` steps from the static state; returns the chunks of their
        collected outputs. While telemetry is on (read once per call) the
        loop's host time is split by part (``telemetry.Laps``; under the
        profiler the ranges ``bpe.step.feed``, ``.pick``, ``.replay``,
        ``.report``, ``.chunk``) and reported once, with the steps and the
        picks by branch, through ``count``."""
        laps = telemetry.Laps("bpe.step.") if telemetry.ON else None
        picks = [0] * len(self.steps)
        parts = []
        for i in range(n):
            if before_step is not None:
                if laps is not None:
                    laps("feed")
                before_step(i)
            if laps is not None:
                laps("pick")
            b = 0 if self.pick is None else self.pick(self.rngs)
            if laps is not None:
                picks[b] += 1
                laps("replay")
            self.steps[b](laps)
            if (i + 1) % self.CHUNK == 0 or i + 1 == n:
                if laps is not None:
                    laps("chunk")
                rows = i % self.CHUNK + 1
                parts.append({k: c[:rows].clone() for k, c in self.chunk.items()})
        if laps is not None:
            laps(None)
            count(("runner", "steps"), n)
            for b, k in enumerate(picks):
                count(("runner", "picks", b), k)
            for part in ("pick", "replay", "report", "feed", "chunk"):
                count(("runner", f"{part}_ns"), laps.ns[part])
        return parts

    def run(self, seed, n_steps, collect_every=1, n_burn_in=0, before_step=None):
        """(collected, final state) of init + ``n_steps - 1`` steps, as
        ``sample_chain`` returns them; the final state is a copy."""
        with span("runner.run"):
            with span("runner.start"):
                self.start(seed)
            with span("runner.advance"):
                parts = self.advance(n_steps - 1, before_step=before_step)
            with span("runner.gather"):
                if not parts:
                    return {}, clone_tree(self.state)
                outs = {k: torch.cat([p[k] for p in parts])[n_burn_in::collect_every]
                        for k in parts[0]}
                if next(iter(outs.values())).shape[0] == 0:
                    outs = {}
                elif collect_every > 1:
                    outs = {k: v.contiguous() for k, v in outs.items()}
                return outs, clone_tree(self.state)
