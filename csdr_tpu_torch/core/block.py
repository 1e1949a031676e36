"""The Block protocol: static config plus two functions over explicit state.

Counterpart of ``csdr_tpu/core/block.py``::

    init(device)      -> state            (tensors on that device)
    apply(state, x)   -> (state, y)

A chain composes blocks with a tuple-of-states carry.  Every block declares
a rational ``rate`` (output samples per input sample) and a ``granule``
(its input length must be a multiple of it); a chain computes the minimal
input granule that satisfies every stage, so the runtime can pick a static
block size and trim the last, zero-padded block to the exact rational count.
``Tee`` runs two blocks on one input and outputs a tuple whose branches may
run at different rational rates; ``rate_tree`` reports a rate per output
leaf, and the runtime trims each leaf by its own.

Sharded execution (``parallel/generic.ShardedChain``, ``core/sharding``)
adds to every block

    shard_apply(state, x_local, ctx) -> (state, y_local)
    shard_validate(nloc, ctx)        -> local output length

the same arithmetic on this rank's time segment, coupled to the other
ranks through ``ctx``'s collectives, and a static check (no tensor
operation, no collective) that a segment of ``nloc`` samples is valid.
``stateless`` blocks shard as they are; a ``TailStateBlock`` takes its
carried tail from the left neighbour; a ``Chain`` runs each run of
tail-state blocks on one raw-input context exchanged once
(``Chain._shard_segments``).  Behind a channelizer the data are a
(nch, F) panel, channels over the mesh's "ch" axis and frames over
"time": ``PerChannel`` runs its inner block's sharded step on this rank's
rows with its stacked state placed "ch" (``shard_state_spec``), and
``MixChannels`` sums the rows back into a time-layout stream.
"""

from __future__ import annotations

import math
from fractions import Fraction
from typing import Any, Callable, Sequence

import torch

from ..utils import prof
from .sharding import CH, TIME

__all__ = ["Block", "Chain", "chain", "TailStateBlock", "Lambda", "PerChannel", "MixChannels",
           "Tee", "Delay"]

_META = torch.device("meta")


class Block:
    """Base class.  Subclasses define init/apply and may override
    rate/granule, and the shard methods where they carry state."""

    rate: Fraction = Fraction(1)
    granule: int = 1
    name: str = ""
    stateless: bool = False   # apply ignores the state and passes it on

    def init(self, device: torch.device) -> Any:
        return ()

    def apply(self, state: Any, x: Any):
        raise NotImplementedError

    def rate_tree(self):
        """Per-output-leaf rational rates: a Fraction that every leaf shares
        (the common case, Delay's same-rate pair included) or a tuple of them
        mirroring the output (a multi-rate Tee)."""
        return self.rate

    def flush_len(self) -> int:
        """End-of-stream flush allowance: how many zero input samples must
        follow the source so this block emits what it still withholds.
        Causal filters emit 1:1 and owe nothing."""
        return 0

    # ---- the shard protocol --------------------------------------------------
    def shard_init(self, device: torch.device) -> Any:
        """State of sharded execution: ``init`` but where a Chain collapses
        a fused run's per-block tails into one raw-input tail."""
        return self.init(device)

    def shard_state_spec(self, ctx):
        """Placement tag per leaf of ``shard_init``'s state: "rep", every
        rank holds the whole leaf (the only placement of the time layout)."""
        return _map_tree(lambda _: "rep", self.shard_init(_META))

    def shard_apply(self, state, x, ctx):
        if self.stateless:
            return self.apply(state, x)
        raise NotImplementedError(
            f"{type(self).__name__} ({self.name}) does not support sharded execution: "
            f"implement shard_apply or mark it stateless")

    def shard_validate(self, nloc: int, ctx) -> int:
        """Check that a segment of ``nloc`` samples is valid on ctx's mesh;
        return the local output length."""
        if not self.stateless:
            raise NotImplementedError(
                f"{type(self).__name__} ({self.name}) does not support sharded execution")
        if nloc % self.granule:
            raise ValueError(f"{self.name}: local segment {nloc} not a multiple of granule "
                             f"{self.granule}")
        return self.out_len(nloc)

    def shard_layout(self, in_layout):
        """The output's layout (``core/sharding.TIME`` or ``CH``, a tuple
        for a tuple output) given the input's."""
        return in_layout

    def out_len(self, n_in: int) -> int:
        r = self.rate
        if (n_in * r.numerator) % r.denominator:
            raise ValueError(f"{self.name}: {n_in} samples at rate {r} give no whole output")
        return n_in * r.numerator // r.denominator

    def __rshift__(self, other: "Block") -> "Chain":
        return chain(self, other)

    def __repr__(self):
        return f"<{type(self).__name__} {self.name} rate={self.rate} granule={self.granule}>"


def _chain_granule(blocks: Sequence[Block]) -> int:
    """Minimal input length quantum n such that every stage i receives a
    multiple of its granule: n · Π_{j<i} rate_j ≡ 0 (mod granule_i)."""
    need = 1
    acc = Fraction(1)
    for b in blocks:
        den = acc.denominator * b.granule
        num = acc.numerator
        q = den // math.gcd(num, den)
        need = need * q // math.gcd(need, q)
        acc = acc * b.rate
    return need


class Chain(Block):
    def __init__(self, blocks: Sequence[Block], name: str = ""):
        flat: list[Block] = []
        for b in blocks:
            if isinstance(b, Chain):
                flat.extend(b.blocks)
            else:
                flat.append(b)
        self.blocks = tuple(flat)
        self.rate = math.prod((b.rate for b in self.blocks), start=Fraction(1))
        self.granule = _chain_granule(self.blocks)
        self.name = name or ">>".join(b.name or type(b).__name__ for b in self.blocks)
        self._segs = None  # the fused-run plan, made on first use

    def init(self, device: torch.device):
        return tuple(b.init(device) for b in self.blocks)

    def apply(self, state, x):
        new_states = []
        for b, s in zip(self.blocks, state):
            with prof.stage(b, x):   # a span per stage while the recorder is on
                s, x = b.apply(s, x)
            new_states.append(s)
        return tuple(new_states), x

    # ---- fused halo runs ---------------------------------------------------
    # Block by block, a run of k tail-state blocks makes k left-halo
    # exchanges and k last-rank broadcasts per step.  Fused, it exchanges one
    # raw-input context deep enough that every rank recomputes the
    # intermediate histories it needs.  For blocks B_1..B_k with input
    # halos h_i, granules g_i and rates r_i the least context follows the
    # backward recursion
    #     A_k = h_k;   A_i = h_i + E_i,  E_i the least multiple of g_i with
    #                                    E_i·r_i ≥ A_{i+1}
    # and the run's carried state is the last A_1 raw input samples.  Each
    # stage trims its overshoot in whole granules, which keeps the
    # decimators' and resamplers' phase schedules.

    @staticmethod
    def _fusable_tail(b: Block) -> bool:
        """A tail-state block on the default protocol whose zero context
        reproduces its fresh init (zeros in, zeros out, zero init)."""
        return (isinstance(b, TailStateBlock)
                and type(b).shard_apply is TailStateBlock.shard_apply
                and type(b).shard_layout is Block.shard_layout
                and b.fuse_zero_tail
                and b.tail_len > 0)

    @staticmethod
    def _fusable_interior(b: Block) -> bool:
        """A stateless block that can ride inside a run."""
        return (b.stateless
                and type(b).shard_apply is Block.shard_apply
                and type(b).shard_layout is Block.shard_layout)

    @staticmethod
    def _plan_fused(blocks) -> int | None:
        """A_1, the run's least input context, or None where a granule times
        a rate is not whole (the run then executes block by block)."""
        need = 0                      # A_{i+1}
        for b in reversed(blocks):
            h = b.tail_len if isinstance(b, TailStateBlock) else 0
            g, r = b.granule, Fraction(b.rate)
            if (g * r).denominator != 1:
                return None
            E = 0 if need == 0 else -(-need * r.denominator // (r.numerator * g)) * g
            need = h + E
        return int(need)

    def _shard_segments(self):
        """The blocks as ("solo", i) and ("fused", i0, j, A1) runs.  A run
        starts and ends on a tail-state block and holds at least two, so its
        carried tail has block i0's input dtype."""
        if self._segs is not None:
            return self._segs
        n = len(self.blocks)
        segs, i = [], 0
        while i < n:
            if not self._fusable_tail(self.blocks[i]):
                segs.append(("solo", i))
                i += 1
                continue
            j, last_tail, ntail = i, i, 1
            while j + 1 < n and (self._fusable_tail(self.blocks[j + 1])
                                 or self._fusable_interior(self.blocks[j + 1])):
                j += 1
                if self._fusable_tail(self.blocks[j]):
                    last_tail, ntail = j, ntail + 1
            j = last_tail
            A1 = self._plan_fused(self.blocks[i:j + 1]) if ntail >= 2 else None
            if A1 is None:
                segs.append(("solo", i))
                i += 1
            else:
                segs.append(("fused", i, j, A1))
                i = j + 1
        self._segs = segs
        return segs

    def _fused_apply(self, i0: int, j: int, A1: int, tail, x, ctx):
        """One left halo and one last-rank broadcast for the whole run;
        every stage takes its h-sample history from the recomputed
        context."""
        context = ctx.left_halo(x, tail, A1)
        new_tail = ctx.from_last_time(x[..., -A1:].contiguous())
        z = torch.cat([context, x], dim=-1)
        avail = A1                    # context samples ahead of this stage's input
        for b in self.blocks[i0:j + 1]:
            h = b.tail_len if isinstance(b, TailStateBlock) else 0
            E = avail - h
            T = E % b.granule         # whole-granule trim of the overshoot
            if T:
                z, E = z[..., T:], E - T
            _, z = b.apply(z[..., :h], z[..., h:]) if h else b.apply((), z)
            r = Fraction(b.rate)
            avail = int(E * r.numerator) // r.denominator
        return new_tail, z[..., avail:]

    def shard_init(self, device: torch.device):
        out: list = [None] * len(self.blocks)
        for seg in self._shard_segments():
            if seg[0] == "solo":
                out[seg[1]] = self.blocks[seg[1]].shard_init(device)
            else:
                _, i0, j, A1 = seg
                dtype = self.blocks[i0].init(_META).dtype
                out[i0] = torch.zeros((A1,), dtype=dtype, device=device)
                for i in range(i0 + 1, j + 1):
                    out[i] = ()
        return tuple(out)

    def shard_state_spec(self, ctx):
        out: list = [None] * len(self.blocks)
        for seg in self._shard_segments():
            if seg[0] == "solo":
                out[seg[1]] = self.blocks[seg[1]].shard_state_spec(ctx)
            else:
                _, i0, j, _ = seg
                out[i0] = "rep"
                for i in range(i0 + 1, j + 1):
                    out[i] = ()
        return tuple(out)

    def shard_apply(self, state, x, ctx):
        new_states: list = [None] * len(self.blocks)
        for seg in self._shard_segments():
            if seg[0] == "solo":
                i = seg[1]
                b = self.blocks[i]
                new_states[i], x = b.shard_apply(state[i], x, ctx)
                ctx.layout = b.shard_layout(ctx.layout)
            else:
                # a run keeps the layout (_fusable_* check it)
                _, i0, j, A1 = seg
                new_states[i0], x = self._fused_apply(i0, j, A1, state[i0], x, ctx)
                for i in range(i0 + 1, j + 1):
                    new_states[i] = ()
        return tuple(new_states), x

    def shard_validate(self, nloc, ctx):
        """Walk the blocks with the local length.  A tuple of local lengths
        (a multi-rate Tee's) can only end the graph: every port block after
        a tuple combines it (as ``rate_tree`` collapses it), which needs
        equal branch lengths, so a combining block after a multi-rate Tee
        refuses."""
        run_ctx = {s[1]: s[3] for s in self._shard_segments() if s[0] == "fused"}
        for bi, b in enumerate(self.blocks):
            A1 = run_ctx.get(bi)
            if isinstance(nloc, tuple):
                lens = set(_leaves(nloc))
                if len(lens) > 1:
                    raise NotImplementedError(
                        f"{b.name}: cannot consume a multi-rate tuple (local lengths "
                        f"{_leaves(nloc)}) under a mesh: multi-rate Tees must be terminal")
                nloc = lens.pop()
            if A1 is not None and nloc < A1:
                raise ValueError(f"{b.name}: local segment {nloc} shorter than the fused "
                                 f"run's {A1}-sample context: use a larger block or fewer "
                                 f"time shards")
            nloc = b.shard_validate(nloc, ctx)
            ctx.layout = b.shard_layout(ctx.layout)
        return nloc

    def shard_layout(self, in_layout):
        for b in self.blocks:
            in_layout = b.shard_layout(in_layout)
        return in_layout

    def flush_len(self) -> int:
        # block i's allowance is at ITS input rate: scale each back to the
        # chain input by the accumulated rate prefix, rounding up
        total = Fraction(0)
        prefix = Fraction(1)
        for b in self.blocks:
            fl = b.flush_len()
            if fl:
                total += Fraction(fl) / prefix
            prefix *= b.rate
        return int(math.ceil(total))

    def rate_tree(self):
        # A block with its own output structure (Tee) defines the tree, scaled
        # by the rate accumulated on its single-stream input; any other block
        # after a tuple collapses the structure (only same-rate tuples
        # combine elementwise), so its input rate is the first leaf's.
        tree = Fraction(1)
        for b in self.blocks:
            bt = b.rate_tree()
            if not isinstance(bt, Fraction):
                lead = tree if isinstance(tree, Fraction) else _leaves(tree)[0]
                tree = _map_tree(lambda r: lead * r, bt)
            elif isinstance(tree, Fraction):
                tree = tree * bt
            else:
                tree = _leaves(tree)[0] * bt
        return tree


def _leaves(tree) -> list:
    return [leaf for part in tree for leaf in _leaves(part)] if isinstance(tree, tuple) else [tree]


def _map_tree(fn, tree):
    """Apply ``fn`` to every leaf of a tuple/list tree; returns tuples."""
    if isinstance(tree, (tuple, list)):
        return tuple(_map_tree(fn, t) for t in tree)
    return fn(tree)


def chain(*blocks: Block) -> Chain:
    return Chain(blocks)


class TailStateBlock(Block):
    """A block whose carried state is the last ``tail_len`` raw input
    samples (FIR filters, FM demod, …).  That state is the halo a rank
    needs: ``shard_apply`` runs the same ``apply`` on the left neighbour's
    tail and carries the last time rank's.

    ``fuse_zero_tail``: the init state is zeros and zero input with zero
    history gives zero output, so a zero context in a fused run (Chain)
    reproduces the fresh init's warm-up.  FMDemod's init is a unit sample:
    False, it runs solo."""

    tail_len: int = 0
    fuse_zero_tail: bool = True

    def shard_apply(self, state, x, ctx):
        h = self.tail_len
        if h == 0:
            return self.apply(state, x)
        hist = ctx.left_halo(x, state, h)
        _, y = self.apply(hist, x)
        return ctx.from_last_time(x[..., -h:].contiguous()), y

    def shard_validate(self, nloc: int, ctx) -> int:
        if nloc % self.granule:
            raise ValueError(f"{self.name}: local segment {nloc} not a multiple of granule "
                             f"{self.granule}")
        if nloc < self.tail_len:
            raise ValueError(f"{self.name}: local segment {nloc} shorter than its "
                             f"{self.tail_len}-sample halo: use a larger block or fewer "
                             f"time shards")
        return self.out_len(nloc)


class Lambda(Block):
    """Stateless same-rate function of the whole block (reference
    ``mapA``)."""

    stateless = True

    def __init__(self, fn: Callable, name: str = "lambda"):
        self.fn = fn
        self.name = name

    def apply(self, state, x):
        return state, self.fn(x)


class PerChannel(Block):
    """Run a block over a leading channel axis.  The JAX package vmaps the
    inner block; here the batch dimension is written out: the inner block's
    apply works along the last axis, and its state gains a leading
    channel axis."""

    def __init__(self, inner: Block, nch: int, name: str = "per_channel"):
        self.inner = inner
        self.nch = nch
        self.rate = inner.rate
        self.granule = inner.granule
        self.name = f"{name}[{nch}x{inner.name or type(inner).__name__}]"

    def init(self, device: torch.device):
        return _stack_tree([self.inner.init(device) for _ in range(self.nch)])

    def apply(self, state, x):
        return self.inner.apply(state, x)

    def flush_len(self) -> int:
        return self.inner.flush_len()

    # ---- sharded: the channel layout -----------------------------------------
    def shard_init(self, device: torch.device):
        return _stack_tree([self.inner.shard_init(device) for _ in range(self.nch)])

    def shard_state_spec(self, ctx):
        """Every leaf "ch" on a channel axis (each rank carries its own
        channels' rows, no channel collective per step), "rep" without
        one."""
        tag = "ch" if ctx.dc > 1 else "rep"
        # the stack has one inner state's structure; stacking meta tensors
        # would load torch's symbolic-shape machinery (seconds at start-up)
        return _map_tree(lambda _: tag, self.inner.shard_init(_META))

    def shard_apply(self, state, x, ctx):
        """x: this rank's (nch/dc, nloc) panel, ``state`` its stacked rows
        (``ShardedChain`` places them, ``ctx.state_local``).  The inner
        block's sharded step runs once on the whole panel, each row its own
        stream along the last axis, so its time collectives run once per
        step for every row (the JAX package vmaps it per channel)."""
        if ctx.dc > 1 and not ctx.state_local:
            raise ValueError(f"{self.name}: on a {ctx.dc}-way channel axis the state must "
                             f"arrive as this rank's channel rows (ShardedChain places it)")
        return self.inner.shard_apply(state, x, ctx.clone(layout=TIME))

    def shard_validate(self, nloc, ctx):
        if ctx.layout != CH:
            raise ValueError(f"{self.name}: sharded PerChannel requires channelized (nch, n) "
                             f"input layout")
        if self.nch % ctx.dc:
            raise ValueError(f"{self.name}: nch={self.nch} not divisible by the {ctx.dc}-way "
                             f"channel mesh axis")
        return self.inner.shard_validate(nloc, ctx.clone(layout=TIME))


def _stack_tree(states: list):
    first = states[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(states)
    if isinstance(first, dict):
        return {k: _stack_tree([s[k] for s in states]) for k in first}
    return type(first)(_stack_tree(list(parts)) for parts in zip(*states))


class MixChannels(Block):
    """Sum over the channel axis (reference ``mix``).  Sharded, each rank
    sums its channel rows and the ch ranks add their partial sums
    (``ShardCtx.sum_ch``): the output is a time-layout stream, the same on
    every ch rank."""

    stateless = True

    def __init__(self, name: str = "mix"):
        self.name = name

    def apply(self, state, x):
        return state, x.sum(dim=0)

    def shard_apply(self, state, x, ctx):
        return state, ctx.sum_ch(x.sum(dim=0))

    def shard_validate(self, nloc, ctx):
        if ctx.layout != CH:
            raise ValueError(f"{self.name}: mix requires channelized input")
        return nloc

    def shard_layout(self, in_layout):
        return TIME


class Tee(Block):
    """Run two blocks on the same input and output the pair (reference
    ``tee``, without the list zip).  The branches may run at different
    rational rates: ``rate_tree`` reports one rate per branch and the
    runtime trims each output leaf by its own; ``rate`` is branch 1's (the
    primary output, which the runtime counts)."""

    def __init__(self, b1: Block, b2: Block, name: str = "tee"):
        self.b1, self.b2 = b1, b2
        self.rate = b1.rate
        g = b1.granule * b2.granule // math.gcd(b1.granule, b2.granule)
        # a full block must give whole outputs on both branches
        for r in (b1.rate, b2.rate):
            g = g * r.denominator // math.gcd(g, r.denominator)
        self.granule = g
        self.name = name

    def init(self, device: torch.device):
        return (self.b1.init(device), self.b2.init(device))

    def apply(self, state, x):
        s1, y1 = self.b1.apply(state[0], x)
        s2, y2 = self.b2.apply(state[1], x)
        return (s1, s2), (y1, y2)

    def flush_len(self) -> int:
        # one zero fill feeds both branches; the larger allowance wins, and
        # the other branch's extra output is trimmed by its own rate
        return max(self.b1.flush_len(), self.b2.flush_len())

    def rate_tree(self):
        return (self.b1.rate_tree(), self.b2.rate_tree())

    def shard_init(self, device: torch.device):
        return (self.b1.shard_init(device), self.b2.shard_init(device))

    def shard_state_spec(self, ctx):
        return (self.b1.shard_state_spec(ctx), self.b2.shard_state_spec(ctx))

    def shard_apply(self, state, x, ctx):
        s1, y1 = self.b1.shard_apply(state[0], x, ctx.clone())
        s2, y2 = self.b2.shard_apply(state[1], x, ctx.clone())
        return (s1, s2), (y1, y2)

    def shard_validate(self, nloc, ctx):
        """One local length per branch; one number where they agree, so a
        block after a same-rate Tee takes it as one stream."""
        n1 = self.b1.shard_validate(nloc, ctx.clone())
        n2 = self.b2.shard_validate(nloc, ctx.clone())
        return n1 if n1 == n2 else (n1, n2)

    def shard_layout(self, in_layout):
        return (self.b1.shard_layout(in_layout), self.b2.shard_layout(in_layout))


class Delay(TailStateBlock):
    """Pair the stream with an n-sample delayed copy: output (x, delayed x)
    (reference ``delay``).  State: the last n samples.  At the end of the
    stream the runtime feeds ``flush_len() = n`` zeros, so the delayed copy
    completes while the live branch carries zeros; each branch keeps its
    sample order (the reference's fold hands the leftover to the live
    branch instead)."""

    def __init__(self, n: int, dtype: torch.dtype = torch.float32, name: str = "delay"):
        self.n = n
        self.tail_len = n
        self.dtype = dtype
        self.name = f"{name}({n})"

    def init(self, device: torch.device):
        return torch.zeros((self.n,), dtype=self.dtype, device=device)

    def apply(self, state, x):
        full = torch.cat([state, x], dim=-1)
        n = x.shape[-1]
        return full[..., n:].clone(), (x, full[..., :n])

    def flush_len(self) -> int:
        return self.n

    def shard_layout(self, in_layout):
        return (in_layout, in_layout)
