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

The JAX package's sharding protocol is not ported here (ROADMAP Queue A,
multi-GPU).
"""

from __future__ import annotations

import math
from fractions import Fraction
from typing import Any, Callable, Sequence

import torch

__all__ = ["Block", "Chain", "chain", "TailStateBlock", "Lambda", "PerChannel", "MixChannels",
           "Tee", "Delay"]


class Block:
    """Base class.  Subclasses define init/apply and may override
    rate/granule."""

    rate: Fraction = Fraction(1)
    granule: int = 1
    name: str = ""

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

    def init(self, device: torch.device):
        return tuple(b.init(device) for b in self.blocks)

    def apply(self, state, x):
        new_states = []
        for b, s in zip(self.blocks, state):
            s, x = b.apply(s, x)
            new_states.append(s)
        return tuple(new_states), x

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
    samples (FIR filters, FM demod, …)."""

    tail_len: int = 0


class Lambda(Block):
    """Stateless same-rate function of the whole block (reference
    ``mapA``)."""

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


def _stack_tree(states: list):
    first = states[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(states)
    if isinstance(first, dict):
        return {k: _stack_tree([s[k] for s in states]) for k in first}
    return type(first)(_stack_tree(list(parts)) for parts in zip(*states))


class MixChannels(Block):
    """Sum over the channel axis (reference ``mix``)."""

    def __init__(self, name: str = "mix"):
        self.name = name

    def apply(self, state, x):
        return state, x.sum(dim=0)


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
