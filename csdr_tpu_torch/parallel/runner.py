"""Streaming runner of a sharded receiver: host feed → sharded step →
sinks, over every rank of the mesh.

Counterpart of ``csdr_tpu/parallel/runner.py`` (``ShardedPipeline``) on
``torch.distributed``.  Every rank constructs the runner and calls ``run``
(or iterates ``stream``) together.  Rank 0 alone reads the source: it
re-blocks it (``rechunk``, ``take_n``, and in ``run`` the graph's
end-of-stream flush allowance, ``append_flush``), zero-pads the last short
block, stages each block as the serial ``Pipeline`` does (``_Staging``: two
pinned buffers that take turns on a card) and scatters its time segments
over the 'time' group in the source's own wire type (cu8 as uint8 (n, 2)
rows, complex64 as float32 (n, 2) planes, a real stream, such as an FM
composite, as float32 (n, 1)); each ch group broadcasts its segment from
its first rank.  Every rank steps, and rank 0 gathers each
output leaf: a channel-layout panel (nch/dc, F/dt) from every rank, a
time-layout leaf (replicated over 'ch') from the ranks of its own time
group.  Rank 0 trims each leaf to its rational-rate sample count
(``core/runtime._trim_tree`` with the graph's ``rate_tree``) and alone
owns the sinks.
"""

from __future__ import annotations

from typing import Callable, Iterable, Iterator

import numpy as np
import torch
import torch.distributed as dist

from ..core.block import _leaves, _map_tree
from ..core.runtime import _Staging, _trim_tree, append_flush, rechunk, take_n
from ..core.sharding import CH, _from_wire, _to_wire

__all__ = ["ShardedPipeline"]

# header code → (wire dtype, wire width): complex64 planes, cu8 rows, real
_WIRE = {0: (torch.float32, 2), 1: (torch.uint8, 2), 2: (torch.float32, 1)}


class ShardedPipeline:
    """Feed/drain loop around a sharded step (``ShardedChain``,
    ``ShardedFlagship`` or ``ShardedChannelizedFM``): anything with
    ``ctx``, ``init()``, ``step(state, x)``, ``block_size``,
    ``rate_tree()``, ``flush_len()``, ``out_layout`` and ``device``."""

    def __init__(self, sharded):
        self.sh = sharded
        self.ctx = sharded.ctx
        self.block_size = sharded.block_size
        self.rate_tree = sharded.rate_tree()
        self.layout = sharded.out_layout   # a tag, or a tree of them (a Tee)
        self.device = sharded.device
        self.rank = dist.get_rank()
        self.state = sharded.init()
        self._staging = _Staging(self.device)

    def _host_blocks(self, source: Iterable[np.ndarray], num_samples: int | None):
        """Rank 0: (block padded to block_size, valid samples) per block."""
        it: Iterable[np.ndarray] = source
        if num_samples is not None:
            it = take_n(it, num_samples)
        n = self.block_size
        for chunk in rechunk(it, n):
            valid = len(chunk)
            if valid < n:
                chunk = np.pad(chunk, [(0, n - valid)] + [(0, 0)] * (chunk.ndim - 1))
            yield chunk, valid

    def _stage(self, chunk: np.ndarray) -> tuple[torch.Tensor, int]:
        """Rank 0: a host block as its (n, width) wire tensor on the device
        and the wire's header code."""
        if np.iscomplexobj(chunk):
            wire, code = np.ascontiguousarray(chunk, np.complex64).view(np.float32), 0
        elif chunk.dtype == np.uint8 and chunk.ndim == 2:
            wire, code = chunk, 1
        elif chunk.dtype == np.float32 and chunk.ndim == 1:
            wire, code = chunk, 2
        else:
            raise TypeError(f"source blocks must be complex, float32 or cu8 (n, 2) uint8 rows, "
                            f"got {chunk.dtype} {chunk.shape}")
        return self._staging(wire.reshape(self.block_size, _WIRE[code][1])), code

    def _segment(self, block: torch.Tensor | None, code: int) -> torch.Tensor:
        """This rank's time segment of the block: scattered over the 'time'
        group from rank 0, then broadcast over each 'ch' group."""
        ctx = self.ctx
        nloc = self.block_size // ctx.dt
        dtype, width = _WIRE[code]
        seg = block if ctx.dt == 1 and self.rank == 0 else torch.empty(
            (nloc, width), dtype=dtype, device=self.device)
        if ctx.ci == 0 and ctx.dt > 1:
            parts = list(block.view(ctx.dt, nloc, width).unbind(0)) if self.rank == 0 else None
            dist.scatter(seg, parts, src=0, group=ctx.time_group)
        if ctx.dc > 1:
            dist.broadcast(seg, dist.get_global_rank(ctx.ch_group, 0), group=ctx.ch_group)
        if code == 1:
            return seg
        return seg[:, 0] if code == 2 else torch.view_as_complex(seg)

    def _gather_tree(self, y, layout):
        """Every output leaf by its own layout (one tag may stand for a
        subtree), in the same order on every rank."""
        if isinstance(y, tuple):
            lays = layout if isinstance(layout, tuple) else (layout,) * len(y)
            return tuple(self._gather_tree(a, lay) for a, lay in zip(y, lays))
        return self._gather(y, layout)

    def _gather(self, y: torch.Tensor, layout) -> torch.Tensor | None:
        """One output leaf of every rank → the whole leaf on rank 0 (None
        elsewhere)."""
        ctx, y = self.ctx, y.contiguous()
        if ctx.dt * ctx.dc == 1:
            return y
        if layout != CH:
            return self._gather_time(y)
        w = _to_wire(y)
        parts = [torch.empty_like(w) for _ in range(ctx.dt * ctx.dc)] if self.rank == 0 else None
        dist.gather(w, parts, dst=0)
        if parts is None:
            return None
        # rank = ti·dc + ci: (dt, dc, rows, frames) → (dc·rows, dt·frames)
        g = _from_wire(torch.stack(parts), y).view(ctx.dt, ctx.dc, *y.shape)
        return g.permute(1, 2, 0, 3).reshape(ctx.dc * y.shape[0], ctx.dt * y.shape[1])

    def _gather_time(self, y: torch.Tensor) -> torch.Tensor | None:
        """A time-layout leaf, replicated over 'ch': rank 0's time group
        (ci = 0) gathers its segments, joined along the last axis."""
        ctx = self.ctx
        if ctx.ci != 0:
            return None
        if ctx.dt == 1:
            return y
        w = _to_wire(y)
        parts = [torch.empty_like(w) for _ in range(ctx.dt)] if self.rank == 0 else None
        dist.gather(w, parts, dst=0, group=ctx.time_group)
        if parts is None:
            return None
        return torch.cat([_from_wire(p, y) for p in parts], dim=-1)

    def stream(self, source: Iterable[np.ndarray] | None = None,
               num_samples: int | None = None) -> Iterator:
        """Yield each block's output trimmed leaf by leaf to its
        rational-rate count: numpy on rank 0 (a tuple of arrays for a tuple
        output), None on the others.  Only rank 0's ``source`` is read.  No
        flush, as in the serial ``Pipeline.stream``: ``run`` appends it."""
        blocks = self._host_blocks(source, num_samples) if self.rank == 0 else None
        header = torch.zeros(2, dtype=torch.int64, device=self.device)
        while True:
            block = None
            if blocks is not None:
                nxt = next(blocks, None)
                if nxt is not None:
                    block, code = self._stage(nxt[0])
                    header.copy_(torch.tensor([nxt[1], code]))
                else:
                    header.zero_()
            dist.broadcast(header, 0)
            valid, code = (int(v) for v in header.tolist())
            if valid == 0:
                return
            self.state, y = self.sh.step(self.state, self._segment(block, code))
            out = self._gather_tree(y, self.layout)
            if self.rank != 0:
                yield None
                continue
            trimmed, _ = _trim_tree(out, self.rate_tree, valid)
            yield _map_tree(lambda t: t.cpu().numpy(), trimmed)

    def run(self, source: Iterable[np.ndarray] | None, sink: Callable | None,
            num_samples: int | None = None) -> int:
        """Stream rank 0's source (cut to ``num_samples``, then the graph's
        flush allowance, as the serial ``Pipeline.run``) through the sharded
        step into rank 0's sink; returns the output samples of the first
        output leaf (per channel for a panel; on rank 0, 0 elsewhere)."""
        if self.rank == 0:
            if num_samples is not None:
                source = take_n(source, num_samples)
            if self.sh.flush_len():
                source = append_flush(source, self.sh.flush_len())
        total = 0
        for out in self.stream(source):
            if out is not None:
                sink(out)
                total += _leaves(out)[0].shape[-1]
        return total
