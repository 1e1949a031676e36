"""ShardedChain: any Block graph over a ('time', 'ch') mesh, one process
per device.

Counterpart of ``csdr_tpu/parallel/generic.py``.  The graph is checked
before any collective runs: the block size must be a multiple of
time ranks · the graph's granule, and ``shard_validate`` walks the graph
on a static ctx (the mesh's shape, no process group) for each block's
halo, granule and channel split, giving the local output length and the
output layout.  Then every rank steps its contiguous time segment through
``shard_apply``, coupled to the others by ``core/sharding.ShardCtx``'s
collectives:

  * input: this rank's (block_size / dt,) segment (complex64, or cu8 as
    (n, 2) uint8 rows behind ``U8ToIQ``);
  * carried state: ``shard_init``'s tree, placed by ``shard_state_spec``:
    a "rep" leaf is whole on every rank and each update is the last time
    rank's, so streaming is exact on any mesh; a "ch" leaf (a
    ``PerChannel`` stack on a channel axis) holds only this rank's rows
    [ci·nch/dc, (ci+1)·nch/dc) from ``init`` on;
  * output: per leaf by its layout (a tuple for a Tee): a time-layout
    stream, this rank's time segment replicated over 'ch'; behind a
    ``PFBChannelizer`` a (nch/dc, F/dt) panel, this rank's channels and
    frames (``MixChannels`` sums them back into a stream).

The reference's defining property, that any composition of Pipes works,
holds here one level up: any composition of these blocks shards.
"""

from __future__ import annotations

from fractions import Fraction

from ..core.block import Block
from ..core.sharding import TIME, ShardCtx, mesh_dims, place_state

__all__ = ["ShardedChain"]


class ShardedChain:
    """Sharded streaming executor of ``block`` over ``mesh`` (a DeviceMesh
    with dimensions ("time"[, "ch"])).  Every rank constructs it and calls
    ``step`` together; ``ShardedPipeline`` drives it."""

    def __init__(self, block: Block, mesh, block_size: int):
        dt, dc = mesh_dims(mesh)
        self.nloc_out, self.out_layout = self.validate(block, dt, dc, block_size)
        self.block = block
        self.block_size = block_size
        self.nloc = block_size // dt
        self.rate: Fraction = block.rate
        self.state_tags = block.shard_state_spec(ShardCtx.static(dt, dc))
        self.ctx = ShardCtx(mesh)   # the first collectives
        self.device = self.ctx.device

    @staticmethod
    def validate(block: Block, dt: int, dc: int, block_size: int):
        """(local output length, output layout) of ``block`` on a dt × dc
        mesh at ``block_size``, or ValueError (a size that does not fit, a
        channel count the ch axis does not divide) or NotImplementedError
        (a block that cannot be sharded).  No process group is needed."""
        g = block.granule
        if block_size % (dt * g):
            raise ValueError(f"block_size {block_size} must be a multiple of "
                             f"time_shards·granule = {dt}·{g}")
        nloc_out = block.shard_validate(block_size // dt, ShardCtx.static(dt, dc))
        return nloc_out, block.shard_layout(TIME)

    def rate_tree(self):
        return self.block.rate_tree()

    def flush_len(self) -> int:
        return self.block.flush_len()

    def init(self):
        """This rank's state: the "ch" leaves as its channel rows."""
        return place_state(self.block.shard_init(self.device), self.state_tags, self.ctx.ci,
                           self.ctx.dc)

    def step(self, state, x):
        """(state, this rank's segment) → (state, this rank's output)."""
        return self.block.shard_apply(state, x, self.ctx.clone(layout=TIME, state_local=True))
