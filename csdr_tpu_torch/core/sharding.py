"""Collective helpers of a sharded step on a ('time', 'ch') device mesh.

Counterpart of ``csdr_tpu/core/sharding.py`` on ``torch.distributed``: one
process per device, each holding its contiguous time segment of the block
(and, behind a channelizer, its rows of the channel panel).  The mesh is a
``DeviceMesh`` with dimensions ("time", "ch"); rank = ti·dc + ci, the
row-major order of the JAX mesh's ``reshape(dt, dc)``.  The JAX
collectives map to

    lax.ppermute (j → j+1 over 'time')   dist.batch_isend_irecv in the time group
    lax.all_gather                       dist.all_gather in the time or ch group
    masked psum from the last time index dist.broadcast from the last time rank
    lax.psum over 'ch' / 'time'          dist.all_reduce in the ch / time group

The broadcast is exact where the psum added zeros.  Complex tensors cross
the wire as ``torch.view_as_real`` planes and bools as uint8.  Carried state
is replicated over 'time'; each collective that updates it takes the last
time rank's value, so streaming across blocks is exact on any mesh shape.
A "ch"-placed leaf (``PerChannel``'s stacked state under ``ShardedChain``,
``state_local``) holds only this rank's channel rows.  Everything works
along the last axis, the time axis of a 1-D stream and of a (rows, n)
channel panel alike.

A ctx carries the ``layout`` of the data at the current point of a graph
(``TIME`` or ``CH``; ``core/block.Chain`` updates it from each block's
``shard_layout``).  ``ShardCtx.static(dt, dc)`` is the ctx of
``Block.shard_validate``: the mesh's shape and the layout, no process
group, so a graph is checked before any collective runs.  The port's
``ti``/``ci`` are ints (the JAX ctx's are methods that trace
``axis_index``).
"""

from __future__ import annotations

import copy
import functools

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["ShardCtx", "TIME", "CH", "mesh_dims", "place_state"]

# layout tags for data flowing through a sharded step
TIME = "time"   # 1-D stream, this rank's time segment, replicated over ch
CH = "ch"       # (nch, frames) panel, this rank's channel rows and frames


# ---- host float64 decay tables, copied from csdr_tpu/core/sharding.py ----
@functools.lru_cache(maxsize=None)
def _apow_vec(a: complex, n: int, is_complex: bool) -> np.ndarray:
    """Host-precomputed a^(i+1), i in [0, n) — the particular-solution decay."""
    p = np.power(complex(a) if is_complex else float(a), np.arange(1, n + 1))
    return p.astype(np.complex64 if is_complex else np.float32)


@functools.lru_cache(maxsize=None)
def _astep_table(a: complex, nloc: int, dt: int, is_complex: bool) -> np.ndarray:
    """Host-precomputed a^(i·nloc) for i in [0, dt) (float64/complex128
    accumulated) — per-device decay of the incoming carry."""
    p = np.power(complex(a) if is_complex else float(a),
                 np.arange(dt, dtype=np.float64) * nloc)
    return p.astype(np.complex64 if is_complex else np.float32)


@functools.lru_cache(maxsize=None)
def _carry_coef_table(a: complex, nloc: int, dt: int, is_complex: bool) -> np.ndarray:
    """(dt, dt) table C[i, j] = a^(nloc·(i−1−j)) for j < i else 0: the weight
    of device j's local end value in device i's incoming carry."""
    i = np.arange(dt)[:, None]
    j = np.arange(dt)[None, :]
    expo = np.maximum((i - 1 - j) * nloc, 0).astype(np.float64)
    base = complex(a) if is_complex else float(a)
    C = np.where(j < i, np.power(base, expo), 0.0)
    return C.astype(np.complex64 if is_complex else np.float32)


def _to_wire(t: torch.Tensor) -> torch.Tensor:
    if t.is_complex():
        return torch.view_as_real(t.contiguous())
    if t.dtype == torch.bool:
        return t.to(torch.uint8)
    return t.contiguous()


def _from_wire(w: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if like.is_complex():
        return torch.view_as_complex(w)
    if like.dtype == torch.bool:
        return w != 0
    return w


def _map_leaves(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_map_leaves(fn, t) for t in tree)
    return fn(tree)


def place_state(state, tags, ci: int, dc: int):
    """This rank's share of a ``shard_init`` state: a leaf tagged "ch"
    (``Block.shard_state_spec``) keeps rows [ci·n/dc, (ci+1)·n/dc) of its
    leading axis, a "rep" leaf stays whole.  A tag stands for the whole
    subtree below it (``shard_state_spec`` tags a dict state as one)."""
    if isinstance(tags, str):
        if tags == "rep" or dc == 1:
            return state

        def rows(a):
            n = a.shape[0] // dc
            return a[ci * n:(ci + 1) * n].clone()

        return _map_leaves(rows, state)
    return tuple(place_state(s, t, ci, dc) for s, t in zip(state, tags))


def mesh_dims(mesh) -> tuple[int, int]:
    """(time ranks, ch ranks) of a ("time"[, "ch"]) ``DeviceMesh``."""
    dims = dict(zip(mesh.mesh_dim_names, mesh.shape))
    if "time" not in dims or set(dims) - {"time", "ch"}:
        raise ValueError(f"mesh needs a 'time' and an optional 'ch' dimension, got "
                         f"{mesh.mesh_dim_names}")
    return dims["time"], dims.get("ch", 1)


class ShardCtx:
    """This rank's place on the mesh and the collectives a sharded step
    uses.  ``mesh`` is a ``DeviceMesh`` with a "time" dimension and an
    optional "ch" one; every rank of the mesh constructs its ShardCtx
    together (the constructor runs one collective per group)."""

    def __init__(self, mesh):
        self.dt, self.dc = mesh_dims(mesh)
        self.mesh = mesh
        self.layout = TIME
        # True under ShardedChain: a "ch"-placed state leaf arrives as this
        # rank's channel rows (PerChannel reads it)
        self.state_local = False
        self.ti = mesh.get_local_rank("time")
        has_ch = "ch" in mesh.mesh_dim_names
        self.ci = mesh.get_local_rank("ch") if has_ch else 0
        self.time_group = mesh.get_group("time")
        self.ch_group = mesh.get_group("ch") if has_ch else None
        self.device = (torch.device("cuda", torch.cuda.current_device())
                       if mesh.device_type == "cuda" else torch.device(mesh.device_type))
        self._time_ranks = [dist.get_global_rank(self.time_group, i) for i in range(self.dt)]
        # linrec's device tables, shared by this ctx's clones and freed with them
        self._linrec_tables: dict = {}
        # a first collective in each group, joined by all its ranks, before
        # any point-to-point exchange (NCCL wants one to set up its
        # communicator)
        for g in (self.time_group, self.ch_group):
            if g is not None:
                dist.all_reduce(torch.zeros(1, device=self.device), group=g)

    @classmethod
    def static(cls, dt: int, dc: int = 1, layout=TIME) -> "ShardCtx":
        """The ctx of ``shard_validate``: the mesh's shape and the layout,
        with no process group and no collective."""
        c = cls.__new__(cls)
        c.dt, c.dc, c.mesh, c.layout, c.state_local = dt, dc, None, layout, False
        return c

    def clone(self, **kw) -> "ShardCtx":
        """A copy sharing the groups, with the attributes ``kw`` set (a Tee
        branch's own ``layout``)."""
        c = copy.copy(self)
        for k, v in kw.items():
            setattr(c, k, v)
        return c

    # ---- point to point over 'time' ---------------------------------------
    def send_right(self, t: torch.Tensor) -> torch.Tensor | None:
        """``t`` of the left time neighbour (ppermute j → j+1); None on the
        first time rank.  Every time rank calls it with a tensor of the same
        shape and dtype."""
        if self.dt == 1:
            return None
        w = _to_wire(t)
        ops, buf = [], None
        if self.ti + 1 < self.dt:
            ops.append(dist.P2POp(dist.isend, w, self._time_ranks[self.ti + 1],
                                  self.time_group))
        if self.ti > 0:
            buf = torch.empty_like(w)
            ops.append(dist.P2POp(dist.irecv, buf, self._time_ranks[self.ti - 1],
                                  self.time_group))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return None if buf is None else _from_wire(buf, t)

    def send_left(self, t: torch.Tensor) -> torch.Tensor | None:
        """``t`` of the right time neighbour (ppermute j+1 → j); None on the
        last time rank."""
        if self.dt == 1:
            return None
        w = _to_wire(t)
        ops, buf = [], None
        if self.ti > 0:
            ops.append(dist.P2POp(dist.isend, w, self._time_ranks[self.ti - 1],
                                  self.time_group))
        if self.ti + 1 < self.dt:
            buf = torch.empty_like(w)
            ops.append(dist.P2POp(dist.irecv, buf, self._time_ranks[self.ti + 1],
                                  self.time_group))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return None if buf is None else _from_wire(buf, t)

    def left_halo(self, x: torch.Tensor, carried_tail: torch.Tensor, h: int) -> torch.Tensor:
        """The last ``h`` samples (last axis) before this rank's segment:
        the left neighbour's tail, (..., h); the first time rank gets the
        carried global tail.  Inside ``PerChannel`` ``x`` is a (rows, n)
        panel and every row takes its own halo."""
        left = self.send_right(x[..., -h:] if h > 0 else x[..., :0])
        return carried_tail if left is None else left

    def right_halo(self, x: torch.Tensor, r: int) -> torch.Tensor:
        """The first ``r`` samples (last axis) of the right neighbour's
        segment; the last time rank gets its own final sample repeated, as
        a single device's clamped read at the end of the block."""
        if r <= 0:
            return x[..., :0]
        right = self.send_left(x[..., :r])
        return x[..., -1:].expand(tuple(x.shape[:-1]) + (r,)) if right is None else right

    # ---- collectives --------------------------------------------------------
    def from_last_time(self, val: torch.Tensor) -> torch.Tensor:
        """``val`` as the last time rank holds it, on every time rank."""
        if self.dt == 1:
            return val
        w = _to_wire(val)
        if self.ti != self.dt - 1:
            w = torch.empty_like(w)
        dist.broadcast(w, self._time_ranks[-1], group=self.time_group)
        return _from_wire(w, val)

    def _gather(self, t: torch.Tensor, group, n: int) -> torch.Tensor:
        w = _to_wire(t)
        parts = [torch.empty_like(w) for _ in range(n)]
        dist.all_gather(parts, w, group=group)
        return _from_wire(torch.stack(parts), t)

    def all_gather_time(self, t: torch.Tensor) -> torch.Tensor:
        """(dt, *t.shape): every time rank's ``t``, in time order."""
        return t[None] if self.dt == 1 else self._gather(t, self.time_group, self.dt)

    def all_gather_ch(self, t: torch.Tensor) -> torch.Tensor:
        """Every ch rank's ``t`` joined along the leading axis, in ch order:
        this rank's channel rows → all nch rows."""
        if self.dc == 1:
            return t
        g = self._gather(t, self.ch_group, self.dc)
        return g.reshape((-1,) + tuple(t.shape[1:]))

    def _sum(self, t: torch.Tensor, group) -> torch.Tensor:
        w = _to_wire(t).clone()
        dist.all_reduce(w, group=group)
        return _from_wire(w, t)

    def sum_ch(self, t: torch.Tensor) -> torch.Tensor:
        """Σ of ``t`` over the ch ranks, on every one of them (the JAX psum
        over 'ch'); ``t`` itself where dc = 1."""
        return t if self.dc == 1 else self._sum(t, self.ch_group)

    def sum_time(self, t: torch.Tensor) -> torch.Tensor:
        """Σ of ``t`` over the time ranks, on every one of them (the JAX
        psum over 'time'); ``t`` itself where dt = 1.  The ranks' terms add
        in the collective's order, not in one serial reduction's."""
        return t if self.dt == 1 else self._sum(t, self.time_group)

    # ---- distributed linear recurrence ---------------------------------------
    def _linrec_tables_on(self, a, nloc: int, is_complex: bool, device: torch.device,
                          dtype: torch.dtype):
        """``linrec``'s a^(i+1) vector and this rank's carry weights on
        ``device``, made once per ctx: a blocking host→device copy
        synchronises the stream, so none runs per step."""
        key = (a, nloc, is_complex, device, dtype)
        if key not in self._linrec_tables:
            self._linrec_tables[key] = (
                torch.from_numpy(_apow_vec(a, nloc, is_complex)).to(device, dtype),
                torch.from_numpy(_carry_coef_table(a, nloc, self.dt, is_complex)[self.ti])
                .to(device, dtype))
        return self._linrec_tables[key]

    def linrec(self, forcing: torch.Tensor, a: complex | float, carry0: torch.Tensor):
        """Solve y[n] = a·y[n−1] + forcing[n] along the last axis, across the
        time mesh.  ``forcing``: (..., nloc) this rank's segment, one
        recurrence per row; ``carry0``: the global incoming carry y[−1] of
        each row (replicated).  Returns ``(y, y_in, new_carry)``: the local
        solution, this rank's incoming carry and the end-of-block carry
        (the last time rank's, on every rank).

        Each rank solves with zero carry (w), the end values are
        all-gathered over 'time' and the incoming carry is rebuilt in
        closed form from the host float64 tables:

            y_in[i] = a^(i·nloc)·carry0 + Σ_{j<i} a^(nloc·(i−1−j))·w_end[j]
        """
        from ..ops.linrec import linrec

        nloc = forcing.shape[-1]
        if isinstance(a, complex) and a.imag == 0.0:
            a = a.real
        a_complex = isinstance(a, complex)
        carry0 = torch.as_tensor(carry0, device=forcing.device)
        out_complex = a_complex or forcing.is_complex() or carry0.is_complex()
        dtt = torch.complex64 if out_complex else torch.float32
        forcing, carry0 = forcing.to(dtt), carry0.to(dtt)
        apow, coef = self._linrec_tables_on(a, nloc, a_complex, forcing.device, dtt)
        w = linrec(forcing, a, torch.zeros((), dtype=dtt, device=forcing.device))
        if self.dt == 1:
            y_in = carry0.expand(forcing.shape[:-1])
        else:
            ends = self.all_gather_time(w[..., -1])                    # (dt, ...)
            astep = _astep_table(a, nloc, self.dt, a_complex)[self.ti]
            y_in = astep.item() * carry0 + torch.tensordot(coef, ends, dims=1)
        y = w + apow * y_in[..., None]
        return y, y_in, self.from_last_time(y[..., -1].contiguous())

    # ---- sharded FIR ----------------------------------------------------------
    def fir(self, taps: np.ndarray, hist: torch.Tensor, x: torch.Tensor,
            strategy: str = "auto"):
        """Sharded ``ops/fir.fir_stream`` along the last axis: the (K−1)
        history comes from the left neighbour, the first time rank's from
        the carried ``hist``; the new carried history is the last time
        rank's input tail."""
        from ..ops.fir import fir_stream

        K = len(taps)
        if K == 1:
            return hist, x * float(taps[0])
        h = K - 1
        left = self.send_right(x[..., -h:])
        _, y = fir_stream(taps, hist if left is None else left, x, strategy)
        return self.from_last_time(x[..., -h:].contiguous()), y
