"""Process groups and the ('time', 'ch') device mesh.

Counterpart of ``csdr_tpu/parallel/mesh.py`` and of
``parallel/channelized.make_mesh``.  One process per device: NCCL on CUDA
cards (rank r binds ``cuda:LOCAL_RANK``), gloo on the CPU.  A run either
joins the group torchrun set up (``init_distributed()`` reads
``MASTER_ADDR``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``) or starts its own
local ranks with ``spawn``, which meet through a ``file://`` store in a
temporary directory (no fixed port, so concurrent runs never collide).

    python -m torch.distributed.run --nproc-per-node 4 -m csdr_tpu_torch.apps.soapy_sdr_cli \\
        --filename cap.cu8 -n 33554432 -c 64 --mesh 4x1 --backend fused --demod "DeNBFM 0.6 F32"
"""

from __future__ import annotations

import multiprocessing as mp
import multiprocessing.connection
import os
import pickle
import sys
import tempfile
import time
import traceback
from datetime import timedelta
from pathlib import Path

import torch
import torch.distributed as dist

__all__ = ["init_distributed", "build_mesh", "make_mesh", "mesh_shape", "check_devices",
           "spawn"]


def check_devices(world: int, device_type: str):
    """Raise ValueError where this host has fewer CUDA cards than ``world``
    local ranks need (one rank per card)."""
    if device_type == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if world > have:
            raise ValueError(f"{world} ranks need {world} CUDA devices, have {have}")


def init_distributed(rank: int | None = None, world_size: int | None = None,
                     local_rank: int | None = None, init_method: str | None = None,
                     device_type: str = "cuda") -> torch.device:
    """Join the process group and return this rank's device.  Arguments
    left None come from torchrun's variables (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``; ``init_method`` defaults to ``env://``, which reads
    ``MASTER_ADDR`` and ``MASTER_PORT``)."""
    env = os.environ
    rank = int(env["RANK"]) if rank is None else rank
    world_size = int(env["WORLD_SIZE"]) if world_size is None else world_size
    local_rank = int(env.get("LOCAL_RANK", rank)) if local_rank is None else local_rank
    if device_type == "cuda":
        check_devices(local_rank + 1, "cuda")
        device = torch.device("cuda", local_rank)
        torch.cuda.set_device(device)
        backend = "nccl"
    elif device_type == "cpu":
        device, backend = torch.device("cpu"), "gloo"
    else:
        raise ValueError(f"device_type must be 'cuda' or 'cpu', got {device_type!r}")
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank, timeout=timedelta(minutes=10),
                            device_id=device if device_type == "cuda" else None)
    return device


def mesh_shape(n: int) -> tuple[int, int]:
    """(time, ch) for n devices: the largest ch factor in (4, 2, 1) that
    leaves time >= ch (8 → 4×2, 4 → 2×2, 2 → 2×1), as the JAX make_mesh."""
    ch = next(c for c in (4, 2, 1) if n % c == 0 and n // c >= c)
    return n // ch, ch


def build_mesh(time_shards: int, ch_shards: int = 1, device_type: str = "cuda"):
    """DeviceMesh ("time", "ch") over every rank of the group."""
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    if time_shards * ch_shards != world:
        raise ValueError(f"mesh {time_shards}x{ch_shards} needs {time_shards * ch_shards} "
                         f"ranks, the group has {world}")
    return init_device_mesh(device_type, (time_shards, ch_shards),
                            mesh_dim_names=("time", "ch"))


def make_mesh(n: int | None = None, device_type: str = "cuda"):
    """``build_mesh`` with the shape ``mesh_shape`` picks for n ranks
    (default: the whole group)."""
    return build_mesh(*mesh_shape(n or dist.get_world_size()), device_type=device_type)


def _rank_main(fn, rank: int, world: int, device_type: str, tmp: str, args: tuple):
    """One spawned rank: join the group, run ``fn(device, *args)``, leave
    its pickled result (or its traceback) in ``tmp``."""
    try:
        if device_type == "cpu":
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
            # the ranks are local: gloo's sockets stay on the loopback
            os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        device = init_distributed(rank, world, rank, f"file://{tmp}/store", device_type)
        out = fn(device, *args)
        with open(f"{tmp}/rank{rank}.part", "wb") as f:
            pickle.dump(out, f)
        os.replace(f"{tmp}/rank{rank}.part", f"{tmp}/rank{rank}.pkl")
        dist.destroy_process_group()
    except BaseException:
        with open(f"{tmp}/rank{rank}.err", "w") as f:
            f.write(traceback.format_exc())
        sys.stderr.write(f"rank {rank} failed:\n{traceback.format_exc()}")
        sys.stderr.flush()
        os._exit(1)  # not sys.exit: a rank stuck in a collective must not hold the exit


def spawn(fn, world: int, device_type: str = "cuda", args: tuple = (),
          timeout: float = 900.0) -> list:
    """Run ``fn(device, *args)`` on ``world`` local ranks, one process each
    (the ``spawn`` start method: ``fn`` and ``args`` are pickled, so ``fn``
    is a module-level function), and return each rank's result in rank
    order.  A rank that fails or a run that outlasts ``timeout`` seconds
    kills every rank and raises, so no rank is left waiting in a
    collective.  On CUDA the kernels are built here first, once, so the
    ranks do not compile the same sources side by side."""
    check_devices(world, device_type)
    if device_type == "cuda":
        from ..ops.cuda import _build

        _build.build()
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="csdr-mesh-") as tmp:
        procs = [ctx.Process(target=_rank_main, args=(fn, r, world, device_type, tmp, args),
                             daemon=True) for r in range(world)]
        for p in procs:
            p.start()
        try:
            deadline = time.monotonic() + timeout
            while True:
                failed = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
                if failed:
                    # report the rank that failed first: the others may have
                    # failed after it, in a collective whose peer went away
                    errs = {r: Path(tmp) / f"rank{r}.err" for r in failed}
                    r = min(failed, key=lambda r: (errs[r].stat().st_mtime_ns
                                                   if errs[r].exists() else float("inf"), r))
                    err = errs[r]
                    why = err.read_text() if err.exists() else "no traceback"
                    raise RuntimeError(f"rank {r} of {world} failed (exit code "
                                       f"{procs[r].exitcode}):\n{why}")
                running = [p.sentinel for p in procs if p.exitcode is None]
                if not running:
                    break
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"{world} ranks did not finish within {timeout} s")
                mp.connection.wait(running, timeout=min(left, 1.0))
        finally:
            for p in procs:
                if p.exitcode is None:
                    p.kill()
            for p in procs:
                p.join(10)
        out = []
        for r in range(world):
            with open(f"{tmp}/rank{r}.pkl", "rb") as f:
                out.append(pickle.load(f))
        return out
