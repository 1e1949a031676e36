"""Checkpoint and resume for streaming pipelines.

Counterpart of ``csdr_tpu/core/checkpoint.py``.  Every block's state is an
explicit tree of tensors, so a checkpoint is (state, stream position, graph
signature), and a resumed stream continues bit for bit.

Format: one ``.npz`` holding the flattened leaves as ``leaf_0`` … ``leaf_N``
(plain numpy arrays of each tensor's dtype: complex64, float32, …) and a
JSON entry with the position, the signature (the graph's name), the leaf
count and the tree's structure.  Tuples, lists and dicts are flattened
depth first, dict keys in sorted order as ``jax.tree`` orders them.  The
JAX package writes the same layout, but with its complex leaves encoded as
float re/im planes (``CEnc``); the port does not read its files.

A load is checked against ``block.init(device)``: leaf count, each leaf's
shape and dtype, and the signature.  Blocks whose state layout differs
from the JAX package's carry a layout version in their name (for example
``flagship_fused(64)/torch-v1``), so a state of one layout cannot resume
another.
"""

from __future__ import annotations

import json

import numpy as np
import torch

__all__ = ["save_state", "load_state", "save_pipeline", "resume_pipeline"]

_META_KEY = "__csdr_meta__"


def _norm_path(path: str) -> str:
    """np.savez appends '.npz' to a path without it: save and load the
    same path string."""
    return path if path.endswith(".npz") else path + ".npz"


def _flatten(tree) -> tuple[list, object]:
    """(leaves, structure): tuples and lists in order, dicts by sorted key."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [_flatten(tree[k]) for k in keys]
        return [leaf for p in parts for leaf in p[0]], {"dict": [[k, p[1]] for k, p in
                                                                 zip(keys, parts)]}
    if isinstance(tree, (tuple, list)):
        parts = [_flatten(t) for t in tree]
        return [leaf for p in parts for leaf in p[0]], {"seq": [p[1] for p in parts]}
    return [tree], "*"


def _unflatten(struct, leaves: list):
    it = iter(leaves)

    def build(s):
        if s == "*":
            return next(it)
        if "dict" in s:
            return {k: build(sub) for k, sub in s["dict"]}
        return tuple(build(sub) for sub in s["seq"])

    return build(struct)


def save_state(path: str, state, *, position: int = 0, signature: str = ""):
    leaves, struct = _flatten(state)
    arrays = {f"leaf_{i}": x.detach().cpu().numpy() for i, x in enumerate(leaves)}
    meta = dict(position=int(position), signature=signature, n_leaves=len(leaves),
                treedef=struct)
    arrays[_META_KEY] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez(_norm_path(path), **arrays)


def load_state(path: str, like_state, device: torch.device, *, signature: str = ""):
    """Load a checkpoint into the structure of ``like_state`` (usually
    ``block.init(device)``), its leaves onto ``device``.  Returns (state,
    position); raises ValueError on a signature, structure, shape or dtype
    mismatch."""
    with np.load(_norm_path(path)) as z:
        meta = json.loads(bytes(z[_META_KEY]).decode())
        if signature and meta["signature"] and meta["signature"] != signature:
            raise ValueError(f"checkpoint signature {meta['signature']!r} != graph {signature!r}")
        leaves, struct = _flatten(like_state)
        if meta["n_leaves"] != len(leaves):
            raise ValueError(f"checkpoint has {meta['n_leaves']} leaves, graph has {len(leaves)}")
        if meta["treedef"] != struct:
            raise ValueError("checkpoint state structure differs from the graph's")
        new_leaves = []
        for i, ref in enumerate(leaves):
            arr = z[f"leaf_{i}"]
            want = torch.empty(0, dtype=ref.dtype).numpy().dtype
            if arr.shape != tuple(ref.shape) or arr.dtype != want:
                raise ValueError(f"leaf {i}: {arr.shape}/{arr.dtype} != "
                                 f"{tuple(ref.shape)}/{want}")
            new_leaves.append(torch.from_numpy(arr).to(device))
        return _unflatten(struct, new_leaves), meta["position"]


def save_pipeline(path: str, pipeline, position: int):
    """Checkpoint a ``core.runtime.Pipeline`` mid-stream: ``position`` is
    the number of input samples its state has consumed."""
    save_state(path, pipeline.state, position=position, signature=pipeline.block.name)


def resume_pipeline(path: str, pipeline) -> int:
    """Restore a Pipeline's state; returns the stream position (input
    samples already consumed), for ``runtime.skip_n`` on the source."""
    like = pipeline.block.init(pipeline.device)
    pipeline.state, position = load_state(path, like, pipeline.device,
                                          signature=pipeline.block.name)
    return position
