"""A configuration's graph, built from the recipe in its file.

A recipe is ``{"call": name, "args": [...], "kwargs": {...}}``: ``name`` is
an attribute of ``csdr_tpu_torch`` (``"chain"``, ``"u8_to_iq"``) or a
dotted path below it (``"models.receivers.channelized_receiver"``); an
argument that is itself a recipe is built first.  So a configuration adds
a graph of the port's public blocks without code.
"""

from __future__ import annotations

import importlib

PACKAGE = "csdr_tpu_torch"


def resolve(name: str):
    """The object ``name`` names inside the port's package."""
    mod, _, attr = name.rpartition(".")
    target = importlib.import_module(f"{PACKAGE}.{mod}" if mod else PACKAGE)
    return getattr(target, attr)


def build(recipe, **extra):
    """Build ``recipe``; ``extra`` keyword arguments go to the outermost
    call (a mesh, a block size)."""
    if isinstance(recipe, dict) and "call" in recipe:
        args = [build(a) for a in recipe.get("args", [])]
        kwargs = {k: build(v) for k, v in recipe.get("kwargs", {}).items()}
        return resolve(recipe["call"])(*args, **kwargs, **extra)
    if isinstance(recipe, list):
        return [build(a) for a in recipe]
    return recipe


def state_at(state, path: list):
    """The leaf of a graph's state tree at ``path`` (indices and keys)."""
    for p in path:
        state = state[p]
    return state
