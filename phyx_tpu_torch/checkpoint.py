"""Checkpoint and resume (``phyx_tpu/checkpoint.py``).

A checkpoint is the State's tensors in one ``.npz`` file, under the JAX
package's path names (``bodies/pos``, ..., ``stats/ovf_slab``), so a file
written by either package loads in the other.  Resuming is exact: the
contact cache and the joint accumulators ride along, so warm starting
continues across the restore.

The reference's orbax pair (``save_orbax``/``load_orbax``) is not ported:
``orbax.checkpoint`` imports jax.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from phyx_tpu_torch.convert import _RECORDS
from phyx_tpu_torch.types import State


def _paths(state: State) -> dict:
    """{"record/field": tensor} in the order of ``convert._RECORDS`` and
    each record's fields (the JAX package's flattening order)."""
    return {f"{name}/{f.name}": getattr(getattr(state, name), f.name)
            for name, cls in _RECORDS for f in dataclasses.fields(cls)}


def save(path: str, state: State) -> None:
    """Write the full simulation state to one ``.npz`` file."""
    np.savez_compressed(path, **{
        key: t.detach().cpu().numpy() for key, t in _paths(state).items()})


def load(path: str, like: State) -> State:
    """Restore a state saved by ``save`` (or by the JAX package's).
    ``like`` supplies the structure, the dtypes and the device (build it
    with the same SimConfig capacities).  A missing ``stats/`` counter
    takes ``like``'s value; any other missing field raises ``KeyError``,
    a shape mismatch ``ValueError``."""
    tensors = {}
    with np.load(path) as data:
        for key, ref in _paths(like).items():
            if key not in data:
                if key.startswith("stats/"):
                    # stats counters are observability, not physics: a
                    # file written before a counter existed restores it
                    # from ``like``
                    tensors[key] = ref.clone()
                    continue
                raise KeyError(f"checkpoint missing field {key!r}")
            arr = data[key]
            if arr.shape != tuple(ref.shape):
                raise ValueError(
                    f"checkpoint field {key!r} shape {arr.shape} != "
                    f"expected {tuple(ref.shape)} (capacity mismatch — "
                    f"rebuild with the original SimConfig)")
            tensors[key] = torch.as_tensor(arr).to(
                device=ref.device, dtype=ref.dtype)
    return State(**{name: cls(**{
        f.name: tensors[f"{name}/{f.name}"] for f in dataclasses.fields(cls)})
        for name, cls in _RECORDS})
