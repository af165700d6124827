"""Map and pose checkpoints (counterpart of
``sfm_tpu/utils/checkpoint.py``).

The reconstruction state (poses, points, track tables) goes to one
``.npz`` in the JAX package's exact format: an ``f_<field>`` array per
field and a ``__meta__`` JSON of the field names, the state's type and
caller extras.  The port indexes with int64, the JAX package with
int32, so integer fields are written as int32 and read back as int64:
a map written by either package loads in the other.
"""

from __future__ import annotations

import json

import numpy as np
import torch


def _to_numpy(v):
    a = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    return a.astype(np.int32) if a.dtype.kind in "iu" else a


def save_map(path, state, extra: dict | None = None):
    """Persist an incremental.MapState (or any NamedTuple of tensors)."""
    fields = state._asdict()
    arrays = {f"f_{name}": _to_numpy(v) for name, v in fields.items()}
    meta = {"fields": list(fields), "type": type(state).__name__}
    if extra:
        meta["extra"] = extra
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def load_map(path, cls=None):
    """Load a checkpoint; returns (state, extra) where state is ``cls``
    (default: the port's MapState for a MapState file) of CPU tensors,
    integers as int64, or a dict of numpy arrays when no class
    applies."""
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(bytes(data["__meta__"]).decode())
        fields = {name: data[f"f_{name}"] for name in meta["fields"]}
    extra = meta.get("extra")
    if cls is None and meta.get("type") == "MapState":
        from sfm_tpu_torch.models.incremental import MapState

        cls = MapState
    if cls is None or meta.get("type") != cls.__name__:
        return fields, extra
    return cls(**{k: torch.as_tensor(v.astype(np.int64) if v.dtype.kind in "iu" else v)
                  for k, v in fields.items()}), extra
