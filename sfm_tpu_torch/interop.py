"""State carried between the JAX package and the port.

The system has no learned weights: what crosses between ``sfm_tpu``
and ``sfm_tpu_torch`` is the configuration (dataclasses with the same
fields on both sides; ``config_to_torch``) and the pipeline's
intermediate state — detections,
keypoints / SIFT results, matches, correspondences ``(uv1, uv2, mask)``,
RANSAC minimal-set indices, homography fits, two-view results and the
multi-view state (PnP results, BA problems and states, the incremental
map and result).  The JAX side hands these over as numpy arrays
(``np.asarray`` of its outputs), so this module needs no jax: it maps
numpy containers to port tensors and back.

Field names are identical on both sides, so a JAX NamedTuple converts
to the port's class of the same name, and ``to_numpy`` of a port result
is accepted by the JAX class's constructor (``JaxCls(**nt._asdict())``).
Integer arrays become int64 tensors (the port indexes with int64) and
come back as int32, the JAX package's index type.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sfm_tpu_torch import config
from sfm_tpu_torch.geometry.homography import HomographyResult
from sfm_tpu_torch.geometry.pnp import PnPResult
from sfm_tpu_torch.models.bundle_adjust import BAProblem, BAState
from sfm_tpu_torch.models.incremental import IncrementalResult, MapState
from sfm_tpu_torch.models.two_view import TwoViewResult
from sfm_tpu_torch.sift.detect import Detections
from sfm_tpu_torch.sift.frontend import Keypoints, SiftResult
from sfm_tpu_torch.sift.match import Matches

_PORT_TYPES = {cls.__name__: cls for cls in
               (Detections, Keypoints, SiftResult, Matches, HomographyResult,
                TwoViewResult, PnPResult, BAProblem, BAState, MapState,
                IncrementalResult)}


def _is_namedtuple(obj) -> bool:
    return isinstance(obj, tuple) and hasattr(obj, "_fields")


def to_torch(obj, device="cpu"):
    """numpy arrays / JAX-side containers -> port tensors on ``device``.

    Accepts an array, a tuple or list of them (e.g. correspondences or
    minimal sets), or a NamedTuple whose class name is one of the
    port's state types.
    """
    if _is_namedtuple(obj):
        cls = _PORT_TYPES.get(type(obj).__name__)
        if cls is None:
            raise TypeError(f"no port type for {type(obj).__name__}")
        # A field with a default that the JAX package's type lacks keeps it.
        return cls(**{f: to_torch(getattr(obj, f), device) for f in cls._fields
                      if hasattr(obj, f) or f not in cls._field_defaults})
    if isinstance(obj, (tuple, list)):
        return type(obj)(to_torch(o, device) for o in obj)
    a = np.asarray(obj)
    if a.dtype.kind in "iu":
        a = a.astype(np.int64)
    elif not a.flags.writeable:  # JAX hands out read-only views
        a = a.copy()
    return torch.as_tensor(a, device=device)


def to_numpy(obj):
    """Port tensors / containers -> numpy (NamedTuples keep their type,
    with numpy fields)."""
    if _is_namedtuple(obj):
        return type(obj)(*(to_numpy(v) for v in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(to_numpy(o) for o in obj)
    if isinstance(obj, torch.Tensor):
        a = obj.detach().cpu().numpy()
        return a.astype(np.int32) if a.dtype == np.int64 else a
    return np.asarray(obj)


_CONFIG_TYPES = {cls.__name__: cls for cls in
                 (config.SiftConfig, config.MatchConfig, config.RansacConfig,
                  config.PipelineConfig)}


def config_to_torch(cfg):
    """A JAX-side config dataclass (nested ones included) -> the port's
    class of the same name, field by field."""
    cls = _CONFIG_TYPES.get(type(cfg).__name__)
    if cls is None or not dataclasses.is_dataclass(cfg):
        raise TypeError(f"no port config for {type(cfg).__name__}")
    vals = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        vals[f.name] = config_to_torch(v) if dataclasses.is_dataclass(v) else v
    return cls(**vals)
