"""Build, load and count the port's hand-written CUDA kernels.

The kernels live in ``sfm_tpu_torch/csrc/*.cu`` behind a plain C
interface.  On first use they are compiled with ``nvcc`` for Hopper
(``sm_90a``) into one shared library under ``sfm_tpu_torch/_build/``
(named by a hash of the sources and flags, so an edited source
rebuilds) and loaded with ``ctypes``.  Nothing here runs at import
time: a machine without ``nvcc`` or a card imports the package fine
and only fails when a CUDA tensor reaches a kernel wrapper.

Each C entry point launches on the stream it is given (PyTorch's
current stream), allocates nothing and returns ``cudaGetLastError()``;
:func:`check` raises on a non-zero code.  Every wrapper counts its
launches in :data:`LAUNCHES` so a run can show which kernels it went
through.  :func:`library` runs in a span named ``kernels.nvcc`` where it
compiles and ``kernels.load`` where it loads, so the program's first
calls (``utils/timing.first_calls``) hold each one's seconds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

import torch

from sfm_tpu_torch.utils import timing

_PKG = pathlib.Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# name -> launches since the last reset, one entry per kernel wrapper.
LAUNCHES = {"base_chain": 0, "scale_up": 0, "detect_maps": 0,
            "fused_orient_descriptor": 0, "descriptor_sample": 0,
            "match_top2": 0, "orientation_histogram_sample": 0,
            "fused_orient_descriptor_win": 0, "refine_relative_pose": 0,
            "pnp_lo": 0, "recover_pose": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # src, H, W, prefilter taps (host floats; NULL: level 0 is src),
    # n_pre, descent taps (host floats), n_sd, levels, offsets (host
    # int64 per written level), dst, sync (the tile counters, int32 on
    # the card), blocks, stream
    "sfm_base_chain": (_P, _I, _I, _P, _I, _P, _I, _I, _P, _P, _P, _I, _P),
    # out: chain-kernel blocks resident per SM
    "sfm_base_chain_blocks_per_sm": (_P,),
    # H, W, levels, prefilter (0/1) -> the tile counters a launch needs
    "sfm_base_chain_sync_ints": (_I, _I, _I, _I),
    # src, H, W, dst, stream
    "sfm_scale_up": (_P, _I, _I, _P, _P),
    # n_octaves (<= 8), then per octave (host arrays): base and out
    # ([1 + C, H, W]: resp, then aux) pointers, H, W; taps [n_octaves,
    # n_planes, 9] (host floats, <= 13 planes) or NULL, the same taps on
    # the card (any plane count) or NULL, scale gates [n_octaves] (host
    # floats), n_planes, lean (1: 11 aux maps, 0: the gated mode's 6),
    # sm_count, thresh, edge_limit, stream
    "sfm_detect_maps": (_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _P),
    # out: the most planes the run-time-plane route takes on this card
    "sfm_detect_max_planes": (_P,),
    # atlas, H, W, Hp, Wp, x, y, scale, count, K, w2d, sup_off, sup,
    # d1, ori1, ori2, dup, stream
    "sfm_fused_orient_descriptor": (_P, _I, _I, _I, _I, _P, _P, _P, _P, _I,
                                    _P, _P, _P, _P, _P, _P, _P, _P),
    # the same arguments as sfm_fused_orient_descriptor
    "sfm_fused_orient_descriptor_win": (_P, _I, _I, _I, _I, _P, _P, _P, _P, _I,
                                        _P, _P, _P, _P, _P, _P, _P, _P),
    # out: resident blocks per SM of K4, K5, K8, K9
    "sfm_sample_blocks_per_sm": (_P,),
    # img, H, W, Hp, Wp, x, y, scale, count, K, out, stream
    "sfm_orientation_histogram_sample": (_P, _I, _I, _I, _I, _P, _P, _P, _P, _I,
                                         _P, _P),
    # atlas, H, W, Hp, Wp, x, y, scale, ori, count, K, w2d, sup_off, sup,
    # out, stream
    "sfm_descriptor_sample": (_P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _I,
                              _P, _P, _P, _P, _P),
    # d1, d2, valid2, n1, n2, bf16, split, cols_per_split, d2's split
    # tiles (scratch, bf16 == 0), partial best, second, index (scratch,
    # split > 1), best, second, index, stream
    "sfm_match_top2": (_P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P,
                       _P, _P),
    # R0, t0, x1, x2, weights (NULL: all ones), weights' batch stride (0
    # or n), B, n, iters, huber_delta, damping, R, t, E, cost,
    # initial cost, stream
    "sfm_refine_relative_pose": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _P, _P,
                                 _P, _P, _P, _P),
    # x, X, mask, R0, t0, n, iters, threshold, gates (host floats),
    # rounds, huber_delta, rows (scratch), R, t, count, inliers, stream
    "sfm_pnp_lo": (_P, _P, _P, _P, _P, _I, _I, _F, _P, _I, _F, _P, _P, _P, _P, _P, _P),
    # E, x1, x2, weights (NULL: a count), n, sweeps, R, t, index (int64),
    # votes, points, front, finite, stream
    "sfm_recover_pose": (_P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P),
}


class _Library:
    """The loaded shared library plus how it was obtained."""

    def __init__(self, lib, path, build_log):
        self.lib = lib
        self.path = path
        self.build_log = build_log


_LIB: _Library | None = None


def launched(name: str):
    """Count one launch of the kernel ``name`` in :data:`LAUNCHES` and
    in the program's ``kernel_launches`` (``utils/timing``)."""
    LAUNCHES[name] += 1
    timing.count_launch()


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    if home is None:
        from torch.utils.cpp_extension import CUDA_HOME as home
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def library() -> _Library:
    """Build (once per source hash) and load the kernel library."""
    global _LIB
    if _LIB is not None:
        return _LIB
    sources = sorted(SRC_DIR.glob("*.cu"))
    headers = sorted(SRC_DIR.glob("*.cuh"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in headers + sources:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    so = BUILD_DIR / f"libsfm_kernels_{h.hexdigest()[:16]}.so"
    log = ""
    if not so.exists():
        with timing.span("kernels.nvcc"):
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
            os.replace(tmp, so)
    with timing.span("kernels.load"):
        lib = ctypes.CDLL(str(so))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
    _LIB = _Library(lib, so, log)
    return _LIB


def check(code: int, name: str):
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code} at launch")


def stream_ptr(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


_SM_COUNT: dict = {}


def sm_count(device) -> int:
    """Streaming multiprocessors of the card (sizes the kernels' grids)."""
    i = torch.device(device).index
    i = torch.cuda.current_device() if i is None else i
    if i not in _SM_COUNT:
        _SM_COUNT[i] = torch.cuda.get_device_properties(i).multi_processor_count
    return _SM_COUNT[i]


def require(t: torch.Tensor, name: str, dtype, shape=None, device=None):
    """Validate a tensor handed to a kernel; the kernels take dense
    row-major buffers on one card."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
