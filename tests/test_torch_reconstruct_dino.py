"""The port's turntable driver (``python -m
sfm_tpu_torch.tools.reconstruct_dino``) and its frame reader
(``io.image_io.iter_gray_frames``) on the CPU.

The reader is held exactly against the JAX package's on the same files,
both on the native prefetcher and on the thread-pool fallback.  The
driver runs on ``tests/test_turntable.py``'s 12-frame injected ring
(``synthetic_ring.injected_ring``),
written as an npz of features (``--load-feats``) beside 12 frames: its
metrics JSON has the JAX tool's keys and reaches the JAX package's own
turntable bar on that ring (the mean step within 0.2 deg of 30, std
< 0.3, 360 +- 2 deg in all, < 1.5 px), and its PLY holds the vertex
count the metrics report.
"""

import json
import math
import os

import numpy as np
import pytest

from sfm_tpu.io import image_io as jio
from sfm_tpu_torch.io import image_io, native
from sfm_tpu_torch.sift.frontend import Keypoints
from sfm_tpu_torch.tools import reconstruct_dino as rd
from synthetic_pair import write_pgm
from synthetic_ring import injected_ring
from test_turntable import N_FRAMES
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

# The metrics keys of tools/reconstruct_dino.py --turntable (:220-235,
# :186-198, the circle fit's three and ply_vertices).
JAX_TOOL_KEYS = {
    "frames", "step_deg_ideal", "angles_deg", "angle_mean_deg", "angle_std_deg",
    "total_rotation_deg", "poses_valid", "n_points", "mean_reproj_norm2",
    "mean_reproj_px", "elapsed_s", "radius", "radial_rms_rel", "out_of_plane_rms_rel",
    "turntable", "tt_rms_px", "tt_f_px", "tt_k1", "tt_k2", "tt_tracks", "tt_obs",
    "tt_obs_kept", "tt_step_deg_mean", "tt_step_deg_std", "tt_total_deg",
    "ply_vertices"}


def _frames(d, rng, n=5, h=24, w=32):
    imgs = rng.uniform(0, 255, size=(n, h, w))
    paths = []
    for i, im in enumerate(imgs):
        paths.append(os.path.join(d, f"viff.{i:03d}.ppm"))
        write_pgm(paths[-1], im)
    return paths, np.rint(imgs).astype(np.float32)


@pytest.mark.parametrize("route", ["native", "threads", "png"])
def test_iter_gray_frames_order_and_content_match_jax(tmp_path, rng, route, monkeypatch):
    paths, imgs = _frames(str(tmp_path), rng)
    if route == "png":
        from PIL import Image
        paths[2] = str(tmp_path / "frame2.png")
        Image.fromarray(imgs[2].astype(np.uint8)).save(paths[2])
    if route == "threads":
        monkeypatch.setattr(native, "available", lambda: False)
    elif route == "native" and not native.available():
        pytest.skip("the native I/O library does not build here")
    for depth in (1, 2, 8):
        got = list(image_io.iter_gray_frames(paths, depth=depth))
        ref = list(jio.iter_gray_frames(paths, depth=depth))
        assert [i for i, _ in got] == list(range(len(paths))) == [i for i, _ in ref]
        for (_, a), (_, b), im in zip(got, ref, imgs):
            assert a.dtype == np.float32 and a.shape == im.shape
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, im)


def _ply_vertices(path):
    with open(path, "rb") as fh:
        for line in fh:
            if line.startswith(b"element vertex"):
                return int(line.split()[-1])
    raise AssertionError(f"no vertex count in {path}")


def test_driver_turntable_on_an_injected_ring(tmp_path, rng, monkeypatch):
    frames = injected_ring()[0]
    d = tmp_path / "ring"
    d.mkdir()
    for i in range(N_FRAMES):
        write_pgm(str(d / f"viff.{i:03d}.ppm"), np.zeros((576, 720)))
    feats = {"n_frames": N_FRAMES}
    for i, f in enumerate(frames):
        n = len(f["x"])
        fields = {"x": f["x"], "y": f["y"], "valid": f["valid"],
                  "octave": np.zeros(n, np.int32)}
        for k in Keypoints._fields:
            feats[f"f{i}_{k}"] = fields.get(k, np.ones(n, np.float32))
        feats[f"f{i}_desc"] = f["descriptors"]
    npz, saved = str(tmp_path / "feats.npz"), str(tmp_path / "saved.npz")
    np.savez(npz, **feats)
    out = str(tmp_path / "tt")
    monkeypatch.delenv("SFM_DINO_DIR", raising=False)
    with pytest.raises(SystemExit):
        rd.main(["--turntable", "--device", "cpu"])      # no frame directory
    args = ["--dir", str(d), "--frames", str(N_FRAMES), "--turntable", "--out", out,
            "--fx", "1800", "--load-feats", npz, "--save-feats", saved]
    assert rd.main(args + ["--device", "cpu"]) == 0
    with open(out + ".metrics.json") as fh:
        m = json.load(fh)
    assert set(m) == JAX_TOOL_KEYS
    assert m["frames"] == m["poses_valid"] == N_FRAMES and m["turntable"] is True
    steps = np.array(m["angles_deg"])
    assert abs(steps.mean() - 30.0) < 0.2 and steps.std() < 0.3
    assert abs(m["tt_step_deg_mean"] - 30.0) < 0.2 and m["tt_step_deg_std"] < 0.3
    assert abs(m["tt_total_deg"] - 360.0) < 2.0 and m["tt_rms_px"] < 1.5
    assert m["tt_tracks"] >= 0.9 * len(frames[0]["x"])
    assert m["tt_obs_kept"] > 0.8 * m["tt_obs"]
    assert 0 < m["ply_vertices"] <= m["n_points"] <= m["tt_tracks"]
    assert _ply_vertices(out + ".ply") == m["ply_vertices"]
    assert m["radial_rms_rel"] < 0.01 and math.isfinite(m["mean_reproj_px"])
    # --save-feats writes back what --load-feats read.
    a, b = np.load(npz), np.load(saved)
    assert set(a.files) == set(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # Without --device cpu the driver runs on the card, or raises.
    import torch
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            rd.main(args)
