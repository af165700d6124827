"""The benchmark's multi-view sequence rendered with torch on the card:
``sequence_np.synthetic_sequence`` (the frozen numpy copy of the
repository's arc sequence) computed by ``gen.scene``'s renderer.  The
draws (``scene``: the planes, ``noise``: the sensor noise) come from a
``scene.TorchDraws`` (the benchmark's runs) or a ``scene.NumpyDraws``
(the CPU test that holds the two copies to the same images)."""

from __future__ import annotations

import torch

from portbench.gen import scene as render
from portbench.gen.sequence_np import arc_poses


def synthetic_sequence(height=576, width=720, n_frames=12, step_deg=4.0, *, scene, noise,
                       device):
    """images [n, H, W] float32 on ``device``; K [3, 3], R [n, 3, 3] and
    t [n, 3] numpy float32 (``sequence_np.synthetic_sequence``)."""
    f, K = render._intrinsics(height, width)
    planes = render._planes(scene, f)
    Rs, ts = arc_poses(n_frames, step_deg)
    imgs = torch.stack([
        render._noisy(render._render(planes, K, R, t, height, width, device), noise)
        for R, t in zip(Rs, ts)])
    return {"images": imgs, "K": K.astype("float32"), "R": Rs.astype("float32"),
            "t": ts.astype("float32")}
