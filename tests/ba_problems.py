"""Bundle-adjustment problems in numpy (no torch, no jax), shared by the
CPU and CUDA tests and ``chip_smoke.py``'s solver A/B.

``ring_problem``: a turntable-like ring of M cameras around a unit cube
of points, every camera looking at its centre, no camera fixed, so the
7-dimensional similarity gauge is held by the LM damping alone; the
start perturbs every pose and point.

``rig_problem``: the distributed BA of ``__graft_entry__.py``'s
``dryrun_multichip`` at 8 devices: 16 cameras on a line, 2,048 points,
16,384 observations, camera 0 fixed, the points' start perturbed.
"""

import numpy as np


def ring_problem(seed: int = 0, M: int = 36, P: int = 400, noise: float = 5e-4):
    """(R0, t0, X0, cam, pt, uv, mask, fixed): float64 start poses
    [M, 3, 3], [M, 3] and points [P, 3]; observation camera and point
    indices [M * P]; normalized image points [M * P, 2] with Gaussian
    noise of ``noise``; ~95% of observations valid; no camera fixed."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1, 1, (P, 3))
    Rs, ts = [], []
    for i in range(M):
        a = 2 * np.pi * i / M
        c = 5.0 * np.array([np.sin(a), 0.3, -np.cos(a)])
        z = -c / np.linalg.norm(c)
        x = np.cross([0.0, 1.0, 0.0], z)
        x /= np.linalg.norm(x)
        R = np.stack([x, np.cross(z, x), z])
        Rs.append(R)
        ts.append(-R @ c)
    R, t = np.stack(Rs), np.stack(ts)
    cam, pt = np.repeat(np.arange(M), P), np.tile(np.arange(P), M)
    Xc = np.einsum("oij,oj->oi", R[cam], X[pt]) + t[cam]
    uv = Xc[:, :2] / Xc[:, 2:3] + rng.normal(scale=noise, size=(M * P, 2))
    mask = rng.random(M * P) > 0.05
    d = rng.normal(scale=0.02, size=M)
    dR = np.stack([np.array([[1, -a, 0], [a, 1, 0], [0, 0, 1]]) for a in d])
    R0 = np.einsum("mij,mjk->mik", R, dR)
    t0 = t + rng.normal(scale=0.02, size=t.shape)
    X0 = X + rng.normal(scale=0.02, size=X.shape)
    return R0, t0, X0, cam, pt, uv, mask, np.zeros(M, bool)


def rig_problem(seed: int = 0, M: int = 16, P: int = 2048, obs_per_cam: int = 1024,
                noise: float = 5e-4):
    """(R0, t0, X0, cam, pt, uv, mask, fixed) in float64: M cameras at
    (0.3 i, 0, 0) looking down z, each observing ``obs_per_cam``
    distinct random points of P; camera 0 fixed; the points start 0.01
    off.  ``noise`` (normalized plane) keeps the optimum's cost above
    float32's floor, where the dry run's noise-free cost ends and two
    summation orders agree in no digit."""
    rng = np.random.default_rng(seed)
    X = rng.uniform([-1, -1, 4], [1, 1, 7], size=(P, 3))
    R = np.broadcast_to(np.eye(3), (M, 3, 3)).copy()
    t = np.stack([np.array([0.3 * i, 0.0, 0.0]) for i in range(M)])
    cam = np.repeat(np.arange(M), obs_per_cam)
    pt = np.concatenate([rng.choice(P, obs_per_cam, replace=False) for _ in range(M)])
    Xc = np.einsum("oij,oj->oi", R[cam], X[pt]) + t[cam]
    uv = Xc[:, :2] / Xc[:, 2:3] + rng.normal(scale=noise, size=(M * obs_per_cam, 2))
    fixed = np.arange(M) == 0
    X0 = X + rng.normal(scale=0.01, size=X.shape)
    return R, t, X0, cam, pt, uv, np.ones(M * obs_per_cam, bool), fixed
