"""The port's ``utils/{metrics,checkpoint,debug,timing}.py`` and
``io/native.load_gray``: metrics against the JAX package's copy (float64
numpy on both sides: equal to 1e-12), map checkpoints across the two
packages (the same arrays and dtypes both ways), the debug dump on a
small synthetic pair, one PNM through both packages' native decoders
(equal), and ``measure_rtt`` on the CPU.

The dump is not held against ``sfm_tpu.utils.debug``'s: the two
packages' RANSAC draws differ.  It is held against the port's own
pipeline on the same draws.
"""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import rot
from sfm_tpu.io import native as jnative
from sfm_tpu.models import incremental as jinc
from sfm_tpu.utils import checkpoint as jckpt
from sfm_tpu.utils import metrics as jmetrics
from sfm_tpu_torch import interop
from sfm_tpu_torch.config import PipelineConfig, RansacConfig, SiftConfig
from sfm_tpu_torch.models import incremental as inc
from sfm_tpu_torch.models import two_view
from sfm_tpu_torch.io import native
from sfm_tpu_torch.utils import checkpoint, debug, metrics, timing
from synthetic_pair import synthetic_pair, write_pgm
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _trajectory(rng, n=7):
    R = np.stack([rot(rng.normal(size=3), rng.uniform(0, 1)) for _ in range(n)])
    t = rng.normal(size=(n, 3))
    return R, t


def test_metrics_match_jax(rng):
    R_gt, t_gt = _trajectory(rng)
    # An estimate in another similarity frame, with noise.
    S = rot([0.3, 1, 0.2], 0.7)
    R_est = np.einsum("nij,jk->nik", R_gt, S.T) @ rot([1, 0, 0], 0.01)
    t_est = 2.5 * t_gt + rng.normal(scale=0.01, size=t_gt.shape)
    src, dst = rng.normal(size=(20, 3)), rng.normal(size=(20, 3))
    for scale in (True, False):
        for a, b in zip(metrics.umeyama_alignment(src, dst, scale),
                        jmetrics.umeyama_alignment(src, dst, scale)):
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(metrics.camera_centers(R_est, t_est),
                               jmetrics.camera_centers(R_est, t_est), atol=1e-12)
    a, ea = metrics.ate_rmse(R_est, t_est, R_gt, t_gt)
    b, eb = jmetrics.ate_rmse(R_est, t_est, R_gt, t_gt)
    assert a == pytest.approx(b, rel=1e-12) and a > 0
    np.testing.assert_allclose(ea, eb, rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(metrics.rotation_errors_deg(R_est, R_gt),
                               jmetrics.rotation_errors_deg(R_est, R_gt), atol=1e-12)
    np.testing.assert_allclose(metrics.rpe_rmse(R_est, t_est, R_gt, t_gt),
                               jmetrics.rpe_rmse(R_est, t_est, R_gt, t_gt), rtol=1e-12)
    # Tensors in: the same numbers.
    assert metrics.ate_rmse(torch.as_tensor(R_est), torch.as_tensor(t_est),
                            R_gt, t_gt)[0] == pytest.approx(a, rel=1e-12)


def _jax_map(rng):
    st = jinc._empty_state(4, 32, 40)
    X = rng.normal(size=(40, 3)).astype(np.float32)
    pid = rng.integers(-1, 40, (4, 32)).astype(np.int32)
    return st._replace(X=jnp.asarray(X), X_valid=jnp.asarray(rng.random(40) < 0.6),
                       n_points=jnp.int32(31), point_id=jnp.asarray(pid),
                       pose_valid=jnp.asarray([True, True, False, True]),
                       t=jnp.asarray(rng.normal(size=(4, 3)).astype(np.float32)))


def test_checkpoint_written_by_jax_loads_in_the_port(rng, tmp_path):
    sj = _jax_map(rng)
    path = tmp_path / "jax_map.npz"
    jckpt.save_map(path, sj, extra={"K": [[1.0, 0, 0], [0, 1, 0], [0, 0, 1]]})
    st, extra = checkpoint.load_map(path)
    assert type(st) is inc.MapState and extra == {"K": [[1.0, 0, 0], [0, 1, 0], [0, 0, 1]]}
    for f in inc.MapState._fields:
        a, b = getattr(st, f), np.asarray(getattr(sj, f))
        np.testing.assert_array_equal(a.numpy(), b, f)
        want = torch.int64 if b.dtype.kind == "i" else torch.as_tensor(b).dtype
        assert a.dtype == want, f
    assert st.point_id.dtype == torch.int64 and st.n_points.shape == ()


def test_checkpoint_written_by_the_port_loads_in_jax(rng, tmp_path):
    st = interop.to_torch(_jax_map(rng))            # the port's int64 tables
    path = tmp_path / "port_map.npz"
    checkpoint.save_map(path, st, extra={"K": [[2.0]]})
    sj, extra = jckpt.load_map(path)
    assert type(sj) is jinc.MapState and extra == {"K": [[2.0]]}
    ref = _jax_map(np.random.default_rng(0))
    for f in jinc.MapState._fields:
        a = np.asarray(getattr(sj, f))
        assert a.dtype == np.asarray(getattr(ref, f)).dtype, f   # int32 ids, as JAX's
        np.testing.assert_array_equal(a, interop.to_numpy(getattr(st, f)), f)
    with np.load(path) as raw:
        assert raw["f_point_id"].dtype == np.int32 and raw["f_n_points"].dtype == np.int32
    # And back into the port, unchanged.
    st2, _ = checkpoint.load_map(path)
    for a, b in zip(st2, st):
        assert torch.equal(a, b)


def test_checkpoint_of_another_type_loads_as_a_dict(tmp_path):
    path = tmp_path / "r.npz"
    checkpoint.save_map(path, two_view.TwoViewResult(*[torch.zeros(2)] * 11))
    fields, extra = checkpoint.load_map(path)
    assert isinstance(fields, dict) and set(fields) == set(two_view.TwoViewResult._fields)
    assert extra is None


@pytest.fixture(scope="module")
def small_dump():
    pair = synthetic_pair(128, 176, seed=0)
    cfg = PipelineConfig(sift=SiftConfig(num_octaves=3, max_pts_per_octave=256),
                         ransac=RansacConfig(n_hyps=128, threshold=3e-6))
    img1, img2, K = (torch.as_tensor(pair[k]) for k in ("img1", "img2", "K"))
    gen = torch.Generator()
    gen.manual_seed(5)
    return debug.two_view_dump(img1, img2, K, gen, cfg, max_hyps=4, max_pts=5), cfg, pair


def test_two_view_dump_surfaces(small_dump):
    d, cfg, pair = small_dump
    n_hyps = cfg.ransac.n_hyps
    n = d["U1"].shape[0]
    assert all(isinstance(v, np.ndarray) for v in d.values())
    assert d["A"].shape == (n_hyps, 8, 9) and d["minimal_idx"].shape == (n_hyps, 8)
    assert d["E_bank"].shape == (n_hyps, 3, 3) and d["inlier_counts"].shape == (n_hyps,)
    assert d["E_bank_head"].shape == (4, 3, 3) and d["points_head"].shape == (5, 3)
    assert d["R_candidates"].shape == (4, 3, 3) and d["cheirality_votes"].shape == (4,)
    assert d["X1"].shape == (n, 3) and d["points"].shape == (n, 3)
    np.testing.assert_allclose(d["U1"][:, 2], 1.0)
    np.testing.assert_array_equal(d["A0"], d["A"][0])
    assert int(d["best_index"]) == int(np.argmax(d["inlier_counts"]))
    assert int(d["num_matches"]) > 100 and int(d["num_inliers"]) > 50
    # The pipeline's pose on the dump's own draws: the rendered pose.
    np.testing.assert_allclose(d["P_chosen"][:, :3], d["R"])
    assert np.abs(d["R"] - pair["R"]).max() < 2e-2


def test_print_dump_runs(small_dump):
    d, _, _ = small_dump
    out = io.StringIO()
    debug.print_dump(d, file=out)
    text = out.getvalue()
    for k in ("num_matches =", "best_index =", "E_bank_head [4x3x3]:",
              "R_candidates [4x3x3]:", "points_head [5x3]:", "A0 [8x9]:"):
        assert k in text, k


def test_native_load_gray_matches_jax(tmp_path):
    img = (np.random.default_rng(5).random((37, 53)) * 255).astype(np.float32)
    path = tmp_path / "a.pgm"
    write_pgm(str(path), img)
    out = native.load_gray(path)
    assert out.dtype == np.float32 and out.shape == (37, 53)
    np.testing.assert_array_equal(out, jnative.load_gray(path))
    np.testing.assert_array_equal(out, np.round(img))
    with pytest.raises(ValueError, match="PNM header"):
        native.load_gray(tmp_path / "missing.pgm")


def test_measure_rtt_is_a_positive_round_trip():
    rtt = timing.measure_rtt(3, device="cpu")
    assert 0.0 < rtt < 1e3
