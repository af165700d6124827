"""The port's configuration and command-line driver against the JAX
package's: the same dataclass fields and defaults, the same options
(apart from JAX's ``--platform`` and the port's ``--device``), and
``python -m sfm_tpu_torch`` on a small PGM pair (or three frames of
the arc sequence) giving the metrics of a direct ``run_two_view`` /
``extract_sift`` / ``run_incremental`` at the same configuration and
seed (exactly: the same code on the same CPU)."""

import argparse
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from synthetic_pair import synthetic_pair, write_pgm
from synthetic_sequence import synthetic_sequence, write_pgms
from sfm_tpu import cli as jcli
from sfm_tpu import config as jconfig
from sfm_tpu.utils import checkpoint as jcheckpoint
from sfm_tpu_torch import cli, config, interop
from sfm_tpu_torch.io import image_io
from sfm_tpu_torch.models import incremental, two_view
from sfm_tpu_torch.parallel import mesh as meshmod
from sfm_tpu_torch.utils import checkpoint
from sfm_tpu_torch.sift import frontend, match
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name", ["SiftConfig", "MatchConfig", "RansacConfig",
                                  "PipelineConfig"])
def test_config_fields_and_defaults_match_jax(name):
    jcls, tcls = getattr(jconfig, name), getattr(config, name)
    jf, tf = dataclasses.fields(jcls), dataclasses.fields(tcls)
    assert [f.name for f in tf] == [f.name for f in jf]
    jd, td = jcls(), tcls()
    for f in jf:
        a, b = getattr(jd, f.name), getattr(td, f.name)
        if dataclasses.is_dataclass(a):
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
        else:
            assert a == b and type(a) is type(b), f.name
    assert tcls.__dataclass_params__.frozen
    assert hash(td) == hash(tcls())


def test_config_to_torch_maps_nested_configs():
    j = jconfig.PipelineConfig(
        sift=jconfig.SiftConfig(num_octaves=3, octave_caps=(8, 4, 2),
                                sample_window="vmem"),
        ransac=jconfig.RansacConfig(n_hyps=256), tvote_rounds=2)
    t = interop.config_to_torch(j)
    assert type(t) is config.PipelineConfig
    assert type(t.sift) is config.SiftConfig and type(t.match) is config.MatchConfig
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    with pytest.raises(TypeError):
        interop.config_to_torch(object())


class _Parsed(Exception):
    def __init__(self, parser):
        self.parser = parser


def _jax_parser(monkeypatch):
    """The parser ``sfm_tpu.cli.main`` builds (it builds it inline)."""
    def grab(self, args=None, namespace=None):
        raise _Parsed(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    with pytest.raises(_Parsed) as e:
        jcli.main([])
    monkeypatch.undo()
    return e.value.parser


def _options(parser):
    """{subcommand: {option string or positional dest: default}}."""
    sub = next(a for a in parser._actions
               if isinstance(a, argparse._SubParsersAction))
    out = {}
    for name, sp in sub.choices.items():
        opts = {}
        for a in sp._actions:
            if isinstance(a, argparse._HelpAction):
                continue
            for key in a.option_strings or [a.dest]:
                opts[key] = a.default
        out[name] = opts
    top = {s for a in parser._actions for s in a.option_strings}
    return out, top


def test_cli_options_match_jax(monkeypatch):
    jopts, jtop = _options(_jax_parser(monkeypatch))
    topts, ttop = _options(cli.build_parser())
    assert jtop - {"--platform"} == ttop
    assert set(topts) == set(jopts) == {"reconstruct", "sift"}
    for name in jopts:
        assert topts[name].pop("--device") == "cuda"
        assert topts[name] == jopts[name], name


@pytest.fixture(scope="module")
def pgm_pair(tmp_path_factory):
    d = tmp_path_factory.mktemp("pair")
    pair = synthetic_pair(128, 176, seed=0)
    paths = [str(d / f"{i}.pgm") for i in (1, 2)]
    for p, k in zip(paths, ("img1", "img2")):
        write_pgm(p, pair[k])
    return paths, pair


_SMALL = ["--octaves", "3", "--max-pts", "256"]


def test_cli_reconstruct_on_cpu_equals_run_two_view(pgm_pair, tmp_path, capsys):
    paths, pair = pgm_pair
    ply, js = str(tmp_path / "c.ply"), str(tmp_path / "m.json")
    rc = cli.main(["reconstruct", *paths, "--focal", str(float(pair["K"][0, 0])),
                   *_SMALL, "--ransac-hyps", "256", "--seed", "3", "--out", ply,
                   "--metrics", js, "--device", "cpu"])
    assert rc == 0
    m = json.loads(pathlib.Path(js).read_text())
    assert json.loads(capsys.readouterr().out) == m
    jkeys = {"mode", "num_matches", "num_inliers", "num_points",
             "mean_reproj_px", "R", "t", "ply", "stage_times"}
    assert jkeys <= set(m) and m["mode"] == "two_view" and m["device"] == "cpu"
    cfg = config.PipelineConfig(
        sift=config.SiftConfig(num_octaves=3, max_pts_per_octave=256),
        ransac=config.RansacConfig(n_hyps=256, threshold=3e-6))
    imgs = [torch.as_tensor(image_io.load_gray(p)) for p in paths]
    res = two_view.run_two_view(*imgs, torch.as_tensor(pair["K"]), cfg, seed=3)
    assert m["num_matches"] == int(res.num_matches) > 100
    assert m["num_inliers"] == int(res.num_inliers)
    assert m["num_points"] == int(res.point_valid.sum()) > 50
    assert m["R"] == np.round(res.R.numpy(), 6).tolist()
    head = pathlib.Path(ply).read_bytes()[:300]
    assert head.startswith(b"ply")
    assert f"element vertex {m['num_points']}\n".encode() in head


def test_cli_sift_on_cpu_equals_extract_sift(pgm_pair, tmp_path):
    paths, _ = pgm_pair
    npz, js = str(tmp_path / "f.npz"), str(tmp_path / "m.json")
    rc = cli.main(["sift", *paths, *_SMALL, "--homography", "--out", npz,
                   "--metrics", js, "--device", "cpu"])
    assert rc == 0
    m = json.loads(pathlib.Path(js).read_text())
    cfg = config.SiftConfig(num_octaves=3, max_pts_per_octave=256, thresh=2.0)
    s = [frontend.extract_sift(torch.as_tensor(image_io.load_gray(p)), cfg)
         for p in paths]
    assert m["features"] == [int(r.keypoints.valid.sum()) for r in s]
    mm = match.match(s[0].descriptors, s[1].descriptors, s[0].keypoints.valid,
                     s[1].keypoints.valid)
    assert m["num_matches"] == int(mm.valid.sum()) > 50
    assert 0 < m["homography_inliers"] <= m["num_matches"]
    assert np.isfinite(np.array(m["H"])).all()
    with np.load(npz) as f:
        for i in (0, 1):
            assert f[f"descriptors{i}"].shape == (m["features"][i], 128)
            assert f[f"x{i}"].shape == (m["features"][i],)


def test_cli_sift_nine_octaves_over_16384_slots_on_cpu(tmp_path):
    """``--octaves 9 --max-pts 4096``: 36,864 detection slots capped to
    2,560 (the rank-major interleave), the 9th octave 1 x 1 pixel."""
    img = str(tmp_path / "a.pgm")
    write_pgm(img, synthetic_pair(256, 320, seed=0)["img1"])
    js = str(tmp_path / "m.json")
    rc = cli.main(["sift", img, "--octaves", "9", "--max-pts", "4096",
                   "--metrics", js, "--device", "cpu"])
    assert rc == 0
    assert 0 < json.loads(pathlib.Path(js).read_text())["features"][0] <= 2 * 2560


def test_cli_reconstruct_three_images_on_cpu_equals_run_incremental(tmp_path, capsys):
    """3 frames of the arc sequence: the JAX CLI's incremental metrics
    keys (and the port's device), a PLY of num_points vertices and a
    map checkpoint that both packages load, equal to a direct
    run_incremental at the same configuration and seed."""
    seq = synthetic_sequence(144, 176, n_frames=3)
    paths = write_pgms(str(tmp_path), seq["images"])
    ply, js, npz = (str(tmp_path / n) for n in ("c.ply", "m.json", "map.npz"))
    f = float(seq["K"][0, 0])
    rc = cli.main(["reconstruct", *paths, "--focal", str(f), *_SMALL,
                   "--ransac-hyps", "256", "--ba-iters", "6", "--closure", "0,2",
                   "--seed", "1", "--out", ply, "--metrics", js, "--checkpoint", npz,
                   "--device", "cpu"])
    assert rc == 0
    m = json.loads(pathlib.Path(js).read_text())
    assert json.loads(capsys.readouterr().out) == m
    assert set(m) == {"mode", "device", "num_images", "poses_registered",
                      "num_points", "mean_reproj_px", "ba_cost_initial",
                      "ba_cost_final", "ply", "checkpoint", "stage_times"}
    assert m["mode"] == "incremental" and m["device"] == "cpu" and m["num_images"] == 3
    assert m["poses_registered"] == 3 and m["num_points"] > 200
    assert m["ba_cost_final"] < m["ba_cost_initial"] and m["mean_reproj_px"] < 0.5
    head = pathlib.Path(ply).read_bytes()[:300]
    assert f"element vertex {m['num_points']}\n".encode() in head
    cfg = config.PipelineConfig(
        sift=config.SiftConfig(num_octaves=3, max_pts_per_octave=256),
        ransac=config.RansacConfig(n_hyps=256, threshold=3e-6))
    imgs = [torch.as_tensor(image_io.load_gray(p)) for p in paths]
    res = incremental.run_incremental(imgs, seq["K"], cfg, seed=1, ba_iters=6,
                                      closure_pairs=[(0, 2)])
    assert m["num_points"] == int(res.state.X_valid.sum())
    assert m["ba_cost_final"] == float(res.ba_costs[-1])
    st, extra = checkpoint.load_map(npz)
    assert extra == {"K": [[f, 0.0, 88.0], [0.0, f, 72.0], [0.0, 0.0, 1.0]]}
    for a, b in zip(st, res.state):
        assert torch.equal(a, b)
    sj, _ = jcheckpoint.load_map(npz)
    assert type(sj).__module__ == "sfm_tpu.models.incremental"
    assert np.asarray(sj.point_id).dtype == np.int32
    np.testing.assert_array_equal(np.asarray(sj.point_id), res.state.point_id.numpy())


def test_cli_two_images_write_no_checkpoint(pgm_pair, tmp_path):
    """A two-view run has no map state: like the JAX CLI, --checkpoint
    writes nothing and is not reported."""
    paths, pair = pgm_pair
    npz, js = tmp_path / "map.npz", str(tmp_path / "m.json")
    rc = cli.main(["reconstruct", *paths, "--focal", str(float(pair["K"][0, 0])),
                   *_SMALL, "--ransac-hyps", "128", "--checkpoint", str(npz),
                   "--metrics", js, "--device", "cpu"])
    assert rc == 0 and not npz.exists()
    m = json.loads(pathlib.Path(js).read_text())
    assert m["mode"] == "two_view" and "checkpoint" not in m


def test_cli_mesh_past_the_device_count_is_refused(pgm_pair):
    paths, _ = pgm_pair
    with pytest.raises(ValueError, match="requested 2 devices, have 1"):
        cli.main(["reconstruct", *paths, "--mesh", "2", "--device", "cpu"])
    assert not torch.distributed.is_initialized()


@pytest.fixture(scope="module")
def pgm_sequence(tmp_path_factory):
    seq = synthetic_sequence(144, 176, n_frames=3)
    return write_pgms(str(tmp_path_factory.mktemp("seq")), seq["images"]), seq


@pytest.mark.parametrize("extra", [["--mesh", "1"], ["--mesh", "-1"], ["--distributed"]])
def test_cli_on_a_one_rank_mesh_equals_run_incremental_on_it(
        pgm_sequence, extra, tmp_path, capsys, monkeypatch):
    """``--mesh 1``, ``--mesh -1`` (every device: one CPU) and
    ``--distributed`` without a launcher's environment (one process)
    run the 3-frame sequence on a one-rank gloo mesh, equal to a direct
    run_incremental on such a mesh, and close the group."""
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    paths, seq = pgm_sequence
    js, npz = str(tmp_path / "m.json"), str(tmp_path / "map.npz")
    f = float(seq["K"][0, 0])
    rc = cli.main(["reconstruct", *paths, "--focal", str(f), *_SMALL,
                   "--ransac-hyps", "256", "--ba-iters", "6", "--metrics", js,
                   "--checkpoint", npz, "--device", "cpu", *extra])
    assert rc == 0 and not torch.distributed.is_initialized()
    m = json.loads(pathlib.Path(js).read_text())
    assert m["mesh"] == {"size": 1, "backend": "gloo"}
    assert m["poses_registered"] == 3 and m["ba_cost_final"] < m["ba_cost_initial"]
    said = "distributed: 1 processes, mesh over 1 devices" in capsys.readouterr().err
    assert said == (extra == ["--distributed"])
    cfg = config.PipelineConfig(
        sift=config.SiftConfig(num_octaves=3, max_pts_per_octave=256),
        ransac=config.RansacConfig(n_hyps=256, threshold=3e-6))
    imgs = [torch.as_tensor(image_io.load_gray(p)) for p in paths]
    with meshmod.make_mesh(1, device="cpu") as mesh:
        res = incremental.run_incremental(imgs, seq["K"], cfg, ba_iters=6, mesh=mesh)
    assert m["num_points"] == int(res.state.X_valid.sum())
    assert m["ba_cost_final"] == float(res.ba_costs[-1])
    st, _ = checkpoint.load_map(npz)
    for a, b in zip(st, res.state):
        assert torch.equal(a, b)


def test_cli_needs_a_card_unless_told_cpu(pgm_pair):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device is valid")
    paths, _ = pgm_pair
    for cmd in (["reconstruct", *paths], ["sift", paths[0]]):
        with pytest.raises(RuntimeError, match="--device cpu"):
            cli.main(cmd)


def test_python_dash_m_runs_the_cli(pgm_pair):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = _ROOT
    proc = subprocess.run(
        [sys.executable, "-m", "sfm_tpu_torch", "sift", pgm_pair[0][0],
         "--octaves", "2", "--max-pts", "64", "--device", "cpu"],
        cwd=_ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    m = json.loads(proc.stdout)
    assert m["mode"] == "sift" and m["features"][0] > 0


def test_stage_timer_and_sync():
    from sfm_tpu_torch.utils.timing import StageTimer, sync

    timer = StageTimer()
    timer.record("a", 0.5)
    timer.record("a", 0.25)
    timer.record("b", 0.25)
    assert timer.summary() == {
        "a": {"total_ms": 750.0, "count": 2, "mean_ms": 375.0},
        "b": {"total_ms": 250.0, "count": 1, "mean_ms": 250.0}}
    x = torch.ones(3)
    res = {"x": x, "pair": (x, [x])}
    assert sync(res) is res                        # CPU tensors need no wait
