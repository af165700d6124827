"""One rank of a multi-process run of the port's distributed layer
(``sfm_tpu_torch/parallel/``) over gloo, and the parent's launcher.

Each worker joins the group (``init_distributed`` with rank 0's address,
the world size and its rank; ``make_global_mesh`` on the given device),
reads the cases from an npz that the parent wrote, runs them and writes
what it computed to its own npz:

* ``match/<case>/{d1, d2, v2, bf16}``: ``dist_match_top2`` of d1
  (replicated) against the rank's block of d2, and ``dist_match`` with
  ``MatchConfig(bf16=bf16)`` on the full sets;
* ``ba/<case>/{R, t, X, cam, pt, uv, mask, fixed, iters, solver,
  cg_iters}``: ``partition_problem`` of the full problem, the rank's
  blocks (``put_sharded``; the points through ``put_local_shards``),
  ``run_dist_ba``, and the points gathered back (``gather_sharded``),
  with the host-clock ms of the LM loop.

Usage (the parent, :func:`run_ranks`, starts one per rank):

    python tests/torch_dist_worker.py PORT RANK WORLD IN.npz OUT.npz DEVICE

It imports torch and the port only: never the tests' conftest, which
sets up JAX.
"""

import os
import pathlib
import socket
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(cases: dict, device: str = "cpu", world: int = 2,
              timeout: float = 300.0):
    """Run ``cases`` (npz keys -> arrays, as in the module docstring) on
    ``world`` worker processes over gloo, each on ``device``.  Returns
    (one dict of outputs per rank, their ``TORCH_DIST_OK`` lines).
    Raises if a worker fails or outlasts ``timeout``."""
    import numpy as np

    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")     # the ranks share this host
    with tempfile.TemporaryDirectory() as d:
        inp = os.path.join(d, "in.npz")
        np.savez(inp, **cases)
        outs = [os.path.join(d, f"out{r}.npz") for r in range(world)]
        procs = [subprocess.Popen(
            [sys.executable, __file__, str(port), str(r), str(world), inp, outs[r],
             device], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True) for r in range(world)]
        lines, failed = [], []
        try:
            for r, p in enumerate(procs):
                out, err = p.communicate(timeout=timeout)
                ok = [ln for ln in out.splitlines() if ln.startswith("TORCH_DIST_OK")]
                if p.returncode != 0 or not ok:
                    failed.append(f"rank {r}: exit code {p.returncode}\n{out}\n{err}")
                lines.append(ok[0] if ok else "")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if failed:
            raise RuntimeError("distributed workers failed:\n" + "\n".join(failed))
        results = []
        for o in outs:
            with np.load(o) as z:
                results.append({k: z[k] for k in z.files})
    return results, lines


def main():
    port, rank, world, inp, out, device = sys.argv[1:7]
    rank, world = int(rank), int(world)
    import numpy as np
    import torch

    torch.set_num_threads(1)
    sys.path.insert(0, str(ROOT))
    from sfm_tpu_torch.config import MatchConfig
    from sfm_tpu_torch.models.bundle_adjust import BAProblem
    from sfm_tpu_torch.ops import _cuda
    from sfm_tpu_torch.parallel import dist_ba, dist_match
    from sfm_tpu_torch.parallel import mesh as meshmod

    n = meshmod.init_distributed(f"localhost:{port}", world, rank, backend="gloo")
    assert n == world, n
    with meshmod.make_global_mesh(device=device) as mesh:
        assert (mesh.rank, mesh.size) == (rank, world), mesh
        dev = mesh.device

        def sync():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

        with np.load(inp) as z:
            data = {k: z[k] for k in z.files}
        cases = sorted({k.rsplit("/", 1)[0] for k in data})
        res, summary = {}, []
        _cuda.reset_launches()
        for case in cases:
            a = {k.rsplit("/", 1)[1]: v for k, v in data.items()
                 if k.rsplit("/", 1)[0] == case}
            if case.startswith("match/"):
                d1, d2, v2 = (meshmod.put_replicated(mesh, a[k]) for k in ("d1", "d2", "v2"))
                bf16 = bool(a["bf16"])
                top2 = dist_match.dist_match_top2(
                    d1, meshmod.put_sharded(mesh, d2), meshmod.put_sharded(mesh, v2),
                    mesh, bf16=bf16)
                m = dist_match.dist_match(d1, d2, None, v2, MatchConfig(bf16=bf16),
                                          mesh=mesh)
                for k, v in zip(("best", "second", "index"), top2):
                    res[f"{case}/{k}"] = v.cpu().numpy()
                for k in ("index", "score", "ambiguity", "valid"):
                    res[f"{case}/m_{k}"] = getattr(m, k).cpu().numpy()
            else:
                full = BAProblem(*(meshmod.put_replicated(mesh, a[k]) for k in
                                   ("cam", "pt", "uv", "mask", "fixed")))
                X = meshmod.put_replicated(mesh, a["X"])
                X_sh, prob_sh = dist_ba.partition_problem(full, X, mesh.size)
                prob = BAProblem(*(meshmod.put_sharded(mesh, v) for v in prob_sh[:4]),
                                 prob_sh.fixed)
                # The multi-process ingest path: each rank hands over
                # only its own block of the points.
                rows = X_sh.shape[0] // mesh.size
                X_own = meshmod.put_local_shards(
                    mesh, X_sh[rank * rows:(rank + 1) * rows].cpu())
                iters = int(a["iters"])
                sync()
                t0 = time.perf_counter()
                R, t, X_loc, costs = dist_ba.run_dist_ba(
                    meshmod.put_replicated(mesh, a["R"]),
                    meshmod.put_replicated(mesh, a["t"]), X_own, prob, mesh, iters=iters,
                    solver=str(a["solver"]), cg_iters=int(a["cg_iters"]))
                sync()
                res[f"{case}/ms_per_iter"] = np.float64(
                    (time.perf_counter() - t0) * 1e3 / iters)
                Xf = dist_ba.unpartition_points(meshmod.gather_sharded(mesh, X_loc),
                                                X.shape[0])
                for k, v in (("R", R), ("t", t), ("X", Xf), ("costs", costs)):
                    res[f"{case}/{k}"] = v.cpu().numpy()
                summary.append(f"{case}:cost={float(costs[-1]):.8e}")
        res["launches/match_top2"] = np.int64(_cuda.LAUNCHES["match_top2"])
        np.savez(out, **res)
    print("TORCH_DIST_OK " + " ".join(summary), flush=True)


if __name__ == "__main__":
    main()
