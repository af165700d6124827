"""Seeds and RANSAC minimal sets drawn by the benchmark, not the port.

Every seed of a run derives from ``--seed`` and a few labels through a
hash, so any whole number is a seed and the same seed gives the same
inputs.  The scenes come from the traffic file's fixed ``scene_seed``,
so every run does the same work; ``--seed`` draws the sensor noise,
the order in which requests visit the pool and the RANSAC draws.  The two-view cell hands the port its minimal sets: uniform
draws made here from the request's seed, mapped onto the valid
correspondences of the side that runs them (the program's or the
reference's) as the port's ``geometry/ransac.sample_minimal_sets``
maps its own draws (Floyd's algorithm over the valid slots compacted
to the front).
"""

from __future__ import annotations

import hashlib

import torch


def derive(seed: int, *labels) -> int:
    """A 63-bit seed from ``seed`` and ``labels``."""
    text = ":".join(str(x) for x in (int(seed),) + labels)
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:8], "little") >> 1


def order(seed: int, n: int) -> list:
    """The pool's visiting order for ``seed``: a permutation of range(n)."""
    g = torch.Generator().manual_seed(derive(seed, "order"))
    return torch.randperm(n, generator=g).tolist()


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def uniforms(seed: int, n_hyps: int, k: int, device) -> torch.Tensor:
    """[n_hyps, k] float64 uniforms in [0, 1) from ``seed``."""
    return torch.rand((k, n_hyps), generator=generator(seed, device), device=device,
                      dtype=torch.float64).T


def minimal_sets(u: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """[n_hyps, k] distinct indices of valid entries of ``mask`` from the
    uniforms ``u`` [n_hyps, k]; no host synchronization."""
    n_hyps, k = u.shape
    order = torch.argsort((~mask).to(torch.int8), stable=True)
    n_valid = torch.clamp(mask.sum(), min=k)
    sel = torch.zeros((n_hyps, k), dtype=torch.int64, device=mask.device)
    for m in range(k):
        j = n_valid - k + m
        t = torch.minimum(torch.floor(u[:, m] * (j + 1)).to(torch.int64), j)
        if m:
            dup = torch.any(sel[:, :m] == t[:, None], dim=1)
            t = torch.where(dup, j, t)
        sel[:, m] = t
    return order[sel]
