"""Configuration surface of the port (counterpart of ``sfm_tpu/config.py``).

The same dataclasses, field names, defaults and order as the JAX
package's, frozen and hashable, so a configuration written for one
package reads the same in the other (``interop.config_to_torch`` maps a
JAX config onto these classes by field name).

Routes.  ``None`` (the default) of ``SiftConfig.fused_detect``,
``SiftConfig.use_pallas`` and ``MatchConfig.use_pallas`` keeps the
fused route on every device: detection maps from K3, fused sampling
(K4 or K9, duplicates by K5) and K6 at ``bf16``.  An explicit
``False`` selects the JAX package's XLA route for that knob alone, so
all four combinations of the two frontend knobs run:
``fused_detect=False`` the dense DoG detector (``sift/pyramid.
build_pyramid``, ``sift/detect.detect``), ``use_pallas=False``
two-stage sampling (K8 histograms, the peaks, a second compaction,
K5 for every slot), ``MatchConfig.use_pallas=False`` the f32 top-2
(K6 with ``bf16=False``, whatever ``bf16`` says: f32-accurate products
as three TF32 passes over an error-compensated split, within 1e-5 of
exact f32).  ``True`` is the fused route.  The knobs that only choose
how the JAX package computes the same function on a TPU are accepted
and ignored: ``pyramid_pallas`` and ``blur_matmul`` (the base chain
K1 + K2 computes the octave bases either way), ``dup_split`` (the
duplicates always take their own K5 launch), ``sample_block_k`` and
``topk_block`` (TPU tilings).
``detect_lean`` picks K3's mode, as in the JAX package.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SiftConfig:
    """SIFT frontend (reference defaults: src/main.cpp:269-277)."""

    num_octaves: int = 5
    num_scales: int = 5          # NUM_SCALES (cudaSiftD.h:8)
    init_blur: float = 1.5       # prefilter sigma (src/main.cpp:269)
    thresh: float = 1.0          # DoG threshold, 0..255 intensity scale
    edge_limit: float = 10.0     # tr^2 < limit*det (cudaSiftH.cu:213)
    lowest_scale: float = 0.0    # min accepted blob scale
    up_scale: bool = False       # 2x upscale path (cudaSiftH.cu:119-133)
    max_pts_per_octave: int = 1024   # capacity replacing atomic append
    orientation_duplicates: bool = True  # 2nd-peak duplication (cudaSiftD.cu:1041)
    laplace_radius: int = 4      # LAPLACE_R (cudaSiftD.h:40)
    lowpass_radius: int = 4      # LOWPASS_R (cudaSiftD.h:44)
    # False: two-stage sampling (K8 histograms, then K5 descriptors of
    # the primaries and duplicates compacted together); None / True:
    # fused sampling (K4 or K9, duplicates by K5 at slot i + K).
    use_pallas: bool | None = None
    # Slot cap for the sampling stage: the orientation and descriptor
    # kernels and the matcher downstream scale with slots, while the
    # per-octave capacities sum to num_octaves * max_pts_per_octave of
    # which real images fill a fraction; the cap keeps the globally
    # strongest detections.  0 = no cap.
    sample_cap: int = 2560
    blur_matmul: bool | None = None      # TPU banded-matmul blurs; ignored
    # False: the dense DoG detector (blur bank, DoG volume, 26-neighbour
    # extrema, dense refinement); None / True: K3's detection maps.
    fused_detect: bool | None = None
    pyramid_pallas: bool | None = None   # TPU base-chain choice; ignored
    # Windowed sampling kernel: True, "hbm" or "vmem" run K9 (each
    # keypoint's 48 x 40 patch staged in shared memory before it is
    # sampled); None, False and "blk" run K4.  Both compute the same
    # function.
    sample_window: bool | str | None = None
    # Detection kernel mode: None = lean unless lowest_scale > 0 (whose
    # scale gate needs the gated mode); True with lowest_scale > 0
    # raises.
    detect_lean: bool | None = None
    # Candidate selection in both detectors: "topk" (exact, strongest
    # first), "approx" (the JAX package's approx_max_k; the port's exact
    # top-k meets its recall contract) or "compact" (the first k
    # candidates in scan order, the reference's append semantics).
    select: str = "topk"
    # Second-peak descriptors in a separate compacted launch (K5).  The
    # port always splits them; ignored.
    dup_split: bool | None = None
    # Profiling truncation of the JAX package's sampling kernel; only
    # the full kernel (5) is ported.
    sample_phases: int = 5
    # Optional per-octave detection slot caps (override
    # max_pts_per_octave when set; length must equal num_octaves).
    octave_caps: tuple | None = None
    sample_block_k: int = 64             # JAX tiling knob; ignored
    topk_block: int = 32                 # JAX tiling knob; ignored


@dataclasses.dataclass(frozen=True)
class MatchConfig:
    """Brute-force matcher (reference CudaSift/matching.cu:1090-1206)."""

    max_ambiguity: float = 0.95  # ratio-test cutoff
    min_score: float = 0.0       # min correlation of best match
    mutual: bool = False         # cross-check (not in reference)
    # False: the f32 top-2 (K6 with bf16=False, whatever ``bf16`` says);
    # None / True: K6 at ``bf16``.
    use_pallas: bool | None = None
    # True: bf16 products, f32 accumulation (K6); False: f32-accurate
    # products, three TF32 passes over x = hi + lo (~2^-21 per product).
    bf16: bool = True


@dataclasses.dataclass(frozen=True)
class RansacConfig:
    """Essential-matrix RANSAC (reference SfM/sfm.cu:94-236)."""

    n_hyps: int = 4096           # reference: floor(N/8) (sfm.cu:95)
    threshold: float = 1e-6      # symmetric epipolar dist^2, normalized coords
    chunk: int = 512
    refit_iters: int = 2
    sweeps: int = 10             # fixed-sweep Jacobi eigensolver sweeps
    # Matches with pixel disparity below this satisfy x^T E x = 0 for
    # any skew-symmetric E (static background) and are kept out of the
    # estimate.
    min_disparity_px: float = 1.5


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    sift: SiftConfig = SiftConfig()
    match: MatchConfig = MatchConfig()
    ransac: RansacConfig = RansacConfig()
    refine_iters: int = 10       # on-manifold pose refinement iterations
    # Refine <-> re-vote <-> re-score rounds; each re-weights the
    # refinement by the cheirality-consistent inliers of the previous
    # one, and the best round by tight-then-valid count wins.
    refine_rounds: int = 2
    # Translation re-vote rounds after the refine rounds: each searches
    # a Fibonacci bank of directions for the max-cheirality t given the
    # best round's R (geometry.pose.cheirality_t_vote), enters the voted
    # E as a candidate and re-refines from it; a vote-only half round
    # always follows.  0 disables both.
    tvote_rounds: int = 1
    tvote_dirs: int = 1024       # size of the direction bank
    # Rounds are ranked by the count of inliers at threshold *
    # score_tight_mult, lexicographically above the full valid count.
    # 0 = valid count only.
    score_tight_mult: float = 0.25
    # Multi-start: all 4 pose branches of the refit E plus the top
    # restart_k RANSAC draws are scored; 0 = single-start vote.
    restart_k: int = 16
    # Probe refinement of the best branch of the top probe_starts
    # candidates (probe_iters Gauss-Newton steps) picks the start of the
    # refine rounds; 0 or 1 disables.
    probe_starts: int = 8
    probe_iters: int = 6
    # Correspondences compacted to this many slots (valid first) before
    # the geometry stage.  0 disables.
    geometry_cap: int = 2560
    # Correspondence subset for the branch-picking votes (the final
    # vote and triangulation use every point).  0 = all points.
    vote_cap: int = 512
