"""Typed configuration for the whole engine.

A copy of slam_toolkit_tpu/config.py, verbatim below this docstring
but for the comment on ExtractorConfig.fused_fast, so that the port
imports nothing of the JAX package; a test holds every field of
SlamConfig() and SlamConfig.tiny() equal to the original's.
The comments record measurements taken with the JAX package (on a TPU
where they say so), not with this port.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ExtractorConfig:
    """ORB pyramid extractor (reference: src/pipeline.cpp:45-58)."""

    num_features: int = 2000          # requested features across all levels
    scale_factor: float = 1.2
    num_levels: int = 8
    # "matmul": banded interpolation matmuls, any scale factor — the
    # default: in the full bench it is both faster (582-590 vs 554-566
    # fps, 2x2 interleaved same-hour A/B) and more accurate (ATE 0.138
    # vs 0.150 m) than poly, despite poly winning the isolated pyramid
    # microbenchmark ~10x (the pyramid is not the critical path inside
    # the fused chunk program, and poly's <=6 px level-shape padding
    # shifts keypoint selection). "poly": exact 6:5 polyphase cascade
    # (scale_factor must be 1.2) — five static-stride weighted adds per
    # axis, pure VPU, no gathers/MXU; kept as an option for rigs where
    # extraction dominates.
    pyramid_mode: str = "matmul"
    fast_threshold_high: int = 20     # initial FAST threshold
    fast_threshold_low: int = 7       # fallback threshold in sparse cells
    # dual-threshold rank boost (the reference's 20->7 per-cell retry,
    # ref src/orb_extractor.cpp:769-829): high-threshold corners outrank
    # all low-threshold ones in cell selection. False = single
    # low-threshold pass ranked purely by corner response (~40% less
    # FAST/NMS work); see detect_dual for the measured accuracy delta.
    dual_threshold: bool = True
    cell_size: int = 32               # spatial-uniformity cell (ref uses 30px grid)
    patch_radius: int = 15            # IC_Angle / rBRIEF patch radius
    edge_margin: int = 19             # pyramid border (ref: EDGE_THRESHOLD 19)
    blur_sigma: float = 2.0           # GaussianBlur(7x7, sigma=2) before BRIEF
    # Rotation-steered BRIEF (the reference's rBRIEF). On near-planar
    # motion (KITTI: roll ~ 0) upright descriptors are markedly more
    # distinctive because IC-angle noise decorrelates steered patterns;
    # steering stays available for rotation-heavy rigs.
    steer_rotation: bool = False
    # dtype of the blur -> patch-gather -> BRIEF-compare path. bfloat16
    # halves the descriptor path's HBM footprint but measured NO fps
    # gain on a v5e (the patch gathers are VMEM/issue-bound, not
    # HBM-bound, and Mosaic's 32-bit-only dynamic_rotate forces an
    # in-kernel upcast) while near-tie comparison flips cost ~0.05 m
    # ATE on the KITTI-scale bench. Keep float32; the bf16 path stays
    # available for HBM-constrained deployments.
    descriptor_dtype: str = "float32"
    # In the JAX package: the fused FAST+NMS Pallas kernel, bit-exact
    # vs the XLA formulation, default off after a v5e A/B tie. In the
    # port it selects nothing: ops/extractor always routes FAST through
    # ops/fast_kernel.detect_levels (one launch of the hand-written
    # kernel a frame on the card, the plain detector on the CPU), as
    # both routes give the same responses bit for bit. Kept so that
    # configurations of either package load unchanged.
    fused_fast: bool = False

    @property
    def max_keypoints(self) -> int:
        """Padded per-frame keypoint capacity (lane-aligned)."""
        return _round_up(self.num_features, 128)

    @property
    def scales(self) -> Tuple[float, ...]:
        return tuple(self.scale_factor ** i for i in range(self.num_levels))


@dataclasses.dataclass(frozen=True)
class MatcherConfig:
    """Descriptor matching (reference: src/matcher.cpp)."""

    # Best/second-best Hamming ratio. The reference uses 0.5
    # (src/matcher.cpp:69,138) tuned to its learned BRIEF pattern; for
    # this engine's pattern a measured sweep (scripts/sweep_gates.py)
    # gives ~2x recall at >=93% precision at 0.7.
    ratio: float = 0.7
    # Ratio for PROJECTION-GUIDED matches (pose-predicted search
    # windows). Near ground texture is self-similar under magnification:
    # measured on the bench clothoid at z<21.5 m, the 0.7 ratio rejected
    # 151 of 166 hamming-passing near matches (~25 candidates per 50 px
    # window, second-best ~ best) while far points passed 224/512 — so
    # the map keeps almost no near landmarks. Relaxing this to 0.9
    # (ORB-SLAM's tracking SearchByProjection value) was measured and
    # REJECTED: the extra ambiguous matches tripled open-loop drift on
    # the bench clothoid (the LM's inlier gate does not reject
    # look-alikes that land within the 10 px reprojection window on
    # self-similar texture). Near geometry for the loop measurement
    # comes from the candidate keyframe's stereo rows instead
    # (closer._candidate_group_landmarks).
    track_ratio: float = 0.7
    stereo_max_dy: float = 3.0        # |y_l - y_r| epipolar gate
    stereo_min_dx: float = 0.0        # disparity bounds
    stereo_max_dx: float = 100.0
    # "sad": left-anchored SAD correlation sweep (ops/stereo_sad.py) —
    #   no right-image extraction, subpixel built in; ~5x cheaper.
    # "descriptor": the reference's design — extract right ORB, match
    #   descriptors along row bands, then refine subpixel
    #   (ref src/frame.cpp:384-389, src/matcher.cpp:54-132).
    stereo_method: str = "sad"
    stereo_uniqueness: float = 0.15   # SAD second-best margin (sad mode)
    # descriptor-consistency gate on SAD stereo matches (one BRIEF per
    # eye at level 0, reject on Hamming > max_hamming). Costs ~0.7 ms of
    # each keyframe event (two patch-gather kernels + two pick matmuls +
    # a right-image blur). Measured OFF on the KITTI-scale 3-seed sweep:
    # 509 fps / 0.179 m ATE vs 475 / 0.178 with it on — the SAD
    # uniqueness margin + positive-depth gate + BA's sigma trim already
    # reject what the gate would (classic StereoBM ships exactly this
    # uniqueness-only design). Re-enable for scenes with strongly
    # repetitive texture along epipolar lines (fences, facades).
    stereo_brief_gate: bool = False
    projection_radius: float = 50.0   # px, pose-tracking search radius
    loop_radius: float = 10.0         # px, loop-merge search radius
    max_hamming: int = 80             # absolute distance acceptance cap


@dataclasses.dataclass(frozen=True)
class TrackerConfig:
    """Motion-only LM (reference: src/posetracker.cpp)."""

    num_iterations: int = 10
    # tracking method strategy (ref include/method.h:33-50):
    # "indirect" = descriptor matching + reprojection LM (the default,
    # the only one the reference Pipeline wires); "direct" = photometric
    # 8-point-pattern alignment against the latest keyframe image with
    # affine brightness, the reference's BrightenDirectPoseTracker
    # (src/posetracker.cpp:250-353) actually wired into the engine here.
    # "hybrid" = indirect seed + a short full-resolution photometric
    # polish against the anchor keyframe (r4 verdict #5: the
    # configuration where photometric refinement can pay at KITTI
    # baselines — the full direct method's convergence basin cannot
    # absorb 0.8 m/frame, but a seeded polish starts inside the basin)
    method: str = "indirect"
    direct_bind_px: float = 5.0       # post-hoc keypoint binding radius
    #                                   (ref src/posetracker.cpp:278-317)
    hybrid_iters: int = 3             # photometric LM iterations of the
    #                                   hybrid polish (finest level only)
    hybrid_max_shift_m: float = 0.3   # reject a polish that moves the
    #                                   camera center further than this:
    #                                   sub-pixel refinement moves
    #                                   centimeters; a large move means
    #                                   the photometric model disagreed
    #                                   (occlusion / brightness break)
    min_matches: int = 8              # retry / accept thresholds
    reprojection_px: float = 10.0     # outlier filter (ReprojectionFilter)
    huber_delta: float = 2.4477468    # sqrt(5.991), on sigma-normalized residual
    lm_lambda0: float = 1e-4
    lm_lambda_up: float = 10.0
    lm_lambda_down: float = 0.1


@dataclasses.dataclass(frozen=True)
class LocalBAConfig:
    """Local-window bundle adjustment (reference: src/localmapper.cpp)."""

    num_iterations: int = 10
    window_keyframes: int = 8         # free + fixed poses in the window
    # mappoint slots in one BA problem. Under claim-grid suppression
    # (map.claim_cell_px) landmarks are never re-created, so BA must
    # cover essentially ALL active window landmarks: 512 slots left the
    # un-refined remainder drifting at ~0.01 m/frame (measured); 1024
    # covers the ~4.5k-point claim-regime map's window at the same ATE
    # as 2048 and ~6 fps more.
    max_points: int = 1024
    max_obs_per_point: int = 8        # observations kept per point
    huber_delta: float = 2.4477468
    trim_sigma: float = 5.0           # hard outlier trim (whitened sigma)
    lm_lambda0: float = 1e-4
    lm_lambda_up: float = 10.0
    lm_lambda_down: float = 0.1


@dataclasses.dataclass(frozen=True)
class KeyframeConfig:
    """Grid-occupancy keyframe rule (reference: src/pipeline.cpp:264-300)."""

    grid_cols: int = 4
    grid_rows: int = 1
    min_per_cell: int = 5
    min_total: int = 20
    culling_window: int = 5           # reserve range for non-keyframes
    # relative decay rule (ORB-SLAM2's tracked-vs-reference criterion,
    # self-calibrating): also fire a keyframe when tracked inliers fall
    # below decay_ratio x the running max since the last keyframe. The
    # reference's pure grid rule under-fires when the map is dense
    # (a dense stereo supplier keeps every cell above min_per_cell while
    # drift accumulates).
    # measured sweep (KITTI-scale synthetic, 160 frames, claim-grid
    # map): 0.2 -> 472 fps / 0.216 m / RPE 0.030; 0.25 -> 0.166 m but
    # RPE 0.031; 0.3 -> 442 fps / 0.171 m / RPE 0.022; 0.35 -> 422 /
    # 0.215; 0.4 -> 403 / 0.197 / 0.018. 0.3 is the knee: both the
    # fps and the accuracy curve favor it.
    decay_ratio: float = 0.3


@dataclasses.dataclass(frozen=True)
class LoopConfig:
    """Loop detection / closing (reference: src/loopdetector.cpp, loopcloser.cpp)."""

    min_covisibility: int = 20
    min_score_ratio: float = 0.7      # minScore = 0.7 * best-neighbor score
    min_score_floor: float = 0.02     # absolute floor under the relative
    #                                   rule: with NO covisible neighbor
    #                                   the relative minScore degrades to
    #                                   0 and floods candidates (typical
    #                                   true-revisit L1 scores land well
    #                                   above 0.1; random frames ~0.01)
    acc_score_ratio: float = 0.75     # keep groups > 0.75 * bestAccScore
    #                                   (ref src/pipeline_map.cpp:253-269)
    acc_group_size: int = 10          # top-N covisible KFs per group
    #                                   (ref src/pipeline_map.cpp:224-251)
    consistency_threshold: int = 5    # consecutive-KF consistency groups
    correction_window: int = 20       # keyframes rigidly pre-corrected by
    #                                   the loop transform before the pose
    #                                   graph runs (ORB-SLAM-style
    #                                   CorrectLoop; without it LM cannot
    #                                   execute large-drift corrections)
    min_kf_gap: int = 10              # candidates must be >= this many
    #                                   keyframes older than the query
    #                                   (covisibility exclusion alone is
    #                                   thinner here than in the reference)
    relpose_neighbor_kfs: int = 4     # relative-pose solves against the
    #                                   candidate + its top-N covisible
    #                                   neighbors' landmarks (ORB-SLAM2
    #                                   SearchAndFuse neighborhood). The
    #                                   candidate alone (~a frame's worth
    #                                   of far points) is weakly
    #                                   conditioned: measured 1-2.4 m /
    #                                   5-8 deg loop-edge errors passing
    #                                   80+ reprojection inliers on the
    #                                   revisit circle
    relpose_landmarks: int = 4096     # dedup capacity of that gather
    relpose_stereo_aug: bool = False  # augment the loop solve's point
    #                                   set with the candidate keyframe's
    #                                   own stereo keypoints triangulated
    #                                   off its disparity rows. The
    #                                   curated map is near-starved (the
    #                                   track_ratio note above), so the
    #                                   solve otherwise inherits the
    #                                   far-field ambiguity valley; the
    #                                   keyframe rows keep ~500 near
    #                                   stereo points per frame whose
    #                                   descriptors match directly at
    #                                   the revisit viewpoint. Geometry
    #                                   verified exact on CPU; default
    #                                   OFF because on the synthetic
    #                                   bench world near matches are
    #                                   texture-aliased and the
    #                                   mostly-coplanar aug set admitted
    #                                   a tilted consensus (+2.5 m
    #                                   vertical edge, BASELINE.md r5) —
    #                                   re-evaluate on real imagery,
    #                                   whose near field is matchable
    min_matches: int = 40             # relative-pose acceptance — the
    #                                   ORB-SLAM2 threshold. The reference's
    #                                   8 (and an earlier 25 here) admits
    #                                   weakly-conditioned loop edges:
    #                                   measured on the synthetic revisit
    #                                   circle, a 27-inlier edge carried a
    #                                   3.8 m relative error and walked the
    #                                   loop seam from 1.3 to 6 m
    reloc_min_matches: int = 25       # relocalization acceptance — laxer
    #                                   than min_matches: a weak re-track
    #                                   still beats a blind constant-
    #                                   velocity prediction, whereas a
    #                                   weak LOOP EDGE corrupts the graph
    relpose_depth_baselines: float = 40.0   # loop relpose solves on
    #                                   landmarks nearer than this many
    #                                   stereo baselines when enough
    #                                   exist (ORB-SLAM2's close/far
    #                                   split): far stereo depths are
    #                                   biased and slide the pose along
    #                                   the rot/trans ambiguity valley
    relpose_near_min: int = 40        # near matches required before the
    #                                   depth gate engages — decoupled
    #                                   from min_matches (acceptance):
    #                                   a handful of near points pins
    #                                   translation better than 100 far
    #                                   ones (r5 sweep knob)
    relpose_rt_rounds: int = 0        # >0: decoupled rotation/translation
    #                                   polish after the joint LM
    #                                   (closer._decoupled_rt_refine) —
    #                                   breaks the yaw/lateral valley the
    #                                   r4/r5 seam dissections measured
    #                                   (1.5 m lateral edge error at
    #                                   1.03 deg through 122 inliers)
    relpose_refine_rounds: int = 0    # re-match-by-projection rounds from
    #                                   the SOLVED pose (the ORB-SLAM2 loop
    #                                   flow: Sim3 seed -> SearchByProjection
    #                                   -> optimize again; ref loop re-track
    #                                   src/loopcloser.cpp:51-100 seeds from
    #                                   the candidate pose once). The first
    #                                   match searches around projections at
    #                                   the DRIFTED prediction, so only
    #                                   landmarks whose true projection
    #                                   falls within the radius of the
    #                                   drifted one get matched — a
    #                                   selection biased toward the
    #                                   prediction that drags the solve
    #                                   along the yaw/lateral valley (the
    #                                   r5 dissection's 1.5 m lateral edge
    #                                   error through 122 inliers).
    #                                   Re-matching from the solved pose
    #                                   removes the selection bias.
    #                                   Default 0 on the r5 on-chip
    #                                   sweep: one gated round trimmed
    #                                   the bench clothoid's edge 1.516
    #                                   -> 1.408 m but the seam landed
    #                                   0.25 m WORSE through post-
    #                                   closure revisit sensitivity
    #                                   (same result with the sim3
    #                                   scale locked to 1 — not a scale
    #                                   artifact); and it MUST stay
    #                                   gated on prior acceptance: an
    #                                   ungated refine rescued a
    #                                   34-inlier wrong candidate to 46
    #                                   self-consistent inliers at a
    #                                   4.3 m edge (BASELINE.md r5).
    relpose_refine_radius: float = 1.0  # re-match radius, as a fraction
    #                                   of matcher.projection_radius. NOT
    #                                   tighter than the first pass: a
    #                                   residual 1.5 m solve error still
    #                                   projects near (z~10 m) landmarks
    #                                   ~100 px off, and a 0.4x radius
    #                                   (20 px) kept the near points out
    #                                   of the refined set — measured
    #                                   n_near=0 after refinement on the
    #                                   bench clothoid
    reloc_lost_streak: int = 6        # chunked engine: consecutive lost
    #                                   frames (packed ok=0) before a
    #                                   fold-time BoW relocalization is
    #                                   attempted; the per-frame engine
    #                                   relocs on every lost frame, but a
    #                                   fold sees whole chunks, and a 1-2
    #                                   frame blip recovers by itself
    closure_cooldown_kfs: int = 10    # suppress detection for this many
    #                                   keyframes after a closure —
    #                                   ORB-SLAM2's mLastLoopKFid+10 gate;
    #                                   the reference declares the member
    #                                   for it (src/loopdetector.cpp:33
    #                                   last_loop_kf_) but never wires it.
    #                                   Re-closing an already-consistent
    #                                   seam re-injects measurement noise
    #                                   at full edge weight (measured:
    #                                   seam 0.19 m -> 0.89 m on the
    #                                   second closure of the same revisit)
    loop_edge_min_weight: float = 0.1  # floor for the inlier-proportional
    #                                   loop-edge information scale
    #                                   (weight = clip(inliers /
    #                                   (2*min_matches), floor, 1))
    closure_dedup_frames: int = 20    # a new loop edge whose BOTH
    #                                   endpoints fall within this many
    #                                   frames of an already-closed pair
    #                                   re-measures the same seam: accept
    #                                   it only if it has MORE inliers
    #                                   than the recorded edge
    #                                   (refinement), else skip —
    #                                   re-closing with a weaker
    #                                   measurement only injects noise
    posegraph_iterations: int = 20
    seam_ba: bool = False             # run one structure-only local-BA
    #                                   pass over a both-sides window
    #                                   (current + candidate + covisible
    #                                   KFs) right after each closure —
    #                                   the reference always runs local
    #                                   BA after CloseLoop (ref
    #                                   src/pipeline.cpp:137-138) because
    #                                   its WORLD-FRAME points need
    #                                   re-optimizing after the rigid
    #                                   correction. Here landmarks are
    #                                   anchored inverse-depth to their
    #                                   ref keyframe ray: the pose-graph
    #                                   correction moves structure WITH
    #                                   the keyframes by construction,
    #                                   and measurements agree the pass
    #                                   is redundant-to-harmful (bench
    #                                   clothoid seam 1.647 -> 1.848 m,
    #                                   ATE 0.944 -> 1.128 m; low-drift
    #                                   circle 0.73 -> 0.94 m; only the
    #                                   blind-drift circle improved,
    #                                   0.28 -> 0.20 m). Default OFF —
    #                                   available for maps whose drift
    #                                   profile matches the blind case
    seam_ba_min_corr_m: float = 0.75  # only when the closure moved the
    #                                   current keyframe by at least this
    #                                   much: on an already-consistent
    #                                   seam BA has nothing to fix and
    #                                   measurably walks it instead
    #                                   (low-drift circle: 0.73 m ->
    #                                   0.99 m), while after a real
    #                                   correction it helps (blind
    #                                   circle: 0.28 -> 0.26 m)
    chain_quality_floor: float = 0.2  # floor for the tracking-quality
    #                                   de-weighting of odometry edges
    #                                   (info scale = clip(q / (2 *
    #                                   tracker.min_matches), floor, 1)).
    #                                   Low floor -> a blind/lost stretch
    #                                   absorbs nearly the whole loop
    #                                   correction; 1.0 disables the
    #                                   de-weighting (uniform chain).
    #                                   0.2 swept best on the blind-drift
    #                                   circle (seam 0.278 vs 0.562 m at
    #                                   0.01, 2.44 m at 1.0) and is
    #                                   indistinguishable when odometry
    #                                   never breaks
    #                                   (scripts/sweep_loop_quality.py)
    info_translation: float = 100.0   # anisotropic odometry-edge info
    info_rotation: float = 100.0
    info_yaw_damp: float = 0.01       # ref wv(5,5)=0.01 (vertical-axis rot)
    pose_graph_group: str = "sim3"    # "sim3" | "se3". "sim3" realizes the
    #                                   reference's own TODO (ref
    #                                   src/loopcloser.cpp:107 "SE3->Sim3"):
    #                                   7-DoF essential-graph correction
    #                                   whose loop edge carries the scale
    #                                   drift measured from matched-landmark
    #                                   depth ratios; anchored inverse
    #                                   depths are rescaled with their
    #                                   keyframes. Default since the r3
    #                                   on-chip A/B: even on stereo
    #                                   (baseline-fixed scale) the scale
    #                                   component absorbs residual drift —
    #                                   bench clothoid ATE 0.858 vs 0.947 m,
    #                                   seam 1.382 vs 1.640 m, at equal
    #                                   speed (346 vs 292 fps run pair).
    #                                   "se3" remains selectable.
    info_scale: float = 100.0         # sigma-component info (sim3 edges)
    min_scale_pairs: int = 12         # matched depth-ratio pairs required
    #                                   before trusting a loop-scale
    #                                   estimate (else scale = 1)
    replay_edge_boost: float = 1.0    # information multiplier for
    #                                   REPLAYED loop edges in the pose
    #                                   graph (closer.close_loop): a
    #                                   replayed seam was measured,
    #                                   accepted and already corrected,
    #                                   so later closures could be made
    #                                   to deform the graph elsewhere
    #                                   instead of dragging it apart
    #                                   through the odometry chain.
    #                                   Default 1 (off) on the r5 CPU
    #                                   fig8 sweeps: in the 2-closure
    #                                   regime boost 4-8 improved every
    #                                   seam (lap2 1.31 -> 1.12-1.20 m),
    #                                   but in the 3-closure regime the
    #                                   boost AMPLIFIED an earlier
    #                                   noisy edge and doubled the seams
    #                                   (lap2 2.11 -> 4.88 m at boost 4)
    #                                   — overweighting is only safe
    #                                   when every replayed edge is
    #                                   good, which nothing guarantees.
    #                                   Single-closure runs (the bench
    #                                   clothoid) are untouched either
    #                                   way (the ring is empty at their
    #                                   solve)
    max_scale_drift: float = 0.05     # clamp on the sim3 loop-scale
    #                                   estimate: a STEREO rig observes
    #                                   absolute scale every frame, so
    #                                   real map scale drift is a few
    #                                   percent at most — an unclamped
    #                                   estimate applies whatever the
    #                                   drift-distorted matched structure
    #                                   says (measured: a 0.815 scale on
    #                                   a 137-inlier fig8 closure
    #                                   rescaled every anchored depth by
    #                                   18.5% and wrecked the map).
    #                                   Raise for monocular operation,
    #                                   where Sim3 scale genuinely floats
    # vocabulary (ours is trained, not ORBvoc.txt: branching k, depth L)
    vocab_k: int = 10
    vocab_levels: int = 4             # 10^4 = 10k words
    bow_mode: str = "auto"            # "auto" | "dense" | "topw". The
    #                                   dense (F, W) BoW database is
    #                                   exact and cheap at 10k words but
    #                                   4 GB at the reference's 1M-word
    #                                   ORBvoc scale (ref
    #                                   TemplatedVocabulary.h:1338+);
    #                                   "topw" stores fixed-width sorted
    #                                   (word, weight) rows and scores by
    #                                   vectorized merge-join (SURVEY
    #                                   §7.3; ref ScoringObject.cpp:34-60)
    bow_dense_max_words: int = 65536  # "auto" switches to topw above this
    bow_top_words: int = 512          # per-frame sparse BoW width; exact
    #                                   when >= distinct words per frame


@dataclasses.dataclass(frozen=True)
class MapConfig:
    """Fixed-capacity map state (replaces pointer-graph PipelineMap)."""

    max_keyframes: int = 1024         # keyframe ring capacity
    max_mappoints: int = 16384        # landmark table capacity
    # mappoint culling (ORB-SLAM-style): landmarks not re-observed by
    # >= mp_cull_min_obs keyframes within mp_cull_grace_frames frames of
    # their anchor are freed (keeps the fixed-capacity table from
    # saturating under a dense stereo supplier)
    mp_cull_min_obs: int = 2
    mp_cull_grace_frames: int = 12
    recent_frames: int = 16           # non-keyframe pose history kept on device
    max_obs_per_frame: int = 2048     # = extractor.max_keypoints
    track_landmarks: int = 3072       # local-map slots fed to the tracker
    track_recent_kfs: int = 10        # recency window for the local map
    track_covis_kfs: int = 6          # + top covisible neighbors of the
    #                                   latest keyframe (the reference's
    #                                   covisibility walk, ref
    #                                   src/pipeline.cpp:167-177). This is
    #                                   what keeps tracking INSIDE the old
    #                                   map after a loop closure — see
    #                                   mapping/map_state.
    #                                   gather_local_landmarks. 0 disables
    track_covis_min: int = 5          # min shared landmarks to count a
    #                                   keyframe as a covisible neighbor
    # new-landmark suppression: a keypoint whose image cell (or any of
    # its 8 neighbors) already contains a projected live landmark is
    # "claimed" and never spawns a new landmark. Geometric analog of the
    # reference's SetMappoitIfEmpty + duplicate keep-best fuse
    # (ref src/pipeline.cpp:252-261, src/matcher.cpp:197-205): without
    # it, every keyframe re-creates near-duplicates at keypoints whose
    # landmark match failed the descriptor test, flooding the table
    # (~30% of slots) and destabilizing the BA window. 0 disables.
    claim_cell_px: float = 6.0


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """Pinhole + radial-tangential stereo rig (reference: src/camera.cpp)."""

    fx: float = 718.856
    fy: float = 718.856
    cx: float = 607.1928
    cy: float = 185.2157
    # distortion [k1, k2, p1, p2]
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    baseline: float = 0.537           # KITTI stereo baseline [m]
    width: int = 1241
    height: int = 376


@dataclasses.dataclass(frozen=True)
class SlamConfig:
    camera: CameraConfig = dataclasses.field(default_factory=CameraConfig)
    extractor: ExtractorConfig = dataclasses.field(default_factory=ExtractorConfig)
    matcher: MatcherConfig = dataclasses.field(default_factory=MatcherConfig)
    tracker: TrackerConfig = dataclasses.field(default_factory=TrackerConfig)
    local_ba: LocalBAConfig = dataclasses.field(default_factory=LocalBAConfig)
    keyframe: KeyframeConfig = dataclasses.field(default_factory=KeyframeConfig)
    loop: LoopConfig = dataclasses.field(default_factory=LoopConfig)
    map: MapConfig = dataclasses.field(default_factory=MapConfig)

    def replace(self, **kw) -> "SlamConfig":
        return dataclasses.replace(self, **kw)

    @staticmethod
    def tiny() -> "SlamConfig":
        """Small shapes for fast CPU tests."""
        return SlamConfig(
            camera=CameraConfig(fx=120.0, fy=120.0, cx=64.0, cy=48.0,
                                baseline=0.5, width=128, height=96),
            extractor=ExtractorConfig(num_features=256, num_levels=4,
                                      cell_size=16),
            local_ba=LocalBAConfig(window_keyframes=4, max_points=256),
            map=MapConfig(max_keyframes=128, max_mappoints=4096,
                          max_obs_per_frame=256, track_landmarks=512,
                          track_recent_kfs=6,
                          # claim radius scales with image width
                          # (6px on 1241px KITTI ~ 0.6px here)
                          claim_cell_px=1.0),
            # search radii scale with image width (reference's 50px/10px
            # are for 1241px-wide KITTI frames)
            matcher=MatcherConfig(projection_radius=10.0, loop_radius=4.0),
            tracker=TrackerConfig(reprojection_px=4.0),
            # production decay_ratio (0.3) is tuned on the KITTI-scale
            # bench; the 10-frame tiny test worlds were calibrated at 0.4
            keyframe=KeyframeConfig(decay_ratio=0.4),
            loop=LoopConfig(vocab_k=4, vocab_levels=3, bow_top_words=64,
                            relpose_landmarks=1024),
        )
