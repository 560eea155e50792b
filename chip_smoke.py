#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (slam_toolkit_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. Device and build: require CUDA, print the card's name and power limit,
   torch's CUDA, the driver and whether torch binds CUDA-graph
   conditional nodes (the port adds its own, csrc/graph_cond.cu), build
   the CUDA kernels from csrc/ (one nvcc per source, in parallel) and
   print the build time.
2. Each kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it, with its stated tolerance, and its
   times:
   - `ms`: device time of one wrapper call, host work out of the window
     (device_ms: the call captured once in a CUDA graph, 50 replays
     queued behind a torch.cuda._sleep that outlasts their enqueue,
     CUDA events around the replays; median of 5 rounds). The same timer
     gives `library_ms`, one PyTorch call computing the same function,
     where there is one.
   - `host_ms`: host-clock time of one wrapper call with no synchronise,
     median of 50 calls (the port is host-bound, so this matters too).
   - `plain_ms`: CUDA events around single calls of the plain version,
     host work included (median of 30; 10 for local BA): no yardstick.
   - `bound_ms`: the larger of its bytes over 3.35 TB/s and its
     operations over 67 TFLOP/s (the H100's published HBM rate and
     float32 peak). The gather's and the stereo SAD's bytes count the
     images' 32-byte sectors that their windows (SAD: the left windows
     and the right strips) cover, not the whole images. The top-2's
     operations count what its output needs on this run's inputs: the
     float32 pixel gate on every pair, and the Hamming distance and
     running top-2 only for the pairs inside 2r, in integer operations
     at the rates of their type (__popc at 16 a clock per SM); its dense
     count of earlier commits, 36 float32 operations a pair, is printed
     beside it.
   The gather is timed as the main path launches it, a frame's 31x31
   windows at every pyramid level's budget in one launch (its bound and
   its library time, one unfold call a level, summed over the levels),
   and level 0's 434 windows alone; and as direct LM launches it, 3072
   windows 8x8 on a full-size level. The top-2 matcher is exact in every
   column, with the share of its pairs inside r and 2r. FAST+NMS is
   timed as the main path launches it, a frame's 8 levels in one launch
   (frame 0 of the track; its level 0 alone and a textured-noise frame
   beside it), bit-exact on every level in both modes; its bound counts
   the work its outputs need on the run's input (a response only for the
   (pixel, threshold, side) triples that pass the cardinal test, the NMS
   only for the positive centres), the dense count of earlier commits
   printed beside it. Local BA is also timed at 0 and 1 iterations.
   Local BA and the pose LM are cluster kernels (8 CTAs holding their
   share of the points / observations in shared memory); for local BA
   the script also prints where a solve's time goes, phase by phase,
   from the kernel's own clock64() counts on its first CTA, what those
   clocks cost, and each cluster kernel's capacity (points,
   observations).
3. The main path at full width: SlamConfig() (1241x376, 2000 features,
   3072 tracked landmarks, local BA over 8 keyframes x 1024 points), 48
   synthetic frames on a +0.8 m/frame track (tools/bench.stage_frames,
   cached under the temporary directory),
   ChunkedSlamEngine(chunk_size=16, device="cuda"), 3 chunks, then
   trajectory_refined(). The engine runs graphed, its default
   (scan_engine.make_chunk_fn: the chunk captured once as a CUDA graph
   in the first chunk, its frames a WHILE node with the frame index,
   images and rows on the device, the keyframe event an IF node on the
   device flag inside it, then launched once a chunk); phases 4-8, 10,
   11 (c) and 13 too. Phases 3, 4, 6-8, 13, 14 and 16 assert one launch
   of the graph "chunk" a chunk and the WHILE body's iterations equal
   to the frames run. Every kernel's launch count is reset just before and read just
   after (a graph adds on each replay the launches its capture recorded,
   and an IF body's once for each of its executions; the warm-up before
   the capture is set-up and not counted). Phases 3, 4, 6, 7 and 8 print
   the host syncs inside the chunks (CUDA's sync debug mode; the
   capturing chunk left out), which must be 0, and the keyframe IF
   body's runs, which must equal the rows' keyframe flags. Kernels 1-5
   must have launched, the gather
   once a frame, local BA once per keyframe after the bootstrap; ATE
   must stay <= 0.138 m. The captures, their seconds and the graphs'
   memory pool are printed. The inputs projection_match hands to the
   top-2 matcher on one frame are kept on the card (copied inside the
   graph: the last frame replayed); after the run the kernel must be
   exact against the plain version on them, and its device time there
   is printed beside the synthetic case's.
4. The same 48 frames through the plain detector
   (fast_kernel.detect_levels swapped for detect_levels_plain, captured
   in the chunk graph in the kernel's place): counts reset before and
   read after; FAST never launches, every other kernel as in phase 3,
   keyframe flags equal phase 3's, translations within 1e-4 m of it.
5. The first 8 frames again through the port's CPU path (plain
   versions, local BA included); fails on a frame whose translation
   differs by > 0.25 m.
6. The 48 frames again with a keyframe ring of 19 (decay_ratio 0.9,
   chunks of 8): the ring never over capacity after a chunk, >= 2 culls,
   48 finite poses, ATE <= 0.138 m. The headroom culls run through the
   engine's cull programs (captured as CUDA graphs at the first cull):
   >= 2 runs of the cull program, a graph for each program run; then the
   same run with the culls' programs eager (the host's `graphs` off):
   culls, the ring after each chunk, launches, rows and map bit-equal.
7. The 48 frames with tracker.method="hybrid": tracking ok on >= 90% of
   frames, ATE <= 0.150 m, the gather launched at 8x8 (its launches are
   counted by window shape).
8. The first 16 frames with tracker.method="direct": finite poses, the
   gather launched at 8x8, the pose LM never.
   Phases 3-8 each set every kernel's count to 0 just before the run and
   read the counts just after.
9. The kernel table as one JSON line (launches from phase 3, each
   kernel's launches in phase 10 as `launches_loop`, in
   phase 11 (a) as `launches_classic`, in phase 12 (a) as
   `launches_cluster`, in phase 13's batched layout as `launches_dp`
   and in its batched hybrid and direct runs as `launches_dp_hybrid`,
   `launches_dp_direct`; the top-2's launches from the loop closer's
   call sites as `launches_loop_closer`; the five batched entries of
   phase 13 as rows of their own, whose `launches` are their launches
   in that batched run, their own path, and the batched gather at 8x8
   as a row whose launches are the batched hybrid run's (its
   `launches_dp` the indirect run's 8x8 count, as on every row); the
   bfloat16
   entries of phase 15 likewise), then
   the result line. It is printed last, after phases 10-16.
10. Loop closing at full width: SlamConfig(), the loop bench's world and
   clothoid (tools/bench.stage_loop_frames: 192 frames, the track closing
   at frame 160, then its first 32 frames again; rendered in parallel
   processes and cached under the temporary directory), its vocabulary
   (k=10, L=3, trained on every 8th frame, through the DBoW2 text file),
   ChunkedSlamEngine(vocab=...) in chunks of 16, twice: the loop
   programs replayed as CUDA graphs (the kernel table's `launches_loop`),
   then eagerly (the host's `graphs` off; the chunk graphed in both).
   Counts reset just before each run and read just after, by kernel and
   by loop program (ProgramCounts); each fold's stage split, host and
   device ms (utils/timing.StreamStages); the loop graphs' captures,
   capture seconds, pools and capturing threads. In the eager run the
   inputs that the closer's call sites (relative pose, mappoint merge,
   relocalization) hand to the top-2 matcher are kept on the card (the
   first call of each; the track has no lost streak, so after the run
   the revisit of the first closure's candidate frame is relocalized
   against it to capture that call too, and through the graphed
   relocalization program). Gates: at least one closure and one replay,
   every pose finite, closures, events, ATE and seam exactly equal in
   both runs, launches equal by kernel and by loop program, 6 graphs
   plus one close graph a pose-graph tier used (captured at the
   closure, its capture seconds and pool printed) on the main thread,
   the loop host's 3 keyframe graphs (the culls and the closure's
   snapshot), the graphed relocalization and seam-BA
   programs bit-equal to their eager calls (one top-2 and one local-BA
   launch), the top-2 kernel exact against its plain version on every
   captured input (M, N and r printed, its device time beside phase
   2's), the kernels of the main path launched; the pose-graph tier,
   ATE and seam printed. The closure's close graph is replayed 5 times
   and its body run eagerly 5 times on the same inputs and the live map
   (put back after): the median ms of each, host clock and CUDA events.
   Local BA is held on the first closure's seam window (mapping/
   ba_adapter select_seam_window, every pose fixed) from the run's final
   map: T exact (all fixed), points anchored outside the window
   unchanged, X no farther from the plain solver's float64 run than
   twice the plain float32 run is (+ 1e-3 m), the final edge residuals
   against the plain run's as in phase 2, and the cost below the
   input's; how far the points moved is printed.
11. The per-frame engine, checkpoint/resume and the KITTI runner at
   SlamConfig(), graphed (process's _build and _track captured as two
   CUDA graphs at the bootstrap frame and its keyframe programs at their
   first use, the default; phase 18): (a)
   SlamEngine(device="cuda").process over phase 3's 48 frames, counts
   reset just before and read just after: kernels 1-5 launched (local
   BA once per keyframe from the third), every pose finite, ATE <= 0.138
   m; frames/s (the process calls alone), keyframes, mappoints and ATE
   printed beside phase 3's, and the chunked engine's
   frames/s on the same frames run again right after. (b) A checkpoint saved
   after frame 24 (pipeline/checkpoint) and loaded into a fresh engine
   on the card, which processes frames 24-47: its poses, as processed
   and refined, within 1e-5 m of (a)'s (the largest difference and
   whether they are bit-equal printed). (c) The first 32 frames written
   as 8-bit PNGs in KITTI layout (sequences/00/image_{0,1}, and
   poses/00.txt from the ground truth) under a temporary directory, then
   slam_toolkit_tpu_torch.run_kitti.main(["--root", ..., "--device",
   "cuda", "--out", ...]) with --classic, chunked, and chunked with
   --train-vocab: 32 frames, a finite ATE <= 0.138 m, a finite 32x12
   poses file and stats.json (the plots are written where matplotlib is
   installed). The vocabulary (vocab_phase): run_kitti.VocabExtract over
   the sampled frames graphed (one CUDA graph, the default) and eager,
   ms a frame of each printed, the corpora bit-equal, the CLI's
   vocabulary equal to one trained on the eager corpus (nodes,
   children, word ids, weights) and its extract's gather launches one a
   sampled frame.
12. The dense motion-clustering workload (cluster/) at 1241x376 with
   DenseConfig(max_points=18688), on make_cluster_scene's 60 frames:
   (a) the bench's run, tools/bench.cluster_record (BENCH_CLUSTER=1):
   FusedDenseTracker(device="cuda") over the frames staged on the card,
   graphed (its fused step one CUDA graph, the default; phase 17)
   (kernel counts reset just before and read just after: the workload
   reaches none of the six kernels, so all stay 0; printed as
   `launches_cluster`), frames/s after 5 warm-up frames, and its gates,
   each of which must hold: each mover one distinct cluster id over the
   last 20 frames; disparity p95 <= 0.3 px and <= 0.5% over 3 px, flow
   EPE p95 <= 2.0 px and <= 6% over 3 px on probe frames 10, 30 and 58
   against cluster_scene_gt; with one blocked dense_frame's ms, each
   stage's ms, host syncs a frame (CUDA's sync debug mode), and kernels
   a frame and the card's busy share from one torch.profiler pass in
   its record. (b) dense_frame on one pair on the card against the plain run
   on the CPU, to the JAX parity bars (validity, disparity within 1e-3
   px and the Sobel mask on >= 99.9% of pixels, flow within 1e-3 px on
   >= 99.9%, flow_p95 within 1e-3): the guard against TF32 filters.
   (c) The stepwise tracker (DenseTracker, stepwise_phase) over the 60
   frames graphed (its frame, track and round programs CUDA graphs, the
   default) and eager (graphs=False): frames/s over frames 5-39, host
   syncs over 40-59 (sync debug mode; graphed at most one a program run
   there, the readbacks), captures and pool bytes; every result
   (labels, skip flags, new-cluster counts, each cluster's slot, size
   and T) equal between the two, and the labels equal the fused
   tracker's. (d) The first 8 frames written as KITTI PNGs, then
   slam_toolkit_tpu_torch.run_cluster.main([..., "--device", "cuda",
   "--out", ...]): stats.json for 8 frames, at least 6 processed, one
   mask PNG a processed frame, clusters found, its DenseTracker graphed
   (a capture a program it ran, a replay a run).
13. Multi-sequence lanes (parallel/mesh) at SlamConfig(): four distinct
   sequences of 33 frames (phase 3's straight track, and phase 10's
   clothoid from frames 0, 48 and 96), frame 0 bootstrapping every lane
   (mesh.batched_bootstrap), frames 1-32 in two chunks of 16, through
   the lane layout (mesh.multi_sequence_lane_chunk: lanes in turn) and
   the batched layout (mesh.multi_sequence_chunk: the step batched over
   the lanes, and on a frame where any lane is flagged the keyframe
   event once over all lanes). For each layout every count is set to 0
   just before its bootstrap and read just after its last chunk: the
   batched layout must launch the batched gather once a frame for all
   lanes (and once for the bootstrap), the batched top-2 and pose LM
   once a frame, the batched SAD once for the bootstrap and once a frame
   with a flagged lane, the batched local BA once a frame with a flagged
   lane, and none of their single entries; the lane layout launches the
   single SAD and local BA. Keyframe flags, ok flags and slots must be
   equal between the layouts and to each lane run alone through
   ChunkedSlamEngine, and translations within 1e-3 m (a lane that parts
   names the frame). Aggregate frames/s of both layouts (the second
   chunk) and one lane alone's, and the device operations a frame of
   each layout (frames 2 and 3 under torch.profiler, after frame 1
   captured the graphs) are printed, and the host syncs over the rest
   of the first chunk: the batched layout's graph (the frames a WHILE
   node, the keyframe event an IF node on any lane's flag inside it)
   must make none, be launched once a chunk, iterate once a frame, and
   its IF body must run once for each frame with a flagged lane. The inputs of the five batched
   entries in the batched run are kept on the card (as phase 3's: the
   last frame that ran each); each entry is then held, lane by lane,
   against its single launch on them (exactly; the pose LM and local BA
   bit for bit) and against its batched plain version (the SAD bar, the
   pose LM's 2e-3, local BA's T 3e-3 and X 2e-2 from the float64 run
   beyond the plain float32 run's own distance), with its times, bound,
   library time and loss as phase 2's. Then the same four sequences
   under tracker.method "hybrid" and "direct" through both layouts, the
   photometric anchor added to the bootstrap's carry as ChunkedSlamEngine
   builds its own: the same equalities to each other and to each lane
   alone, the same keyframe-event launches, the batched gather at 8x8
   and never the single gather; the batched hybrid run keeps the 8x8
   gather's inputs, held as the 31x31 ones.
14. CUDA graphs against the eager step (graphs=False, make_frame_body)
   at full width: phase 3's 48 frames in the paired order eager,
   graphed, graphed, eager. Every run's 48 x 36 packed values (the
   bootstrap frame's row built the same way from the engine's
   trajectory) must be bit-equal, and the launch counts of the graphed
   runs, counted from the replays, equal to the eager runs' (by window
   shape too). Then phase 13's batched indirect and hybrid runs again,
   eagerly: their rows bit-equal to phase 13's graphed runs and their
   launches equal; each graphed batched run captured 1 graph (its
   keyframe event an IF node for all lanes). Prints each run's frames/s,
   the captures, their seconds and the graphs' pool memory, the host
   syncs inside each run's chunks (0 graphed, 1 a frame eager) and the
   keyframe IF body's runs against the keyframe rows, the graph
   launches and WHILE iterations against the chunks and frames, the
   last chunk's device time and kernels a frame from the first eager
   run under torch.profiler (it records one iteration of a WHILE body a
   graph launch, and reads fewer of the eager step's kernels here than
   profile_chunk does), the same chunk's wall in one launch from the first
   graphed run (busy share at that device time), the host CUDA calls
   and graph launches a chunk call from the second graphed run's last
   chunk under the profiler a frame a call, and both modes' aggregate
   frames/s at four lanes.
15. The option sets (tools/bench.OPTIONS) at SlamConfig(): (a) the
   kernels at their shapes on frame 0 (frame 1 as a second lane), each
   exact against its plain version and unfold, with phase 2's columns:
   the gather's bfloat16 entries (single, multi, batched) at 2000
   windows 31x31 over the 8 poly levels' budgets of the blurred levels
   rounded to bfloat16; the float32 gather at subpixel's 11x11 and
   11x17 (2048 windows) and at ic_angle's 31x31 over the raw poly
   levels; FAST+NMS on the poly level shapes. (b) Phase 3's 48 frames
   under O1 (steered BRIEF, bfloat16 descriptors, poly pyramid,
   descriptor stereo), O2 (the SAD stereo's BRIEF gate) and O3 (O1
   with upright descriptors, the path of the gather's bfloat16 entry),
   each graphed and then eagerly: rows bit-equal and launches equal (by
   window shape too), every kernel of the path launched and none that
   it does not run (SAD under O1 and O3; the bfloat16 gather under O1,
   whose steered descriptors sample by element); frames/s, keyframes,
   mappoints, ATE and RPE printed beside the JAX package's float32 CPU
   reading of the same frames and option (JAX_F32_48, from
   port_reference/jax_f32_headline.py --option). (c) Phase 10's first
   closure: its relative pose re-run on the run's final map with
   loop.relpose_stereo_aug off and on (the inliers of both; the top-2
   problem grows by the candidate's 2048 keypoint rows), the top-2
   kernel exact against its plain version on the augmented problem.
   (d) Two lanes (frames 0-16 and 16-32) under O1 and under O3 through
   mesh.multi_sequence_chunk, each lane's rows bit-equal to
   ChunkedSlamEngine on its frames; every gather, top-2 and local-BA
   launch on the batched entries, counted exactly (a frame's
   descriptors, and each keyframe event's right images extracted and
   refined over both lanes at once; O3's descriptors on the bfloat16
   entry), the single entries never. Counts are set to 0
   just before each run and read just after. The kernel table gains
   the two bfloat16 rows (launches: O3's run and the batched O3 lanes)
   and on every row `launches_o1` ... `launches_o3` and
   `launches_o1_batched`, `launches_o3_batched`.
16. The pipelined schedule (JAX's default): phase 10's 192 loop frames
   and vocabulary at SlamConfig(), graphed, through
   ChunkedSlamEngine(queue_depth=2, loop_thread=True): two chunks in
   flight, the loop phases on the mapping worker's thread and CUDA
   stream. (a) Counts set to 0 just before and read just after (the
   kernel table's `launches_loop_pipelined`); the launches made on the
   main thread and by the worker's jobs are counted apart
   (cuda_lib.counting) and must add up to every kernel's count. Gates:
   a closure and a replay, every pose finite, the kernels of the loop
   path launched, the closer's relative pose measured on the worker
   with the top-2 kernel (from its graph's replays), every such call on
   the worker's stream (torch.cuda.current_stream inside the job), 12
   loop graphs plus a close graph a tier used (captured on the main
   thread in thread_local mode at the closure, the worker waiting for
   it) captured on the main thread, and no exception or work
   left on the worker. Frames/s, ATE, seam, closures, the frames run
   when each landed, replays and the stage split are printed beside
   phase 10's inline run. Then the same in lockstep (the worker's jobs
   drained after each chunk, each measurement waited for) with the loop
   graphs and with the eager loop programs: closures, events, ATE, seam
   and launches exactly equal, the stage split of each, and the top-2
   exact against its plain version on the inputs the eager run's first
   relative pose on the worker handed it. The free-running run is held
   to the lockstep run with the loop graphs: the rows returned before
   the first closure landed bit-equal, every closure one that lockstep
   took (slot and candidate), ATE and seam finite and within the loop
   cell's limits (LOOP_ATE_LIMIT_M, LOOP_SEAM_LIMIT_M); a line sets both
   runs' closures, landings, ATE and seam side by side. No profiler
   pass runs over a one-launch chunk while the worker runs (PERF.md
   §7). (b) The same frames at depth 2 with the loop phases inline right after
   (a): its frames/s and closures, and the host syncs inside the chunks
   in both runs (0 inline; the worker's own are counted with the
   worker). (c) Without a vocabulary, phase 3's frames at
   depths 0 and 2: the rows returned (none while the queue fills)
   concatenated with the flush's are bit-equal. (d) The interpreter
   lock: a pure-Python loop on another thread ticks through the depth-2
   run's chunks 2-3; its rate against its rate alone is the share of
   the lock the main thread leaves free, and those chunks' walls are
   printed beside depth 0's without it.
17. The cluster tracker's fused step as one CUDA graph, the skip gate's
   two sides and each RANSAC round IF nodes: the first 20 of
   phase 12's frames at 1241x376 staged on the card, through
   FusedDenseTracker(graphs=False), then (graphs=True), counts set to 0
   just before each run and read just after (no kernel may launch).
   Every row (labels, skip flag, counts, sizes, ground flags, the
   accepted motions and their poses) must be bit-equal between the
   runs, and the graphed run must capture one graph. Printed per run:
   frames/s over frames 3-10, host syncs a frame over 11-16 (CUDA's sync
   debug mode) beside the tracker's waits for its packed row (an event
   wait the debug mode does not see), kernels a frame and the card's
   busy share on frame 17 (torch.profiler), and the graph's capture
   seconds and pool. The IF bodies' runs must equal the eager run's
   (run_if's plain version reads each flag on the host: the host-gated
   count), the skip and run sides the skipped and live rows, and the
   graphed kernels a frame must fall below 14,604 (the masked step's
   graph, which ran every round). Phase 12 (a)'s record is the graphed
   60-frame run.
18. SlamEngine.process's programs as CUDA graphs (tracking: _build and
   _track; the keyframe programs: stereo, insert, BA, snapshot): phase
   3's 48 frames through SlamEngine(graphs=False) and (graphs=True) in
   the order eager, graphed, graphed, eager, counts set to 0 just before
   each run and read just after. Every pose (as processed and refined),
   keyframe flag, inlier count and map field must be bit-equal across
   the runs, the launches counted from the replays equal to the eager
   counts, six graphs captured for a graphed engine's life (no cull at
   this ring), ATE <= 0.138 m. Printed per run: frames/s over frames
   1-31, ATE, host syncs a frame over 32-39, kernels a frame and busy
   share on frame 47, the graphs' capture seconds and pool, and the mean
   host ms of a tracking frame and of a keyframe frame.

It imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import struct
import subprocess
import sys
import tempfile
import time
import zlib

import numpy as np
import torch


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def device_ms(fn, n: int = 50, rounds: int = 5) -> float:
    """Device time of one fn() call in ms, with the host's work out of the
    event window.

    fn() runs once to warm up, then is captured once in a CUDA graph
    (the ctypes launch goes to the current stream, the capture stream).
    Each round enqueues a torch.cuda._sleep, the start event, n replays
    of the graph and the end event. The sleep is doubled until it
    outlasts the host's enqueue of the n replays, so the device runs them
    back to back. The result is the median over rounds of elapsed / n:
    the kernel with whatever device work its wrapper enqueues (dtype
    casts of the inputs), and no host time."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    cycles, times = 1 << 20, []
    while len(times) < rounds:
        slept, start, end = (torch.cuda.Event(enable_timing=True)
                             for _ in range(3))
        slept.record()
        torch.cuda._sleep(cycles)
        start.record()
        t0 = time.perf_counter()
        for _ in range(n):
            graph.replay()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        torch.cuda.synchronize()
        if slept.elapsed_time(start) < 1.5 * enqueue_ms:
            cycles *= 2                    # the device caught up: again
            continue
        times.append(start.elapsed_time(end) / n)
    del graph
    return float(np.median(times))


def host_ms(fn, n: int = 50) -> float:
    """Median host-clock time of one fn() call in ms, with no synchronise
    inside the timed call (the queue is drained every 10 calls, outside
    the window, so that it never fills)."""
    fn()
    times = []
    for i in range(n):
        if i % 10 == 0:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return float(np.median(times))


def call_ms(fn, reps: int = 30) -> float:
    """Median CUDA-event time of single fn() calls in ms, host work
    included: the plain versions' timer (they are no yardstick of speed)."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def row_times(kernel_fn, plain_fn, plain_reps: int = 30) -> dict:
    """The timing columns of a kernel row with no library call."""
    return {"ms": device_ms(kernel_fn), "host_ms": host_ms(kernel_fn),
            "plain_ms": call_ms(plain_fn, plain_reps), "library_ms": None}


def to_dev(a, dev) -> torch.Tensor:
    """numpy -> tensor on `dev`; uint32 descriptor words as int32."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a).to(dev)


def random_words(rng, n):
    return rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint64).astype(np.uint32)


def _textured(h, w, rng):
    base = rng.uniform(0, 255, (h, w)).astype(np.float32)
    for ax in (0, 1):
        base = (np.roll(base, 1, ax) * 0.25 + base * 0.5 +
                np.roll(base, -1, ax) * 0.25)
    return np.round(base).astype(np.float32)


HBM_BYTES_PER_S = 3.35e12      # H100 SXM, published
F32_OPS_PER_S = 67e12          # H100 SXM float32 peak (an FMA counts 2)
# The float32 peak is 128 FMA lanes a clock on each of 132 SMs, so the
# clock it assumes is 67e12 / (2 * 128 * 132) = 1.98 GHz. At that clock,
# by the CUDA programming guide's throughput table for compute capability
# 9.0, 32-bit integer add, compare and logic run at 64 lanes a clock per
# SM, and __popc at 16.
SM_CLOCK_HZ = F32_OPS_PER_S / (2 * 128 * 132)
INT32_OPS_PER_S = 64 * 132 * SM_CLOCK_HZ
POPC_OPS_PER_S = 16 * 132 * SM_CLOCK_HZ


def bound(n_bytes: float, n_ops: float, int_ops: float = 0,
          popc_ops: float = 0) -> dict:
    """Least time for the work: bytes moved once over the memory rate, or
    operations over their type's peak rate (float32, 32-bit integer,
    __popc; the types share the SMs' issue slots, so their times add),
    whichever is larger."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = (n_ops / F32_OPS_PER_S + int_ops / INT32_OPS_PER_S +
             popc_ops / POPC_OPS_PER_S) * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def window_bytes(img, ys, xs, rows: int, cols: int) -> int:
    """Bytes of img that rows x cols windows at corners (ys, xs) must read:
    the 32-byte sectors (the unit the memory system moves) that hold a
    pixel of their union, marked in a mask of the image, its rows laid
    end to end from an aligned start."""
    h, w = img.shape
    mask = torch.zeros(h, w, dtype=torch.bool, device=img.device)
    ry = torch.arange(rows, device=img.device)
    rx = torch.arange(cols, device=img.device)
    mask[(ys.long()[:, None] + ry)[:, :, None],
         (xs.long()[:, None] + rx)[:, None, :]] = True
    per = 32 // img.element_size()
    flat = torch.nn.functional.pad(mask.flatten(), (0, -mask.numel() % per))
    return int(flat.view(-1, per).any(1).sum()) * 32


# ---------------------------------------------------------------- phase 2
def _gather_case(img, k: int, side: int, rng):
    """k random window corners inside img, the kernel's and the plain
    version's calls, and one PyTorch call for the same function: an
    advanced-index gather of the image's window view (unfold)."""
    from slam_toolkit_tpu_torch.ops import patches
    h, w = img.shape
    ys = to_dev(rng.integers(0, h - side + 1, k).astype(np.int32), img.device)
    xs = to_dev(rng.integers(0, w - side + 1, k).astype(np.int32), img.device)
    win = img.unfold(0, side, 1).unfold(1, side, 1)
    yl, xl = ys.long(), xs.long()
    return (ys, xs,
            lambda: patches.gather_blocks_cuda(img, ys, xs, side, side),
            lambda: patches.gather_blocks_plain(img, ys, xs, side, side),
            lambda: win[yl, xl])


def check_gather(dev, rng):
    """Exact at 2048 windows of 31x31 and 37x37 on one image; then the
    main path's launch: a frame's 31x31 BRIEF windows at each pyramid
    level's budget (434 at level 0), all levels in one launch, exact
    against the per-level plain gather. Level 0's one-image launch is
    timed too. The row's bound sums the levels' bounds, its library time
    the levels' unfold calls (one a level)."""
    from slam_toolkit_tpu_torch.config import ExtractorConfig
    from slam_toolkit_tpu_torch.ops import patches, pyramid
    from slam_toolkit_tpu_torch.ops.extractor import level_budgets
    h, w, side = 376, 1241, 31
    img = to_dev(rng.uniform(0, 255, (h, w)).astype(np.float32), dev)
    err = 0.0
    for s in (31, 37):
        _, _, kern, plain, lib = _gather_case(img, 2048, s, rng)
        out, ref = kern(), plain()
        e = float((out - ref).abs().max())
        print(f"[phase2] gather 2048x{s}x{s}: max_abs_err {e}")
        if not (torch.equal(out, ref) and torch.equal(lib(), ref)):
            raise AssertionError(f"gather {s}x{s}: kernel, plain and unfold "
                                 "disagree")
        err = max(err, e)
        if s == side:
            print(f"[phase2] gather 2048x31x31: kernel {device_ms(kern):.4f}"
                  f" ms, unfold {device_ms(lib):.4f} ms (device)")
    cfg = ExtractorConfig()
    imgs, ys, xs, counts = [], [], [], []
    for (lh, lw), k in zip(pyramid.level_shapes(h, w, cfg),
                           level_budgets(cfg)):
        if k == 0:
            continue
        img_l = to_dev(rng.uniform(0, 255, (lh, lw)).astype(np.float32), dev)
        y, x, kern, _, lib = _gather_case(img_l, k, side, rng)
        if not imgs:                               # level 0, one image
            print(f"[phase2] gather level 0 alone, {k}x31x31 of {lh}x{lw}: "
                  f"kernel {device_ms(kern):.4f} ms, unfold "
                  f"{device_ms(lib):.4f} ms (device); the windows cover "
                  f"{window_bytes(img_l, y, x, side, side)} of the image's "
                  f"{nbytes(img_l)} bytes")
        imgs.append(img_l)
        ys.append(y)
        xs.append(x)
        counts.append(k)
    row = gather_row(imgs, torch.cat(ys), torch.cat(xs), counts, side, side,
                     patches.KERNEL, f"gather of a frame's {len(counts)} "
                     "levels")
    print(f"[phase2] gather, a frame's {len(counts)} levels ({sum(counts)} "
          f"windows 31x31, budgets {counts}) in one launch: kernel "
          f"{row['ms']:.4f} ms (device), wrapper {row['host_ms']:.4f} ms "
          f"(host), unfold {row['library_ms']:.4f} ms ({len(counts)} calls, "
          f"summed), bound {row['bound_ms']:.6f} ms (summed), exact")
    return {"name": "patch_gather",
            "source": "slam_toolkit_tpu_torch/csrc/patch_gather.cu",
            "replaces": "slam_toolkit_tpu/ops/patches.py:113",
            "kernel": patches.KERNEL, **row, "max_abs_err": err,
            "direct_8x8": check_gather_8x8(dev, rng)}


def check_gather_8x8(dev, rng) -> dict:
    """Direct LM's launch (optim/direct_lm._pattern_samples): 3072 8x8
    windows, one a tracked landmark, on a full-size level; exact against
    the plain gather, timed like the row, its bound from the sectors its
    windows cover."""
    h, w, k = 376, 1241, 3072
    img = to_dev(rng.uniform(0, 255, (h, w)).astype(np.float32), dev)
    ys, xs, kern, plain, lib = _gather_case(img, k, 8, rng)
    out, ref = kern(), plain()
    if not (torch.equal(out, ref) and torch.equal(lib(), ref)):
        raise AssertionError("gather 8x8: kernel, plain and unfold disagree")
    cover = window_bytes(img, ys, xs, 8, 8)
    case = {"ms": device_ms(kern), "host_ms": host_ms(kern),
            "plain_ms": call_ms(plain), "library_ms": device_ms(lib),
            **bound(cover + nbytes(ys, xs, out), 0)}
    print(f"[phase2] gather at direct LM's shape, {k} windows 8x8 of "
          f"{h}x{w}: exact; kernel {case['ms']:.4f} ms (device), wrapper "
          f"{case['host_ms']:.4f} ms (host), plain {case['plain_ms']:.4f} ms,"
          f" unfold {case['library_ms']:.4f} ms, bound "
          f"{case['bound_ms']:.6f} ms ({case['bound_by']}; the windows cover"
          f" {cover} of the image's {nbytes(img)} bytes)")
    return case


def check_topk2(dev, rng):
    from slam_toolkit_tpu_torch.ops import match_kernel as mk
    m, n, r, w, h = 3072, 2048, 50.0, 1241, 376
    a_desc, b_desc = random_words(rng, m), random_words(rng, n)
    b_desc[: n // 2] = a_desc[: n // 2] ^ (rng.random((n // 2, 8)) < 0.05) \
        .astype(np.uint32)                 # near-duplicates: real matches
    a_uv = rng.uniform(0, [w, h], (m, 2)).astype(np.float32)
    b_xy = rng.uniform(0, [w, h], (n, 2)).astype(np.float32)
    b_xy[: n // 2] = a_uv[: n // 2] + rng.normal(0, 20, (n // 2, 2))
    a_uv[m - 256:] = 1e7                   # invisible landmarks
    t = [to_dev(x, dev) for x in (a_desc, b_desc, a_uv, b_xy)]
    err = topk2_exact(t, r, "synthetic")
    row = row_times(lambda: mk.topk2_match_cuda(*t, r),
                    lambda: mk.topk2_match_plain(*t, r))
    b, dense_ms = topk2_bound(t, r)
    print(f"[phase2] top-2 M={m} N={n} r={r}: exact, {gate_shares(t, r)}, "
          f"rows with a match in r: "
          f"{int((mk.topk2_match_plain(*t, r)[:, 0] < 1e8).sum())}; bound "
          f"{b['bound_ms']:.6f} ms from the pairs inside 2r, "
          f"{dense_ms:.6f} ms counted dense (36 float32 operations a pair, "
          "the bound before the gate-first design)")
    return {"name": "topk2_match",
            "source": "slam_toolkit_tpu_torch/csrc/match_topk2.cu",
            "replaces": "slam_toolkit_tpu/ops/match_kernel.py:139",
            "kernel": mk.KERNEL, "max_abs_err": err, **row, **b}


def topk2_bound(t, r: float):
    """The top-2's bound from the work its output needs, and the dense
    count of the earlier bound (ms). Every pair needs the pixel gate: 2
    sub, 2 mul, 1 add and 2 compares in float32. Only a pair inside 2r
    needs its Hamming distance (8 __popc; 8 xor and 7 adds) and the
    running top-2 (~6 integer compares and selects). The dense count
    gives every pair all of it, 36 operations at the float32 rate."""
    m, n = t[0].shape[0], t[1].shape[0]
    _, in_2r = gate_counts(t, r)
    n_bytes = nbytes(*t) + m * 8 * 4                  # inputs, (M, 8) out
    return (bound(n_bytes, m * n * 7, int_ops=in_2r * 21,
                  popc_ops=in_2r * 8),
            bound(n_bytes, m * n * 36)["bound_ms"])


def topk2_exact(t, r: float, what: str) -> float:
    """The kernel against the plain version, every column exact (empty
    rows included: BIG and argbest 0); returns the max abs error (0)."""
    from slam_toolkit_tpu_torch.ops import match_kernel as mk
    out = mk.topk2_match_cuda(*t, r)
    ref = mk.topk2_match_plain(*t, r)
    if not torch.equal(out, ref):
        bad = sorted({int(c) for c in torch.nonzero(out != ref)[:, 1]})
        raise AssertionError(f"top-2 on the {what} case: columns {bad} "
                             "differ from the plain version")
    return float((out - ref).abs().max())


def gate_counts(t, r: float):
    """The number of (M, N) pairs inside r and inside 2r."""
    from slam_toolkit_tpu_torch.ops import match_kernel as mk
    _, _, a_uv, b_xy = t
    du = a_uv[:, None, 0] - b_xy[None, :, 0]
    dv = a_uv[:, None, 1] - b_xy[None, :, 1]
    d2 = du * du + dv * dv
    r1sq, r2sq = mk._gates(r)
    return int((d2 <= r1sq).sum()), int((d2 <= r2sq).sum())


def gate_shares(t, r: float) -> str:
    """The share of the (M, N) pairs inside r and inside 2r, and of the
    rows (landmarks) that are visible (u below 1e6)."""
    a_uv, pairs = t[2], t[0].shape[0] * t[1].shape[0]
    in_r, in_2r = gate_counts(t, r)
    return (f"pairs inside r {100 * in_r / pairs:.3f}%, inside 2r "
            f"{100 * in_2r / pairs:.3f}%, visible rows "
            f"{int((a_uv[:, 0] < 1e6).sum())} of {a_uv.shape[0]}")


class MatchCapture:
    """Keeps, on the card, the inputs that projection_match hands to the
    top-2 matcher on its `call`-th call (one mid-run frame); the matcher
    itself runs as before, once a call. Under a CUDA graph the matcher's
    Python runs only at the capture: the copy is then captured with it,
    and after the run holds the inputs of the last frame replayed."""

    def __init__(self, call: int):
        from slam_toolkit_tpu_torch.frontend import matching
        self.matching, self.orig = matching, matching.topk2_match
        self.call, self.calls, self.args = call, 0, None
        self.what = f"call {call}"
        matching.topk2_match = self

    def __call__(self, *args):
        self.calls += 1
        capturing = torch.cuda.is_current_stream_capturing()
        if self.calls == self.call or capturing:
            self.args = [a.clone() if isinstance(a, torch.Tensor) else a
                         for a in args]
            if capturing:
                self.what = "the last frame, copied inside the graph"
        return self.orig(*args)

    def close(self):
        self.matching.topk2_match = self.orig


def check_topk2_frame(cap: MatchCapture, synthetic_ms: float, label: str):
    """The top-2 kernel on the captured main-path frame: exact against
    the plain version, the gate shares there, and its device time beside
    the synthetic case's."""
    from slam_toolkit_tpu_torch.ops import match_kernel as mk
    if cap.args is None:
        raise AssertionError(f"the matcher was called {cap.calls} times, "
                             f"no call {cap.call} to capture")
    *t, r = cap.args
    m, n = t[0].shape[0], t[1].shape[0]
    topk2_exact(t, r, f"main-path frame ({cap.what})")
    ms = device_ms(lambda: mk.topk2_match_cuda(*t, r))
    b, dense_ms = topk2_bound(t, r)
    print(f"[phase3] {label} top-2 on the main path's {cap.what} "
          f"(M={m} N={n} r={r}): exact, {gate_shares(t, r)}; kernel "
          f"{ms:.4f} ms (device) there, {synthetic_ms:.4f} ms on the "
          f"synthetic case; bound there {b['bound_ms']:.6f} ms "
          f"({b['bound_by']}), {dense_ms:.6f} ms counted dense")


def check_pose_lm(dev, rng):
    from slam_toolkit_tpu_torch.config import TrackerConfig
    from slam_toolkit_tpu_torch.geometry import se3
    from slam_toolkit_tpu_torch.ops import pose_lm_kernel as plk
    n = 3072
    Xw = np.stack([rng.uniform(-20, 20, n), rng.uniform(-5, 5, n),
                   rng.uniform(4, 60, n)], -1).astype(np.float32)
    xi = torch.from_numpy(rng.uniform(-0.2, 0.2, 6).astype(np.float32))
    T_true = se3.exp(xi).numpy()
    Xc = (T_true[:3, :3] @ Xw.T).T + T_true[:3, 3]
    z = (Xc[:, :2] / Xc[:, 2:3]).astype(np.float32)
    z += rng.normal(0, 1e-3, z.shape).astype(np.float32)
    out_idx = rng.random(n) < 0.2                         # 20% outliers
    z[out_idx] += rng.normal(0, 0.3, (int(out_idx.sum()), 2)) \
        .astype(np.float32)
    mask = np.ones(n, bool)
    mask[::13] = False
    args = [torch.eye(4, device=dev)] + [
        to_dev(a, dev) for a in (Xw, z, np.full(n, 1e-6, np.float32), mask)]
    cfg = TrackerConfig()
    out = plk.optimize_pose_cuda(*args, cfg)
    ref = plk.optimize_pose_plain(*args, cfg)
    err = float((out.T_cw - ref.T_cw).abs().max())
    gt_err = float((out.T_cw.cpu() - torch.from_numpy(T_true)).abs().max())
    print(f"[phase2] pose LM N={n}, 20% outliers: max |T - T_plain| {err} "
          f"(bound 2e-3), max |T - T_true| {gt_err}")
    if not err <= 2e-3:
        raise AssertionError(f"pose LM differs from the plain solver: {err}")
    return {"name": "pose_lm",
            "source": "slam_toolkit_tpu_torch/csrc/pose_lm.cu",
            "replaces": "slam_toolkit_tpu/ops/pose_lm_kernel.py:224",
            "kernel": plk.KERNEL, "max_abs_err": err,
            **row_times(lambda: plk.optimize_pose_cuda(*args, cfg),
                        lambda: plk.optimize_pose_plain(*args, cfg)),
            # per observation and iteration: ~186 operations for the
            # normal equations, ~40 for the trial cost; 80 for the first
            # cost and the final r2
            **bound(nbytes(*args, out.T_cw, out.cost, out.inlier_r2),
                    n * (cfg.num_iterations * 226 + 80))}


def check_sad(dev, rng):
    from slam_toolkit_tpu_torch.ops import stereo_sad as sad
    h, w, k, max_disp, d = 376, 1241, 2048, 100, 23
    base = _textured(h, w + d, rng)
    left, right = to_dev(base[:, :w], dev), to_dev(base[:, d:d + w], dev)
    xl = rng.integers(0, w, k)
    yl = rng.integers(0, h, k)
    side, sw = 2 * sad.WIN + 1, sad._strip_w(max_disp)

    def i32(a):
        return to_dev(a.astype(np.int32), dev)
    ys0 = i32(np.clip(yl - sad.WIN, 0, h - side))
    xl0 = i32(np.clip(xl - sad.WIN, 0, w - side))
    xs0 = i32(np.clip(xl - (max_disp + sad.WIN + sad.PAD), 0, w - sw))
    args = (left, right, ys0, xl0, xs0, max_disp)
    out = sad.sad_curve_cuda(*args)
    ref = sad.sad_curve_plain(*args)
    err = float((out - ref).abs().max())
    # the sectors the left windows and the right strips cover, the
    # corners, the curves; per output and window pixel a subtract and an
    # add (the absolute value is an operand modifier of the add)
    left_b = window_bytes(left, ys0, xl0, side, side)
    right_b = window_bytes(right, ys0, xs0, side, sw)
    b = bound(left_b + right_b + nbytes(ys0, xl0, xs0, out),
              out.numel() * side * side * 2)
    print(f"[phase2] SAD K={k} max_disp={max_disp}: max_abs_err {err} "
          f"(rtol 1e-5, atol 1e-3); the windows cover {left_b} of the left "
          f"image's {nbytes(left)} bytes, the strips {right_b} of the "
          f"right's; bound {b['bound_ms']:.6f} ms ({b['bound_by']})")
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-3)
    return {"name": "stereo_sad",
            "source": "slam_toolkit_tpu_torch/csrc/stereo_sad.cu",
            "replaces": "slam_toolkit_tpu/ops/stereo_sad.py:128",
            "kernel": sad.KERNEL, "max_abs_err": err,
            **row_times(lambda: sad.sad_curve_cuda(*args),
                        lambda: sad.sad_curve_plain(*args)), **b}


def _ba_problem(dev, rng, W=8, P=1024, noise=5e-4):
    """A production-shape local-BA problem: W = 8 poses along +z (slot 0
    the fixed gauge, slot 5 an invalid pose), P = 1024 points, every
    edge stereo, 5% of the edges 30-sigma outliers; every 9th point fixed
    (anchored outside the window), the last 24 points empty."""
    from slam_toolkit_tpu_torch.geometry import se3
    from slam_toolkit_tpu_torch.optim.local_ba import BAProblem
    Xw = np.stack([rng.uniform(-15, 15, P), rng.uniform(-3, 3, P),
                   rng.uniform(6, 60, P)], -1).astype(np.float32)
    xi = np.zeros((W, 6), np.float32)
    xi[:, 2] = -0.8 * np.arange(W)
    T_true = se3.exp(torch.from_numpy(xi))
    dxi = rng.uniform(-1e-3, 1e-3, (W, 6)).astype(np.float32)
    dxi[0] = 0.0
    T_init = se3.exp(torch.from_numpy(dxi)) @ T_true
    Xc = (Xw[None] @ T_true[:, :3, :3].numpy().transpose(0, 2, 1)
          + T_true[:, None, :3, 3].numpy())
    z = np.stack([Xc[..., 0] / Xc[..., 2], Xc[..., 1] / Xc[..., 2],
                  (Xc[..., 0] - 0.537) / Xc[..., 2]], -1).astype(np.float32)
    z += rng.normal(0, noise, z.shape).astype(np.float32)
    bad = rng.uniform(size=(W, P)) < 0.05
    z[bad, :2] += 30 * noise
    obs = (Xc[..., 2] > 1.0) & (rng.uniform(size=(W, P)) < 0.6)
    pose_valid = np.ones(W, bool)
    pose_valid[5] = False
    pv = np.ones(P, bool)
    pv[-24:] = False
    free = np.ones(P, bool)
    free[::9] = False

    def t(a):
        return to_dev(a, dev)
    return BAProblem(
        T_cw=T_init.to(dev), pose_fixed=t(np.arange(W) == 0),
        pose_valid=t(pose_valid),
        Xw=t(Xw + rng.normal(0, 5e-3, Xw.shape).astype(np.float32)),
        point_valid=t(pv), z=t(z),
        inv_sigma=t(np.full((W, P), 1 / noise / 3, np.float32)),
        obs_mask=t(obs), stereo_mask=t(obs),
        baseline=torch.tensor(0.537, device=dev), point_free=t(free))


def ba_ops(W: int, P: int, iters: int) -> int:
    """Operations of the local-BA solve, counted from the algorithm: per
    edge and iteration ~327 for residual, Jacobians and the Hpp, bp,
    Hll, bl and Hpl terms, 144 for A = Hpl Hll^-1 and its rhs term, 33
    for the pose sums, 40 for the trial cost; per point ~40 for the 3x3
    inverse and 36 W + 18 for back-substitution; the S_off product
    2 (6W)^2 3P and the Gauss-Jordan 2 (6W)^2 (6W+1); the first cost and
    the final r2 ~70 per edge."""
    n6 = 6 * W
    per_iter = (W * P * (327 + 144 + 33 + 40) + P * (40 + 36 * W + 18) +
                2 * n6 * n6 * 3 * P + 2 * n6 * n6 * (n6 + 1))
    return iters * per_iter + W * P * 70


def _ba_kw(lb) -> dict:
    return dict(iters=lb.num_iterations, huber_delta=lb.huber_delta,
                lambda0=lb.lm_lambda0, lambda_up=lb.lm_lambda_up,
                lambda_down=lb.lm_lambda_down, trim_sigma=lb.trim_sigma)


def check_local_ba(dev, rng):
    from slam_toolkit_tpu_torch.config import LocalBAConfig
    from slam_toolkit_tpu_torch.ops import ba_kernel
    lb = LocalBAConfig()                  # trim_sigma 5.0, 10 iterations
    W, P = lb.window_keyframes, lb.max_points
    p = _ba_problem(dev, rng, W, P)
    kw = _ba_kw(lb)
    out = ba_kernel.solve_ba_cuda(p, **kw)
    ref = ba_kernel.solve_ba_plain(p, **kw)
    start = ba_kernel.solve_ba_plain(p, **dict(kw, iters=0))
    pv = p.point_valid
    act = p.obs_mask & p.pose_valid[:, None] & pv[None, :]
    err_T = float((out.T_cw - ref.T_cw).abs().max())
    err_X = float((out.Xw[pv] - ref.Xw[pv]).abs().max())
    print(f"[phase2] local BA W={W} P={P} trim {lb.trim_sigma}: "
          f"max |T - T_plain| {err_T} (bound 3e-3), max |X - X_plain| "
          f"{err_X} (bound 2e-2), cost {float(start.cost):.3f} -> "
          f"{float(out.cost):.3f} (plain {float(ref.cost):.3f})")
    if not (err_T <= 3e-3 and err_X <= 2e-2):
        raise AssertionError("local BA differs from the plain solver")
    torch.testing.assert_close(out.edge_r2[act], ref.edge_r2[act], rtol=0.2,
                               atol=0.5)
    if not (torch.equal(out.T_cw[5], p.T_cw[5]) and
            torch.equal(out.Xw[~pv], p.Xw[~pv]) and
            torch.equal(out.Xw[~p.point_free], p.Xw[~p.point_free])):
        raise AssertionError("local BA moved a masked or fixed slot")
    if not float(out.cost) < float(start.cost):
        raise AssertionError("local BA did not lower the cost")
    ins = [p.T_cw, p.pose_fixed, p.Xw, p.z, p.inv_sigma, p.obs_mask,
           p.stereo_mask, p.point_valid, p.point_free]
    # the fixed cost (set-up, first cost, outputs) against the cost of an
    # iteration: the same solve at 0, 1 and 10 iterations
    split = {n: device_ms(lambda n=n: ba_kernel.solve_ba_cuda(
        p, **dict(kw, iters=n)), n=20) for n in (0, 1, lb.num_iterations)}
    print(f"[phase2] local BA device ms at iters 0 / 1 / "
          f"{lb.num_iterations}: " + " / ".join(
              f"{split[n]:.4f}" for n in sorted(split)))
    return {"name": "local_ba",
            "source": "slam_toolkit_tpu_torch/csrc/local_ba.cu",
            "replaces": "slam_toolkit_tpu/ops/ba_kernel.py:408",
            "kernel": ba_kernel.KERNEL, "max_abs_err": max(err_T, err_X),
            "split_ms": split,
            **row_times(lambda: ba_kernel.solve_ba_cuda(p, **kw),
                        lambda: ba_kernel.solve_ba_plain(p, **kw),
                        plain_reps=10),
            **bound(nbytes(*ins, out.T_cw, out.Xw, out.edge_r2) + 8,
                    ba_ops(W, P, lb.num_iterations))}


def ba_phases(dev, ba_ms: float) -> None:
    """Where a local-BA solve's time goes: the kernel's clock64() cycles
    per phase on the cluster's first CTA, as shares of the solve and
    scaled to ba_ms (its device time) in microseconds; and what the
    clocks cost, the solve's device time with them on and off."""
    from slam_toolkit_tpu_torch.config import LocalBAConfig
    from slam_toolkit_tpu_torch.ops import ba_kernel
    lb = LocalBAConfig()
    p = _ba_problem(dev, np.random.default_rng(0), lb.window_keyframes,
                    lb.max_points)
    cyc = torch.zeros(len(ba_kernel.PHASES), dtype=torch.int64, device=dev)
    kw = _ba_kw(lb)
    ba_kernel.solve_ba_cuda(p, **kw, phase_cycles=cyc)
    c = cyc.cpu().numpy().astype(np.float64)
    on, off = (device_ms(lambda buf=buf: ba_kernel.solve_ba_cuda(
        p, **kw, phase_cycles=buf), n=20) for buf in (cyc, None))
    print(f"[phase2] local BA device ms with the phase clocks on {on:.4f}, "
          f"off {off:.4f}")
    us = c / c.sum() * ba_ms * 1e3
    per_it = [1 <= i <= 9 for i in range(len(c))]
    print(f"[phase2] local BA phases ({int(c.sum())} cycles; us of the "
          f"{ba_ms:.4f} ms solve, 'per it.' over {lb.num_iterations} "
          "iterations): " + ", ".join(
              f"{n} {u / lb.num_iterations if it else u:.2f} us"
              f"{' per it.' if it else ''} ({100 * u / us.sum():.1f}%)"
              for n, u, it in zip(ba_kernel.PHASES, us, per_it)))


def fast_ops(h: int, w: int, dual: bool) -> int:
    """The dense count of earlier commits, per pixel of the level: 16
    circle differences; per threshold 16 x (2 compares, 2 for the excess
    sum, 1 mask bit), the 9-of-16 arc test (18) and the 3x3 NMS (13); the
    boost and the border mask (2)."""
    per_thr = 16 * 5 + 18 + 13
    return h * w * (16 + per_thr * (2 if dual else 1) + 2)


def _span(n: int, lo: int, hi: int) -> int:
    """The length of [lo, hi) inside [0, n)."""
    return max(0, min(n, hi) - max(0, lo))


def fast_work(img, thr_hi, thr_lo: float, border: int) -> dict:
    """What one level's outputs need, counted on its pixels with the
    kernel's own tests. `ring`: the response ring [border - 1, h - border]
    (both axes), whose responses the NMS reads. `triples`: its (pixel,
    threshold, side) triples with one of taps 0 and 8 and one of taps 4
    and 12 beyond the threshold on that side (a 9-arc covers two
    neighbouring cardinal taps, so no other triple has a response);
    `passing`: its pixels with at least one. `inner`: the valid interior
    [border, h - border); `positive`: its pixels with a positive response
    at some threshold, the only ones the NMS can keep."""
    from slam_toolkit_tpu_torch.ops import fast
    h, w = img.shape
    p = torch.nn.functional.pad(img[None, None], (3, 3, 3, 3),
                                mode="replicate")[0, 0]
    d0, d4, d8, d12 = (p[3 + dy:3 + dy + h, 3 + dx:3 + dx + w] - img
                       for dy, dx in ((-3, 0), (0, 3), (3, 0), (0, -3)))
    hi08, hi412 = torch.maximum(d0, d8), torch.maximum(d4, d12)
    lo08, lo412 = torch.minimum(d0, d8), torch.minimum(d4, d12)
    thrs = [thr_lo] if thr_hi is None else [thr_lo, thr_hi]
    cand = torch.stack([c for t in thrs for c in (
        (hi08 > t) & (hi412 > t), (lo08 < -t) & (lo412 < -t))])
    y0, x0 = max(0, border - 1), max(0, border - 1)
    cand = cand[:, y0:max(y0, h - border + 1), x0:max(x0, w - border + 1)]
    resp = ([fast.fast_response(img, thr_lo)] if thr_hi is None
            else list(fast.dual_response(img, thr_hi, thr_lo)))
    y0, x0 = max(0, border), max(0, border)
    pos = torch.stack(resp)[:, y0:max(y0, h - border),
                            x0:max(x0, w - border)] > 0
    return {"ring": _span(h, border - 1, h - border + 1) *
            _span(w, border - 1, w - border + 1),
            "passing": int(cand.any(0).sum()), "triples": int(cand.sum()),
            "inner": _span(h, border, h - border) *
            _span(w, border, w - border),
            "positive": int(pos.any(0).sum())}


def fast_bound(levels, thr_hi, thr_lo: float, border: int):
    """The FAST row's bound from the work its outputs need, summed over
    the levels; the dense count of earlier commits (ms); and the levels'
    summed fast_work counts it was made from. Bytes: every output pixel
    written once, and the input pixels within 4 of the valid interior
    [border, h - border) read once. Operations, with n_thr thresholds:
    on each ring pixel the cardinal test (4 differences, 4 max / min and
    4 n_thr compares in float32; an and per (threshold, side)); on each
    passing pixel the other 12 differences; on each passing triple, per
    tap a compare, a subtract and an add for the excess sum (float32) and
    a mask bit (integer), then one log-step arc test (12 integer
    operations) and the select and the max of the sides (2 float32); on
    each interior pixel n_thr compares of the centre with 0; on each
    positive one the 3x3 NMS per threshold (13), the boost and the mask
    (2)."""
    n_thr = 1 if thr_hi is None else 2
    n_bytes = f32 = i32 = 0
    counts = dict.fromkeys(("ring", "passing", "triples", "inner",
                            "positive"), 0)
    for img in levels:
        h, w = img.shape
        c = fast_work(img, thr_hi, thr_lo, border)
        for key in counts:
            counts[key] += c[key]
        n_bytes += 4 * (h * w + _span(h, border - 4, h - border + 4) *
                        _span(w, border - 4, w - border + 4))
        f32 += (c["ring"] * (8 + 4 * n_thr) + c["passing"] * 12 +
                c["triples"] * (16 * 3 + 2) + c["inner"] * n_thr +
                c["positive"] * (13 * n_thr + 2))
        i32 += c["ring"] * 2 * n_thr + c["triples"] * (16 + 12)
    dense = bound(2 * sum(nbytes(lv) for lv in levels),
                  sum(fast_ops(*lv.shape, thr_hi is not None)
                      for lv in levels))["bound_ms"]
    return bound(n_bytes, f32, int_ops=i32), dense, counts


def check_fast_nms(dev, rng):
    """FAST+NMS as the main path launches it: every level of a frame in
    one launch (detect_levels), bit-exact against the plain detector on
    all 8 levels in both modes. The row is frame 0 of the synthetic track
    (the main path's input), its bound counted from the work its outputs
    need; level 0 alone and a textured-noise frame (more corner
    candidates) are timed beside it."""
    from slam_toolkit_tpu_torch.config import SlamConfig
    from slam_toolkit_tpu_torch.ops import fast_kernel, pyramid
    from slam_toolkit_tpu_torch.tools.bench import stage_frames
    cfg = SlamConfig()
    ecfg = cfg.extractor
    border = ecfg.patch_radius + 1
    thr = (float(ecfg.fast_threshold_high), float(ecfg.fast_threshold_low))
    frame = to_dev(stage_frames(cfg, 1)[0][0, 0].astype(np.float32), dev)
    noise = to_dev(_textured(376, 1241, rng), dev)
    cases = {name: pyramid.build_pyramid(img, ecfg)
             for name, img in (("frame 0", frame), ("textured", noise))}
    cases_ms, bounds = {}, {}
    for name, levels in cases.items():
        n_corners = 0
        for thr_hi in (thr[0], None):
            outs = fast_kernel.detect_levels_cuda(levels, thr_hi, thr[1],
                                                  border)
            refs = fast_kernel.detect_levels_plain(levels, thr_hi, thr[1],
                                                   border)
            for lv, out, ref in zip(levels, outs, refs):
                if not torch.equal(out, ref):
                    raise AssertionError(
                        f"FAST+NMS differs on {name} at level "
                        f"{tuple(lv.shape)}, thr_hi={thr_hi}")
                n_corners += int((ref > 0).sum())
        b, dense_ms, c = fast_bound(levels, thr[0], thr[1], border)
        bounds[name] = b
        ms = device_ms(lambda lv=levels: fast_kernel.detect_levels_cuda(
            lv, thr[0], thr[1], border))
        lv0_ms = device_ms(lambda lv=levels[0]: fast_kernel.detect_fused_cuda(
            lv, thr[0], thr[1], border))
        cases_ms[name] = ms
        cases_ms[f"{name} level 0"] = lv0_ms
        print(f"[phase2] FAST+NMS on {name}: exact at all {len(levels)} "
              f"level shapes {[tuple(lv.shape) for lv in levels]}, both "
              f"modes ({n_corners} corners); {c['passing']} of the "
              f"{c['ring']} ring pixels ({100 * c['passing'] / c['ring']:.1f}"
              f"%) pass the cardinal test, {c['triples']} (threshold, side) "
              f"triples ({c['triples'] / max(c['passing'], 1):.2f} a passing "
              f"pixel), {c['positive']} of the {c['inner']} interior pixels "
              f"positive; the frame's one launch {ms:.4f} ms, level 0 alone "
              f"{lv0_ms:.4f} ms (device); bound {b['bound_ms']:.6f} ms "
              f"({b['bound_by']}) from the work the outputs need, "
              f"{dense_ms:.6f} ms counted dense (every pixel of every level, "
              "the bound before the one-launch design)")
    levels = cases["frame 0"]
    args = (levels, thr[0], thr[1], border)
    return {"name": "fast_nms",
            "source": "slam_toolkit_tpu_torch/csrc/fast_nms.cu",
            "replaces": "slam_toolkit_tpu/ops/fast_kernel.py:149",
            "kernel": fast_kernel.KERNEL, "max_abs_err": 0.0,
            "cases_ms": cases_ms,
            **row_times(lambda: fast_kernel.detect_levels_cuda(*args),
                        lambda: fast_kernel.detect_levels_plain(*args)),
            **bounds["frame 0"]}


def phase2(dev) -> list:
    """Every kernel against its plain version, with its times: one row
    each, on inputs made from seed 0."""
    rng = np.random.default_rng(0)
    return [check_gather(dev, rng), check_topk2(dev, rng),
            check_pose_lm(dev, rng), check_sad(dev, rng),
            check_local_ba(dev, rng), check_fast_nms(dev, rng)]


# ---------------------------------------------------------------- phase 10
LOOP_FRAMES = 192          # lap 160 + revisit 32 in chunks of 16
# the loop cell's limits (PERF.md §2: the loop bench's ATE and seam, m);
# the bench is bimodal, so a run that takes another closure than its
# reference is held to these, not to the reference's reading
LOOP_ATE_LIMIT_M, LOOP_SEAM_LIMIT_M = 0.885, 1.311
CLOSER_SITES = ("relative_pose", "merge_mappoints", "relocalize_frame")


class LoopCapture:
    """While installed: the loop closer's call sites (CLOSER_SITES) are
    wrapped so that the inputs they hand to the top-2 matcher are kept on
    the card (the first call of each site) and the matcher's launches
    made inside them are counted per site."""

    def __init__(self):
        from slam_toolkit_tpu_torch.frontend import matching
        from slam_toolkit_tpu_torch.loop import closer
        from slam_toolkit_tpu_torch.ops import match_kernel as mk
        self.matching, self.closer, self.mk = matching, closer, mk
        self.orig_match = matching.topk2_match
        self.orig_sites = {n: getattr(closer, n) for n in CLOSER_SITES}
        self.site, self.args = None, {}
        self.launches = {n: 0 for n in CLOSER_SITES}
        matching.topk2_match = self._match
        for n in CLOSER_SITES:
            setattr(closer, n, self._wrap(n))

    def _match(self, *args):
        if self.site is not None and self.site not in self.args:
            self.args[self.site] = [a.clone() if isinstance(a, torch.Tensor)
                                    else a for a in args]
        return self.orig_match(*args)

    def _wrap(self, name):
        def call(*args, **kw):
            self.site, n0 = name, self.mk.KERNEL.launches
            try:
                return self.orig_sites[name](*args, **kw)
            finally:
                self.launches[name] += self.mk.KERNEL.launches - n0
                self.site = None
        return call

    def close(self):
        self.matching.topk2_match = self.orig_match
        for n, f in self.orig_sites.items():
            setattr(self.closer, n, f)


def check_seam_ba(eng, event: dict, label: str) -> float:
    """Local BA on the seam window of a closure (every pose fixed, as
    seam_ba_step builds it) from the engine's final map: kernel against
    the plain solver. Poses unchanged, points anchored outside the window
    unchanged, X no farther from the float64 run than twice the plain
    float32 run is (+ 1e-3 m), the final edge residuals as phase 2 holds
    them, and the cost below the input's. Returns the kernel's device
    ms."""
    from slam_toolkit_tpu_torch.mapping import ba_adapter
    from slam_toolkit_tpu_torch.ops import ba_kernel
    cfg, m = eng.cfg, eng.map
    window, win_valid = ba_adapter.select_seam_window(
        m, event["kf_slot"], event["cand"], cfg.local_ba.window_keyframes)
    p, _, _ = ba_adapter.build_problem(m, eng.cam, cfg, window, win_valid,
                                       torch.ones_like(win_valid))
    kw = _ba_kw(cfg.local_ba)
    out = ba_kernel.solve_ba_cuda(p, **kw)
    ref = ba_kernel.solve_ba_plain(p, **kw)
    ref64 = ba_kernel.solve_ba_plain(_ba_float64(p), **kw)
    start = ba_kernel.solve_ba_plain(p, **dict(kw, iters=0))
    pv = p.point_valid
    act = p.obs_mask & p.pose_valid[:, None] & pv[None, :]
    X_in = p.Xw[pv].double()
    spread = float((ref.Xw[pv].double() - ref64.Xw[pv]).abs().max())
    err_X = float((out.Xw[pv].double() - ref64.Xw[pv]).abs().max())
    move64 = float((ref64.Xw[pv] - X_in).abs().max())
    move = float((out.Xw[pv].double() - X_in).abs().max())
    n_obs = int((p.obs_mask & pv[None, :]).sum())
    ms = device_ms(lambda: ba_kernel.solve_ba_cuda(p, **kw), n=20)
    print(f"[phase10] {label} local BA on the seam window of closure "
          f"{event['kf_slot']}->{event['cand']}: W={window.numel()} "
          f"({int(win_valid.sum())} valid, all fixed), P="
          f"{int(pv.sum())} points, {n_obs} observations; max |X - X_in| "
          f"{move:.3g} (float64 run {move64:.3g}); max |X - X_f64| "
          f"{err_X:.3g} (bound 2 x plain f32 spread {spread:.3g} + 1e-3); "
          f"cost {float(start.cost):.3f} -> {float(out.cost):.3f} (plain "
          f"{float(ref.cost):.3f}, float64 {float(ref64.cost):.3f}); "
          f"kernel {ms:.4f} ms (device)")
    if not torch.equal(out.T_cw, p.T_cw):
        raise AssertionError("seam BA moved a fixed pose")
    if not torch.equal(out.Xw[~p.point_free], p.Xw[~p.point_free]):
        raise AssertionError("seam BA moved a point anchored outside")
    if not err_X <= 2.0 * spread + 1e-3:
        raise AssertionError(f"seam BA: X off the float64 run by {err_X}")
    torch.testing.assert_close(out.edge_r2[act], ref.edge_r2[act], rtol=0.2,
                               atol=0.5)
    if not float(out.cost) < float(start.cost):
        raise AssertionError("seam BA did not lower the cost")
    return ms


def _ba_float64(p):
    return type(p)(*(t.double() if isinstance(t, torch.Tensor)
                     and t.is_floating_point() else t for t in p))


class ProgramCounts:
    """While installed on a chunked engine's loop host: every call of a
    loop program's entry (the host's JAX names) counts the kernel
    launches its thread made inside it (a graph's replay adds its
    capture's launches, an eager call launches them), by program."""

    NAMES = ("_bow_register", "_bow_register_only", "_covis", "_relpose",
             "_reloc", "_close", "_seam_ba")

    def __init__(self, eng):
        from slam_toolkit_tpu_torch.utils import cuda_lib
        self.h = eng._host
        self.launches = {n: {} for n in self.NAMES}
        self.calls = {n: 0 for n in self.NAMES}
        for n in self.NAMES:
            orig = getattr(self.h, n)

            def call(*a, _n=n, _orig=orig, **k):
                with cuda_lib.counting() as d:
                    out = _orig(*a, **k)
                got = self.launches[_n]
                for c, v in d.items():
                    key = getattr(c, "symbol", type(c).__name__)
                    got[key] = got.get(key, 0) + v
                self.calls[_n] += 1
                return out
            setattr(self.h, n, call)

    def close(self):
        for n in self.NAMES:
            delattr(self.h, n)

    def of(self, symbol: str) -> dict:
        """Launches of kernel `symbol` by program (programs that made
        none left out)."""
        return {n[1:]: d[symbol] for n, d in self.launches.items()
                if d.get(symbol)}


def print_stages(tag: str, label: str, what: str, st: dict,
                 folds: int) -> None:
    """A StreamStages summary: per stage its count, host ms and device ms
    (the stage's stream between its events), in all and per fold."""
    parts = []
    for name, r in st.items():
        dev = "not measured" if r["device_ms"] is None else \
            f"{r['device_ms']:.3f}"
        parts.append(f"{name} x{r['n']}: host {1000 * r['host_s']:.3f} ms, "
                     f"device {dev} ms")
    host = sum(r["host_s"] for r in st.values())
    print(f"[{tag}] {label} {what}: stage split over {folds} folds "
          f"(total host {1000 * host:.1f} ms, "
          f"{1000 * host / max(folds, 1):.2f} ms a fold): "
          + "; ".join(parts))


def graph_stats_line(st) -> str:
    if st is None:
        return "no loop graphs"
    pool = "not named" if st["pool_bytes"] is None else \
        f"{st['pool_bytes'] / 2 ** 20:.1f} MiB"
    return (f"{st['captures']} loop graphs captured in "
            f"{st['capture_s']:.3f} s on {st['capture_threads']}, pools "
            f"{pool}, runs {st['runs']}; {closes_line(st)}")


def closes_line(st) -> str:
    """Each close tier's graph: its capture seconds (warm-up included) and
    pool bytes."""
    if not st["closes"]:
        return "no close graph"
    return "close graphs: " + ", ".join(
        f"{n} captured in {c['capture_s']:.3f} s, pool "
        + ("not named" if c["pool_bytes"] is None
           else f"{c['pool_bytes'] / 2 ** 20:.1f} MiB")
        for n, c in sorted(st["closes"].items()))


def expect_loop_graphs(st, n_loop: int, what: str) -> None:
    """The loop graphs: n_loop programs plus one close graph for each
    pose-graph tier a closure used, all captured on the main thread."""
    if st["captures"] != n_loop + len(st["closes"]) or not st["closes"] \
            or st["capture_threads"] != ["MainThread"]:
        raise AssertionError(f"loop graphs {what}: {st}")


def close_times(eng, reps: int = 5) -> dict:
    """The close graph of the engine's closure replayed, and its body run
    eagerly on the same static inputs, each `reps` times on the live map
    (the map and the ring put back after): ms a close on the host clock
    (synchronised) and on CUDA events."""
    h = eng._host
    prog = next(p for p in h._loop._progs.values()
                if p.late and p.gname in h._loop.graphs)
    m = prog.inputs[0]
    ring = (h.closed_i, h.closed_j, h.closed_T, h.closed_valid, h.closed_w)
    saved = [t.clone() for t in (*m, *ring)]
    out = {}
    for what, fn in (("graphed", lambda: h._loop.graphs.replay(prog.gname)),
                     ("eager", lambda: prog.fn(h, m, *prog.inputs[1:]))):
        host, dev = [], []
        for _ in range(reps):
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            host.append(1000 * (time.perf_counter() - t0))
            dev.append(start.elapsed_time(end))
        out[what] = {"host_ms": float(np.median(host)),
                     "event_ms": float(np.median(dev))}
    for dst, src in zip((*m, *ring), saved):
        dst.copy_(src)
    out["tier"] = prog.name
    return out


def loop_run(cfg, frames, chunk: int, vocab, kernels: dict,
             loop_graphs: bool, capture: bool = False) -> dict:
    """Phase 10's engine over the loop frames: the chunk graphed, the loop
    programs replayed as CUDA graphs or (loop_graphs False, the host's
    `graphs` off) run eagerly; every kernel's count set to 0 just before
    and read just after, the launches by loop program, the fold's stage
    split, and with `capture` the closer's top-2 inputs (LoopCapture: the
    eager programs call the closer)."""
    from slam_toolkit_tpu_torch.pipeline.scan_engine import ChunkedSlamEngine
    from slam_toolkit_tpu_torch.utils.timing import StreamStages
    eng = ChunkedSlamEngine(cfg, vocab=vocab, chunk_size=chunk,
                            device="cuda")
    eng._host.graphs = loop_graphs
    eng._host.stages = StreamStages()
    progs = ProgramCounts(eng)
    cap = LoopCapture() if capture else None
    for k in kernels.values():
        k.launches = 0
    chunk_s = []
    try:
        for i in range(0, len(frames), chunk):
            t0 = time.perf_counter()
            eng.process_chunk(frames[i:i + chunk])
            torch.cuda.synchronize()
            chunk_s.append(time.perf_counter() - t0)
        eng.flush()
        torch.cuda.synchronize()
    finally:
        progs.close()
        if cap is not None:
            cap.close()
    return {"engine": eng, "chunk_s": chunk_s,
            "launches": {n: k.launches for n, k in kernels.items()},
            "programs": progs, "cap": cap,
            "stages": eng._host.stages.summary(),
            "graphs": eng._host.loop_graph_stats()}


def loop_outcome(eng, gt, lap: int, revisit: int, n: int) -> dict:
    """What a loop run gives: its events, replays, ATE and seam."""
    from slam_toolkit_tpu_torch.evaluation.traj import ate_rmse
    from slam_toolkit_tpu_torch.tools import bench
    traj = finite_trajectory(eng, n, "loop path")
    c = bench._centers(traj)
    return {"events": eng.loop_events, "replays": eng.n_replays,
            "ate": ate_rmse(traj, gt, align=True),
            "seam": float(np.mean(np.linalg.norm(
                c[lap:lap + revisit] - c[:revisit], axis=1)))}


def same_outcome(a: dict, b: dict, what: str) -> None:
    """Two loop runs' events (closures and relocalizations, every field),
    replays, ATE and seam exactly equal."""
    for k in ("events", "replays", "ate", "seam"):
        if a[k] != b[k]:
            raise AssertionError(f"{what}: {k} differ: {a[k]} against "
                                 f"{b[k]}")


def phase10(cfg, kernels: dict, rows: list, label: str) -> dict:
    """Loop closing at full width, the loop programs replayed as CUDA
    graphs (the close through its tier's graph, captured at the closure),
    then once more eagerly (the chunk graphed in both): the same
    closures, events, ATE and seam, the same launches by kernel and by
    loop program; the stage split of both; the close's graph replay and
    eager body timed. Returns the graphed run's launch counts and
    engine."""
    from slam_toolkit_tpu_torch.mapping.ba_adapter import seam_ba_step
    from slam_toolkit_tpu_torch.mapping.map_state import MapState
    from slam_toolkit_tpu_torch.ops import ba_kernel
    from slam_toolkit_tpu_torch.ops import match_kernel as mk
    from slam_toolkit_tpu_torch.tools import bench
    from slam_toolkit_tpu_torch.utils import cuda_lib
    from slam_toolkit_tpu_torch.utils.timing import StreamStages
    chunk = 16
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    frames, gt = bench.stage_loop_frames(cfg, LOOP_FRAMES, chunk)
    t1 = time.perf_counter()
    vocab = bench.loop_vocabulary(cfg, frames, bench.loop_cache_base(
        cfg, LOOP_FRAMES, chunk, "clothoid", None) + ".vocab.txt", "cuda")
    lap, revisit, _, _ = bench.loop_geometry(LOOP_FRAMES, chunk)
    print(f"[phase10] frames ready in {t1 - t0:.1f} s, vocabulary "
          f"({vocab.num_words} words) in {time.perf_counter() - t1:.1f} s; "
          f"lap {lap}, revisit {revisit}")
    runs = {g: loop_run(cfg, frames, chunk, vocab, kernels, g,
                        capture=not g) for g in (True, False)}
    g_run, e_run = runs[True], runs[False]
    eng = g_run["engine"]
    out = {g: loop_outcome(r["engine"], gt, lap, revisit, LOOP_FRAMES)
           for g, r in runs.items()}
    launches = g_run["launches"]
    closures = [e for e in eng.loop_events if "cand" in e]
    relocs = [e for e in eng.loop_events if "reloc_to" in e]
    folds = len(g_run["chunk_s"])
    for g, r in runs.items():
        what = "loop graphs" if g else "loop programs eager"
        print(f"[phase10] {label} {what}, {LOOP_FRAMES} frames: frames/s "
              f"{LOOP_FRAMES / sum(r['chunk_s']):.2f} (chunk seconds "
              f"{[round(x, 3) for x in r['chunk_s']]}), ATE "
              f"{out[g]['ate']:.4f} m, seam {out[g]['seam']:.4f} m, "
              f"keyframes {r['engine'].n_keyframes}, closures "
              f"{len(closures)}, replays {r['engine'].n_replays}, "
              f"relocalizations {len(relocs)}, pose-graph tiers "
              f"{r['engine']._host.close_tiers}")
        print(f"[phase10] {label} {what}: launches {r['launches']}; top-2 "
              f"by loop program {r['programs'].of('slam_topk2_match')}, "
              f"local BA {r['programs'].of('slam_local_ba')}; calls "
              f"{r['programs'].calls}")
        print_stages("phase10", label, what, r["stages"], folds)
    print(f"[phase10] {label} {graph_stats_line(g_run['graphs'])}")
    for e in closures:
        t_err, r_err, _ = bench.loop_edge_error(e, gt)
        print(f"[phase10] {label} closure frame {e['frame']} -> "
              f"{e['fid_cand']} (slots {e['kf_slot']} -> {e['cand']}): "
              f"{e['inliers']} inliers, {e['n_near']} near, loop-edge "
              f"error {t_err:.3f} m / {r_err:.2f} deg")
    if not closures or eng.n_replays < 1:
        raise AssertionError(f"no closure landed: {len(closures)} closures, "
                             f"{eng.n_replays} replays")
    same_outcome(out[True], out[False], "phase 10, loop graphs against "
                 "the eager loop programs")
    if launches != e_run["launches"]:
        raise AssertionError(f"launches differ: graphed {launches}, eager "
                             f"{e_run['launches']}")
    if g_run["programs"].launches != e_run["programs"].launches:
        raise AssertionError(
            f"launches by loop program differ: graphed "
            f"{g_run['programs'].launches}, eager "
            f"{e_run['programs'].launches}")
    expect_loop_graphs(g_run["graphs"], 6, "inline")
    kf_st = eng._host.graph_stats()
    print(f"[phase10] {label} the host's keyframe programs (culls, "
          f"snapshot) on the static carry's map: {graph_line(kf_st)}; runs "
          f"{eng._host._kf.runs}")
    if kf_st["captures"] != 3:
        raise AssertionError(f"keyframe graphs of the loop host: {kf_st}")
    missing = [n for n, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the loop path: "
                             f"{missing}")
    closer = sum(g_run["programs"].of("slam_topk2_match").get(n, 0)
                 for n in ("relpose", "reloc", "close"))
    if not g_run["programs"].of("slam_topk2_match").get("relpose"):
        raise AssertionError("the graphed relative pose launched no top-2 "
                             "kernel")
    cap = e_run["cap"]
    if "relative_pose" not in cap.args:
        raise AssertionError("the eager relative pose launched no top-2 "
                             "kernel")
    print(f"[phase10] {label} the same closures, events, ATE and seam, "
          f"launches by kernel and by loop program, graphed and eager")
    # relocalization fires only after a lost streak, which this track
    # has not: re-track the revisit of the closure's candidate frame
    # against it, eagerly through the capture, and through the graphed
    # relocalization program
    h = eng._host
    reloc = LoopCapture()
    try:
        e = closures[0]
        img = torch.from_numpy(np.array(frames[lap + e["fid_cand"], 0])).to(
            eng.device, torch.float32)
        fr = h._build(img)
        rel = reloc.closer.relocalize_frame(eng.map, fr.feats, fr.norm_xy,
                                            e["cand"], eng.cam, cfg)
    finally:
        reloc.close()
    with cuda_lib.counting() as d:
        rel_g = h._reloc(eng.map, fr.feats, fr.norm_xy, e["cand"])
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(rel_g, rel)) or \
            d.get(mk.KERNEL, 0) != reloc.launches["relocalize_frame"]:
        raise AssertionError("the graphed relocalization parts from the "
                             "eager one")
    print(f"[phase10] {label} relocalization of frame {lap + e['fid_cand']} "
          f"against slot {e['cand']}: {int(rel.n_inliers)} inliers, ok "
          f"{bool(rel.ok)}, top-2 launches {reloc.launches}; the graphed "
          f"relocalization program bit-equal, {d.get(mk.KERNEL, 0)} top-2 "
          f"launch")
    cap.args.update(reloc.args)
    synthetic_ms = next(r["ms"] for r in rows if r["name"] == "topk2_match")
    for site, args in cap.args.items():
        *t, r = args
        topk2_exact(t, r, f"loop closer's {site}")
        ms = device_ms(lambda: mk.topk2_match_cuda(*t, r))
        b, _ = topk2_bound(t, r)
        print(f"[phase10] {label} top-2 from {site} (M={t[0].shape[0]} "
              f"N={t[1].shape[0]} r={r}): exact, {gate_shares(t, r)}; "
              f"kernel {ms:.4f} ms (device), {synthetic_ms:.4f} ms on "
              f"phase 2's case; bound {b['bound_ms']:.6f} ms "
              f"({b['bound_by']})")
    check_seam_ba(eng, closures[0], label)
    # the graphed seam BA program on the final map against seam_ba_step
    # on a copy; the map is put back after
    m = eng.map
    saved = MapState(*(t.clone() for t in m))
    ref = MapState(*(t.clone() for t in m))
    seam_st = StreamStages()
    with cuda_lib.counting() as d_e, seam_st.stage("eager", eng.device):
        seam_ba_step(ref, e["kf_slot"], e["cand"], eng.cam, cfg)
    with cuda_lib.counting() as d_g, seam_st.stage("graphed", eng.device):
        h._seam_ba(m, e["kf_slot"], e["cand"])
    torch.cuda.synchronize()
    seam_t = seam_st.summary()
    moved = float((m.mp_invd - saved.mp_invd).abs().max())
    if not all(torch.equal(a, b) for a, b in zip(m, ref)) or d_e != d_g:
        raise AssertionError("the graphed seam BA parts from seam_ba_step")
    for dst, src in zip(m, saved):
        dst.copy_(src)
    print(f"[phase10] {label} the graphed seam BA program on closure "
          f"{e['kf_slot']}->{e['cand']}: map bit-equal to seam_ba_step's, "
          f"local-BA launches {d_g.get(ba_kernel.KERNEL, 0)} (eager "
          f"{d_e.get(ba_kernel.KERNEL, 0)}), largest inverse-depth change "
          f"{moved:.3g}; seam BA stage: "
          + "; ".join(f"{k} host {1000 * v['host_s']:.3f} ms, device "
                      f"{v['device_ms']} ms" for k, v in seam_t.items()))
    ct = close_times(eng)
    print(f"[phase10] {label} the closure's {ct['tier']} close, 5 runs each "
          f"on the live map (put back after): graph replay "
          f"{ct['graphed']['host_ms']:.3f} ms host, "
          f"{ct['graphed']['event_ms']:.3f} ms events; the same body eager "
          f"{ct['eager']['host_ms']:.3f} ms host, "
          f"{ct['eager']['event_ms']:.3f} ms events (medians)")
    print(f"[phase10] {label} phase seconds "
          f"{time.perf_counter() - t_phase:.1f}")
    return {"launches": launches, "closer": closer, "frames": frames,
            "engine": eng, "closure": closures[0], "gt": gt, "vocab": vocab,
            "chunk_s": g_run["chunk_s"], "ate": out[True]["ate"],
            "seam": out[True]["seam"], "eager_chunk_s": e_run["chunk_s"]}


# ---------------------------------------------------------------- phase 11
SAVE_AT = 24               # the checkpoint of phase 11 (b)
CLI_FRAMES = 32            # the PNG frames of phase 11 (c)


def write_png(path: str, img: np.ndarray) -> None:
    """An 8-bit grayscale PNG of `img` (uint8), every row unfiltered."""
    def chunk(tag: bytes, data: bytes) -> bytes:
        return struct.pack(">I", len(data)) + tag + data + \
            struct.pack(">I", zlib.crc32(tag + data))
    h, w = img.shape
    raw = b"".join(b"\0" + img[r].tobytes() for r in range(h))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 1)) + chunk(b"IEND", b""))


def stage_kitti(root: str, frames: np.ndarray, gt, n: int) -> None:
    """The first n stereo frames in the KITTI odometry layout, with the
    ground truth as poses/00.txt (3x4 T_wc rows)."""
    seq = os.path.join(root, "sequences", "00")
    for i in range(n):
        for cam in (0, 1):
            d = os.path.join(seq, f"image_{cam}")
            os.makedirs(d, exist_ok=True)
            write_png(os.path.join(d, f"{i:06d}.png"),
                      np.ascontiguousarray(frames[i, cam], np.uint8))
    os.makedirs(os.path.join(root, "poses"))
    np.savetxt(os.path.join(root, "poses", "00.txt"), np.stack(
        [np.linalg.inv(np.asarray(T, np.float64))[:3].reshape(-1)
         for T in gt[:n]]))


def max_shift_m(a, b) -> float:
    return max(float(np.linalg.norm(np.asarray(x)[:3, 3] -
                                    np.asarray(y)[:3, 3]))
               for x, y in zip(a, b))


def phase11(cfg, frames, gt, kernels: dict, label: str, main: dict) -> dict:
    """The per-frame engine, checkpoint/resume and the KITTI runner;
    returns (a)'s launch counts."""
    from slam_toolkit_tpu_torch import run_kitti
    from slam_toolkit_tpu_torch.evaluation.traj import ate_rmse
    from slam_toolkit_tpu_torch.pipeline import checkpoint
    from slam_toolkit_tpu_torch.pipeline.engine import SlamEngine
    n = len(frames)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "state.npz")
        # (a) the per-frame engine; (b)'s checkpoint saved on the way,
        # outside the timed process calls
        for k in kernels.values():
            k.launches = 0
        eng = SlamEngine(cfg, device="cuda")
        step_s, save_s = [], 0.0
        for i in range(n):
            if i == SAVE_AT:
                t0 = time.perf_counter()
                checkpoint.save(eng, ckpt)
                save_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            eng.process(frames[i, 0], frames[i, 1])
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
        launches = {k: v.launches for k, v in kernels.items()}
        traj = finite_trajectory(eng, n, "per-frame engine")
        ate = ate_rmse(traj, gt, align=True)
        n_kf, n_lm = eng.n_keyframes, eng.num_mappoints()
        print(f"[phase11] {label} (a) SlamEngine.process: frames/s "
              f"{n / sum(step_s):.2f} ({(n - 16) / sum(step_s[16:]):.2f} "
              f"over frames 16-47), keyframes {n_kf}, mappoints {n_lm}, ATE "
              f"{ate:.4f} m; phase 3's chunked engine: frames/s "
              f"{main['fps']:.2f}, keyframes {main['n_kf']}, landmarks "
              f"{main['n_lm']}, ATE {main['ate']:.4f} m")
        print(f"[phase11] {label} (a) launches {launches}")
        missing = [k for k, v in launches.items() if v == 0]
        if missing:
            raise AssertionError(f"kernels not launched by process: "
                                 f"{missing}")
        if launches["local_ba"] != n_kf - 2:
            raise AssertionError(f"local BA launched {launches['local_ba']} "
                                 f"times for {n_kf - 2} keyframes from the "
                                 "third")
        if not ate <= 0.138:
            raise AssertionError(f"per-frame engine: ATE {ate:.4f} m above "
                                 "0.138")
        # the chunked engine on the same frames right after, outside the
        # counted run: both engines' frames/s read next to each other
        _, chunk_s = run_engine(cfg, frames, 16, "cuda")
        print(f"[phase11] {label} (a) the chunked engine again right after: "
              f"frames/s {n / sum(chunk_s):.2f}")
        # (b) resume on the card from the checkpoint
        t0 = time.perf_counter()
        eng2 = checkpoint.load(SlamEngine(cfg, device="cuda"), ckpt)
        load_s = time.perf_counter() - t0
        for i in range(SAVE_AT, n):
            eng2.process(frames[i, 0], frames[i, 1])
        d_raw = max_shift_m(eng2.trajectory, eng.trajectory)
        d_ref = max_shift_m(eng2.trajectory_refined(),
                            eng.trajectory_refined())
        bit = all(np.array_equal(a, b) for a, b in zip(
            eng2.trajectory_refined(), eng.trajectory_refined()))
        print(f"[phase11] {label} (b) checkpoint after frame {SAVE_AT} "
              f"({os.path.getsize(ckpt) / 1e6:.1f} MB, saved in {save_s:.2f}"
              f" s, loaded in {load_s:.2f} s), resumed to frame {n - 1}: "
              f"max |t - t_uninterrupted| {d_raw} m as processed, {d_ref} m "
              f"refined, bit-equal {bit}")
        if len(eng2.trajectory) != n or max(d_raw, d_ref) > 1e-5:
            raise AssertionError(f"resumed run differs by "
                                 f"{max(d_raw, d_ref)} m")
    # (c) the KITTI runner over PNG frames
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        stage_kitti(root, frames, gt, CLI_FRAMES)
        print(f"[phase11] {label} (c) wrote {CLI_FRAMES} stereo PNG pairs "
              f"in {time.perf_counter() - t0:.1f} s")
        # the chunked run with --train-vocab: its _get_vocab's vocabulary
        # and gather launches kept
        vocab_run, get_vocab = {}, run_kitti._get_vocab

        def kept_vocab(*a):
            g0 = kernels["patch_gather"].launches
            vocab_run["voc"] = get_vocab(*a)
            vocab_run["gathers"] = kernels["patch_gather"].launches - g0
            return vocab_run["voc"]
        run_kitti._get_vocab = kept_vocab
        try:
            for mode in (["--classic"], [], ["--train-vocab"]):
                out = os.path.join(root, "out" + "".join(mode))
                with contextlib.redirect_stdout(io.StringIO()) as printed:
                    stats = run_kitti.main(["--root", root, "--seq", "00",
                                            "--device", "cuda", "--out",
                                            out] + mode)
                if json.loads(printed.getvalue()) != stats:
                    raise AssertionError(f"run_kitti printed "
                                         f"{printed.getvalue()!r}")
                poses = np.loadtxt(os.path.join(out, "00.txt"))
                name = {"--classic": "classic",
                        "--train-vocab": "chunked --train-vocab"}.get(
                            "".join(mode), "chunked")
                print(f"[phase11] {label} (c) run_kitti {name}: {stats}, "
                      f"poses {poses.shape}, files "
                      f"{sorted(os.listdir(out))}")
                if stats["frames"] != CLI_FRAMES or \
                        poses.shape != (CLI_FRAMES, 12) or \
                        not np.isfinite(poses).all() or \
                        not stats["ate_rmse_m"] <= 0.138:
                    raise AssertionError(f"run_kitti {name}: {stats}, "
                                         f"poses {poses.shape}")
        finally:
            run_kitti._get_vocab = get_vocab
        vocab_phase(root, vocab_run, label)
    return launches


def replay_ms(graphs, name: str, reps: int = 10) -> float:
    """Device ms of one replay of graph `name`: CUDA events around `reps`
    replays queued after a synchronise (counted as replays)."""
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        graphs.replay(name)
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def vocab_phase(root: str, vocab_run: dict, label: str) -> None:
    """Phase 11 (c)'s vocabulary: run_kitti.VocabExtract over the sampled
    frames graphed and eager (ms a frame, its first call apart), the
    corpora bit-equal, and the CLI run's vocabulary equal to one trained
    on the eager corpus, its gather launches one a sampled frame."""
    from slam_toolkit_tpu_torch import run_kitti
    from slam_toolkit_tpu_torch.data.kitti import KittiDataset
    from slam_toolkit_tpu_torch.loop import vocab as V
    ds = KittiDataset("00", root=root)
    imgs = [ds[i][0] for i in run_kitti.vocab_frames(len(ds))]
    ext_cfg = run_kitti._auto_config(imgs[0].shape).extractor
    corpora = {}
    for mode in ("graphed", "eager"):
        ex = run_kitti.VocabExtract(ext_cfg, "cuda",
                                    graphs=mode == "graphed")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        corpus = [ex(imgs[0])]
        first_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        corpus += [ex(im) for im in imgs[1:]]
        ms = 1000.0 * (time.perf_counter() - t0) / (len(imgs) - 1)
        corpora[mode] = corpus
        st = ex.graph_stats()
        print(f"[phase11] {label} (c) vocabulary extract {mode}: "
              f"{ms:.3f} ms a frame over sampled frames 1-{len(imgs) - 1} "
              f"(image copied in, descriptors read back), the first "
              f"{first_s:.3f} s"
              + ("" if st is None else
                 f"; a replay alone {replay_ms(ex.graphs, 'extract'):.3f} "
                 f"ms (device); {graph_line(st)}"))
        if mode == "graphed" and (st["captures"] != 1 or st["replays"] !=
                                  {"extract": len(imgs)}):
            raise AssertionError(f"vocabulary extract: {st}")
    bad = [i for i, (a, b) in enumerate(zip(corpora["graphed"],
                                            corpora["eager"]))
           if not np.array_equal(a, b)]
    if bad:
        raise AssertionError(f"vocabulary extract: graphed and eager "
                             f"descriptors part on sampled frames {bad}")
    eager_voc = V.train(np.concatenate(corpora["eager"]), k=10, levels=3,
                        seed=0)
    cli_voc = vocab_run["voc"]
    parts = [n for n, a, b in zip(("nodes", "children", "word_id",
                                   "weights"), V.to_numpy(cli_voc),
                                  V.to_numpy(eager_voc))
             if not np.array_equal(a, b)]
    print(f"[phase11] {label} (c) --train-vocab: {cli_voc.num_words} words "
          f"from {len(imgs)} sampled frames ({sum(map(len, corpora['eager']))}"
          f" descriptors), the CLI's vocabulary and the eager corpus's "
          f"equal: {not parts}; gather launches in the CLI's extract "
          f"{vocab_run['gathers']}")
    if parts or (cli_voc.k, cli_voc.levels) != (eager_voc.k,
                                                eager_voc.levels):
        raise AssertionError(f"--train-vocab: the graphed vocabulary parts "
                             f"from the eager one in {parts}")
    if vocab_run["gathers"] != len(imgs):
        raise AssertionError(f"--train-vocab: {vocab_run['gathers']} gather "
                             f"launches for {len(imgs)} sampled frames")


# ---------------------------------------------------------------- phase 12
CLUSTER_FRAMES = 60        # make_cluster_scene's frames (bench.py's 60)
CLUSTER_CLI_FRAMES = 8     # the PNG frames run_cluster reads
CLUSTER_WARMUP_SW = 5      # phase 12 (c): frames before the timed ones
SW_SYNCS = 40              # phase 12 (c): syncs counted from this frame


def phase12(kernels: dict, label: str):
    """The dense motion-clustering workload at 1241x376 (see the module
    docstring); returns each kernel's launches over (a), all 0, and (a)'s
    record."""
    from slam_toolkit_tpu_torch import run_cluster
    from slam_toolkit_tpu_torch.cluster import tracker as trk
    from slam_toolkit_tpu_torch.data.synthetic import make_cluster_scene
    from slam_toolkit_tpu_torch.pipeline.engine import full_float32
    from slam_toolkit_tpu_torch.tools import bench
    dev = torch.device("cuda")
    t_phase = time.perf_counter()

    # (a) the bench's run (FusedDenseTracker over the scene) and its gates
    for k in kernels.values():
        k.launches = 0
    rec = bench.cluster_record(CLUSTER_FRAMES, "cuda")
    launches = {n: k.launches for n, k in kernels.items()}
    print(f"[phase12] {label} (a) BENCH_CLUSTER record {json.dumps(rec)}; "
          f"kernel launches {launches}; "
          f"{time.perf_counter() - t_phase:.1f} s")
    failed = [g for g, ok in rec["gates"].items() if not ok]
    if failed:
        raise AssertionError(f"cluster: gates {failed} failed")

    scene = make_cluster_scene(n_frames=CLUSTER_FRAMES)
    cfg = trk.DenseConfig(max_points=bench.CLUSTER_MAX_POINTS)

    # (b) dense_frame on the card against the plain run on the CPU
    t0 = time.perf_counter()
    (l0, _), (l1, r1) = scene.frames[9], scene.frames[10]
    fr = []
    for d in (dev, torch.device("cpu")):
        with torch.no_grad(), full_float32():
            fr.append(trk.dense_frame(*(torch.from_numpy(a).to(d) for a in
                                        (l1, r1, l0)), scene.cam, cfg))
    par = trk.frame_parity(*fr)
    print(f"[phase12] {label} (b) dense_frame card against CPU: {par}; "
          f"{time.perf_counter() - t0:.1f} s")

    # (c) the stepwise tracker graphed and eager, and the fused one
    stepwise_phase(scene, cfg, label)

    # (d) run_cluster over the scene written as KITTI PNGs
    with tempfile.TemporaryDirectory() as root:
        n = CLUSTER_CLI_FRAMES
        frames = np.stack([np.stack(fr) for fr in scene.frames[:n]])
        stage_kitti(root, np.clip(np.rint(frames), 0, 255).astype(np.uint8),
                    [np.eye(4)] * n, n)
        out = os.path.join(root, "out")
        made, tracker_cls = [], trk.DenseTracker

        class Kept(tracker_cls):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                made.append(self)
        trk.DenseTracker = Kept
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                stats = run_cluster.main(["--root", root, "--seq", "00",
                                          "--out", out, "--device", "cuda"])
        finally:
            trk.DenseTracker = tracker_cls
        with open(os.path.join(out, "stats.json")) as f:
            written = json.load(f)
        masks = sorted(f for f in os.listdir(out) if f.startswith("mask_"))
    done = [d for d in written["frames_detail"] if not d["skipped"]]
    st = made[0].graph_stats()
    print(f"[phase12] {label} (d) run_cluster over {n} PNG frames: "
          f"{ {k: v for k, v in stats.items() if k != 'frames_detail'} }, "
          f"{len(masks)} masks, clusters a frame "
          f"{[len(d['clusters']) for d in done]}; its DenseTracker graphed "
          f"{made[0].graphed}, runs {made[0].runs}, "
          f"{None if st is None else graph_line(st)}")
    if st is None or st["replays"] != made[0].runs or \
            st["captures"] != sum(v > 0 for v in made[0].runs.values()):
        raise AssertionError(f"run_cluster's tracker did not replay its "
                             f"graphs: {st}, runs {made[0].runs}")
    if written["frames"] != n or len(done) < n - 2 or \
            len(masks) != len(done) or not any(d["clusters"] for d in done):
        raise AssertionError(f"run_cluster: {written['processed']} of "
                             f"{n} frames processed, {len(masks)} masks")
    print(f"[phase12] {label} phase seconds "
          f"{time.perf_counter() - t_phase:.1f}")
    return launches, rec


def stepwise_phase(scene, cfg, label: str) -> None:
    """Phase 12 (c): the stepwise DenseTracker over the scene's frames
    graphed (its frame, track and round programs CUDA graphs, the
    default) and eager (graphs=False): frames/s over frames
    CLUSTER_WARMUP_SW to SW_SYNCS - 1, host syncs over the rest against the
    programs' readbacks there, captures and pool bytes; the two runs'
    results (labels, skip flags, new-cluster counts, every cluster's T)
    equal, and their labels equal the fused tracker's."""
    from slam_toolkit_tpu_torch.cluster import tracker as trk
    from slam_toolkit_tpu_torch.utils.timing import count_syncs
    t_phase = time.perf_counter()
    staged = [tuple(torch.from_numpy(a).to("cuda") for a in fr)
              for fr in scene.frames]
    n, warm = len(staged), CLUSTER_WARMUP_SW
    runs = {}
    for mode in ("graphed", "eager"):
        t0 = time.perf_counter()
        st = trk.DenseTracker(scene.cam, cfg, device="cuda",
                              graphs=mode == "graphed")
        outs = [st.track(gl, gr) for gl, gr in staged[:warm]]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        outs += [st.track(gl, gr) for gl, gr in staged[warm:SW_SYNCS]]
        torch.cuda.synchronize()
        secs = time.perf_counter() - t1
        before = dict(st.runs)
        rest, syncs = count_syncs(
            lambda: [st.track(gl, gr) for gl, gr in staged[SW_SYNCS:]])
        outs += rest
        ran = {k: v - before[k] for k, v in st.runs.items()}
        live = sum(not o["skipped"] for o in rest)
        stats = st.graph_stats()
        runs[mode] = outs
        print(f"[phase12] {label} (c) stepwise {mode}: frames/s "
              f"{(SW_SYNCS - warm) / secs:.2f} over frames {warm}-"
              f"{SW_SYNCS - 1}; host syncs {syncs} over frames {SW_SYNCS}-"
              f"{n - 1} ({live} live: {syncs / max(live, 1):.2f} a live "
              f"frame), programs run there {ran} (a readback each); runs "
              f"{st.runs}; {time.perf_counter() - t0:.1f} s"
              + ("" if stats is None else f"; {graph_line(stats)}"))
        if mode == "graphed":
            if stats["captures"] != 3 or stats["replays"] != st.runs:
                raise AssertionError(f"stepwise graphed: {stats}, runs "
                                     f"{st.runs}")
            if syncs > sum(ran.values()):
                raise AssertionError(f"stepwise graphed: {syncs} host syncs "
                                     f"for {ran} program runs")
            dev = {p: replay_ms(st.graphs, p) for p in st.PROGRAMS}
            print(f"[phase12] {label} (c) stepwise graphed, a replay alone "
                  f"(device ms, on the last frame's buffers): "
                  f"{ {p: round(v, 3) for p, v in dev.items()} }; a live "
                  f"frame of frames {SW_SYNCS}-{n - 1} at its mean runs: "
                  f"{sum(dev[p] * ran[p] for p in dev) / max(live, 1):.3f} "
                  f"ms")
    # the fused tracker over the same frames
    ft = trk.FusedDenseTracker(scene.cam, cfg, queue_depth=2, device="cuda")
    fused = [None]
    for gl, gr in staged:
        o = ft.process(gl, gr)
        if o is not None:
            fused.append(o)
    fused += ft.flush()
    g, e = runs["graphed"], runs["eager"]
    for t in range(n):
        a, b = g[t], e[t]
        same = a.keys() == b.keys() and all(
            np.array_equal(a[k], b[k]) for k in a if k != "clusters") and \
            [(c["id"], c["size"], c["tracked"], c["is_ground"])
             for c in a.get("clusters", ())] == \
            [(c["id"], c["size"], c["tracked"], c["is_ground"])
             for c in b.get("clusters", ())] and \
            all(np.array_equal(c["T"], d["T"]) for c, d in
                zip(a.get("clusters", ()), b.get("clusters", ())))
        if not same:
            raise AssertionError(f"stepwise: graphed and eager part at "
                                 f"frame {t}")
        if t and (a["skipped"] != fused[t]["skipped"] or (
                not a["skipped"] and
                not np.array_equal(a["labels"], fused[t]["labels"]))):
            raise AssertionError(f"stepwise and fused part at frame {t}")
    live = sum(not o["skipped"] for o in g[1:])
    print(f"[phase12] {label} (c) stepwise graphed and eager equal over "
          f"{n} frames ({live} live, "
          f"{sum(o.get('n_new_clusters', 0) for o in g)} clusters made): "
          f"labels, skip flags, new-cluster counts, every cluster's slot, "
          f"size and T; labels equal the fused tracker's; phase "
          f"{time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------- phase 13
DP_FRAMES = 33             # frame 0 bootstraps every lane, then 2 chunks
DP_CHUNK = 16
DP_PROFILED = 2            # frames of each layout under torch.profiler
DP_LOOP_STARTS = (0, 48, 96)  # lanes 1-3: phase 10's clothoid from here
BATCHED = (("patch_gather_batched", "patches", "gather_blocks_batched_cuda"),
           ("topk2_match_batched", "match_kernel",
            "topk2_match_batched_cuda"),
           ("pose_lm_batched", "pose_lm_kernel",
            "optimize_pose_batched_cuda"),
           ("sad_curve_batched", "stereo_sad", "sad_curve_batched_cuda"),
           ("local_ba_batched", "ba_kernel", "solve_ba_batched_cuda"))
KEYFRAME_ENTRIES = ("sad_curve_batched", "local_ba_batched")
PHOTOMETRIC = ("hybrid", "direct")


def _clone(a):
    if isinstance(a, torch.Tensor):
        return a.clone()
    if hasattr(a, "_fields"):
        return type(a)(*(_clone(x) for x in a))
    if isinstance(a, (list, tuple)):
        return [_clone(x) for x in a]
    if isinstance(a, dict):
        return {k: _clone(v) for k, v in a.items()}
    return a


def _copy_into(dst, src) -> None:
    """Copy the tensors of `src` into those of `dst`, a _clone of an
    earlier call with the same shapes."""
    if isinstance(src, torch.Tensor):
        if dst.shape != src.shape:
            raise AssertionError(f"captured shape {tuple(src.shape)}, kept "
                                 f"{tuple(dst.shape)}")
        dst.copy_(src)
    elif isinstance(src, dict):
        for k, v in src.items():
            _copy_into(dst[k], v)
    elif isinstance(src, (list, tuple)):
        for d, v in zip(dst, src):
            _copy_into(d, v)


class BatchedCapture:
    """While installed, keeps on the card the inputs of the `call`-th
    call of each batched kernel entry (a mid-run frame of the batched
    layout; the keyframe event's entries, which run only on frames with
    a flagged lane, at their last call); the entries run as before.
    Under the CUDA graph the copy made at the capture holds the inputs of
    the last frame replayed: tracking's first call of an entry (captured
    first; the hybrid tracker's 8x8 gather also runs in the keyframe
    event), and the keyframe event's calls, in the IF node's body,
    copied into the buffers of an earlier eager call (the bootstrap's,
    the warm-up's), outside the graph's pools: the body runs only on a
    frame with a flagged lane, and a copy it allocated would hold stale
    memory after the frames that skip it. The batched gather's calls are
    kept apart by window shape ("patch_gather_batched" for 31x31, else
    "patch_gather_batched_<bh>x<bw>"), and its launches counted by shape
    (`shape_counts`, LaunchCounts that a CUDA graph adds on replay)."""

    def __init__(self, call: int):
        import importlib
        from slam_toolkit_tpu_torch.ops import patches
        self.call, self.calls, self.args, self.orig = call, {}, {}, {}
        self.kwargs, self.by_shape, self.patches = {}, {}, patches
        self.captured = set()
        for name, mod, fn in BATCHED:
            m = importlib.import_module(f"slam_toolkit_tpu_torch.ops.{mod}")
            self.orig[name] = (m, fn, getattr(m, fn))
            setattr(m, fn, self._wrap(name))

    @property
    def shape_counts(self) -> dict:
        return {k: c.launches for k, c in self.by_shape.items()}

    def _wrap(self, name):
        from slam_toolkit_tpu_torch.utils.cuda_lib import LaunchCount
        orig = self.orig[name][2]
        kernel = self.patches.BATCHED_KERNEL

        def call(*args, **kw):
            key = name
            if name == "patch_gather_batched" and tuple(args[4:6]) != (31, 31):
                key = f"{name}_{args[4]}x{args[5]}"
            self.calls[key] = self.calls.get(key, 0) + 1
            capturing = torch.cuda.is_current_stream_capturing()
            if capturing and key in KEYFRAME_ENTRIES:
                # the keyframe event's IF body: into an eager call's buffers
                _copy_into(self.args[key], list(args))
                _copy_into(self.kwargs[key], kw)
            elif capturing and key not in self.captured:
                # tracking (captured first): its call of the entry
                self.captured.add(key)
                self.args[key] = _clone(list(args))
                self.kwargs[key] = _clone(kw)
            elif not capturing and (self.calls[key] == self.call or
                                    key in KEYFRAME_ENTRIES):
                self.args[key] = _clone(list(args))
                self.kwargs[key] = _clone(kw)
            if name != "patch_gather_batched":
                return orig(*args, **kw)
            n0 = kernel.launches
            out = orig(*args, **kw)
            if key not in self.by_shape:
                self.by_shape[key] = LaunchCount()
            self.by_shape[key].add(kernel.launches - n0)
            return out
        return call

    def close(self):
        for m, fn, orig in self.orig.values():
            setattr(m, fn, orig)


def batched_kernels() -> dict:
    import importlib
    return {name: importlib.import_module(
        f"slam_toolkit_tpu_torch.ops.{mod}").BATCHED_KERNEL
        for name, mod, _ in BATCHED}


def check_gather_batched(args) -> dict:
    """The batched gather on the captured frame: each lane exactly the
    multi-image launch on that lane's levels, and the batched plain
    version; its times, its bound (the sectors every lane's windows cover
    on its levels, the corners, the output) and its library time (one
    unfold index a level over the lanes)."""
    from slam_toolkit_tpu_torch.ops import patches
    images, ys, xs, counts, bh, bw = args
    lanes = ys.shape[0]
    out = patches.gather_blocks_batched_cuda(images, ys, xs, counts, bh, bw)
    for b in range(lanes):
        one = patches.gather_blocks_multi_cuda([im[b] for im in images],
                                               ys[b], xs[b], counts, bh, bw)
        if not torch.equal(out[b], one):
            raise AssertionError(f"batched gather: lane {b} differs from "
                                 "its single launch")
    ref = patches.gather_blocks_batched_plain(images, ys, xs, counts, bh, bw)
    if not torch.equal(out, ref):
        raise AssertionError("batched gather differs from its plain version")
    offs = np.cumsum([0] + list(counts))
    read, libs = 0, []
    bidx = torch.arange(lanes, device=ys.device)[:, None]
    for im, a, z in zip(images, offs[:-1], offs[1:]):
        if z == a:
            continue
        h, w = im.shape[-2:]
        yl = ys[:, a:z].long().clamp(0, h - bh)
        xl = xs[:, a:z].long().clamp(0, w - bw)
        for b in range(lanes):
            read += window_bytes(im[b], yl[b], xl[b], bh, bw)
        win = im.unfold(1, bh, 1).unfold(2, bw, 1)
        libs.append(lambda win=win, yl=yl, xl=xl: win[bidx, yl, xl])
    lib_out = torch.cat([f() for f in libs], dim=1)
    if not torch.equal(lib_out, out):
        raise AssertionError("batched gather differs from unfold")

    def kern():
        return patches.gather_blocks_batched_cuda(images, ys, xs, counts, bh,
                                                  bw)
    row = {"ms": device_ms(kern), "host_ms": host_ms(kern),
           "plain_ms": call_ms(lambda: patches.gather_blocks_batched_plain(
               images, ys, xs, counts, bh, bw)),
           "library_ms": sum(device_ms(f) for f in libs),
           **bound(read + nbytes(ys, xs, out), 0)}
    return {"name": "patch_gather_batched",
            "source": "slam_toolkit_tpu_torch/csrc/patch_gather.cu",
            "replaces": "slam_toolkit_tpu/ops/patches.py:113",
            "kernel": patches.BATCHED_KERNEL, "max_abs_err": 0.0,
            "what": f"{lanes} lanes x {len(counts)} levels, "
                    f"{sum(counts)} windows {bh}x{bw} a lane", **row}


def check_topk2_batched(args) -> dict:
    """The batched top-2 on the captured frame: each lane, every column,
    exactly the single launch on that lane's inputs and the plain
    version; its bound sums the lanes' work (phase 2's count a lane)."""
    from slam_toolkit_tpu_torch.ops import match_kernel as mk
    a_desc, b_desc, a_uv, b_xy, r = args
    lanes, m, n = a_desc.shape[0], a_desc.shape[1], b_desc.shape[1]
    out = mk.topk2_match_batched_cuda(a_desc, b_desc, a_uv, b_xy, r)
    in_2r = 0
    for b in range(lanes):
        t = [a_desc[b], b_desc[b], a_uv[b], b_xy[b]]
        if not torch.equal(out[b], mk.topk2_match_cuda(*t, r)):
            raise AssertionError(f"batched top-2: lane {b} differs from "
                                 "its single launch")
        topk2_exact(t, r, f"batched frame, lane {b}")
        in_2r += gate_counts(t, r)[1]
    t = (a_desc, b_desc, a_uv, b_xy)
    row = row_times(lambda: mk.topk2_match_batched_cuda(*t, r),
                    lambda: mk.topk2_match_batched_plain(*t, r))
    b = bound(nbytes(*t, out), lanes * m * n * 7, int_ops=in_2r * 21,
              popc_ops=in_2r * 8)
    return {"name": "topk2_match_batched",
            "source": "slam_toolkit_tpu_torch/csrc/match_topk2.cu",
            "replaces": "slam_toolkit_tpu/ops/match_kernel.py:139",
            "kernel": mk.BATCHED_KERNEL, "max_abs_err": 0.0,
            "what": f"{lanes} problems M={m} N={n} r={r}, "
                    f"{in_2r} pairs inside 2r", **row, **b}


def check_pose_lm_batched(args) -> dict:
    """The batched pose LM on the captured frame: each lane's pose, cost
    and residuals bit for bit the single launch's; the pose within 2e-3
    of the batched plain version; its bound B times a problem's."""
    from slam_toolkit_tpu_torch.ops import pose_lm_kernel as plk
    *t, cfg = args
    lanes, n = t[1].shape[0], t[1].shape[1]
    out = plk.optimize_pose_batched_cuda(*t, cfg)
    for b in range(lanes):
        one = plk.optimize_pose_cuda(*(x[b] for x in t), cfg)
        if not (torch.equal(out.T_cw[b], one.T_cw) and
                torch.equal(out.cost[b], one.cost) and
                torch.equal(out.inlier_r2[b], one.inlier_r2)):
            raise AssertionError(f"batched pose LM: lane {b} differs from "
                                 "its single launch")
    ref = plk.optimize_pose_batched_plain(*t, cfg)
    err = float((out.T_cw - ref.T_cw).abs().max())
    if not err <= 2e-3:
        raise AssertionError(f"batched pose LM: {err} from the plain solver")
    row = row_times(lambda: plk.optimize_pose_batched_cuda(*t, cfg),
                    lambda: plk.optimize_pose_batched_plain(*t, cfg),
                    plain_reps=5)
    b = bound(nbytes(*t, out.T_cw, out.cost, out.inlier_r2),
              lanes * n * (cfg.num_iterations * 226 + 80))
    return {"name": "pose_lm_batched",
            "source": "slam_toolkit_tpu_torch/csrc/pose_lm.cu",
            "replaces": "slam_toolkit_tpu/ops/pose_lm_kernel.py:224",
            "kernel": plk.BATCHED_KERNEL, "max_abs_err": err,
            "what": f"{lanes} problems N={n}", **row, **b}


def check_sad_batched(args) -> dict:
    """The batched SAD curves on the captured keyframe frame: each flagged
    lane exactly its single launch and within the SAD bar of the batched
    plain version (an unflagged lane's rows are left unwritten); its
    bound counts the flagged lanes' work (phase 2's count a lane) and
    their rows of the output."""
    from slam_toolkit_tpu_torch.ops import stereo_sad as sad
    img_l, img_r, ys0, xl0, xs0, max_disp, lanes = args
    n_lanes, k = ys0.shape
    keep = lanes.bool().tolist()
    out = sad.sad_curve_batched_cuda(*args)
    for b in range(n_lanes):
        if keep[b]:
            one = sad.sad_curve_cuda(img_l[b], img_r[b], ys0[b], xl0[b],
                                     xs0[b], max_disp)
            if not torch.equal(out[b], one):
                raise AssertionError(f"batched SAD: lane {b} differs from "
                                     "its single launch")
    kept = [b for b in range(n_lanes) if keep[b]]
    ref = sad.sad_curve_batched_plain(*args)
    err = float((out[kept] - ref[kept]).abs().max()) if kept else 0.0
    torch.testing.assert_close(out[kept], ref[kept], rtol=1e-5, atol=1e-3)
    side, sw = 2 * sad.WIN + 1, sad._strip_w(max_disp)
    read = sum(window_bytes(img_l[b], ys0[b], xl0[b], side, side) +
               window_bytes(img_r[b], ys0[b], xs0[b], side, sw) +
               nbytes(ys0[b], xl0[b], xs0[b], out[b]) for b in kept)
    b_ = bound(read + nbytes(lanes),
               len(kept) * k * out.shape[-1] * side * side * 2)
    return {"name": "sad_curve_batched",
            "source": "slam_toolkit_tpu_torch/csrc/stereo_sad.cu",
            "replaces": "slam_toolkit_tpu/ops/stereo_sad.py:128",
            "kernel": sad.BATCHED_KERNEL, "max_abs_err": err,
            "what": f"{n_lanes} lanes ({len(kept)} flagged) K={k}, "
                    f"{out.shape[-1]} shifts",
            **row_times(lambda: sad.sad_curve_batched_cuda(*args),
                        lambda: sad.sad_curve_batched_plain(*args)), **b_}


def check_ba_batched(args, kw) -> dict:
    """The batched local BA on the captured keyframe frame: each flagged
    lane's poses, points, cost and residuals bit for bit its single
    launch's (an unflagged lane's outputs are left unwritten); T within
    3e-3 of the batched plain version, X (valid points of the flagged lanes) within 2e-2 of
    the plain float64 run plus the plain float32 run's own distance from
    it (float32 rounding alone moves a badly observed point's optimum;
    phase 10 and tests/test_torch_cuda.py read X so), |X - X_plain|
    printed beside; its bound the flagged lanes' work."""
    from slam_toolkit_tpu_torch.ops import ba_kernel
    p, lanes = args
    n_lanes, W, P = p.z.shape[:3]
    keep = lanes.bool().tolist()
    out = ba_kernel.solve_ba_batched_cuda(p, lanes, **kw)
    ref = ba_kernel.solve_ba_batched_plain(p, lanes, **kw)
    err_T = err_X = err_X32 = 0.0
    kept = [b for b in range(n_lanes) if keep[b]]
    for b in kept:
        one = ba_kernel._problem_lane(p, b)
        single = ba_kernel.solve_ba_cuda(one, **kw)
        if not all(torch.equal(o[b], s_) for o, s_ in zip(out, single)):
            raise AssertionError(f"batched local BA: lane {b} differs from "
                                 "its single launch")
        err_T = max(err_T, float((out.T_cw[b] - ref.T_cw[b]).abs().max()))
        pv = one.point_valid
        if bool(pv.any()):
            ref64 = ba_kernel.solve_ba_plain(_ba_float64(one), **kw)
            spread = float((ref.Xw[b][pv].double() - ref64.Xw[pv]).abs()
                           .max())
            d = float((out.Xw[b][pv].double() - ref64.Xw[pv]).abs().max())
            err_X32 = max(err_X32, float((out.Xw[b][pv] - ref.Xw[b][pv])
                                         .abs().max()))
            if not d <= 2e-2 + spread:
                raise AssertionError(f"batched local BA lane {b}: X {d} m "
                                     f"from the float64 run (plain float32 "
                                     f"{spread})")
            err_X = max(err_X, d - spread)
    if not err_T <= 3e-3:
        raise AssertionError(f"batched local BA: T {err_T} from the plain "
                             "solver")
    ins = [p.T_cw, p.pose_fixed, p.Xw, p.z, p.inv_sigma, p.obs_mask,
           p.stereo_mask, p.point_valid, p.point_free]
    b_ = bound(sum(nbytes(*(t[b] for t in ins), *(o[b] for o in out))
                   for b in kept) + nbytes(lanes) + 4,
               len(kept) * ba_ops(W, P, kw["iters"]))
    return {"name": "local_ba_batched",
            "source": "slam_toolkit_tpu_torch/csrc/local_ba.cu",
            "replaces": "slam_toolkit_tpu/ops/ba_kernel.py:408",
            "kernel": ba_kernel.BATCHED_KERNEL,
            "max_abs_err": max(err_T, err_X32),
            "what": f"{n_lanes} problems ({len(kept)} flagged) W={W} P={P}, "
                    f"max |X - X_plain| {err_X32:.2e}",
            **row_times(lambda: ba_kernel.solve_ba_batched_cuda(p, lanes,
                                                                **kw),
                        lambda: ba_kernel.solve_ba_batched_plain(p, lanes,
                                                                 **kw),
                        plain_reps=5), **b_}


def anchored(carry, lefts, cam, cfg):
    """batched_bootstrap's carry (the JAX package's: no photometric
    anchor) with the anchor a photometric tracker needs, built as
    ChunkedSlamEngine builds its own: frame 0's left image, (a, b) = (0,
    0), and for "hybrid" the pattern intensities at latest_T
    (direct_lm.reference_values over the lanes: one batched gather)."""
    from slam_toolkit_tpu_torch.optim import direct_lm
    if cfg.tracker.method == "indirect":
        return carry
    kf_ab = torch.zeros((lefts.shape[0], 2), dtype=torch.float32,
                        device=lefts.device)
    refvals = None
    if cfg.tracker.method == "hybrid":
        refvals = direct_lm.reference_values(
            direct_lm.DirectState(T_cw=carry.latest_T, a=kf_ab[:, 0],
                                  b=kf_ab[:, 1]),
            lefts, cam.left, carry.lm_Xw, carry.lm_valid, 1.0)
    return carry._replace(kf_img=lefts.clone(), kf_ab=kf_ab,
                          kf_refvals=refvals)


def dp_run(make_step, cfg, cam, first, chunks, kernels: dict, cap=None):
    """One layout over the lanes: every count set to 0 just before the
    bootstrap, read just after the last chunk (a photometric tracker's
    anchor added after the bootstrap, anchored()); frame 1 alone (where
    the graphs are captured, outside the profiler), frames 2 to
    DP_PROFILED + 1 under torch.profiler (operations a frame; a call a
    frame), the rest of the first chunk with its host syncs counted
    (act["syncs"]: syncs, frames), the second chunk timed alone:
    3 + DP_PROFILED calls (act["calls"]) of a chunk function of capacity
    DP_CHUNK. Returns the chunk function too."""
    from slam_toolkit_tpu_torch.parallel import mesh
    from slam_toolkit_tpu_torch.utils.timing import (count_syncs,
                                                     device_activity)
    step = make_step(cfg, cam, capacity=DP_CHUNK)
    for k in kernels.values():
        k.launches = 0
    try:
        carry = anchored(mesh.batched_bootstrap(cfg, cam)(
            mesh.batched_empty_map(cfg, first.shape[0], first.device),
            first[:, 0], first[:, 1]), first[:, 0], cam, cfg)
        carry, p0 = step(carry, chunks[0][:1])

        def frame_by_frame(carry):
            # a call a frame: the profiler records one iteration of a
            # WHILE body a graph launch
            out = []
            for k in range(1, 1 + DP_PROFILED):
                carry, p = step(carry, chunks[0][k:k + 1])
                out.append(p)
            return carry, torch.cat(out)
        (carry, p1), act = device_activity(frame_by_frame, carry)
        (carry, p2), syncs = count_syncs(step, carry,
                                         chunks[0][1 + DP_PROFILED:])
        act["syncs"] = (syncs, chunks[0].shape[0] - 1 - DP_PROFILED)
        act["calls"] = 3 + DP_PROFILED
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        carry, p3 = step(carry, chunks[1])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        if cap is not None:
            cap.close()
    launches = {n: k.launches for n, k in kernels.items()}
    rows = torch.cat([p0, p1, p2, p3]).cpu().numpy()      # (32, B, 36)
    return carry, rows, secs, launches, act, step


def lanes_apart(a: np.ndarray, b: np.ndarray, tol: float = 1e-3):
    """(first frame where flags, slot or translation part, largest
    translation difference) of two (N, 36) row sets."""
    dt = np.linalg.norm(a[:, 3:16:4][:, :3] - b[:, 3:16:4][:, :3], axis=1)
    bad = np.flatnonzero((a[:, 32:35] != b[:, 32:35]).any(1) | (dt > tol))
    return (int(bad[0]) + 1 if len(bad) else None), float(dt.max())


def alone_rows(cfg, seqs):
    """Each sequence alone through ChunkedSlamEngine (graphed, chunks of
    DP_CHUNK): its rows without T_rel, and its frames/s over frames
    16-31."""
    alone, fps = [], []
    for seq in seqs:
        eng, chunk_s = run_engine(cfg, seq, DP_CHUNK, "cuda")
        alone.append(np.stack([np.concatenate([
            T.reshape(-1), np.zeros(16, np.float32),
            [sl, st["ok"], st["kf"], st["inliers"]]]) for T, (sl, _), st in
            zip(eng.trajectory[1:], eng._traj_anchor[1:],
                eng.frame_stats[1:])]).astype(np.float32))
        fps.append(DP_CHUNK / chunk_s[1])             # frames 16-31
    return alone, float(np.mean(fps))


def compare_lanes(rows_v, others: dict, what: str) -> None:
    """Each lane of the batched rows against each other layout's: flags,
    ok and slots equal, translations within 1e-3 m (a lane that parts
    names the frame)."""
    for b in range(rows_v.shape[1]):
        kf = [int(v) for v in rows_v[:, b, 34]]
        for name, other in others.items():
            part, dt = lanes_apart(rows_v[:, b], other[b])
            same = np.array_equal(rows_v[:, b, :16], other[b][:, :16])
            print(f"[phase13] {what} lane {b} batched vs {name}: max |dt| "
                  f"{dt:.2e} m, poses {'bit-equal' if same else 'differ'}, "
                  + ("flags and slots equal" if part is None
                     else f"parts at frame {part}"))
            if part is not None:
                raise AssertionError(f"{what} lane {b}: the batched layout "
                                     f"and the {name} part at frame {part}")
        print(f"[phase13] {what} lane {b}: keyframes at frames "
              f"{[i + 1 for i, v in enumerate(kf) if v]}, inliers "
              f"{[int(v) for v in rows_v[:, b, 35]]}")


def lanes_if_line(step, rows_v, act, what: str) -> str:
    """The batched chunk's keyframe IF body runs against its frames with a
    flagged lane, and its host syncs in the counted frames: both must hold
    (a run a flagged frame, 0 syncs)."""
    st = step.graph_stats()
    runs = st["if_runs"].get("keyframe", 0)
    n_any = int((rows_v[..., 34] > 0.5).any(1).sum())
    syncs, frames = act["syncs"]
    if st["captures"] != 1 or runs != n_any or syncs:
        raise AssertionError(f"{what}: {st['captures']} graphs, keyframe IF "
                             f"body runs {runs} for {n_any} frames with a "
                             f"flagged lane, {syncs} host syncs")
    scan = scan_line(st, act["calls"], rows_v.shape[0], what)
    return (f"1 graph for {rows_v.shape[1]} lanes, the keyframe event an IF "
            f"node on any lane's flag: IF body runs {runs} = frames with a "
            f"flagged lane {n_any} of {rows_v.shape[0]}; host syncs inside "
            f"a chunk {syncs} over {frames} frames; {scan}")


def keyframe_launches(rows_v, launch_v, launch_l, what: str) -> int:
    """The batched layout must launch the batched SAD once for the
    bootstrap and once a frame where any lane is flagged, the batched
    local BA once a frame where any lane is flagged, and their single
    entries never; the lane layout launches the single ones. Returns the
    frames with a flagged lane."""
    n_any = int((rows_v[..., 34] > 0.5).any(1).sum())
    want = {"sad_curve_batched": 1 + n_any, "local_ba_batched": n_any,
            "stereo_sad": 0, "local_ba": 0}
    got = {k: launch_v[k] for k in want}
    if got != want:
        raise AssertionError(f"{what} batched layout: keyframe-event "
                             f"launches {got}, expected {want}")
    if launch_l["stereo_sad"] == 0 or launch_l["local_ba"] == 0:
        raise AssertionError(f"{what} lane layout launches {launch_l}")
    return n_any


def print_batched_row(label: str, r: dict, call: str) -> None:
    lib_ms = "none" if r["library_ms"] is None else \
        f"{r['library_ms']:.4f} ms"
    print(f"[phase13] {label} {r['name']} ({r['what']}; {call}): exact per "
          f"lane against the single launch, max_abs_err {r['max_abs_err']}; "
          f"kernel {r['ms']:.4f} ms (device), wrapper {r['host_ms']:.4f} ms "
          f"(host), plain {r['plain_ms']:.4f} ms, library {lib_ms}, bound "
          f"{r['bound_ms']:.6f} ms ({r['bound_by']}), loss "
          f"{r['launches'] * (r['ms'] - r['bound_ms']):.4f} ms over its "
          f"{r['launches']} launches")


def phase13_photometric(cfg, method: str, seqs, first, chunks, cam,
                        every: dict, label: str) -> dict:
    """The four sequences under tracker.method `method` through both
    layouts from the same hand-built anchor (anchored()), and each alone
    through ChunkedSlamEngine: flags, ok and slots equal, translations
    within 1e-3 m; the batched keyframe-event launches as for "indirect".
    The hybrid batched run keeps the batched gather's 8x8 inputs."""
    from slam_toolkit_tpu_torch.parallel import mesh
    cfg_m = dataclasses.replace(cfg, tracker=dataclasses.replace(
        cfg.tracker, method=method))
    t0 = time.perf_counter()
    _, rows_l, secs_l, launch_l, _, _ = dp_run(
        mesh.multi_sequence_lane_chunk, cfg_m, cam, first, chunks, every)
    cap = BatchedCapture(call=DP_CHUNK)
    _, rows_v, secs_v, launch_v, act_v, step_v = dp_run(
        mesh.multi_sequence_chunk, cfg_m, cam, first, chunks, every, cap)
    t1 = time.perf_counter()
    alone, alone_fps = alone_rows(cfg_m, seqs)
    lanes = first.shape[0]
    fps = {"lane": lanes * DP_CHUNK / secs_l, "vmap": lanes * DP_CHUNK /
           secs_v, "alone": alone_fps}
    print(f"[phase13] {label} {method}: aggregate frames/s lane "
          f"{fps['lane']:.2f}, vmap {fps['vmap']:.2f} ({lanes} lanes, chunk "
          f"2); one lane alone {fps['alone']:.2f}; busy share vmap "
          f"{act_v['busy']}; seconds: layouts {t1 - t0:.1f}, alone "
          f"{time.perf_counter() - t1:.1f}")
    print(f"[phase13] {label} {method} launches, lane layout: {launch_l}")
    print(f"[phase13] {label} {method} launches, batched layout: "
          f"{launch_v}; batched gather by window {cap.shape_counts}")
    compare_lanes(rows_v, {"lane layout": rows_l.transpose(1, 0, 2),
                           "alone": alone}, method)
    n_any = keyframe_launches(rows_v, launch_v, launch_l, method)
    print(f"[phase13] {label} {method} batched layout: "
          f"{lanes_if_line(step_v, rows_v, act_v, method)}")
    n8 = cap.shape_counts.get("patch_gather_batched_8x8", 0)
    if n8 == 0 or launch_v["patch_gather"] != 0:
        raise AssertionError(f"{method}: the batched gather at 8x8 launched "
                             f"{n8} times, the single one "
                             f"{launch_v['patch_gather']}")
    return {"launches": launch_v, "rows_v": rows_v, "fps": fps,
            "n_any": n_any, "n8": n8, "cap": cap, "cfg": cfg_m,
            "graphs_v": step_v.graph_stats()}


def phase13(cfg, frames7, loop_frames, kernels: dict, label: str) -> dict:
    """Multi-sequence lanes (parallel/mesh) at full width; returns the
    batched runs' launch counts and the batched entries' rows."""
    from slam_toolkit_tpu_torch.geometry.camera import StereoCamera
    from slam_toolkit_tpu_torch.parallel import mesh
    t_phase = time.perf_counter()
    seqs = [np.asarray(frames7[:DP_FRAMES])] + [
        np.asarray(loop_frames[i:i + DP_FRAMES]) for i in DP_LOOP_STARTS]
    lanes = len(seqs)
    stack = torch.from_numpy(np.stack(seqs, axis=1)).to(
        "cuda", torch.float32)                       # (N, B, 2, H, W)
    first = stack[0]
    chunks = [stack[1 + i * DP_CHUNK:1 + (i + 1) * DP_CHUNK]
              for i in range(2)]
    cam = StereoCamera.from_config(cfg.camera, "cuda")
    every = {**kernels, **batched_kernels()}
    print(f"[phase13] {lanes} sequences of {DP_FRAMES} frames: phase 3's "
          f"straight track, phase 10's clothoid from frames "
          f"{DP_LOOP_STARTS}")
    t0 = time.perf_counter()
    _, rows_l, secs_l, launch_l, act_l, _ = dp_run(
        mesh.multi_sequence_lane_chunk, cfg, cam, first, chunks, every)
    t1 = time.perf_counter()
    cap = BatchedCapture(call=DP_CHUNK)
    _, rows_v, secs_v, launch_v, act_v, step_v = dp_run(
        mesh.multi_sequence_chunk, cfg, cam, first, chunks, every, cap)
    t2 = time.perf_counter()
    alone, alone_fps = alone_rows(cfg, seqs)
    print(f"[phase13] seconds: lane layout {t1 - t0:.1f}, batched "
          f"{t2 - t1:.1f}, the lanes alone {time.perf_counter() - t2:.1f} "
          "(profiled frames and first uses included)")
    n = DP_CHUNK
    fps = {"lane": lanes * n / secs_l, "vmap": lanes * n / secs_v,
           "alone": alone_fps}
    per_frame = {k: None if a["kernels"] is None else
                 a["kernels"] / DP_PROFILED
                 for k, a in (("lane", act_l), ("vmap", act_v))}
    print(f"[phase13] {label} aggregate frames/s: lane {fps['lane']:.2f}, "
          f"vmap {fps['vmap']:.2f} ({lanes} lanes, chunk 2); one lane "
          f"alone (ChunkedSlamEngine, chunk 2, mean of {lanes}) "
          f"{fps['alone']:.2f}; device operations a frame of the {lanes} "
          f"lanes (torch.profiler, frames 2-{DP_PROFILED + 1}): lane "
          f"{per_frame['lane']}, "
          f"vmap {per_frame['vmap']}; busy share lane "
          f"{act_l['busy']}, vmap {act_v['busy']}")
    print(f"[phase13] {label} launches, lane layout: {launch_l}")
    print(f"[phase13] {label} launches, batched layout: {launch_v}")
    compare_lanes(rows_v, {"lane layout": rows_l.transpose(1, 0, 2),
                           "alone": alone}, "indirect")
    n_frames = DP_FRAMES - 1
    want_v = {"patch_gather_batched": 1 + n_frames,
              "topk2_match_batched": n_frames, "pose_lm_batched": n_frames,
              "patch_gather": 0, "topk2_match": 0, "pose_lm": 0}
    got_v = {k: launch_v[k] for k in want_v}
    if got_v != want_v:
        raise AssertionError(f"batched layout launches {got_v}, expected "
                             f"{want_v}")
    if launch_l["patch_gather"] != lanes * n_frames or \
            launch_l["pose_lm"] != lanes * n_frames:
        raise AssertionError(f"lane layout launches {launch_l}")
    n_any = keyframe_launches(rows_v, launch_v, launch_l, "indirect")
    print(f"[phase13] {label} batched layout: {n_any} of {n_frames} frames "
          f"with a flagged lane, {int((rows_v[..., 34] > 0.5).sum())} lane "
          f"keyframes; {lanes_if_line(step_v, rows_v, act_v, 'indirect')}")
    print(f"[phase13] {label} lane layout (one chunk graph a lane): host "
          f"syncs {act_l['syncs'][0]} over {act_l['syncs'][1]} frames of "
          f"{lanes} lanes")
    rows = [check_gather_batched(cap.args["patch_gather_batched"]),
            check_topk2_batched(cap.args["topk2_match_batched"]),
            check_pose_lm_batched(cap.args["pose_lm_batched"]),
            check_sad_batched(cap.args["sad_curve_batched"]),
            check_ba_batched(cap.args["local_ba_batched"],
                             cap.kwargs["local_ba_batched"])]
    for r in rows:
        r["launches"] = launch_v[r["name"]]
        print_batched_row(label, r, "the last frame of the batched run "
                          "that ran it" if r["name"] in
                          ("sad_curve_batched", "local_ba_batched")
                          else f"its call {DP_CHUNK} of the batched run")
    photo = {m: phase13_photometric(cfg, m, seqs, first, chunks, cam, every,
                                    label) for m in PHOTOMETRIC}
    r8 = check_gather_batched(
        photo["hybrid"]["cap"].args["patch_gather_batched_8x8"])
    r8.update(name="patch_gather_batched_8x8",
              launches=photo["hybrid"]["n8"])
    print_batched_row(label, r8, "the last 8x8 call of the batched hybrid "
                      "run")
    rows.append(r8)
    print(f"[phase13] {label} phase seconds "
          f"{time.perf_counter() - t_phase:.1f}")
    return {"launches": launch_v, "shapes_v": cap.shape_counts,
            "rows": rows, "rows_v": rows_v,
            "fps_v": fps["vmap"], "fps_l": fps["lane"],
            "graphs_v": step_v.graph_stats(), "inputs": (cam, first, chunks),
            "kernels": every, "photo": photo}


# ---------------------------------------------------------------- phase 14
PAIRED = ("eager", "graphed", "graphed", "eager")


def engine_rows(eng) -> np.ndarray:
    """(N, 36) float32 rows of every frame the engine ran, the
    bootstrap's too (identity, slot, ok, kf, 0 inliers): the pose, the
    anchor's relative pose and slot, and the frame's stats."""
    return np.stack([np.concatenate([
        T.reshape(-1), rel.reshape(-1),
        [sl, st.get("ok", True), st["kf"], st["inliers"]]])
        for T, (sl, rel), st in zip(eng.trajectory, eng._traj_anchor,
                                    eng.frame_stats)]).astype(np.float32)


def graph_line(stats) -> str:
    pool = "not reported" if stats["pool_bytes"] is None else \
        f"{stats['pool_bytes'] / 2 ** 20:.1f} MiB"
    return (f"{stats['captures']} captures in {stats['capture_s']:.3f} s "
            f"(warm-up included), pool {pool}, warm-up launches (not "
            f"counted) {stats['setup_launches']}, graph launches "
            f"{stats['replays']}, WHILE nodes {stats['while_nodes']}, their "
            f"iterations {stats['while_runs']}, IF nodes "
            f"{stats['if_nodes']}, their bodies' runs {stats['if_runs']}")


def phase14(cfg, frames, kernels: dict, label: str, dp: dict) -> None:
    """CUDA graphs against the eager step at full width: phase 3's frames
    in the order eager, graphed, graphed, eager, then phase 13's batched
    layout eagerly against its graphed run."""
    from slam_toolkit_tpu_torch.parallel import mesh
    t_phase = time.perf_counter()
    runs = []
    for i, mode in enumerate(PAIRED):
        # the first eager and the second graphed run's last chunk under
        # torch.profiler, a frame a call (run_engine)
        prof = i in (0, 2)
        eng, chunk_s, launches, shapes = drive(cfg, frames, 16, kernels,
                                               graphs=mode == "graphed",
                                               profile_last=prof)
        stats = eng._chunk.graph_stats() if mode == "graphed" else None
        runs.append({"rows": engine_rows(eng), "launches": launches,
                     "shapes": shapes, "chunk_s": chunk_s,
                     "profile": eng.smoke_profile if prof else None})
        steady = "chunk 2 (chunk 3 profiled)" if prof else "chunks 2-3"
        print(f"[phase14] {label} {mode}: frames/s "
              f"{len(frames) / sum(chunk_s):.2f} over the 3 chunks, "
              f"{16 * (3 - prof - 1) / sum(chunk_s[1:3 - prof]):.2f} over "
              f"{steady} (chunk seconds "
              f"{[round(c, 3) for c in chunk_s]}), launches {launches}"
              + ("" if stats is None else f"; {graph_line(stats)}"))
        print(f"[phase14] {label} {mode}: "
              f"{if_runs_line(eng, eng.smoke_syncs, f'phase 14 {mode}')}")
    # The profiler records one iteration of a WHILE body a graph launch,
    # and in this process it sees none of the graphed chunk's kernels (and
    # fewer than profile_chunk's of the eager step's): the device time and
    # kernels of the last chunk come from the eager run (the same kernels,
    # the WHILE loop's few aside), the host CUDA calls from the graphed
    # run, the wall of that chunk in one launch, no profiler, from the
    # first graphed run.
    (act_e, n), (act_g, _) = runs[0]["profile"], runs[2]["profile"]
    wall_ms = 1000 * runs[1]["chunk_s"][2]
    kern, busy = "not seen", "not seen"
    if act_e["kernels"] is not None:
        kern = f"{act_e['kernels'] / n:.1f}"
        busy = f"{act_e['device_ms'] / wall_ms:.4f}"
    dev_ms = "not seen" if act_e["device_ms"] is None else \
        f"{act_e['device_ms']:.1f}"
    print(f"[phase14] {label} last chunk ({n} frames, "
          f"{int(runs[0]['rows'][-n:, 34].sum())} keyframes): eager under "
          f"torch.profiler, kernels, copies and fills a frame {kern}, "
          f"device ms {dev_ms} (as this process's profiler reads them); "
          f"graphed in one launch, no profiler, {wall_ms:.1f} ms: busy "
          f"share at that eager device time {busy}; "
          f"graphed under torch.profiler as {n} chunk calls of one frame: "
          f"host CUDA calls a chunk call {act_g['host_calls'] / n:.2f} (its "
          f"final synchronise included), graph launches a chunk call "
          f"{act_g['graph_launches'] / n:.2f}")
    ref = runs[0]
    for mode, r in zip(PAIRED[1:], runs[1:]):
        if not np.array_equal(r["rows"], ref["rows"]):
            bad = np.flatnonzero((r["rows"] != ref["rows"]).any(1))
            raise AssertionError(f"a {mode} run parts from the first eager "
                                 f"run at frame {int(bad[0])}")
        if (r["launches"], r["shapes"]) != (ref["launches"], ref["shapes"]):
            raise AssertionError(
                f"{mode} launches {r['launches']} {r['shapes']}, eager "
                f"{ref['launches']} {ref['shapes']}")
    print(f"[phase14] {label} all {PAIRED} runs: "
          f"{ref['rows'].shape[0]} x {ref['rows'].shape[1]} packed values "
          f"bit-equal; launches counted from the graphs' replays equal the "
          f"eager counts {ref['launches']}, gather by window "
          f"{ref['shapes']}")
    cam, first, chunks = dp["inputs"]
    lanes = first.shape[0]
    for method, run in (("indirect", dp), ("hybrid", dp["photo"]["hybrid"])):
        cfg_m = run.get("cfg", cfg)
        _, rows_e, secs_e, launch_e, _, _ = dp_run(
            lambda c, cm, capacity: mesh.multi_sequence_chunk(
                c, cm, graphs=False),
            cfg_m, cam, first, chunks, dp["kernels"])
        fps_g = run["fps_v"] if method == "indirect" else run["fps"]["vmap"]
        stats = run["graphs_v"]
        print(f"[phase14] {label} batched {method}, {lanes} lanes: aggregate "
              f"frames/s eager {lanes * DP_CHUNK / secs_e:.2f}, graphed "
              f"{fps_g:.2f} (phase 13; chunk 2); graphed "
              f"{graph_line(stats)}; {stats['captures']} chunk graph for "
              f"{lanes} lanes, {stats['while_nodes']} WHILE node, "
              f"{stats['if_nodes']} IF node")
        if stats["captures"] != 1 or stats["if_nodes"] != 1 or \
                stats["while_nodes"] != 1:
            raise AssertionError(f"batched {method}: {stats['captures']} "
                                 f"graphs, {stats['while_nodes']} WHILE and "
                                 f"{stats['if_nodes']} IF nodes captured, "
                                 "expected 1, 1 and 1")
        if not np.array_equal(rows_e, run["rows_v"]):
            bad = np.flatnonzero((rows_e != run["rows_v"]).any((1, 2)))
            raise AssertionError(f"batched {method}: the graphed rows part "
                                 f"from the eager ones at frame "
                                 f"{int(bad[0]) + 1}")
        if launch_e != run["launches"]:
            raise AssertionError(f"batched {method} launches: eager "
                                 f"{launch_e}, graphed {run['launches']}")
        print(f"[phase14] {label} batched {method}: {rows_e.shape[0]} x "
              f"{lanes} x {rows_e.shape[2]} packed values bit-equal to "
              f"phase 13's graphed run, launches equal {launch_e}")
    print(f"[phase14] {label} phase seconds "
          f"{time.perf_counter() - t_phase:.1f}")


# ---------------------------------------------------------------- phase 15
OPTION_FRAMES = 48
# The JAX package's float32 CPU reading of the same 48 frames under each
# option set (port_reference/jax_f32_headline.py --option NAME --frames
# 48): ATE and RPE (m), keyframes, mappoints.
JAX_F32_48 = {
    "O1": {"ate_m": 0.04632778157505477, "rpe_t_m": 0.019942253828048706,
           "n_keyframes": 10, "mappoints": 1521},
    "O2": {"ate_m": 0.048018887994099195, "rpe_t_m": 0.020802950486540794,
           "n_keyframes": 10, "mappoints": 2975},
    "O3": {"ate_m": 0.048860370907824635, "rpe_t_m": 0.022601904347538948,
           "n_keyframes": 10, "mappoints": 1838},
}
OPTION_NAMES = ("O1", "O2", "O3")
# the kernels each option set's path must launch, and those it must not:
# descriptor stereo runs no SAD, and steered descriptors sample by element
# (no bfloat16 patch gather)
OPTION_KERNELS = {
    "O1": ("patch_gather", "topk2_match", "pose_lm", "local_ba",
           "fast_nms"),
    "O2": ("patch_gather", "topk2_match", "pose_lm", "stereo_sad",
           "local_ba"),
    "O3": ("patch_gather", "patch_gather_bf16", "topk2_match", "pose_lm",
           "local_ba", "fast_nms"),
}
OPTION_NEVER = {"O1": ("stereo_sad", "patch_gather_bf16"), "O2": (),
                "O3": ("stereo_sad",)}
BATCHED_FRAMES = 17        # frame 0 bootstraps both lanes, then one chunk


def _windows(levels, counts, side: int, rng):
    """counts[i] random side x side window corners inside levels[i] (a
    lane axis first where the levels have one), flat over the levels."""
    lead = levels[0].shape[:-2]
    ys, xs = [], []
    for lv, k in zip(levels, counts):
        h, w = lv.shape[-2:]
        ys.append(rng.integers(0, h - side + 1, lead + (k,)))
        xs.append(rng.integers(0, w - side + 1, lead + (k,)))
    dev = levels[0].device
    return (to_dev(np.concatenate(ys, -1).astype(np.int32), dev),
            to_dev(np.concatenate(xs, -1).astype(np.int32), dev))


def gather_row(images, ys, xs, counts, bh: int, bw: int, kernel,
               what: str) -> dict:
    """The multi-image gather (one launch, any dtype) on one frame's
    images, exact against the per-image plain version and the unfold
    indexings; its times, bound (the sectors its windows cover, the
    corners, the output) and library time (one unfold indexing an
    image, summed)."""
    from slam_toolkit_tpu_torch.ops import patches
    n0 = kernel.launches
    out = patches.gather_blocks_multi_cuda(images, ys, xs, counts, bh, bw)
    if kernel.launches != n0 + 1:
        raise AssertionError(f"{what}: launched {kernel.symbol} "
                             f"{kernel.launches - n0} times")
    ref = patches.gather_blocks_multi_plain(images, ys, xs, counts, bh, bw)
    offs = np.cumsum([0] + list(counts))
    libs, read = [], 0
    for img, a, z in zip(images, offs[:-1], offs[1:]):
        if z == a:
            continue
        yl, xl = ys[a:z].long(), xs[a:z].long()
        win = img.unfold(0, bh, 1).unfold(1, bw, 1)
        libs.append(lambda win=win, yl=yl, xl=xl: win[yl, xl])
        read += window_bytes(img, yl, xl, bh, bw)
    lib = torch.cat([f() for f in libs])
    if not (torch.equal(out, ref) and torch.equal(lib, ref)):
        raise AssertionError(f"{what}: kernel, plain and unfold disagree")

    def kern():
        return patches.gather_blocks_multi_cuda(images, ys, xs, counts, bh,
                                                bw)
    row = {"ms": device_ms(kern), "host_ms": host_ms(kern),
           "plain_ms": call_ms(lambda: patches.gather_blocks_multi_plain(
               images, ys, xs, counts, bh, bw)),
           "library_ms": sum(device_ms(f) for f in libs),
           **bound(read + nbytes(ys, xs, out), 0), "max_abs_err": 0.0}
    return row


def print_case(label: str, what: str, r: dict) -> None:
    lib_ms = "none" if r["library_ms"] is None else \
        f"{r['library_ms']:.4f} ms"
    print(f"[phase15] {label} {what}: exact; kernel {r['ms']:.4f} ms "
          f"(device), wrapper {r['host_ms']:.4f} ms (host), plain "
          f"{r['plain_ms']:.4f} ms, library (unfold) {lib_ms}, bound "
          f"{r['bound_ms']:.6f} ms ({r['bound_by']})")


def check_option_kernels(cfg, frames, label: str) -> dict:
    """Phase 15 (a): the kernels at the option sets' shapes on frame 0 (and
    frame 1 as a second lane) of the track, each exact against its plain
    version, with phase 2's columns: the bfloat16 gather through its
    single, multi and batched entries at 2000 windows 31x31 over the poly
    levels' budgets (the blurred levels rounded to bfloat16); the float32
    gather at subpixel's 11x11 and 11x17 (2048 windows on the left and
    right images) and at ic_angle's 31x31 over the raw poly levels; FAST
    +NMS on the poly level shapes. Returns the two bfloat16 rows."""
    from slam_toolkit_tpu_torch.ops import fast_kernel, patches, pyramid
    from slam_toolkit_tpu_torch.ops.extractor import level_budgets
    from slam_toolkit_tpu_torch.tools import bench
    rng = np.random.default_rng(15)
    ecfg = bench.with_option(cfg, "O1").extractor
    pair = torch.from_numpy(np.asarray(frames[:2], np.float32)).to("cuda")
    levels = pyramid.build_pyramid(pair[:, 0], ecfg)        # 2 lanes
    shapes = [tuple(lv.shape[-2:]) for lv in levels]
    if shapes != pyramid.level_shapes(*shapes[0], ecfg):
        raise AssertionError(f"poly levels {shapes}")
    budgets = level_budgets(ecfg)
    blurred = [pyramid.gaussian_blur(lv, 7, ecfg.blur_sigma).to(
        torch.bfloat16) for lv in levels]
    print(f"[phase15] poly level shapes {shapes}, budgets {budgets}")
    # bfloat16: multi (the extractor's launch), single, batched
    ys, xs = _windows([b[0] for b in blurred], budgets, 31, rng)
    multi = gather_row([b[0] for b in blurred], ys, xs, budgets, 31, 31,
                       patches.KERNEL_BF16, "bf16 gather, 8 levels")
    print_case(label, f"bf16 gather, a frame's {len(levels)} poly levels in "
               f"one launch ({sum(budgets)} windows 31x31)", multi)
    y0, x0 = _windows([blurred[0][0]], [sum(budgets)], 31, rng)
    single = gather_row([blurred[0][0]], y0, x0, [sum(budgets)], 31, 31,
                        patches.KERNEL_BF16, "bf16 gather, level 0")
    n0 = patches.KERNEL_BF16.launches
    patches.gather_blocks_cuda(blurred[0][0], y0, x0, 31, 31)
    if patches.KERNEL_BF16.launches != n0 + 1:
        raise AssertionError("the single bf16 entry did not launch once")
    print_case(label, f"bf16 gather, single entry ({sum(budgets)} windows "
               f"31x31 of level 0, {shapes[0]})", single)
    yb, xb = _windows(blurred, budgets, 31, rng)
    n0 = patches.BATCHED_KERNEL_BF16.launches
    batched = check_gather_batched((blurred, yb, xb, budgets, 31, 31))
    if patches.BATCHED_KERNEL_BF16.launches <= n0:
        raise AssertionError("the batched bf16 entry did not launch")
    batched.update(name="patch_gather_bf16_batched",
                   kernel=patches.BATCHED_KERNEL_BF16)
    print_case(label, f"bf16 gather, batched entry ({batched['what']})",
               batched)
    # float32 at the new shapes
    left, right = pair[0, 0], pair[0, 1]
    for bh, bw, img in ((11, 11, left), (11, 17, right)):
        y, x = _windows([img], [2048], max(bh, bw), rng)
        r = gather_row([img], y, x, [2048], bh, bw, patches.KERNEL,
                       f"gather {bh}x{bw}")
        print_case(label, f"f32 gather at subpixel's {bh}x{bw}, 2048 "
                   f"windows of {tuple(img.shape)}", r)
    raw = [lv[0] for lv in levels]
    y, x = _windows(raw, budgets, 31, rng)
    r = gather_row(raw, y, x, budgets, 31, 31, patches.KERNEL,
                   "ic_angle gather")
    print_case(label, f"f32 gather at ic_angle's 31x31 over the "
               f"{len(raw)} raw poly levels ({sum(budgets)} windows, one "
               f"launch)", r)
    # FAST+NMS on the poly level shapes
    border = ecfg.patch_radius + 1
    thr = (float(ecfg.fast_threshold_high), float(ecfg.fast_threshold_low))
    outs = fast_kernel.detect_levels_cuda(raw, thr[0], thr[1], border)
    refs = fast_kernel.detect_levels_plain(raw, thr[0], thr[1], border)
    for lv, out, ref in zip(raw, outs, refs):
        if not torch.equal(out, ref):
            raise AssertionError(f"FAST+NMS differs at poly level "
                                 f"{tuple(lv.shape)}")
    b, dense_ms, _ = fast_bound(raw, thr[0], thr[1], border)
    fr = {**row_times(lambda: fast_kernel.detect_levels_cuda(
        raw, thr[0], thr[1], border), lambda: fast_kernel.detect_levels_plain(
        raw, thr[0], thr[1], border)), **b}
    print_case(label, f"FAST+NMS, frame 0's {len(raw)} poly levels in one "
               f"launch "
               f"({sum(int((r > 0).sum()) for r in refs)} corners; dense "
               f"bound {dense_ms:.6f} ms)", fr)
    src = {"source": "slam_toolkit_tpu_torch/csrc/patch_gather.cu",
           "replaces": "slam_toolkit_tpu/ops/patches.py:113"}
    return {"patch_gather_bf16": {
        "name": "patch_gather_bf16", "kernel": patches.KERNEL_BF16,
        **src, **multi},
        "patch_gather_bf16_batched": {**batched, **src}}


def option_run(cfg, name: str, frames, gt, kernels: dict, label: str):
    """Phase 15 (b): the 48 frames under option set `name`, graphed, then
    eagerly: rows bit-equal, launches (by window shape too) equal; every
    kernel of the path launched, SAD not under O1. Returns the graphed
    run's launches."""
    from slam_toolkit_tpu_torch.evaluation.traj import ate_rmse, rpe
    from slam_toolkit_tpu_torch.tools import bench
    cfg_o = bench.with_option(cfg, name)
    runs = {}
    for mode in ("graphed", "eager"):
        eng, chunk_s, launches, shapes = drive(cfg_o, frames, 16, kernels,
                                               graphs=mode == "graphed")
        runs[mode] = (eng, chunk_s, launches, shapes, engine_rows(eng))
    eng, chunk_s, launches, shapes, rows = runs["graphed"]
    e_eng, e_s, e_launches, e_shapes, e_rows = runs["eager"]
    if not np.array_equal(rows, e_rows):
        bad = np.flatnonzero((rows != e_rows).any(1))
        raise AssertionError(f"{name}: graphed and eager part at frame "
                             f"{int(bad[0])}")
    if (launches, shapes) != (e_launches, e_shapes):
        raise AssertionError(f"{name}: graphed launches {launches} "
                             f"{shapes}, eager {e_launches} {e_shapes}")
    traj = finite_trajectory(eng, len(frames), f"option {name}")
    ate = ate_rmse(traj, gt, align=True)
    rt, _ = rpe(traj, gt)
    ok = float(np.mean([st["ok"] for st in eng.frame_stats[1:]]))
    n_lm = int(eng.map.mp_valid.sum())
    ref = JAX_F32_48[name]
    print(f"[phase15] {label} {name} ({bench.OPTIONS[name]}): frames/s "
          f"graphed {32 / sum(chunk_s[1:]):.2f}, eager "
          f"{32 / sum(e_s[1:]):.2f} (chunks 2-3); keyframes "
          f"{eng.n_keyframes}, mappoints {n_lm}, ATE {ate:.4f} m, RPE "
          f"{rt:.4f} m, tracking ok on {100 * ok:.1f}% of frames; the JAX "
          f"package in float32 on the CPU, same frames and option: "
          f"keyframes {ref['n_keyframes']}, mappoints {ref['mappoints']}, "
          f"ATE {ref['ate_m']} m, RPE {ref['rpe_t_m']} m")
    stats = eng._chunk.graph_stats()
    print(f"[phase15] {label} {name}: {rows.shape[0]} x {rows.shape[1]} "
          f"packed values bit-equal graphed and eager; launches {launches}, "
          f"gather by window {shapes}"
          + ("" if stats is None else f"; graphs: {graph_line(stats)}"))
    missing = [k for k in OPTION_KERNELS[name] if launches[k] == 0]
    if missing:
        raise AssertionError(f"{name}: kernels not launched: {missing}")
    extra = [k for k in OPTION_NEVER[name] if launches[k] != 0]
    if extra:
        raise AssertionError(f"{name}: launched {extra}, which its path "
                             "does not run")
    if ok < 0.9:
        raise AssertionError(f"{name}: tracking ok on only {ok:.2f}")
    return launches


def augmented_closer(loop: dict, label: str) -> None:
    """Phase 15 (c): phase 10's first closure, its relative pose re-run on
    the run's final map with loop.relpose_stereo_aug off and on; the
    top-2 kernel exact against its plain version on the augmented
    problem."""
    import dataclasses

    from slam_toolkit_tpu_torch.ops import match_kernel as mk
    eng, e = loop["engine"], loop["closure"]
    cfg = eng.cfg
    aug = dataclasses.replace(cfg, loop=dataclasses.replace(
        cfg.loop, relpose_stereo_aug=True))
    cap = LoopCapture()
    try:
        plain = cap.closer.relative_pose(eng.map, e["kf_slot"], e["cand"],
                                         eng.cam, cfg)
        args_plain = cap.args.pop("relative_pose")
        with_aug = cap.closer.relative_pose(eng.map, e["kf_slot"],
                                            e["cand"], eng.cam, aug)
    finally:
        cap.close()
    *t, r = cap.args["relative_pose"]
    m_plain, m_aug = args_plain[0].shape[0], t[0].shape[0]
    if m_aug != m_plain + cfg.extractor.max_keypoints:
        raise AssertionError(f"augmented top-2 rows {m_aug}, expected "
                             f"{m_plain} + {cfg.extractor.max_keypoints}")
    topk2_exact(t, r, "the augmented relative pose")
    ms = device_ms(lambda: mk.topk2_match_cuda(*t, r))
    b, _ = topk2_bound(t, r)
    print(f"[phase15] {label} closure {e['kf_slot']}->{e['cand']} on the "
          f"final map: relative pose {int(plain.n_inliers)} inliers (ok "
          f"{bool(plain.ok)}), with relpose_stereo_aug "
          f"{int(with_aug.n_inliers)} (ok {bool(with_aug.ok)}); top-2 rows "
          f"{m_plain} -> {m_aug} (N={t[1].shape[0]}, r={r}): exact, "
          f"{gate_shares(t, r)}; kernel {ms:.4f} ms (device), bound "
          f"{b['bound_ms']:.6f} ms ({b['bound_by']})")


def batched_option(cfg, name: str, frames, kernels: dict,
                   label: str) -> dict:
    """Phase 15 (d): two lanes under option set `name` (frames 0-16 and
    16-32 of the track) through mesh.multi_sequence_chunk, graphed: each
    lane's rows bit-equal to ChunkedSlamEngine on that lane's frames.
    Counts reset just before, read just after: every gather, top-2 and
    local-BA launch on the batched entries (the keyframe events' right
    images extracted and refined over the lanes at once), under O3 the
    descriptors' on the batched bfloat16 gather."""
    from slam_toolkit_tpu_torch.geometry.camera import StereoCamera
    from slam_toolkit_tpu_torch.parallel import mesh
    from slam_toolkit_tpu_torch.pipeline.scan_engine import ChunkedSlamEngine
    from slam_toolkit_tpu_torch.tools import bench
    cfg_o = bench.with_option(cfg, name)
    n = BATCHED_FRAMES
    seqs = [np.asarray(frames[:n]), np.asarray(frames[n - 1:2 * n - 1])]
    stack = torch.from_numpy(np.stack(seqs, axis=1)).to("cuda",
                                                        torch.float32)
    cam = StereoCamera.from_config(cfg_o.camera, "cuda")
    for k in kernels.values():
        k.launches = 0
    carry = mesh.batched_bootstrap(cfg_o, cam)(
        mesh.batched_empty_map(cfg_o, 2, "cuda"), stack[0, :, 0],
        stack[0, :, 1])
    step = mesh.multi_sequence_chunk(cfg_o, cam)
    t0 = time.perf_counter()
    carry, packed = step(carry, stack[1:])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {k: v.launches for k, v in kernels.items()}
    rows = packed.cpu().numpy()
    for b, seq in enumerate(seqs):
        alone = ChunkedSlamEngine(cfg_o, chunk_size=n - 1,
                                  device="cuda").process_chunk(seq)
        if not np.array_equal(rows[:, b], alone):
            bad = np.flatnonzero((rows[:, b] != alone).any(1))
            raise AssertionError(f"batched {name} lane {b} parts from its "
                                 f"single step at frame {int(bad[0]) + 1}")
    print(f"[phase15] {label} batched {name}, 2 lanes x {n - 1} frames "
          f"(first uses and captures included: {secs:.2f} s): each lane's "
          f"{rows.shape[0]} x {rows.shape[2]} packed values bit-equal to "
          f"its single step; keyframes a lane "
          f"{[int(rows[:, b, 34].sum()) for b in range(2)]}; launches "
          f"{launches}")
    # the keyframe events (the bootstrap's too) extract the right images
    # and refine (11x11 and 11x17 windows) over the lanes at once
    events = 1 + int((rows[..., 34] > 0.5).any(1).sum())
    f32 = 2 * events + (0 if name == "O3" else n + events)
    want = {"patch_gather_batched": f32,
            "patch_gather_bf16_batched": n + events if name == "O3" else 0,
            "topk2_match_batched": n - 1, "local_ba_batched": events - 1,
            "sad_curve_batched": 0, "patch_gather": 0,
            "patch_gather_bf16": 0, "topk2_match": 0, "local_ba": 0,
            "stereo_sad": 0}
    got = {k: launches[k] for k in want}
    if got != want:
        raise AssertionError(f"batched {name}: launches {got}, expected "
                             f"{want}")
    return launches


def phase15(cfg, frames, gt, kernels: dict, loop: dict, label: str):
    """The option sets: kernels at their shapes, O1-O3 at full width, the
    augmented closer, batched O1 and O3. Returns (the new kernel rows,
    each option's launches, the batched runs' launches)."""
    from slam_toolkit_tpu_torch.ops import patches
    t_phase = time.perf_counter()
    new_rows = check_option_kernels(cfg, frames, label)
    every = {**kernels, "patch_gather_bf16": patches.KERNEL_BF16,
             "patch_gather_bf16_batched": patches.BATCHED_KERNEL_BF16,
             **batched_kernels()}
    launches = {name: option_run(cfg, name, frames[:OPTION_FRAMES],
                                 gt[:OPTION_FRAMES], every, label)
                for name in OPTION_NAMES}
    augmented_closer(loop, label)
    dp = {name: batched_option(cfg, name, frames, every, label)
          for name in ("O1", "O3")}
    print(f"[phase15] {label} phase seconds "
          f"{time.perf_counter() - t_phase:.1f}")
    return new_rows, launches, dp


# ---------------------------------------------------------------- phase 16
class WorkerCounts:
    """While installed on an engine with a mapping worker: every launch a
    worker job makes is counted apart (cuda_lib.counting on the worker's
    thread), and every call of the closer's relative pose (the host's
    SlamEngine._relpose, its call site of the top-2 matcher) records
    whether it ran on the worker's thread, whether the current stream
    there was the worker's, and the top-2 launches its thread made inside
    it; the inputs the first call on the worker hands the top-2 matcher
    are kept on the card (cloned on the worker's stream)."""

    def __init__(self, eng):
        import threading
        from slam_toolkit_tpu_torch.frontend import matching
        from slam_toolkit_tpu_torch.ops import match_kernel as mk
        self.eng, self.matching, self.mk = eng, matching, mk
        self.orig_match = matching.topk2_match
        self.orig_relpose = eng._host._relpose
        self.orig_job = eng._run_job
        self.local = threading.local()
        self.calls = []          # (worker thread, worker stream, launches)
        self.job_launches = {}   # {LaunchCount: launches} of the jobs
        self.args = None
        matching.topk2_match = self._match
        eng._host._relpose = self._relpose
        eng._run_job = self._job

    def _job(self, *args):
        from slam_toolkit_tpu_torch.utils import cuda_lib
        with cuda_lib.counting() as d:
            self.orig_job(*args)
        for c, n in d.items():
            self.job_launches[c] = self.job_launches.get(c, 0) + n

    def _relpose(self, *args):
        from slam_toolkit_tpu_torch.utils import cuda_lib
        w = self.eng._worker
        on_stream = torch.cuda.current_stream(self.eng.device) == w.stream
        self.local.inside = True
        try:
            with cuda_lib.counting() as d:
                out = self.orig_relpose(*args)
        finally:
            self.local.inside = False
        self.calls.append((w.on_thread(), on_stream,
                           d.get(self.mk.KERNEL, 0)))
        return out

    def _match(self, *args):
        if getattr(self.local, "inside", False) and self.args is None \
                and self.eng._worker.on_thread():
            self.args = [a.clone() if isinstance(a, torch.Tensor) else a
                         for a in args]
        return self.orig_match(*args)

    def close(self):
        self.matching.topk2_match = self.orig_match
        del self.eng._host._relpose, self.eng._run_job


def timed_run(eng, frames, chunk: int):
    """(chunk seconds, flush seconds, the rows returned) of `eng` over
    `frames`, each ending in a synchronise."""
    chunk_s, rows = [], []
    for i in range(0, len(frames), chunk):
        t0 = time.perf_counter()
        rows.append(eng.process_chunk(frames[i:i + chunk]))
        torch.cuda.synchronize()
        chunk_s.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    rows.append(eng.flush())
    torch.cuda.synchronize()
    return chunk_s, time.perf_counter() - t0, np.concatenate(rows)


def gil_ticks(seconds: float = None, until=None) -> float:
    """Iterations a second of a pure-Python loop on another thread, run
    for `seconds`, or until the threading.Event `until` is set: how much
    of the interpreter lock the rest of the process leaves free."""
    import threading
    stop = until or threading.Event()
    out = []

    def tick():
        n, t0 = 0, time.perf_counter()
        while not stop.is_set():
            n += 1
        out.append(n / (time.perf_counter() - t0))
    t = threading.Thread(target=tick)
    t.start()
    if seconds is not None:
        time.sleep(seconds)
        stop.set()
    return t, out


def lockstep_run(eng, frames, chunk: int) -> np.ndarray:
    """`eng` over `frames` with its mapping worker in lockstep: after each
    chunk the worker's jobs finish and the closures they decide land
    (drain) before the next chunk, and each relative pose is waited for
    where it is measured (so its event has completed when a job asks),
    so that the schedule depends on no timing. The rows returned."""
    measure = eng._measure

    def waited(*args):
        out = measure(*args)
        torch.cuda.current_stream(eng.device).synchronize()
        return out
    eng._measure = waited
    rows = []
    for i in range(0, len(frames), chunk):
        rows.append(eng.process_chunk(frames[i:i + chunk]))
        eng._worker.drain()
    rows.append(eng.flush())
    torch.cuda.synchronize()
    return np.concatenate(rows)


def closure_keys(events) -> list:
    """A run's closures as (frame, candidate's frame, slot, candidate)."""
    return [(e["frame"], e["fid_cand"], e["kf_slot"], e["cand"])
            for e in events if "cand" in e]


def free_against_lockstep(free: dict, lock: dict, label: str) -> None:
    """The free-running schedule held to lockstep: the rows returned
    before the first closure landed (in either run) bit-equal, every
    closure (slot, candidate) one that lockstep took, ATE and seam finite
    and within the loop cell's limits. Each dict: the run's outcome
    (loop_outcome), its rows and its landings."""
    first = min(free["landed"][:1] + lock["landed"][:1]
                + [LOOP_FRAMES + 1])
    n = first - 1                     # the bootstrap frame has no row
    same_rows = np.array_equal(free["rows"][:n], lock["rows"][:n])
    fc, lc = closure_keys(free["events"]), closure_keys(lock["events"])
    print(f"[phase16] {label} free-running / lockstep (loop graphs): "
          f"closures {fc} / {lc}, landed with {free['landed']} / "
          f"{lock['landed']} frames run, ATE {free['ate']:.4f} / "
          f"{lock['ate']:.4f} m, seam {free['seam']:.4f} / "
          f"{lock['seam']:.4f} m; rows before the first landing "
          f"{n} of {len(lock['rows'])}, bit-equal {same_rows}")
    if len(free["rows"]) != len(lock["rows"]) or not same_rows:
        raise AssertionError("phase 16: the free-running run's rows before "
                             "the first closure landed part from "
                             "lockstep's")
    extra = {c[2:] for c in fc} - {c[2:] for c in lc}
    if extra:
        raise AssertionError(f"phase 16: the free-running run took closures "
                             f"(slot, candidate) {sorted(extra)} that "
                             f"lockstep did not")
    for k, limit in (("ate", LOOP_ATE_LIMIT_M), ("seam", LOOP_SEAM_LIMIT_M)):
        if not np.isfinite(free[k]) or free[k] > limit:
            raise AssertionError(f"phase 16: the free-running run's {k} "
                                 f"{free[k]} m is not within {limit} m")


def phase16(cfg, frames48, loop: dict, kernels: dict, label: str) -> dict:
    """The chunked engine's pipelined schedule at full width: phase 10's
    loop frames and vocabulary, graphed, at queue_depth=2 with the
    mapping worker (loop_thread=True), its loop programs replayed as CUDA
    graphs; then in lockstep with the loop graphs and with the loop
    programs eager (the host's `graphs` off), which must agree exactly;
    then the open engine at depths 0 and 2 on phase 3's frames. Returns
    the launch counts."""
    from slam_toolkit_tpu_torch.ops import match_kernel as mk
    from slam_toolkit_tpu_torch.pipeline.scan_engine import \
        ChunkedSlamEngine
    from slam_toolkit_tpu_torch.tools import bench
    from slam_toolkit_tpu_torch.utils import cuda_lib
    from slam_toolkit_tpu_torch.utils.timing import StreamStages
    t_phase = time.perf_counter()
    chunk = 16
    frames, gt, vocab = loop["frames"], loop["gt"], loop["vocab"]
    lap, revisit, _, _ = bench.loop_geometry(LOOP_FRAMES, chunk)

    def pipelined(loop_graphs: bool = True):
        e = ChunkedSlamEngine(cfg, vocab=vocab, chunk_size=chunk,
                              device="cuda", queue_depth=2,
                              loop_thread=True)
        e._host.graphs = loop_graphs
        return e

    # (a) the timed run, loop graphs: counts from 0 just before, read
    # just after
    eng = pipelined()
    eng._host.stages = StreamStages()
    spy = WorkerCounts(eng)
    syncs = ChunkSyncs()
    for k in kernels.values():
        k.launches = 0
    try:
        with cuda_lib.counting() as main_counts:
            chunk_s, flush_s, free_rows = timed_run(eng, frames, chunk)
    finally:
        spy.close()
        syncs.close()
    launches = {n: k.launches for n, k in kernels.items()}
    out = loop_outcome(eng, gt, lap, revisit, LOOP_FRAMES)
    ate, seam = out["ate"], out["seam"]
    closures = [e for e in eng.loop_events if "cand" in e]
    fps = LOOP_FRAMES / sum(chunk_s)
    print(f"[phase16] {label} queue depth 2 + mapping worker, loop graphs, "
          f"{LOOP_FRAMES} frames: frames/s {fps:.2f} over the chunks, "
          f"{LOOP_FRAMES / (sum(chunk_s) + flush_s):.2f} with the flush "
          f"(chunk seconds {[round(x, 3) for x in chunk_s]}, flush "
          f"{flush_s:.3f} s), ATE {ate:.4f} m, seam {seam:.4f} m, keyframes "
          f"{eng.n_keyframes}, closures {len(closures)} (frames "
          f"{[(e['frame'], e['fid_cand']) for e in closures]}, landed with "
          f"{eng.closures_landed} frames run), replays {eng.n_replays}")
    print_stages("phase16", label, "free-running, loop graphs",
                 eng._host.stages.summary(), len(chunk_s))
    print(f"[phase16] {label} {graph_stats_line(eng._host.loop_graph_stats())}")
    print(f"[phase16] {label} phase 10's inline run on the same frames: "
          f"frames/s {LOOP_FRAMES / sum(loop['chunk_s']):.2f} over the "
          f"chunks, ATE {loop['ate']:.4f} m, seam {loop['seam']:.4f} m, "
          f"closures {len([e for e in loop['engine'].loop_events if 'cand' in e])}"
          f", replays {loop['engine'].n_replays}")
    # the loop graphs against the eager loop programs, both in lockstep:
    # no timing left in the schedule, so they must agree exactly; the
    # eager run's worker hands its first relative pose's top-2 inputs
    # over (a replayed graph calls no Python)
    lock = {}
    for loop_graphs in (True, False):
        e = pipelined(loop_graphs)
        e._host.stages = StreamStages()
        sp = None if loop_graphs else WorkerCounts(e)
        for k in kernels.values():
            k.launches = 0
        t0 = time.perf_counter()
        try:
            lock_rows = lockstep_run(e, frames, chunk)
        finally:
            if sp is not None:
                sp.close()
        wall = time.perf_counter() - t0
        lock[loop_graphs] = (dict(loop_outcome(e, gt, lap, revisit,
                                               LOOP_FRAMES),
                                  rows=lock_rows,
                                  landed=list(e.closures_landed)),
                             {n: k.launches for n, k in kernels.items()}, sp)
        if loop_graphs:
            st_l = e._host.loop_graph_stats()
            expect_loop_graphs(st_l, 12, "in lockstep")
            print(f"[phase16] {label} lockstep: {closes_line(st_l)}")
        print_stages("phase16", label, f"lockstep ({wall:.2f} s), "
                     + ("loop graphs" if loop_graphs else
                        "loop programs eager"),
                     e._host.stages.summary(), len(range(0, len(frames),
                                                         chunk)))
        if e._worker.error is not None or e._closure_pend or \
                e._loop_stash or e._worker.outstanding:
            raise AssertionError("the worker left an exception or work "
                                 "behind")
    same_outcome(lock[True][0], lock[False][0], "phase 16 lockstep, loop "
                 "graphs against the eager loop programs")
    if not np.array_equal(lock[True][0]["rows"], lock[False][0]["rows"]):
        raise AssertionError("phase 16 lockstep rows differ, loop graphs "
                             "against the eager loop programs")
    free_against_lockstep(dict(out, rows=free_rows,
                               landed=list(eng.closures_landed)),
                          lock[True][0], label)
    if lock[True][1] != lock[False][1]:
        raise AssertionError(f"phase 16 lockstep launches differ: "
                             f"{lock[True][1]} against {lock[False][1]}")
    lc = [x for x in lock[True][0]["events"] if "cand" in x]
    print(f"[phase16] {label} lockstep (the worker's jobs done before each "
          f"next chunk), loop graphs and eager loop programs: the same "
          f"closures {[(x['frame'], x['fid_cand']) for x in lc]}, events, "
          f"ATE {lock[True][0]['ate']:.4f} m and seam "
          f"{lock[True][0]['seam']:.4f} m, launches {lock[True][1]}")
    # the queue alone, without the thread, right after: which of the two
    # moves the chunk's wall
    eng_q = ChunkedSlamEngine(cfg, vocab=vocab, chunk_size=chunk,
                              device="cuda", queue_depth=2,
                              loop_thread=False)
    syncs_q = ChunkSyncs()
    try:
        chunk_q, flush_q, _ = timed_run(eng_q, frames, chunk)
    finally:
        syncs_q.close()
    scan_w = scan_line(eng._chunk.graph_stats(), syncs.graphed,
                       len(eng.frame_stats) - 1, "with the worker")
    print(f"[phase16] {label} queue depth 2, loop phases inline: frames/s "
          f"{LOOP_FRAMES / sum(chunk_q):.2f} over the chunks, "
          f"{LOOP_FRAMES / (sum(chunk_q) + flush_q):.2f} with the flush "
          f"(chunk seconds {[round(x, 3) for x in chunk_q]}, flush "
          f"{flush_q:.3f} s), closures "
          f"{[(e['frame'], e['fid_cand']) for e in eng_q.loop_events if 'cand' in e]}"
          f"; {if_runs_line(eng_q, syncs_q, 'queue depth 2, inline')}; "
          f"with the worker (its syncs counted too) {syncs.line()}, keyframe "
          f"IF body runs "
          f"{eng._chunk.graph_stats()['if_runs'].get('keyframe', 0)} for "
          f"{sum(s['kf'] for s in eng.frame_stats[1:])} keyframe rows, "
          f"{scan_w}")
    on_worker = [(s, n) for t, s, n in spy.calls if t]
    on_main = [(s, n) for t, s, n in spy.calls if not t]
    worker_top2 = sum(n for _, n in on_worker)
    print(f"[phase16] {label} launches {launches}; made by the worker's "
          f"jobs { {getattr(k, 'symbol', '?'): n for k, n in spy.job_launches.items()} }"
          f"; the closer's relative pose: {len(on_worker)} calls on the "
          f"worker ({sum(s for s, _ in on_worker)} on its stream, "
          f"{worker_top2} top-2 launches from their graphs' replays), "
          f"{len(on_main)} on the main thread at the flush "
          f"({sum(n for _, n in on_main)} top-2 launches)")
    if not closures or eng.n_replays < 1:
        raise AssertionError(f"pipelined: {len(closures)} closures, "
                             f"{eng.n_replays} replays")
    missing = [n for n, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the pipelined loop "
                             f"path: {missing}")
    if not on_worker or worker_top2 == 0:
        raise AssertionError("the worker measured no relative pose with "
                             "the top-2 kernel")
    if not all(s for s, _ in on_worker):
        raise AssertionError("a relative pose on the worker ran on "
                             "another stream than the worker's")
    st = eng._host.loop_graph_stats()
    expect_loop_graphs(st, 12, "under the worker")
    print(f"[phase16] {label} free-running: {closes_line(st)} (thread_local "
          f"capture on the main thread, the worker waiting for the "
          f"closure)")
    for name, k in kernels.items():
        made = main_counts.get(k, 0) + spy.job_launches.get(k, 0)
        if launches[name] != made:
            raise AssertionError(
                f"{name}: {launches[name]} launches counted, "
                f"{main_counts.get(k, 0)} by the main thread + "
                f"{spy.job_launches.get(k, 0)} by the worker's jobs")
    if spy.job_launches.get(mk.KERNEL, 0) < worker_top2:
        raise AssertionError("the worker's relative poses launched more "
                             "top-2 kernels than its jobs")
    if eng._worker.error is not None or eng._closure_pend or \
            eng._loop_stash or eng._worker.outstanding:
        raise AssertionError("the worker left an exception or work behind")
    *t, r = lock[False][2].args
    topk2_exact(t, r, "the mapping worker's relative pose")
    b, _ = topk2_bound(t, r)
    print(f"[phase16] {label} top-2 from the worker's relative pose "
          f"(M={t[0].shape[0]} N={t[1].shape[0]} r={r}): exact, "
          f"{gate_shares(t, r)}; bound {b['bound_ms']:.6f} ms "
          f"({b['bound_by']})")

    # (c) no vocabulary: depth 2 returns depth 0's rows bit for bit. (d)
    # The interpreter lock: a pure-Python loop on another thread ticks
    # alone, then through depth 2's chunks 2-3 (the share of the lock
    # the main thread's replays and flag reads leave free), whose wall
    # is set beside depth 0's without it
    import threading
    th, alone = gil_ticks(0.3)
    th.join()
    outs, rates = {}, []
    for depth in (0, 2):
        e = ChunkedSlamEngine(cfg, chunk_size=chunk, device="cuda",
                              queue_depth=depth, loop_thread=True)
        got, walls = [], []
        for i in range(0, len(frames48), chunk):
            stop = threading.Event()
            if depth == 2 and i:
                th, ticks = gil_ticks(until=stop)
            t0 = time.perf_counter()
            got.append(e.process_chunk(frames48[i:i + chunk]))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            stop.set()
            if depth == 2 and i:
                th.join()
                rates += ticks
        got.append(e.flush())
        outs[depth] = ([len(g) for g in got], np.concatenate(got), walls)
    if not np.array_equal(outs[2][1], outs[0][1]):
        raise AssertionError("depth 2 rows part from depth 0's")
    print(f"[phase16] {label} no vocabulary, phase 3's {len(frames48)} "
          f"frames: rows returned per call at depth 0 {outs[0][0]}, at "
          f"depth 2 {outs[2][0]}; {outs[0][1].shape[0]} x "
          f"{outs[0][1].shape[1]} packed values bit-equal")
    print(f"[phase16] {label} interpreter lock: a Python loop on another "
          f"thread ticks {np.mean(rates) / alone[0]:.3f} of its rate alone "
          f"through graphed chunks (chunks 2-3); they take "
          f"{[round(x, 3) for x in outs[2][2][1:]]} s beside it, "
          f"{[round(x, 3) for x in outs[0][2][1:]]} s without")
    print(f"[phase16] {label} phase seconds "
          f"{time.perf_counter() - t_phase:.1f}")
    return {"launches": launches, "fps": fps, "ate": ate, "seam": seam,
            "closures": len(closures)}


# ---------------------------------------------------------------- phase 17
# phase 17's first frames of make_cluster_scene: 3 warm-up frames (the
# capture in them), 8 timed, 6 with the host syncs counted, 1 under
# torch.profiler (the eager step's events take ~10 s to collect), the
# rest folded
CL_FRAMES, CL_WARM, CL_TIMED, CL_SYNCS, CL_PROF = 20, 3, 11, 17, 18


def cluster_run(scene, cfg, staged, graphs: bool, kernels: dict) -> dict:
    """FusedDenseTracker over the staged frames, graphed or eager: every
    row, frames/s over frames CL_WARM..CL_TIMED, host syncs (CUDA's sync
    debug mode) and the tracker's row waits a frame, kernels a frame and
    the card's busy share, the kernels' launches, the graph's stats and
    the branches' runs (the IF bodies' executions graphed, run_if's plain
    runs eager: the host-gated count)."""
    from slam_toolkit_tpu_torch.cluster.tracker import FusedDenseTracker
    from slam_toolkit_tpu_torch.utils import cuda_graphs
    from slam_toolkit_tpu_torch.utils.timing import (count_syncs,
                                                     device_activity)
    for k in kernels.values():
        k.launches = 0
    plain0 = dict(cuda_graphs.plain_runs)
    tr = FusedDenseTracker(scene.cam, cfg, queue_depth=2, device="cuda",
                           graphs=graphs)
    outs = []

    def run(pairs):
        for gl, gr in pairs:
            o = tr.process(gl, gr)
            if o is not None:
                outs.append(o)
    run(staged[:CL_WARM])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(staged[CL_WARM:CL_TIMED])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    waits = tr.waits
    _, syncs = count_syncs(run, staged[CL_TIMED:CL_SYNCS])
    n_sync = CL_SYNCS - CL_TIMED
    waits = (tr.waits - waits) / n_sync
    _, act = device_activity(run, staged[CL_SYNCS:CL_PROF])
    run(staged[CL_PROF:])
    outs += tr.flush()
    stats = tr.graph_stats()
    ran = stats["if_runs"] if stats is not None else {
        k: n - plain0.get(k, 0) for k, n in cuda_graphs.plain_runs.items()}
    bodies = {k: ran.get(k, 0) for k in ("skip", "run", "round")}
    return {"outs": outs, "fps": (CL_TIMED - CL_WARM) / secs,
            "bodies": bodies,
            "syncs": syncs / n_sync, "waits": waits,
            "kernels": act["kernels"] / (CL_PROF - CL_SYNCS)
            if act["kernels"] else None, "busy": act["busy"],
            "launches": {n: k.launches for n, k in kernels.items()},
            "stats": stats}


def phase17(kernels: dict, label: str, cluster_rec: dict) -> None:
    """The cluster tracker's fused step as one CUDA graph against the
    eager step at phase 12's size, on the scene's first CL_FRAMES frames,
    eager then graphed: every row bit-equal."""
    from slam_toolkit_tpu_torch.cluster import tracker as trk
    from slam_toolkit_tpu_torch.data.synthetic import make_cluster_scene
    from slam_toolkit_tpu_torch.tools import bench
    t_phase = time.perf_counter()
    scene = make_cluster_scene(n_frames=CLUSTER_FRAMES)
    cfg = trk.DenseConfig(max_points=bench.CLUSTER_MAX_POINTS)
    staged = [tuple(torch.from_numpy(a).to("cuda") for a in fr)
              for fr in scene.frames[:CL_FRAMES]]
    runs = []
    for mode in ("eager", "graphed"):
        t0 = time.perf_counter()
        r = cluster_run(scene, cfg, staged, mode == "graphed", kernels)
        runs.append(r)
        kern = "not seen" if r["kernels"] is None else \
            f"{r['kernels']:.1f}"
        busy = "not seen" if r["busy"] is None else f"{r['busy']:.4f}"
        print(f"[phase17] {label} {mode}: frames/s {r['fps']:.2f} over "
              f"frames {CL_WARM}-{CL_TIMED - 1}; host syncs a frame "
              f"{r['syncs']:.2f} (sync debug mode) + row waits "
              f"{r['waits']:.2f}"
              f"; kernels a frame {kern}, busy share {busy} (frames "
              f"{CL_SYNCS}-{CL_PROF - 1}, torch.profiler); launches "
              f"{r['launches']}; {time.perf_counter() - t0:.1f} s"
              + ("" if r["stats"] is None else
                 f"; {graph_line(r['stats'])}"))
        if any(r["launches"].values()):
            raise AssertionError(f"cluster {mode}: a kernel launched "
                                 f"{r['launches']}")
        if mode == "graphed" and r["stats"]["captures"] != 1:
            raise AssertionError(f"cluster: {r['stats']['captures']} "
                                 "graphs captured, expected 1")
    ref = runs[0]["outs"]
    live = sum(not o["skipped"] for o in ref)
    g_b, e_b = runs[1]["bodies"], runs[0]["bodies"]
    R = cfg.max_ransac_rounds
    print(f"[phase17] {label} branches: RANSAC rounds run graphed "
          f"{g_b.get('round', 0)} (IF bodies), host-gated (eager, flags "
          f"read on the host) {e_b.get('round', 0)}, a masked step that "
          f"runs every round {R * len(ref)} ({R} a frame); skip side "
          f"{g_b.get('skip', 0)} and run side {g_b.get('run', 0)} for "
          f"{len(ref) - live} skipped and {live} live rows; IF nodes "
          f"{runs[1]['stats']['if_nodes']}; kernels a frame graphed "
          f"{runs[1]['kernels']} against 14604-14624 for the masked "
          f"step's graph (PERF.md)")
    if g_b != e_b or g_b.get("skip", 0) != len(ref) - live or \
            g_b.get("run", 0) != live:
        raise AssertionError(f"cluster branches: graphed {g_b}, eager "
                             f"{e_b}, rows {len(ref)} ({live} live)")
    if runs[1]["kernels"] is not None and runs[1]["kernels"] >= 14604:
        raise AssertionError(f"cluster: {runs[1]['kernels']} kernels a "
                             "frame graphed, not below the masked graph's")
    for mode, r in (("graphed", runs[1]),):
        if len(r["outs"]) != len(ref):
            raise AssertionError(f"cluster {mode}: {len(r['outs'])} rows, "
                                 f"eager {len(ref)}")
        for t, (a, b) in enumerate(zip(r["outs"], ref)):
            bad = [k for k in b if not np.array_equal(a[k], b[k])]
            if bad:
                raise AssertionError(f"cluster {mode}: frame {t + 1} parts "
                                     f"from eager in {bad}")
    print(f"[phase17] {label} eager and graphed: {len(ref)} rows bit-equal "
          f"(labels, skip flags, counts, sizes, ground flags, accepted "
          f"motions and their poses; {live} live frames, "
          f"{sum(o['n_new_clusters'] for o in ref)} clusters made); phase "
          f"12 (a)'s record ran graphed={cluster_rec.get('graphs')}, "
          f"{cluster_rec.get('captures')} capture; phase seconds "
          f"{time.perf_counter() - t_phase:.1f}")


# ---------------------------------------------------------------- phase 18
def classic_run(cfg, frames, gt, graphs: bool, kernels: dict) -> dict:
    """SlamEngine.process over the frames, graphed or eager: frames/s over
    frames 1-31 (the bootstrap out), host syncs a frame over 32-39, kernels
    a frame and busy share over the last, ATE, launches, graph stats, and
    the host ms of a tracking frame and of a keyframe frame (frames 1-31
    and 40 to the second last, a frame's wall ending in its readback)."""
    from slam_toolkit_tpu_torch.evaluation.traj import ate_rmse
    from slam_toolkit_tpu_torch.pipeline.engine import SlamEngine
    from slam_toolkit_tpu_torch.utils.timing import (count_syncs,
                                                     device_activity)
    for k in kernels.values():
        k.launches = 0
    eng = SlamEngine(cfg, device="cuda", graphs=graphs)
    step_s = []

    def run(idx):
        for i in idx:
            t0 = time.perf_counter()
            eng.process(frames[i, 0], frames[i, 1])   # ends in a readback
            step_s.append(time.perf_counter() - t0)
    n = len(frames)
    run(range(32))
    _, syncs = count_syncs(run, range(32, 40))
    run(range(40, n - 1))
    _, act = device_activity(run, range(n - 1, n))
    traj = finite_trajectory(eng, n, f"per-frame engine, graphs={graphs}")
    split = {True: [], False: []}
    for i in list(range(1, 32)) + list(range(40, n - 1)):
        split[eng.frame_stats[i]["kf"]].append(1000 * step_s[i])
    return {"eng": eng, "fps": 31 / sum(step_s[1:32]), "syncs": syncs / 8,
            "track_ms": float(np.mean(split[False])), "n_track":
            len(split[False]), "kf_ms": float(np.mean(split[True])),
            "n_kf": len(split[True]),
            "kernels": act["kernels"] if act["kernels"] else None,
            "busy": act["busy"], "ate": ate_rmse(traj, gt, align=True),
            "launches": {k: v.launches for k, v in kernels.items()},
            "stats": eng.graph_stats()}


def phase18(cfg, frames, gt, kernels: dict, label: str) -> None:
    """SlamEngine.process's programs as CUDA graphs (tracking and the
    keyframe programs) against the eager programs on phase 3's frames, in
    the order eager, graphed, graphed, eager: trajectories, flags,
    inliers and maps bit-equal; a frame's host ms split into tracking
    frames and keyframe frames."""
    from slam_toolkit_tpu_torch.pipeline.engine import _LoopPrograms
    kf_graphs = _LoopPrograms.KEYFRAME_NAMES[:4]     # no cull at this ring
    t_phase = time.perf_counter()
    runs = []
    for mode in PAIRED:
        t0 = time.perf_counter()
        r = classic_run(cfg, frames, gt, mode == "graphed", kernels)
        runs.append(r)
        e = r["eng"]
        kern = "not seen" if r["kernels"] is None else \
            f"{r['kernels']:.1f}"
        busy = "not seen" if r["busy"] is None else f"{r['busy']:.4f}"
        print(f"[phase18] {label} {mode}: frames/s {r['fps']:.2f} over "
              f"frames 1-31, ATE {r['ate']:.4f} m, keyframes "
              f"{e.n_keyframes}, mappoints {e.num_mappoints()}; host syncs "
              f"a frame {r['syncs']:.2f} (frames 32-39); kernels a frame "
              f"{kern}, busy share {busy} (frame 47, torch.profiler); "
              f"launches {r['launches']}; {time.perf_counter() - t0:.1f} s"
              + ("" if r["stats"] is None else
                 f"; {graph_line(r['stats'])}"))
        print(f"[phase18] {label} {mode}: a tracking frame "
              f"{r['track_ms']:.2f} ms (mean of {r['n_track']}), a keyframe "
              f"frame {r['kf_ms']:.2f} ms (mean of {r['n_kf']}); host wall, "
              f"frames 1-31 and 40-{len(frames) - 2}")
        if mode == "graphed" and (r["stats"]["captures"] != 6 or not all(
                e._kf.runs[n] for n in kf_graphs)):
            raise AssertionError(f"classic: {r['stats']['captures']} "
                                 f"graphs captured, expected 6 (build, "
                                 f"track, {kf_graphs}); runs "
                                 f"{e._kf.runs}")
    ref = runs[0]
    e0 = ref["eng"]
    for mode, r in zip(PAIRED[1:], runs[1:]):
        e = r["eng"]
        for what, a, b in (
                ("poses", e.trajectory, e0.trajectory),
                ("refined poses", e.trajectory_refined(),
                 e0.trajectory_refined())):
            if not np.array_equal(np.stack(a), np.stack(b)):
                bad = [i for i, (x, y) in enumerate(zip(a, b))
                       if not np.array_equal(x, y)]
                raise AssertionError(f"classic {mode}: {what} part from "
                                     f"eager at frame {bad[0]}")
        if [(s["kf"], s["inliers"]) for s in e.frame_stats] != \
                [(s["kf"], s["inliers"]) for s in e0.frame_stats]:
            raise AssertionError(f"classic {mode}: keyframe flags or "
                                 "inliers part from eager")
        bad = [f for f in e0.map._fields
               if not torch.equal(getattr(e.map, f), getattr(e0.map, f))]
        if bad:
            raise AssertionError(f"classic {mode}: map fields {bad} part")
        if r["launches"] != ref["launches"]:
            raise AssertionError(f"classic {mode} launches {r['launches']},"
                                 f" eager {ref['launches']}")
    if not ref["ate"] <= 0.138:
        raise AssertionError(f"classic: ATE {ref['ate']:.4f} m above 0.138")
    print(f"[phase18] {label} all {PAIRED} runs: {len(frames)} poses (as "
          f"processed and refined), keyframe flags, inliers and the map "
          f"bit-equal, ATE {ref['ate']:.4f} m each; launches counted from "
          f"the replays equal the eager counts {ref['launches']}; phase "
          f"seconds {time.perf_counter() - t_phase:.1f}")


# ---------------------------------------------------------------- phase 3
def run_engine(cfg, frames, chunk: int, device: str, ring=None,
               vocab=None, graphs: bool = True, cull_graphs: bool = True,
               profile_last: bool = False):
    """The engine over `frames` in chunks; the seconds of each chunk. With
    a list `ring`, the keyframes in the ring after each chunk go into it
    (read outside the chunk's time). graphs: the engine's (CUDA graphs of
    the step, the default, or the eager step); cull_graphs False runs the
    headroom culls' programs eagerly (the host's `graphs` off);
    profile_last: the last chunk under torch.profiler, graphed a frame
    a process_chunk call (the profiler records one iteration of a WHILE
    body a graph launch: a chunk of one frame is all of it), its device
    activity and frames kept in eng.smoke_profile."""
    from slam_toolkit_tpu_torch.pipeline.scan_engine import ChunkedSlamEngine
    from slam_toolkit_tpu_torch.utils.timing import device_activity
    eng = ChunkedSlamEngine(cfg, vocab=vocab, chunk_size=chunk,
                            device=device, graphs=graphs)
    eng._mapper.graphs = graphs and cull_graphs
    chunk_s = []
    starts = range(0, len(frames), chunk)
    for i in starts:
        t0 = time.perf_counter()
        if profile_last and i == starts[-1]:
            part = frames[i:i + chunk]
            calls = [part[k:k + 1] for k in range(len(part))] if graphs \
                else [part]

            def profiled():
                for c in calls:
                    eng.process_chunk(c)
            _, act = device_activity(profiled)
            eng.smoke_profile = (act, len(part))
        else:
            eng.process_chunk(frames[i:i + chunk])
        if device == "cuda":
            torch.cuda.synchronize()
        chunk_s.append(time.perf_counter() - t0)
        if ring is not None:
            ring.append(int(eng.map.kf_valid.sum()))
    eng.flush()
    return eng, chunk_s


class GatherShapes:
    """Counts the gather kernel's launches by window shape while it is
    installed (bfloat16 launches under "<shape> bf16"), from the kernel's
    own counts around each call of patches.gather_blocks_multi_cuda
    (every single-sequence gather on the card goes through it). Each
    shape's count is a cuda_lib.LaunchCount, so a CUDA graph that
    captured the call adds its launches on every replay, as it does the
    kernel's own."""

    def __init__(self):
        from slam_toolkit_tpu_torch.ops import patches
        self.patches, self.orig = patches, patches.gather_blocks_multi_cuda
        self.by_shape = {}
        patches.gather_blocks_multi_cuda = self

    @property
    def counts(self) -> dict:
        return {k: c.launches for k, c in self.by_shape.items()}

    def _launched(self) -> int:
        return self.patches.KERNEL.launches + \
            self.patches.KERNEL_BF16.launches

    def __call__(self, images, ys, xs, counts, bh: int, bw: int):
        from slam_toolkit_tpu_torch.utils.cuda_lib import LaunchCount
        n0 = self._launched()
        out = self.orig(images, ys, xs, counts, bh, bw)
        key = f"{bh}x{bw}" + (" bf16" if images[0].dtype == torch.bfloat16
                              else "")
        if key not in self.by_shape:
            self.by_shape[key] = LaunchCount()
        self.by_shape[key].add(self._launched() - n0)
        return out

    def close(self):
        self.patches.gather_blocks_multi_cuda = self.orig


class ChunkSyncs:
    """The host synchronisations (CUDA's sync debug mode) inside every
    chunk call while installed, graphed (_StaticChunk, _StaticBatchedChunk)
    or eager (make_chunk_fn(graphs=False)): (syncs, frames) a call. A
    graphed chunk's capturing call is left out (its warm-up and capture
    synchronise); `graphed` counts every graphed call, that one too. The mode is process-wide: a mapping worker's syncs
    meanwhile are counted too."""

    def __init__(self):
        from slam_toolkit_tpu_torch.pipeline import scan_engine as se
        from slam_toolkit_tpu_torch.utils.timing import count_syncs
        self.se, self.calls, self.graphed = se, [], 0
        self.orig = (se._StaticChunk.__call__, se._eager_chunk)
        calls, (orig_call, orig_eager) = self.calls, self.orig

        def call(chunk, carry, images):
            if images.is_cuda:
                self.graphed += 1
            if images.is_cuda and chunk.graphs is None:
                return orig_call(chunk, carry, images)
            out, n = count_syncs(orig_call, chunk, carry, images)
            calls.append((n, images.shape[0]))
            return out

        def eager(body):
            run = orig_eager(body)

            def counted(carry, images):
                out, n = count_syncs(run, carry, images)
                calls.append((n, images.shape[0]))
                return out
            return counted
        se._StaticChunk.__call__ = call
        se._eager_chunk = eager

    def close(self):
        self.se._StaticChunk.__call__, self.se._eager_chunk = self.orig

    @property
    def syncs(self) -> int:
        return sum(n for n, _ in self.calls)

    def line(self) -> str:
        frames = sum(f for _, f in self.calls)
        return (f"host syncs inside the chunks {self.syncs} over {frames} "
                f"frames ({self.syncs / max(frames, 1):.2f} a frame; "
                f"per call {[n for n, _ in self.calls]})")


def if_runs_line(eng, syncs: ChunkSyncs, what: str) -> str:
    """A graphed engine's keyframe IF body runs against its rows'
    keyframe column, and the syncs inside its chunks: both must hold (0
    syncs, a run a keyframe row); an eager engine's syncs alone."""
    st = eng._chunk.graph_stats() if hasattr(eng._chunk, "graphs") \
        else None
    if st is None:
        return f"eager: {syncs.line()}"
    kf = sum(s["kf"] for s in eng.frame_stats[1:])
    runs = st["if_runs"].get("keyframe", 0)
    if syncs.syncs or runs != kf:
        raise AssertionError(f"{what}: {syncs.line()}; keyframe IF body "
                             f"runs {runs} for {kf} keyframe rows")
    scan = scan_line(st, syncs.graphed, len(eng.frame_stats) - 1, what)
    return (f"graphed, the frames a WHILE node, the keyframe event an IF "
            f"node: {syncs.line()}; IF body runs {runs} = keyframe rows {kf} "
            f"of {len(eng.frame_stats) - 1} frames; {scan}")


def scan_line(st: dict, chunks: int, frames: int, what: str) -> str:
    """A graphed chunk function's launches and WHILE iterations: one
    launch of the graph "chunk" a chunk call and one iteration a frame,
    one WHILE node; raises otherwise (nothing falls back to a replay a
    frame)."""
    launches = st["replays"].get("chunk", 0)
    iters = st["while_runs"].get("frame", 0)
    if st["while_nodes"] != 1 or launches != chunks or iters != frames or \
            set(st["replays"]) != {"chunk"}:
        raise AssertionError(f"{what}: graph launches {st['replays']} for "
                             f"{chunks} chunks, {st['while_nodes']} WHILE "
                             f"nodes, iterations {st['while_runs']} for "
                             f"{frames} frames")
    return (f"graph launches {launches} = chunks {chunks} (one a chunk), "
            f"WHILE body iterations {iters} = frames {frames}")


def drive(cfg, frames, chunk: int, kernels: dict, ring=None,
          graphs: bool = True, cull_graphs: bool = True,
          profile_last: bool = False):
    """One path on the card: every kernel's count set to 0 just before,
    read just after; the gather's launches by window shape too. The
    engine keeps the host syncs inside its chunks (`smoke_syncs`, a
    ChunkSyncs) and, with profile_last, its last chunk's device activity
    under torch.profiler (`smoke_profile`)."""
    for k in kernels.values():
        k.launches = 0
    shapes = GatherShapes()
    syncs = ChunkSyncs()
    try:
        eng, chunk_s = run_engine(cfg, frames, chunk, "cuda", ring,
                                  graphs=graphs, cull_graphs=cull_graphs,
                                  profile_last=profile_last)
    finally:
        shapes.close()
        syncs.close()
    eng.smoke_syncs = syncs
    return eng, chunk_s, {n: k.launches for n, k in kernels.items()}, \
        shapes.counts


def finite_trajectory(eng, n: int, what: str):
    traj = eng.trajectory_refined()
    if len(traj) != n or not all(np.isfinite(T).all() for T in traj):
        raise AssertionError(f"{what}: trajectory missing frames or not "
                             "finite")
    return traj


def translations_m(eng_a, eng_b, n: int):
    return [float(np.linalg.norm(a[:3, 3] - b[:3, 3]))
            for a, b in zip(eng_a.trajectory[:n], eng_b.trajectory[:n])]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    # ---- phase 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from slam_toolkit_tpu_torch.utils import cuda_lib
    card = card_line()
    label = f"[{card}]"
    driver = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=driver_version",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"[phase1] card: {card}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, driver {driver}; torch binds "
          f"CUDAGraph.begin_capture_to_if_node: "
          f"{hasattr(torch.cuda.CUDAGraph, 'begin_capture_to_if_node')} "
          f"(the port adds its IF nodes through csrc/graph_cond.cu)")
    t0 = time.perf_counter()
    lib = cuda_lib.library()
    print(f"[phase1] kernels built in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {lib.build_seconds:.2f} s) -> {lib.path.name}")
    print(lib.build_log)

    # ---- phase 2
    rows = phase2(torch.device("cuda"))
    for r in rows:
        lib_ms = "none" if r["library_ms"] is None else \
            f"{r['library_ms']:.4f} ms"
        print(f"[phase2] {label} {r['name']}: kernel {r['ms']:.4f} ms "
              f"(device), wrapper {r['host_ms']:.4f} ms (host), plain "
              f"{r['plain_ms']:.4f} ms (one call), library {lib_ms}, bound "
              f"{r['bound_ms']:.6f} ms ({r['bound_by']})")
    kernels = {r["name"]: r["kernel"] for r in rows}
    ba_phases(torch.device("cuda"),
              next(r["ms"] for r in rows if r["name"] == "local_ba"))
    from slam_toolkit_tpu_torch.ops import ba_kernel, pose_lm_kernel
    print(f"[phase2] one launch holds: local BA "
          f"{ba_kernel.max_points(8, torch.cuda.current_device())} points "
          f"at W=8, pose LM {pose_lm_kernel.max_obs()} observations")

    # ---- phase 3: the main path (SlamConfig(); FAST+NMS a launch a frame)
    from slam_toolkit_tpu_torch.config import SlamConfig
    from slam_toolkit_tpu_torch.evaluation.traj import ate_rmse
    from slam_toolkit_tpu_torch.ops.extractor import level_budgets
    from slam_toolkit_tpu_torch.tools.bench import stage_frames
    cfg = SlamConfig()
    t0 = time.perf_counter()
    frames, gt = stage_frames(cfg, 48)
    print(f"[phase3] staged {len(frames)} stereo pairs "
          f"{frames.shape[-1]}x{frames.shape[-2]} in "
          f"{time.perf_counter() - t0:.1f} s")
    cap = MatchCapture(call=len(frames) // 2)
    try:
        eng, chunk_s, launches, _ = drive(cfg, frames, 16, kernels)
    finally:
        cap.close()
    traj = finite_trajectory(eng, len(frames), "main path")
    ok = [s["ok"] for s in eng.frame_stats[1:]]
    ok_frac = float(np.mean(ok))
    n_kf = eng.n_keyframes
    n_lm = int(eng.map.mp_valid.sum())
    ate = ate_rmse(traj, gt, align=True)
    steady = sum(chunk_s[1:])
    print(f"[phase3] {label} frames/s {len(frames) / sum(chunk_s):.2f} over "
          f"all 3 chunks, {32 / steady:.2f} over chunks 2-3 "
          f"(chunk seconds {[round(c, 3) for c in chunk_s]})")
    print(f"[phase3] {label} ATE {ate:.4f} m (bound 0.138), keyframes "
          f"{n_kf}, landmarks {n_lm}, tracking ok on {ok_frac * 100:.1f}% "
          f"of frames")
    print(f"[phase3] {label} launches {launches}")
    print(f"[phase3] {label} graphs: {graph_line(eng._chunk.graph_stats())}")
    print(f"[phase3] {label} "
          f"{if_runs_line(eng, eng.smoke_syncs, 'main path')}")
    if n_kf < 2:
        raise AssertionError(f"only {n_kf} keyframes")
    if ok_frac < 0.9:
        raise AssertionError(f"tracking ok on only {ok_frac:.2f} of frames")
    missing = [n for n, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: "
                             f"{missing}")
    if launches["local_ba"] != n_kf - 1:
        raise AssertionError(f"local BA launched {launches['local_ba']} "
                             f"times for {n_kf - 1} keyframes after the "
                             "bootstrap")
    n_levels = sum(1 for b in level_budgets(cfg.extractor) if b > 0)
    for name, what in (("patch_gather", "the gather"),
                       ("fast_nms", f"FAST+NMS of {n_levels} levels")):
        if launches[name] != len(frames):
            raise AssertionError(f"{what} launched {launches[name]} times "
                                 f"for {len(frames)} frames, expected one "
                                 "a frame")
    if not ate <= 0.138:
        raise AssertionError(f"ATE {ate:.4f} m above 0.138 m")
    main_path = {"fps": len(frames) / sum(chunk_s), "n_kf": n_kf,
                 "n_lm": n_lm, "ate": ate}
    check_topk2_frame(cap, next(r["ms"] for r in rows
                                if r["name"] == "topk2_match"), label)

    # ---- phase 4: the same frames through the plain detector
    from slam_toolkit_tpu_torch.ops import fast_kernel
    kernel_route = fast_kernel.detect_levels
    fast_kernel.detect_levels = fast_kernel.detect_levels_plain
    try:
        eng_p, chunk_p, launches_p, _ = drive(cfg, frames, 16, kernels)
    finally:
        fast_kernel.detect_levels = kernel_route
    kf_main = [s["kf"] for s in eng.frame_stats]
    kf_plain = [s["kf"] for s in eng_p.frame_stats]
    dt_p = translations_m(eng, eng_p, len(frames))
    print(f"[phase4] {label} plain FAST: frames/s "
          f"{32 / sum(chunk_p[1:]):.2f} over chunks 2-3 (the main path "
          f"{32 / steady:.2f}), launches {launches_p}, max |t_plain - "
          f"t_main| {max(dt_p)} m")
    print(f"[phase4] {label} "
          f"{if_runs_line(eng_p, eng_p.smoke_syncs, 'plain FAST')}")
    if launches_p != dict(launches, fast_nms=0):
        raise AssertionError(f"the plain route's launches {launches_p}, "
                             f"the main path's {launches} but FAST's")
    if kf_plain != kf_main:
        raise AssertionError("the plain detector changed the keyframe "
                             "decisions")
    if max(dt_p) > 1e-4:
        raise AssertionError(f"the plain detector moved a frame by "
                             f"{max(dt_p)} m")

    # ---- phase 5: the CPU path
    cpu_eng, _ = run_engine(cfg, frames[:8], 8, "cpu")
    kf_gpu = [s["kf"] for s in eng.frame_stats[:8]]
    kf_cpu = [s["kf"] for s in cpu_eng.frame_stats[:8]]
    dt = translations_m(eng, cpu_eng, 8)
    print(f"[phase5] keyframe flags cuda {kf_gpu} cpu {kf_cpu}")
    print(f"[phase5] |t_cuda - t_cpu| per frame (m): "
          f"{[round(d, 6) for d in dt]}")
    if max(dt) > 0.25:
        raise AssertionError(f"CUDA and CPU paths diverge: {max(dt):.3f} m")

    # ---- phase 6: the same frames past a small keyframe ring's capacity
    cap_kf, chunk_c = 19, 8
    cfg_c = cfg.replace(
        map=dataclasses.replace(cfg.map, max_keyframes=cap_kf),
        keyframe=dataclasses.replace(cfg.keyframe, decay_ratio=0.9))
    ring = []
    eng_c, chunk_cs, launches_c, _ = drive(cfg_c, frames, chunk_c, kernels,
                                           ring)
    ate_c = ate_rmse(finite_trajectory(eng_c, len(frames), "capacity"), gt,
                     align=True)
    print(f"[phase6] {label} ring of {cap_kf}, decay_ratio 0.9, chunks of "
          f"{chunk_c}: keyframes {eng_c.n_keyframes}, culls {eng_c.n_culls}, "
          f"ring after each chunk {ring}, ATE {ate_c:.4f} m (bound 0.138), "
          f"frames/s {len(frames) / sum(chunk_cs):.2f}, launches {launches_c}")
    print(f"[phase6] {label} "
          f"{if_runs_line(eng_c, eng_c.smoke_syncs, 'capacity')}")
    if max(ring) > cap_kf:
        raise AssertionError(f"the ring held {max(ring)} > {cap_kf}")
    if eng_c.n_culls < 2:
        raise AssertionError(f"only {eng_c.n_culls} culls")
    if not ate_c <= 0.138:
        raise AssertionError(f"capacity run: ATE {ate_c:.4f} m above 0.138")
    # the culls' programs as CUDA graphs against their eager bodies
    cull_st = eng_c._mapper.graph_stats()
    cull_runs = eng_c._mapper._kf.runs
    ring_e = []
    eng_e, _, launches_e, _ = drive(cfg_c, frames, chunk_c, kernels, ring_e,
                                    cull_graphs=False)
    print(f"[phase6] {label} cull programs: runs {cull_runs}, "
          f"{graph_line(cull_st)}; eager culls: culls {eng_e.n_culls}, "
          f"launches {launches_e}")
    if cull_runs["cull"] < 2 or cull_st is None or \
            cull_st["captures"] != len([n for n, v in cull_runs.items()
                                        if v]):
        raise AssertionError(f"culls not run through their graphs: "
                             f"{cull_runs}, {cull_st}")
    if eng_e.n_culls != eng_c.n_culls or ring_e != ring or \
            launches_e != launches_c or \
            not np.array_equal(engine_rows(eng_e), engine_rows(eng_c)):
        raise AssertionError("the graphed culls part from the eager ones")
    bad = [f for f in eng_c.map._fields
           if not torch.equal(getattr(eng_c.map, f), getattr(eng_e.map, f))]
    if bad:
        raise AssertionError(f"graphed culls: map fields {bad} part")
    print(f"[phase6] {label} the {eng_c.n_culls} culls through their CUDA "
          f"graphs and eagerly: rows, ring, launches and map bit-equal")

    # ---- phase 7: the hybrid tracker on the same frames
    cfg_h = cfg.replace(tracker=dataclasses.replace(cfg.tracker,
                                                    method="hybrid"))
    eng_h, chunk_hs, launches_h, shapes_h = drive(cfg_h, frames, 16, kernels)
    ate_h = ate_rmse(finite_trajectory(eng_h, len(frames), "hybrid"), gt,
                     align=True)
    ok_h = float(np.mean([s["ok"] for s in eng_h.frame_stats[1:]]))
    n8 = shapes_h.get("8x8", 0)
    print(f"[phase7] {label} hybrid: ATE {ate_h:.4f} m (bound 0.150), "
          f"tracking ok on {100 * ok_h:.1f}% of frames, keyframes "
          f"{eng_h.n_keyframes}, frames/s over chunks 2-3 "
          f"{32 / sum(chunk_hs[1:]):.2f}, launches {launches_h}, gather by "
          f"window {shapes_h} ({n8 / (len(frames) - 1):.2f} 8x8 a frame)")
    print(f"[phase7] {label} "
          f"{if_runs_line(eng_h, eng_h.smoke_syncs, 'hybrid')}")
    if ok_h < 0.9:
        raise AssertionError(f"hybrid: tracking ok on only {ok_h:.2f}")
    if not ate_h <= 0.150:
        raise AssertionError(f"hybrid: ATE {ate_h:.4f} m above 0.150")
    if n8 == 0:
        raise AssertionError("hybrid: the gather never launched at 8x8")

    # ---- phase 8: the direct tracker on the first 16 frames
    cfg_d = cfg.replace(tracker=dataclasses.replace(cfg.tracker,
                                                    method="direct"))
    n_d = 16
    eng_d, chunk_ds, launches_d, shapes_d = drive(cfg_d, frames[:n_d], 16,
                                                  kernels)
    ate_d = ate_rmse(finite_trajectory(eng_d, n_d, "direct"), gt[:n_d],
                     align=True)
    n8 = shapes_d.get("8x8", 0)
    print(f"[phase8] {label} direct, {n_d} frames: ATE {ate_d:.4f} m (not "
          f"gated), keyframes {eng_d.n_keyframes}, tracking ok on "
          f"{100 * np.mean([s['ok'] for s in eng_d.frame_stats[1:]]):.1f}%, "
          f"{sum(chunk_ds):.2f} s, launches {launches_d}, gather by window "
          f"{shapes_d} ({n8 / (n_d - 1):.1f} 8x8 a frame)")
    print(f"[phase8] {label} "
          f"{if_runs_line(eng_d, eng_d.smoke_syncs, 'direct')}")
    if n8 == 0:
        raise AssertionError("direct: the gather never launched at 8x8")
    if launches_d["pose_lm"] != 0:
        raise AssertionError(f"direct: the pose LM launched "
                             f"{launches_d['pose_lm']} times")

    # ---- phase 10: loop closing at full width
    loop = phase10(cfg, kernels, rows, label)

    # ---- phase 11: the per-frame engine, checkpoint/resume, the runner
    classic = phase11(cfg, frames, gt, kernels, label, main_path)

    # ---- phase 12: the dense motion-clustering workload
    cluster, cluster_rec = phase12(kernels, label)

    # ---- phase 13: multi-sequence lanes, in turn and batched
    dp = phase13(cfg, frames, loop["frames"], kernels, label)

    # ---- phase 14: CUDA graphs against the eager step
    phase14(cfg, frames, kernels, label, dp)

    # ---- phase 15: the option sets
    opt_rows, opt_launches, opt_dp = phase15(cfg, frames, gt, kernels, loop,
                                             label)

    # ---- phase 16: the pipelined schedule (queue depth 2, mapping worker)
    pipe = phase16(cfg, frames, loop, kernels, label)

    # ---- phase 17: the cluster tracker's step as one CUDA graph
    phase17(kernels, label, cluster_rec)

    # ---- phase 18: SlamEngine.process's programs as CUDA graphs
    phase18(cfg, frames, gt, kernels, label)

    # ---- phase 9
    keys = ("max_abs_err", "ms", "host_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    table = [{"name": r["name"], "route": "cuda", "source": r["source"],
              "replaces": r["replaces"], "launches": launches[r["name"]],
              **{k: r[k] for k in keys},
              "launches_loop": loop["launches"][r["name"]],
              "launches_classic": classic[r["name"]],
              "launches_cluster": cluster[r["name"]],
              "launches_dp": dp["launches"][r["name"]]} for r in rows]
    # the batched entries' own path is phase 13's batched layout (the
    # 8x8 gather's its batched hybrid run; launches_dp is the indirect
    # batched run's on every row)
    table += [{"name": r["name"], "route": "cuda", "source": r["source"],
               "replaces": r["replaces"], "launches": r["launches"],
               **{k: r[k] for k in keys}, "launches_loop": 0,
               "launches_classic": 0, "launches_cluster": 0,
               "launches_dp": dp["shapes_v"].get(r["name"], 0)
               if r["name"] == "patch_gather_batched_8x8"
               else r["launches"]} for r in dp["rows"]]
    # the bfloat16 entries' own paths are phase 15's O3 run and its
    # batched O3 lanes
    table += [{"name": r["name"], "route": "cuda", "source": r["source"],
               "replaces": r["replaces"],
               "launches": (opt_launches["O3"] if "batched" not in r["name"]
                            else opt_dp["O3"])[r["name"]],
               **{k: r[k] for k in keys}, "launches_loop": 0,
               "launches_classic": 0, "launches_cluster": 0,
               "launches_dp": 0} for r in opt_rows.values()]
    for t in table:
        for name in OPTION_NAMES:
            t[f"launches_{name.lower()}"] = \
                opt_launches[name].get(t["name"], 0)
        for name, dp_l in opt_dp.items():
            t[f"launches_{name.lower()}_batched"] = dp_l.get(t["name"], 0)
        if t["name"] == "topk2_match":
            t["launches_loop_closer"] = loop["closer"]
        t["launches_loop_pipelined"] = pipe["launches"].get(t["name"], 0)
        for name, run in dp["photo"].items():
            t[f"launches_dp_{name}"] = run["cap"].shape_counts.get(
                t["name"], 0) if t["name"] == "patch_gather_batched_8x8" \
                else run["launches"].get(t["name"], 0)
    print(card)
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
