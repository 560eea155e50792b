"""The CUDA kernels against their plain versions, on an NVIDIA GPU.

Marked `cuda`: they skip on a host without CUDA (as the CPU test runs
are). On a GPU host, without jax installed, run them with

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py

(the suite's conftest imports jax). They cover the edge cases of each
kernel at small and ragged shapes; chip_smoke.py covers the main path's
shapes. This file imports no jax.
"""

import numpy as np
import pytest
import torch
from torch_ba_problems import as_float64, ba_problem as _ba_problem

pytestmark = pytest.mark.cuda
torch.set_num_threads(1)


# seconds a test may take on the card, its kernels' first build included
TIME_LIMIT_S = 300


@pytest.fixture(autouse=True)
def time_limit():
    """A hard time limit on every test: a chunk's CUDA graph whose WHILE
    flag went stale would loop on the card for ever, and the host would
    wait on it in a synchronise that no signal interrupts. faulthandler's
    watchdog thread prints every thread's stack and ends the process."""
    import faulthandler
    faulthandler.dump_traceback_later(TIME_LIMIT_S, exit=True)
    yield
    faulthandler.cancel_dump_traceback_later()


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _dev(a, dev):
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32
                            else a).to(dev)


def _i32(a, dev):
    return _dev(np.asarray(a, np.int32), dev)


def test_gather_blocks_cuda_exact(dev):
    from slam_toolkit_tpu_torch.ops import patches
    rng = np.random.default_rng(0)
    h, w = 70, 301
    img = _dev(rng.uniform(0, 255, (h, w)).astype(np.float32), dev)
    for bh, bw, k in [(31, 31, 37), (8, 8, 5), (11, 113, 300)]:
        ys = rng.integers(0, h - bh + 1, k)
        xs = rng.integers(0, w - bw + 1, k)
        ys[0], xs[0] = h - bh, w - bw
        ys_t, xs_t = _i32(ys, dev), _i32(xs, dev)
        n0 = patches.KERNEL.launches
        out = patches.gather_blocks(img, ys_t, xs_t, bh, bw)
        assert patches.KERNEL.launches == n0 + 1
        torch.testing.assert_close(out, patches.gather_blocks_plain(
            img, ys_t, xs_t, bh, bw), rtol=0, atol=0)


def test_gather_blocks_multi_cuda_exact(dev):
    """Several images in one launch, exactly the per-image plain gather:
    ragged counts, an image with no window, corners outside each image
    (clamped), windows wider than a warp; one launch counted."""
    from slam_toolkit_tpu_torch.ops import patches
    rng = np.random.default_rng(4)
    shapes, counts = [(376, 1241), (70, 301), (45, 40), (90, 200)], \
        [434, 0, 3, 77]
    imgs = [_dev(rng.uniform(0, 255, s).astype(np.float32), dev)
            for s in shapes]
    for bh, bw in [(31, 31), (37, 37), (8, 8)]:
        ys = _i32(rng.integers(-10, 380, sum(counts)), dev)
        xs = _i32(rng.integers(-10, 1250, sum(counts)), dev)
        n0 = patches.KERNEL.launches
        out = patches.gather_blocks_multi(imgs, ys, xs, counts, bh, bw)
        assert patches.KERNEL.launches == n0 + 1
        ref = patches.gather_blocks_multi_plain(imgs, ys, xs, counts, bh, bw)
        assert out.shape == (sum(counts), bh, bw)
        assert torch.equal(out, ref)


@pytest.mark.parametrize("n", [1, 517, 3072])
@pytest.mark.parametrize("hw", [(376, 1241), (81, 268)])
def test_gather_8x8_cuda_direct_shapes(dev, hw, n):
    """Direct LM's windows (optim/direct_lm._pattern_samples): 8x8 at N
    landmarks on a full-size level and on the direct pyramid's coarsest,
    corners past every border (clamped) and on each edge; exact, one
    launch. Then the pattern samples built on the kernel's windows equal
    those built on the plain gather's."""
    from slam_toolkit_tpu_torch.ops import patches
    from slam_toolkit_tpu_torch.optim import direct_lm
    rng = np.random.default_rng(n)
    h, w = hw
    img = _dev(rng.uniform(0, 255, (h, w)).astype(np.float32), dev)
    ys = rng.integers(-20, h + 20, n)
    xs = rng.integers(-20, w + 20, n)
    edges = [(-9, 5), (h - 8, 7), (h + 3, w + 3), (4, -1), (11, w - 8),
             (0, 0), (h - 8, w - 8)]
    for i, (y, x) in enumerate(edges[:n]):
        ys[i], xs[i] = y, x
    ys_t, xs_t = _i32(ys, dev), _i32(xs, dev)
    n0 = patches.KERNEL.launches
    out = patches.gather_blocks(img, ys_t, xs_t, 8, 8)
    assert patches.KERNEL.launches == n0 + 1
    assert torch.equal(out, patches.gather_blocks_plain(img, ys_t, xs_t, 8,
                                                        8))
    uv = _dev(np.stack([rng.uniform(-30, w + 30, n),
                        rng.uniform(-30, h + 30, n)], -1).astype(np.float32),
              dev)
    got = direct_lm._pattern_samples(img, uv)
    real = patches.gather_blocks
    try:
        patches.gather_blocks = patches.gather_blocks_plain
        ref = direct_lm._pattern_samples(img, uv)
    finally:
        patches.gather_blocks = real
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def test_gather_blocks_cuda_image_limit(dev):
    """The C side takes as many images as the wrapper allows (it refuses
    more, and the wrapper would raise), and the wrapper refuses one more."""
    from slam_toolkit_tpu_torch.ops import patches
    img = torch.ones((40, 40), device=dev)
    n = patches.MAX_IMAGES
    ys = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    out = patches.gather_blocks_multi([img] * n, ys[:n], ys[:n], [1] * n, 31,
                                      31)
    assert out.shape == (n, 31, 31) and bool((out == 1).all())
    with pytest.raises(ValueError, match="images"):
        patches.gather_blocks_multi([img] * (n + 1), ys, ys, [1] * (n + 1),
                                    31, 31)


def _topk2_edges(m, n, r, seed, w=1241, h=376):
    """Queries and keypoints on a w x h image with the matcher's edge
    cases, as far as N allows: keypoints exactly at distance r and 2r
    (and just beyond 2r), outside the image, at -1e7 and +1e7, with NaN
    coordinates; equal Hamming distances in different grid cells, the
    lower column placed where the grid visits it last; queries at +1e7,
    NaN, outside the image, and one with no keypoint within 2r."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 2 ** 32, (m, 8), dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint64).astype(np.uint32)
    a_uv = np.round(rng.uniform(0, [w, h], (m, 2)))
    b_xy = rng.uniform(0, [w, h], (n, 2))
    k = min(m, n) // 3
    b[:k] = a[:k] ^ (rng.random((k, 8)) < 0.1).astype(np.uint32)
    b_xy[:k] = a_uv[:k] + rng.normal(0, r, (k, 2))
    # exact distances from query 0..: r and 2r on the axes and the 3-4-5
    # diagonal, and 2r + 0.5 (outside)
    offs = np.array([[2 * r, 0], [0, -2 * r], [-1.2 * r, 1.6 * r],
                     [r, 0], [0.6 * r, -0.8 * r], [2 * r + 0.5, 0]])
    specials = [(i % m, a_uv[i % m] + o) for i in range(4) for o in offs]
    # equal distances (64 bits) in different cells of a query with no
    # near-duplicate: the lowest column (placed first) lies to the right,
    # the others left and below
    q = min(k, m - 8)
    for o in ([1.9 * r, 0.0], [-1.9 * r, 0.0], [0.0, 1.7 * r],
              [-1.3 * r, -1.3 * r]):
        specials.append((q, a_uv[q] + np.array(o), a[q] ^ np.uint32(0xF0F)))
    far = [[-30.0, 100.0], [w + 40.0, 10.0], [500.0, -20.0], [-1e7, -1e7],
           [1e7, 1e7], [1e7, 3.0], [np.nan, 50.0], [60.0, np.nan]]
    j = k
    for s in specials:
        if j >= n:
            break
        b_xy[j] = s[1]
        if len(s) == 3:
            b[j] = s[2]
        j += 1
    for xy in far:
        if j >= n:
            break
        b_xy[j] = xy
        j += 1
    # queries: invisible, NaN, outside the image, and one alone
    a_uv[-7:-3] = 1e7
    a_uv[-3] = [np.nan, 10.0]
    a_uv[-2] = [-60.0, 200.0]
    a_uv[-1] = [w / 2, h + 20 * r + 500]
    return (a, b, a_uv.astype(np.float32), b_xy.astype(np.float32))


@pytest.mark.parametrize("n", [1, 777, 2048, 4096])
@pytest.mark.parametrize("r", [5.0, 20.0, 50.0])
def test_topk2_cuda_exact_edges(dev, r, n):
    """Every column exact against the plain version, M = 203 (not a
    multiple of a block's 24 rows), at the edge cases of _topk2_edges."""
    from slam_toolkit_tpu_torch.ops import match_kernel as mk
    t = [_dev(x, dev) for x in _topk2_edges(203, n, r, seed=int(r) + n)]
    n0 = mk.KERNEL.launches
    out = mk.topk2_match(*t, r)
    assert mk.KERNEL.launches == n0 + 1
    ref = mk.topk2_match_plain(*t, r)
    assert torch.equal(out, ref)
    assert float(ref[-1, 3]) == mk.BIG                 # the lone query
    if n > 100:
        assert int((ref[:, 0] < 1e8).sum()) > 10


@pytest.mark.parametrize("r", [10.0, 50.0, 100.0])
def test_topk2_cuda_loop_closer_shapes(dev, r):
    """The loop closer's calls: M = 4096 landmark rows (relpose_landmarks)
    against N = 2048 keypoints at the merge's r = 10, the relative pose's
    r = 50 and relocalization's r = 100 (2 x projection_radius); a third
    of the rows invisible, as unmatched group landmarks are. Every column
    exact, one launch; two launches agree bit for bit."""
    from slam_toolkit_tpu_torch.ops import match_kernel as mk
    a, b, a_uv, b_xy = _topk2_edges(4096, 2048, r, seed=int(r))
    a_uv[::3] = 1e7
    t = [_dev(x, dev) for x in (a, b, a_uv, b_xy)]
    n0 = mk.KERNEL.launches
    out = mk.topk2_match(*t, r)
    assert mk.KERNEL.launches == n0 + 1
    ref = mk.topk2_match_plain(*t, r)
    assert torch.equal(out, ref)
    assert int((ref[:, 0] < 1e8).sum()) > 100
    assert torch.equal(mk.topk2_match(*t, r), out)


@pytest.mark.parametrize("r", [5.0, 20.0, 50.0])
def test_topk2_cuda_grid_drops_no_pair(dev, r):
    """The grid only pre-filters: with every descriptor equal, every pair
    has Hamming distance 0, so each row's argbest is the lowest column
    inside its gate and its second-best says whether a second one is.
    Keypoints on a lattice of half-pixel steps, queries on integers, so
    many pairs lie exactly at distance r and 2r and on cell edges."""
    from slam_toolkit_tpu_torch.ops import match_kernel as mk
    rng = np.random.default_rng(int(r))
    m, n, w, h = 500, 4096, 1241, 376
    desc = rng.integers(0, 2 ** 32, (1, 8), dtype=np.uint64).astype(np.uint32)
    b_xy = np.round(rng.uniform(0, [w, h], (n, 2)) * 2) / 2
    a_uv = np.round(rng.uniform(0, [w, h], (m, 2)))
    b_xy[:m] = a_uv + rng.choice([-2 * r, -r, r, 2 * r], (m, 2)) * \
        (rng.random((m, 1)) < 0.5)
    t = [_dev(np.repeat(desc, m, 0), dev), _dev(np.repeat(desc, n, 0), dev),
         _dev(a_uv.astype(np.float32), dev), _dev(b_xy.astype(np.float32),
                                                  dev)]
    out = mk.topk2_match(*t, r)
    ref = mk.topk2_match_plain(*t, r)
    assert torch.equal(out, ref)
    assert int((ref[:, 4] == 0).sum()) > m // 4


def test_topk2_cuda_exact_ragged(dev):
    """N not a multiple of a warp's 32 lanes, M not a multiple of a
    block's 24 rows, ties at the best distance, empty gates."""
    from slam_toolkit_tpu_torch.ops import match_kernel as mk
    rng = np.random.default_rng(1)
    m, n = 203, 777
    a = rng.integers(0, 2 ** 32, (m, 8), dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint64).astype(np.uint32)
    b[:100] = a[:100] ^ (rng.random((100, 8)) < 0.1).astype(np.uint32)
    b[100:110] = b[:10]
    a_uv = rng.uniform(0, [300, 200], (m, 2)).astype(np.float32)
    b_xy = rng.uniform(0, [300, 200], (n, 2)).astype(np.float32)
    b_xy[:100] = a_uv[:100] + rng.normal(0, 8, (100, 2))
    b_xy[100:110] = b_xy[:10]
    a_uv[-5:] = 1e7
    t = [_dev(x, dev) for x in (a, b, a_uv, b_xy)]
    out = mk.topk2_match(*t, 20.0)
    ref = mk.topk2_match_plain(*t, 20.0)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)


@pytest.mark.parametrize("n", [1, 517, 3072, 4099])
def test_pose_lm_cuda_matches_plain(dev, n):
    """Ragged N over the 8 CTAs of the cluster (N = 1 leaves seven of
    them empty; its one observation is masked), the main path's 3072."""
    from slam_toolkit_tpu_torch.config import TrackerConfig
    from slam_toolkit_tpu_torch.geometry import se3
    from slam_toolkit_tpu_torch.ops import pose_lm_kernel as plk
    rng = np.random.default_rng(2)
    Xw = np.stack([rng.uniform(-20, 20, n), rng.uniform(-5, 5, n),
                   rng.uniform(4, 60, n)], -1).astype(np.float32)
    T_true = se3.exp(torch.from_numpy(
        rng.uniform(-0.2, 0.2, 6).astype(np.float32))).numpy()
    Xc = Xw @ T_true[:3, :3].T + T_true[:3, 3]
    z = (Xc[:, :2] / Xc[:, 2:3]).astype(np.float32)
    z[:50] += 0.3                                       # gross outliers
    mask = np.ones(n, bool)
    mask[::11] = False
    args = [torch.eye(4, device=dev)] + [
        _dev(x, dev) for x in (Xw, z, np.full(n, 1e-6, np.float32), mask)]
    n0 = plk.KERNEL.launches
    out = plk.optimize_pose(*args, TrackerConfig())
    assert plk.KERNEL.launches == n0 + 1
    ref = plk.optimize_pose_plain(*args, TrackerConfig())
    torch.testing.assert_close(out.T_cw, ref.T_cw, rtol=0, atol=2e-3)
    fin = torch.isfinite(ref.inlier_r2)
    assert torch.equal(torch.isfinite(out.inlier_r2), fin)
    torch.testing.assert_close(out.inlier_r2[fin], ref.inlier_r2[fin],
                               rtol=5e-2, atol=1e-4)
    # a second launch repeats bit for bit (fixed-order reductions)
    again = plk.optimize_pose(*args, TrackerConfig())
    assert torch.equal(again.T_cw, out.T_cw)
    assert torch.equal(again.inlier_r2, out.inlier_r2)


def test_pose_lm_cuda_refuses_too_many(dev):
    from slam_toolkit_tpu_torch.config import TrackerConfig
    from slam_toolkit_tpu_torch.ops import pose_lm_kernel as plk
    n = plk.max_obs() + 1
    args = [torch.eye(4, device=dev), torch.ones((n, 3), device=dev),
            torch.zeros((n, 2), device=dev), torch.ones(n, device=dev),
            torch.ones(n, dtype=torch.bool, device=dev)]
    with pytest.raises(ValueError, match="observations"):
        plk.optimize_pose(*args, TrackerConfig())


def test_sad_curve_cuda_matches_plain(dev):
    from slam_toolkit_tpu_torch.ops import stereo_sad as sad
    rng = np.random.default_rng(3)
    h, w, k, max_disp = 50, 200, 77, 37
    img_l, img_r = (_dev(np.round(rng.uniform(0, 255, (h, w)))
                         .astype(np.float32), dev) for _ in range(2))
    side, sw = 2 * sad.WIN + 1, sad._strip_w(max_disp)
    args = (img_l, img_r, _i32(rng.integers(0, h - side + 1, k), dev),
            _i32(rng.integers(0, w - side + 1, k), dev),
            _i32(rng.integers(0, w - sw + 1, k), dev), max_disp)
    torch.testing.assert_close(sad.sad_curve(*args),
                               sad.sad_curve_plain(*args),
                               rtol=1e-5, atol=1e-3)


def _sad_args(dev, h, w, k, max_disp, seed):
    """Random corners for the SAD curves, the first 8 of them outside the
    image on each of its four edges (the kernel clamps them)."""
    from slam_toolkit_tpu_torch.ops import stereo_sad as sad
    rng = np.random.default_rng(seed)
    img_l, img_r = (_dev(np.round(rng.uniform(0, 255, (h, w)))
                         .astype(np.float32), dev) for _ in range(2))
    side, sw = 2 * sad.WIN + 1, sad._strip_w(max_disp)
    ys = rng.integers(-20, h + 20, k)
    xl = rng.integers(-20, w + 20, k)
    xs = rng.integers(-20, w + 20, k)
    edges = [(-7, -9, -30), (h - 3, w - 2, w), (0, w - side + 4, -1),
             (h - side + 6, 0, w - sw + 9)]
    for i, (y, a, b) in enumerate(edges * 2):
        if i < k:
            ys[i], xl[i], xs[i] = y, a, b
    return (img_l, img_r, _i32(ys, dev), _i32(xl, dev), _i32(xs, dev),
            max_disp)


@pytest.mark.parametrize("k", [0, 1, 77, 2048])
@pytest.mark.parametrize("max_disp", [0, 37, 100, 130])
def test_sad_curve_cuda_shapes(dev, max_disp, k):
    """K = 0 (no launch), 1, 77 (not a multiple of a block's keypoints)
    and the main path's 2048; max_disp 0, 37, the main path's 100 and 130
    (NS = 133, more than one 128-shift group); windows clamped at all four
    image edges. Within the SAD bar of the plain version, and one launch
    for K > 0."""
    from slam_toolkit_tpu_torch.ops import stereo_sad as sad
    args = _sad_args(dev, 60, 400, k, max_disp, seed=k + max_disp)
    n0 = sad.KERNEL.launches
    out = sad.sad_curve(*args)
    assert sad.KERNEL.launches == n0 + (k > 0)
    ref = sad.sad_curve_plain(*args)
    assert out.shape == ref.shape == (k, max_disp + 3)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("trim", [1e9, 5.0])
def test_local_ba_cuda_matches_plain(dev, trim):
    """T within 3e-3 and X within 2e-2 of the plain solver on valid
    points, edge r2 within rtol 0.2, atol 0.5 on active edges (the JAX
    package's kernel-vs-solver bounds: other sum order, Gauss-Jordan for
    LU); the invalid pose, empty points and fixed points do not move."""
    from slam_toolkit_tpu_torch.ops import ba_kernel
    p = _ba_problem(dev)
    n0 = ba_kernel.KERNEL.launches
    out = ba_kernel.solve_ba(p, iters=10, trim_sigma=trim)
    assert ba_kernel.KERNEL.launches == n0 + 1
    ref = ba_kernel.solve_ba_plain(p, iters=10, trim_sigma=trim)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.T_cw, ref.T_cw, rtol=0, atol=3e-3)
    pv = p.point_valid
    torch.testing.assert_close(out.Xw[pv], ref.Xw[pv], rtol=0, atol=2e-2)
    act = p.obs_mask & p.pose_valid[:, None] & pv[None, :]
    torch.testing.assert_close(out.edge_r2[act], ref.edge_r2[act], rtol=0.2,
                               atol=0.5)
    assert torch.equal(out.T_cw[2], p.T_cw[2])
    assert torch.equal(out.Xw[~pv], p.Xw[~pv])
    assert torch.equal(out.Xw[~p.point_free], p.Xw[~p.point_free])
    assert torch.isfinite(out.cost) and float(out.cost) <= float(
        ba_kernel.solve_ba_plain(p, iters=0, trim_sigma=trim).cost)
    # a second launch repeats bit for bit (no atomics)
    again = ba_kernel.solve_ba(p, iters=10, trim_sigma=trim)
    assert torch.equal(again.T_cw, out.T_cw) and torch.equal(again.Xw, out.Xw)


@pytest.mark.parametrize("one_outlier", [False, True])
@pytest.mark.parametrize("W,P", [(8, 1024), (8, 1000), (8, 37), (1, 37)])
@pytest.mark.parametrize("trim", [1e9, 5.0])
def test_local_ba_cuda_cluster_shapes(dev, W, P, trim, one_outlier):
    """The production shape W=8, P=1024, and P not a multiple of the
    8-CTA cluster (1000; 37, where the last CTA holds 2 points) or W=1;
    5% of the edges outliers, any number or at most one a point. Where
    points carry several outlier edges and nothing trims them, float32
    rounding alone moves their optimum by more than 2e-2
    (tests/test_torch_local_ba.py), so X is held against the plain
    solver's float64 run: within 2e-2 plus the distance of the plain
    float32 run from it. T and edge r2 are held against the plain float32
    run at the bounds above; two launches are bit-identical."""
    from slam_toolkit_tpu_torch.ops import ba_kernel
    p = _ba_problem(dev, W=W, P=P, seed=W + P, one_outlier=one_outlier)
    n0 = ba_kernel.KERNEL.launches
    out = ba_kernel.solve_ba(p, iters=10, trim_sigma=trim)
    assert ba_kernel.KERNEL.launches == n0 + 1
    ref = ba_kernel.solve_ba_plain(p, iters=10, trim_sigma=trim)
    ref64 = ba_kernel.solve_ba_plain(as_float64(p), iters=10,
                                     trim_sigma=trim)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.T_cw, ref.T_cw, rtol=0, atol=3e-3)
    pv = p.point_valid
    spread = float((ref.Xw[pv].double() - ref64.Xw[pv]).abs().max())
    err = float((out.Xw[pv].double() - ref64.Xw[pv]).abs().max())
    assert err <= 2e-2 + spread, (err, spread)
    act = p.obs_mask & p.pose_valid[:, None] & pv[None, :]
    torch.testing.assert_close(out.edge_r2[act], ref.edge_r2[act], rtol=0.2,
                               atol=0.5)
    assert torch.equal(out.T_cw[0], p.T_cw[0])
    assert torch.equal(out.Xw[~pv], p.Xw[~pv])
    assert torch.equal(out.Xw[~p.point_free], p.Xw[~p.point_free])
    assert float(out.cost) < float(
        ba_kernel.solve_ba_plain(p, iters=0, trim_sigma=trim).cost)
    again = ba_kernel.solve_ba(p, iters=10, trim_sigma=trim)
    for a, b in zip(again, out):
        assert torch.equal(a, b)


@pytest.mark.parametrize("P", [1024, 300])
def test_local_ba_cuda_seam_window(dev, P):
    """Seam BA's problem: a window of W = 8 with every pose fixed
    (structure only, mapping/ba_adapter.seam_ba_step), one slot invalid.
    Poses come back unchanged; X is held against the plain solver's
    float64 run as in the cluster-shape test, and the cost drops."""
    from slam_toolkit_tpu_torch.ops import ba_kernel
    p = _ba_problem(dev, W=8, P=P, seed=P + 1, one_outlier=True)
    p = p._replace(pose_fixed=torch.ones_like(p.pose_fixed))
    n0 = ba_kernel.KERNEL.launches
    out = ba_kernel.solve_ba(p, iters=10, trim_sigma=5.0)
    assert ba_kernel.KERNEL.launches == n0 + 1
    ref = ba_kernel.solve_ba_plain(p, iters=10, trim_sigma=5.0)
    ref64 = ba_kernel.solve_ba_plain(as_float64(p), iters=10,
                                     trim_sigma=5.0)
    torch.cuda.synchronize()
    assert torch.equal(out.T_cw, p.T_cw)
    pv = p.point_valid
    spread = float((ref.Xw[pv].double() - ref64.Xw[pv]).abs().max())
    err = float((out.Xw[pv].double() - ref64.Xw[pv]).abs().max())
    assert err <= 2e-2 + spread, (err, spread)
    assert torch.equal(out.Xw[~p.point_free], p.Xw[~p.point_free])
    assert float(out.cost) < float(
        ba_kernel.solve_ba_plain(p, iters=0, trim_sigma=5.0).cost)


def test_local_ba_cuda_refuses_too_many_points(dev):
    from slam_toolkit_tpu_torch.ops import ba_kernel
    cap = ba_kernel.max_points(8, torch.cuda.current_device())
    assert 1024 <= cap < 2048
    with pytest.raises(ValueError, match="points"):
        ba_kernel.solve_ba(_ba_problem(dev, W=8, P=cap + 1))


def test_local_ba_cuda_refuses_wide_window(dev):
    from slam_toolkit_tpu_torch.ops import ba_kernel
    p = _ba_problem(dev)
    wide = p._replace(
        T_cw=p.T_cw[[0] * 9], pose_fixed=p.pose_fixed[[0] * 9],
        pose_valid=p.pose_valid[[0] * 9], z=p.z[[0] * 9],
        inv_sigma=p.inv_sigma[[0] * 9], obs_mask=p.obs_mask[[0] * 9],
        stereo_mask=p.stereo_mask[[0] * 9])
    with pytest.raises(ValueError, match="window"):
        ba_kernel.solve_ba(wide)


@pytest.mark.parametrize("border", [0, 5, 16])
@pytest.mark.parametrize("dual", [True, False])
def test_fast_nms_cuda_exact(dev, border, dual):
    """Bit-exact against the plain detector at an odd level shape, with
    corners at the image edge."""
    from slam_toolkit_tpu_torch.ops import fast_kernel
    rng = np.random.default_rng(border + 7 * dual)
    h, w = 97, 301
    img = rng.uniform(40, 60, (h, w)).astype(np.float32)
    for _ in range(200):
        y, x = rng.integers(0, h - 3), rng.integers(0, w - 3)
        img[y:y + 3, x:x + 3] += rng.uniform(30, 180)
    img = _dev(np.round(img), dev)
    thr_hi = 20.0 if dual else None
    n0 = fast_kernel.KERNEL.launches
    out = fast_kernel.detect(img, thr_hi, 7.0, border)
    assert fast_kernel.KERNEL.launches == n0 + 1
    ref = fast_kernel.detect_fused_plain(img, thr_hi, 7.0, border)
    assert torch.equal(out, ref)
    assert int((ref > 0).sum()) > 50


def _blob_image(h, w, rng, n_blobs):
    img = rng.uniform(40, 60, (h, w)).astype(np.float32)
    for _ in range(n_blobs):
        y, x = rng.integers(0, h - 3), rng.integers(0, w - 3)
        img[y:y + 3, x:x + 3] += rng.uniform(30, 180)
    return np.round(img)


@pytest.mark.parametrize("border", [0, 5, 16])
@pytest.mark.parametrize("dual", [True, False])
def test_fast_levels_cuda_exact(dev, border, dual):
    """detect_levels on the 8 levels of a full-size frame (376x1241 at
    scale 1.2, the pyramid built on the card) in one launch, bit-exact
    against the plain detector on every level."""
    from slam_toolkit_tpu_torch.config import ExtractorConfig
    from slam_toolkit_tpu_torch.ops import fast_kernel, pyramid
    rng = np.random.default_rng(11 * border + dual)
    img = _dev(_blob_image(376, 1241, rng, 3000), dev)
    cfg = ExtractorConfig()
    levels = pyramid.build_pyramid(img, cfg)
    assert [tuple(lv.shape) for lv in levels] == \
        pyramid.level_shapes(376, 1241, cfg)
    thr_hi = 20.0 if dual else None
    n0 = fast_kernel.KERNEL.launches
    outs = fast_kernel.detect_levels(levels, thr_hi, 7.0, border)
    assert fast_kernel.KERNEL.launches == n0 + 1
    refs = fast_kernel.detect_levels_plain(levels, thr_hi, 7.0, border)
    for lv, out, ref in zip(levels, outs, refs):
        assert torch.equal(out, ref), tuple(lv.shape)
        assert int((ref > 0).sum()) > 20


def _plateaus(h, w):
    """Flat 50 with bright and dark blocks of 2x2, 1x2, 2x1 and 3x1
    pixels: each block's pixels have equal responses, so only the
    row-major earliest may survive NMS."""
    img = np.full((h, w), 50.0, np.float32)
    blocks = [(2, 2, 100.0), (1, 2, -40.0), (2, 1, 90.0), (3, 1, -35.0),
              (2, 2, -45.0), (1, 2, 120.0)]
    i = 0
    for y in range(6, h - 8, 9):
        for x in range(6, w - 8, 9):
            bh, bw, v = blocks[i % len(blocks)]
            img[y:y + bh, x:x + bw] += v
            i += 1
    return img


@pytest.mark.parametrize("case", ["tiny", "constant", "plateaus"])
@pytest.mark.parametrize("dual", [True, False])
def test_fast_levels_cuda_edge_cases(dev, case, dual):
    """A level smaller than one tile (5x7), a constant image (no corner
    at all) and plateaus of equal response (the earlier-neighbour
    tie-break), each with a full-width level beside it in the same
    launch; bit-exact at borders 0 and 5."""
    from slam_toolkit_tpu_torch.ops import fast, fast_kernel
    rng = np.random.default_rng(5 + dual)
    if case == "tiny":
        img = _blob_image(5, 7, rng, 0)
        img[1:3, 2:4] += 120.0
    elif case == "constant":
        img = np.full((70, 130), 77.0, np.float32)
    else:
        img = _plateaus(97, 301)
    levels = [_dev(img, dev), _dev(_blob_image(376, 1241, rng, 500), dev)]
    thr_hi = 20.0 if dual else None
    for border in (0, 5):
        n0 = fast_kernel.KERNEL.launches
        outs = fast_kernel.detect_levels(levels, thr_hi, 7.0, border)
        assert fast_kernel.KERNEL.launches == n0 + 1
        refs = fast_kernel.detect_levels_plain(levels, thr_hi, 7.0, border)
        for out, ref in zip(outs, refs):
            assert torch.equal(out, ref), (case, border)
    if case == "constant":
        assert int((refs[0] != 0).sum()) == 0
    if case == "plateaus":
        resp = fast.fast_response(levels[0], 7.0)
        ties = (resp[:, 1:] == resp[:, :-1]) & (resp[:, 1:] > 0)
        assert int(ties.sum()) > 50                  # plateaus exist
        assert int((refs[0] > 0).sum()) > 100


def test_process_cuda_matches_cpu(dev):
    """SlamEngine.process over 8 frames of the tiny sequence on the card
    (the kernels) and on the CPU (their plain versions): the gather, the
    top-2 matcher, the pose LM and SAD launched on the card, finite
    poses, the same keyframe flags, and every camera within 0.02 m."""
    from slam_toolkit_tpu_torch.config import SlamConfig
    from slam_toolkit_tpu_torch.data.synthetic import make_sequence
    from slam_toolkit_tpu_torch.ops import (match_kernel, patches,
                                            pose_lm_kernel, stereo_sad)
    from slam_toolkit_tpu_torch.pipeline.engine import SlamEngine
    cfg = SlamConfig.tiny()
    _, _, frames = make_sequence(cfg, n_frames=8, seed=3, step=0.25)
    kernels = (patches.KERNEL, match_kernel.KERNEL, pose_lm_kernel.KERNEL,
               stereo_sad.KERNEL)
    before = [k.launches for k in kernels]
    on_card = SlamEngine(cfg, device=dev)
    on_cpu = SlamEngine(cfg, device="cpu")
    for left, right in frames:
        on_card.process(left, right)
    launched = [k.launches - b for k, b in zip(kernels, before)]
    for left, right in frames:
        on_cpu.process(left, right)
    assert all(n > 0 for n in launched), launched
    assert [s["kf"] for s in on_card.frame_stats] == \
        [s["kf"] for s in on_cpu.frame_stats]
    a, b = np.stack(on_card.trajectory), np.stack(on_cpu.trajectory)
    assert np.isfinite(a).all()
    assert np.abs(a[:, :3, 3] - b[:, :3, 3]).max() < 0.02


def test_dense_frame_cuda_matches_cpu(dev):
    """The cluster workload's dense_frame at full width (one pair of the
    bench scene, DenseConfig(max_points=18688)) on the card against the
    plain run on the CPU, to the JAX parity bars: with TF32 left on by
    the caller, the entry points' full_float32 must keep the filters in
    float32."""
    from slam_toolkit_tpu_torch.cluster.tracker import (DenseConfig,
                                                        dense_frame,
                                                        frame_parity)
    from slam_toolkit_tpu_torch.data.synthetic import make_cluster_scene
    from slam_toolkit_tpu_torch.pipeline.engine import full_float32
    scene = make_cluster_scene(n_frames=12)
    cfg = DenseConfig(max_points=18688)
    (l0, _), (l1, r1) = scene.frames[9], scene.frames[10]
    outs = []
    torch.backends.cudnn.allow_tf32 = True
    for d in (dev, torch.device("cpu")):
        with torch.no_grad(), full_float32():
            outs.append(dense_frame(*(torch.from_numpy(a).to(d)
                                      for a in (l1, r1, l0)), scene.cam,
                                    cfg))
    frame_parity(*outs)


def test_fused_matches_stepwise_cuda(dev):
    """tests/test_dense_tracker.py's tiny scene over 8 frames on the
    card: the fused tracker's labels equal the stepwise one's, and the
    stepwise labels on the card equal the CPU's on >= 99% of the points
    labelled on either."""
    from slam_toolkit_tpu_torch.cluster.tracker import (DenseConfig,
                                                        DenseTracker,
                                                        FusedDenseTracker)
    from torch_cluster_scene import make_scene, tracker_args
    cam, kw = tracker_args()
    cfg = DenseConfig(**kw)
    st = DenseTracker(cam, cfg, device=dev)
    cpu = DenseTracker(cam, cfg, device="cpu")
    ft = FusedDenseTracker(cam, cfg, device=dev)
    so, co, fo = [], [], [None]
    for t in range(8):
        left, right = make_scene(t)
        so.append(st.track(left, right))
        co.append(cpu.track(left, right))
        o = ft.process(left, right)
        if o is not None:
            fo.append(o)
    fo += ft.flush()
    assert len(fo) == 8
    for t in range(1, 8):
        assert so[t]["skipped"] == fo[t]["skipped"] == co[t]["skipped"]
        if so[t]["skipped"]:
            continue
        np.testing.assert_array_equal(so[t]["labels"], fo[t]["labels"])
        assert so[t]["n_new_clusters"] == fo[t]["n_new_clusters"]
        lab = (so[t]["labels"] >= 0) | (co[t]["labels"] >= 0)
        assert np.mean(so[t]["labels"][lab] == co[t]["labels"][lab]) >= 0.99


def _lane_levels(dev, lanes, seed):
    """B lanes of a KITTI-size frame's 8 pyramid levels (the main path's
    images) and each lane's 31x31 BRIEF corners at the extractor's level
    budgets, some outside their level (the kernel clamps them)."""
    from slam_toolkit_tpu_torch.config import ExtractorConfig
    from slam_toolkit_tpu_torch.ops import pyramid
    from slam_toolkit_tpu_torch.ops.extractor import level_budgets
    rng = np.random.default_rng(seed)
    cfg = ExtractorConfig()
    img = _dev(rng.uniform(0, 255, (lanes, 376, 1241)).astype(np.float32),
               dev)
    levels = pyramid.build_pyramid(img, cfg)
    counts = level_budgets(cfg)
    ys, xs = [], []
    for lvl, k in zip(levels, counts):
        h, w = lvl.shape[-2:]
        ys.append(rng.integers(-20, h, (lanes, k)))
        xs.append(rng.integers(-20, w, (lanes, k)))
    return (levels, _i32(np.concatenate(ys, 1), dev),
            _i32(np.concatenate(xs, 1), dev), counts)


@pytest.mark.parametrize("lanes", [1, 2, 4])
def test_gather_blocks_batched_cuda_exact(dev, lanes):
    """B lanes x 8 levels in one launch (32 images at B = 4, past the
    multi-image launch's 16): each lane's windows are the single launch's
    on that lane's levels, and the batched plain version's."""
    from slam_toolkit_tpu_torch.ops import patches
    levels, ys, xs, counts = _lane_levels(dev, lanes, lanes)
    n0, s0 = patches.BATCHED_KERNEL.launches, patches.KERNEL.launches
    out = patches.gather_blocks_batched(levels, ys, xs, counts, 31, 31)
    assert patches.BATCHED_KERNEL.launches == n0 + 1
    assert patches.KERNEL.launches == s0
    assert out.shape == (lanes, sum(counts), 31, 31)
    for b in range(lanes):
        one = patches.gather_blocks_multi([lv[b] for lv in levels], ys[b],
                                          xs[b], counts, 31, 31)
        assert torch.equal(out[b], one)
    assert torch.equal(out, patches.gather_blocks_batched_plain(
        levels, ys, xs, counts, 31, 31))


def _topk2_lanes(dev, lanes, n, r, empty_lane):
    """B lanes of _topk2_edges at the tracker's M = 3072; lane
    `empty_lane` has no valid row: every query invisible (+1e7) and every
    keypoint an invalid slot (-1e7)."""
    per = [_topk2_edges(3072, n, r, seed=int(r) + n + b)
           for b in range(lanes)]
    if empty_lane is not None:
        a, b_, a_uv, b_xy = per[empty_lane]
        per[empty_lane] = (a, b_, np.full_like(a_uv, 1e7),
                           np.full_like(b_xy, -1e7))
    return [_dev(np.stack(x), dev) for x in zip(*per)]


@pytest.mark.parametrize("lanes", [1, 2, 4])
@pytest.mark.parametrize("n", [2048, 4096])
def test_topk2_batched_cuda_exact(dev, lanes, n):
    """B problems of M = 3072 queries against N = 2048 (the main path) or
    4096 (the most a problem takes) keypoints at r = 50 in one launch,
    the last lane with no valid row: each lane's output, every column,
    is the single launch's on its inputs."""
    from slam_toolkit_tpu_torch.ops import match_kernel as mk
    t = _topk2_lanes(dev, lanes, n, 50.0, lanes - 1 if lanes > 1 else None)
    n0, s0 = mk.BATCHED_KERNEL.launches, mk.KERNEL.launches
    out = mk.topk2_match_batched(*t, 50.0)
    assert mk.BATCHED_KERNEL.launches == n0 + 1
    assert mk.KERNEL.launches == s0
    for b in range(lanes):
        assert torch.equal(out[b], mk.topk2_match(*(x[b] for x in t), 50.0))
    if lanes > 1:
        assert bool((out[-1, :, [0, 1, 3, 4]] == mk.BIG).all())
    assert torch.equal(out, mk.topk2_match_batched_plain(*t, 50.0))


def test_topk2_batched_cuda_refuses_too_many_targets(dev):
    from slam_toolkit_tpu_torch.ops import match_kernel as mk
    t = _topk2_lanes(dev, 2, 4097, 50.0, None)
    with pytest.raises(ValueError, match="targets"):
        mk.topk2_match_batched(*t, 50.0)


@pytest.mark.parametrize("lanes", [1, 2, 4])
def test_pose_lm_batched_cuda_exact(dev, lanes):
    """B problems of the tracker's N = 3072 observations in one launch,
    one cluster a problem, the last lane with no valid observation: each
    lane's pose, cost and residuals are the single launch's bit for bit,
    and within the pose LM's bar of the batched plain version."""
    from slam_toolkit_tpu_torch.config import TrackerConfig
    from slam_toolkit_tpu_torch.geometry import se3
    from slam_toolkit_tpu_torch.ops import pose_lm_kernel as plk
    n, cfg = 3072, TrackerConfig()
    rng = np.random.default_rng(lanes)
    Xw = np.stack([rng.uniform(-20, 20, (lanes, n)),
                   rng.uniform(-5, 5, (lanes, n)),
                   rng.uniform(4, 60, (lanes, n))], -1).astype(np.float32)
    T_true = se3.exp(torch.from_numpy(rng.uniform(
        -0.2, 0.2, (lanes, 6)).astype(np.float32))).numpy()
    Xc = np.einsum("bij,bnj->bni", T_true[:, :3, :3], Xw) + \
        T_true[:, None, :3, 3]
    z = (Xc[..., :2] / Xc[..., 2:3]).astype(np.float32)
    z[:, :300] += 0.3                                   # gross outliers
    mask = rng.random((lanes, n)) > 0.1
    if lanes > 1:
        mask[-1] = False
    args = [torch.eye(4, device=dev).repeat(lanes, 1, 1)] + [
        _dev(x, dev) for x in (Xw, z, np.full((lanes, n), 1e-6, np.float32),
                               mask)]
    n0, s0 = plk.BATCHED_KERNEL.launches, plk.KERNEL.launches
    out = plk.optimize_pose_batched(*args, cfg)
    assert plk.BATCHED_KERNEL.launches == n0 + 1
    assert plk.KERNEL.launches == s0
    assert out.T_cw.shape == (lanes, 4, 4) and out.cost.shape == (lanes,)
    for b in range(lanes):
        one = plk.optimize_pose(*(x[b] for x in args), cfg)
        assert torch.equal(out.T_cw[b], one.T_cw)
        assert torch.equal(out.cost[b], one.cost)
        assert torch.equal(out.inlier_r2[b], one.inlier_r2)
    if lanes > 1:
        assert torch.equal(out.T_cw[-1], args[0][-1])
        assert not bool(torch.isfinite(out.inlier_r2[-1]).any())
    ref = plk.optimize_pose_batched_plain(*args, cfg)
    torch.testing.assert_close(out.T_cw, ref.T_cw, rtol=0, atol=2e-3)


def _tiny_images(n: int, seed: int = 3):
    from slam_toolkit_tpu_torch.config import SlamConfig
    from slam_toolkit_tpu_torch.data.synthetic import make_sequence
    _, _, frames = make_sequence(SlamConfig.tiny(), n_frames=n, seed=seed,
                                 step=0.25)
    return np.stack([np.stack([l, r]) for l, r in frames]).astype(
        np.float32)


def _chunk_syncs(monkeypatch) -> list:
    """The host synchronisations (CUDA's sync debug mode) of every chunk
    call after the one that captured, listed as they come."""
    from slam_toolkit_tpu_torch.pipeline import scan_engine
    from slam_toolkit_tpu_torch.utils.timing import count_syncs
    orig, syncs = scan_engine._StaticChunk.__call__, []

    def counted(self, carry, images):
        if self.graphs is None:
            return orig(self, carry, images)
        out, n = count_syncs(orig, self, carry, images)
        syncs.append(n)
        return out
    monkeypatch.setattr(scan_engine._StaticChunk, "__call__", counted)
    return syncs


@pytest.mark.parametrize("method", ["indirect", "hybrid", "direct"])
def test_graphed_chunks_match_eager(dev, method, monkeypatch):
    """ChunkedSlamEngine replaying its frame graph (the keyframe event an
    IF node on the device flag) against the eager step (graphs=False) on
    the card, tiny config, 17 frames in chunks of 4 with a small keyframe
    ring that culls between them: the rows and the maps bit-equal, the
    kernels' launch counts (from the replays and the IF body's
    executions) equal, the body run once for each keyframe row, one
    capture for the engine's life, no host sync inside a chunk."""
    import dataclasses

    from slam_toolkit_tpu_torch.config import SlamConfig
    from slam_toolkit_tpu_torch.pipeline.scan_engine import ChunkedSlamEngine
    from slam_toolkit_tpu_torch.utils import cuda_lib
    cfg = SlamConfig.tiny()
    cfg = dataclasses.replace(
        cfg, tracker=dataclasses.replace(cfg.tracker, method=method),
        map=dataclasses.replace(cfg.map, max_keyframes=11),
        keyframe=dataclasses.replace(cfg.keyframe, decay_ratio=0.95))
    imgs = _tiny_images(17)
    syncs = _chunk_syncs(monkeypatch)
    out = {}
    for graphs in (False, True):
        before = {c: c.launches for c in cuda_lib.launch_counts()}
        eng = ChunkedSlamEngine(cfg, chunk_size=4, device=dev, graphs=graphs)
        rows = np.concatenate([eng.process_chunk(imgs[a:a + 4 + (a == 0)])
                               for a in (0, 5, 9, 13)])
        torch.cuda.synchronize()
        launched = {c.symbol: c.launches - before.get(c, 0)
                    for c in cuda_lib.launch_counts()
                    if isinstance(c, cuda_lib.CudaKernel)}
        out[graphs] = (eng, rows, launched)
    (e_eng, e_rows, e_l), (g_eng, g_rows, g_l) = out[False], out[True]
    assert e_eng.n_culls >= 1 and g_eng.n_culls == e_eng.n_culls
    np.testing.assert_array_equal(g_rows, e_rows)
    for f in e_eng.map._fields:
        assert torch.equal(getattr(g_eng.map, f), getattr(e_eng.map, f)), f
    assert g_l == e_l and e_l["slam_local_ba"] > 0
    st = g_eng._chunk.graph_stats()
    assert st["captures"] == 1 and st["if_nodes"] == 1
    assert st["if_runs"]["keyframe"] == int((g_rows[:, 34] > 0.5).sum())
    assert syncs == [0, 0, 0]


def test_while_node_cuda(dev):
    """run_while captured as a WHILE node: one graph launch runs the body
    n times with no host call between (0 when the flag is false at
    entry), an IF node inside the body runs on the iterations its flag
    is set, the body's kernels' launches are counted once an iteration,
    and the graph's launches and the bodies' runs are in its stats."""
    from slam_toolkit_tpu_torch.utils import cuda_graphs, cuda_lib
    i = torch.zeros((), dtype=torch.int64, device=dev)
    n = torch.zeros((), dtype=torch.int64, device=dev)
    go = torch.zeros((), dtype=torch.bool, device=dev)
    odd = torch.zeros((), dtype=torch.bool, device=dev)
    seen = torch.zeros(16, dtype=torch.int64, device=dev)
    count = cuda_lib.LaunchCount()

    def tick():
        seen.index_add_(0, i.view(1), torch.full_like(i, 10).view(1))
        count.add(1)

    def body():
        seen.index_add_(0, i.view(1), torch.ones_like(i).view(1))
        count.add(1)
        torch.eq(torch.remainder(i, 2), 1, out=odd)
        cuda_graphs.run_if(odd, tick, name="odd")
        i.add_(1)
        torch.lt(i, n, out=go)

    def program():
        i.zero_()
        torch.gt(n, 0, out=go)
        cuda_graphs.run_while(go, body, name="loop")

    g = cuda_graphs.StepGraphs(dev)
    g.warm_up(program)
    seen.zero_()
    g.capture("loop", program)
    total = 0
    for k in (3, 0, 7):
        n.fill_(k)
        count.launches = 0
        g.replay("loop")
        torch.cuda.synchronize()
        want = torch.zeros(16, dtype=torch.int64)
        want[:k] += 1
        want[1:k:2] += 10
        assert torch.equal(seen.cpu(), want), k
        assert count.launches == k + k // 2
        seen.zero_()
        total += k
    st = g.stats()
    assert st["replays"] == {"loop": 3} and st["captures"] == 1
    assert st["while_nodes"] == 1 and st["if_nodes"] == 1
    assert st["while_runs"] == {"loop": total}
    assert st["if_runs"] == {"odd": 3 // 2 + 7 // 2}


def _chunk_launches(before) -> dict:
    from slam_toolkit_tpu_torch.utils import cuda_lib
    return {c.symbol: c.launches - before.get(c, 0)
            for c in cuda_lib.launch_counts()
            if isinstance(c, cuda_lib.CudaKernel)}


@pytest.mark.parametrize("method", ["indirect", "hybrid"])
def test_graphed_scan_chunk_one_launch(dev, method, monkeypatch):
    """The chunk as one graph on the card: ChunkedSlamEngine (capacity
    chunk_size 4) over 15 frames in chunks of 4, 4, 4 and a short last 2
    against the eager chunk: rows and map bit-equal, launches equal
    kernel by kernel, one launch of graph "chunk" a chunk, the WHILE
    body's iterations the frames, the keyframe IF body's runs the
    keyframe rows, no host sync inside a chunk."""
    import dataclasses

    from slam_toolkit_tpu_torch.config import SlamConfig
    from slam_toolkit_tpu_torch.pipeline.scan_engine import ChunkedSlamEngine
    from slam_toolkit_tpu_torch.utils import cuda_lib
    cfg = SlamConfig.tiny()
    cfg = dataclasses.replace(
        cfg, tracker=dataclasses.replace(cfg.tracker, method=method),
        keyframe=dataclasses.replace(cfg.keyframe, decay_ratio=0.95))
    imgs = _tiny_images(15)
    bounds = ((0, 5), (5, 9), (9, 13), (13, 15))
    syncs = _chunk_syncs(monkeypatch)
    out = {}
    for graphs in (False, True):
        before = {c: c.launches for c in cuda_lib.launch_counts()}
        eng = ChunkedSlamEngine(cfg, chunk_size=4, device=dev, graphs=graphs)
        rows = [eng.process_chunk(imgs[a:b]) for a, b in bounds]
        torch.cuda.synchronize()
        out[graphs] = (eng, rows, _chunk_launches(before))
    (e_eng, e_rows, e_l), (g_eng, g_rows, g_l) = out[False], out[True]
    assert [len(r) for r in g_rows] == [4, 4, 4, 2]
    for a, b in zip(g_rows, e_rows):
        np.testing.assert_array_equal(a, b)
    for f in e_eng.map._fields:
        assert torch.equal(getattr(g_eng.map, f), getattr(e_eng.map, f)), f
    assert g_l == e_l and e_l["slam_pose_lm"] == 14
    rows = np.concatenate(g_rows)
    st = g_eng._chunk.graph_stats()
    assert st["captures"] == 1 and st["replays"] == {"chunk": 4}
    assert st["while_nodes"] == 1 and st["if_nodes"] == 1
    assert st["while_runs"] == {"frame": 14}
    assert st["if_runs"] == {"keyframe": int((rows[:, 34] > 0.5).sum())}
    assert syncs == [0, 0, 0]
    with pytest.raises(ValueError, match="at most 4"):
        g_eng._chunk(g_eng.carry, torch.from_numpy(imgs[:5]).to(dev))


def test_traced_chunk_stamps_cuda(dev, monkeypatch):
    """The chunk graph traced on the card (ChunkedSlamEngine(trace=True):
    stamp kernel nodes inside the WHILE and IF bodies) against an
    untraced engine, tiny config, 25 frames in chunks of 8: rows and
    maps bit-equal, every other kernel's launches equal, and no stamp
    launched untraced; the stamps non-decreasing in slot order within a
    frame and frame after frame, the graph stamps around them and
    increasing chunk after chunk; each chunk's stamped graph time within
    2% of CUDA events recorded around its replay("chunk"), and inside
    the host span "chunk" that ran it; the clock's error under 1 ms."""
    import dataclasses

    from slam_toolkit_tpu_torch.config import SlamConfig
    from slam_toolkit_tpu_torch.pipeline.scan_engine import ChunkedSlamEngine
    from slam_toolkit_tpu_torch.utils import cuda_graphs, cuda_lib, timing
    cfg = SlamConfig.tiny()
    cfg = dataclasses.replace(cfg, keyframe=dataclasses.replace(
        cfg.keyframe, decay_ratio=0.95))
    imgs = _tiny_images(25)
    bounds = ((0, 9), (9, 17), (17, 25))
    events = []
    replay = cuda_graphs.StepGraphs.replay

    def timed(self, name):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        replay(self, name)
        ev[1].record()
        if name == "chunk":
            events.append(ev)
    monkeypatch.setattr(cuda_graphs.StepGraphs, "replay", timed)
    out = {}
    for trace in (False, True):
        events.clear()
        before = {c: c.launches for c in cuda_lib.launch_counts()}
        eng = ChunkedSlamEngine(cfg, chunk_size=8, device=dev, trace=trace)
        rows = [eng.process_chunk(imgs[a:b]) for a, b in bounds]
        torch.cuda.synchronize()
        out[trace] = (eng, rows, _chunk_launches(before), list(events))
    (p_eng, p_rows, p_l, _), (t_eng, t_rows, t_l, ev) = out[False], \
        out[True]
    for a, b in zip(p_rows, t_rows):
        np.testing.assert_array_equal(a, b)
    for f in p_eng.map._fields:
        assert torch.equal(getattr(p_eng.map, f), getattr(t_eng.map, f)), f
    assert p_l.get(timing._STAMP.symbol, 0) == 0
    assert t_l.pop(timing._STAMP.symbol) > 0
    assert {k: v for k, v in p_l.items() if v} == \
        {k: v for k, v in t_l.items() if v}
    ex = t_eng.tracer.export()
    spans = {s["id"]: s for s in ex["spans"]}
    err = max(c["error_ns"] for c in ex["clock"])
    assert 0 <= err < 1_000_000
    assert len(ex["stamps"]) == len(ev) == len(bounds)
    last = None
    for c, (e0, e1), r in zip(ex["stamps"], ev, t_rows):
        assert len(c["frames"]) == len(r)
        flat = [t for f in c["frames"] for t in f if t is not None]
        g0, g1 = c["graph"]
        assert flat == sorted(flat) and g0 <= flat[0] and flat[-1] <= g1
        assert last is None or last < g0
        last = g1
        graph_ms, event_ms = (g1 - g0) / 1e6, e0.elapsed_time(e1)
        assert abs(graph_ms - event_ms) <= 0.02 * event_ms, \
            (graph_ms, event_ms)
        root = spans[c["root"]]
        assert root["name"] == "chunk"
        assert root["start_ns"] - err <= g0 and g1 <= root["end_ns"] + err


def test_graphed_scan_batched_one_launch(dev, monkeypatch):
    """The batched chunk as one graph on the card, B = 2 lanes of
    distinct sequences, capacity 5, chunks of 5, 5 and a short last 2:
    rows and maps bit-equal to the eager batched step, launches equal,
    one graph launch a chunk, the WHILE body's iterations the frames,
    the keyframe IF body's runs the frames with a flagged lane, no host
    sync inside a chunk."""
    from slam_toolkit_tpu_torch.config import SlamConfig
    from slam_toolkit_tpu_torch.geometry.camera import StereoCamera
    from slam_toolkit_tpu_torch.parallel import mesh
    from slam_toolkit_tpu_torch.utils import cuda_lib
    cfg = SlamConfig.tiny()
    cam = StereoCamera.from_config(cfg.camera, dev)
    imgs = torch.from_numpy(np.stack([_tiny_images(13, seed=3 + b)
                                      for b in range(2)], axis=1)).to(dev)
    syncs = _chunk_syncs(monkeypatch)
    out = {}
    for graphs in (False, True):
        before = {c: c.launches for c in cuda_lib.launch_counts()}
        carry = mesh.batched_bootstrap(cfg, cam)(
            mesh.batched_empty_map(cfg, 2, dev), imgs[0, :, 0],
            imgs[0, :, 1])
        chunk = mesh.multi_sequence_chunk(cfg, cam, graphs=graphs,
                                          capacity=5)
        rows = []
        for a, b in ((1, 6), (6, 11), (11, 13)):
            carry, p = chunk(carry, imgs[a:b])
            rows.append(p)
        torch.cuda.synchronize()
        out[graphs] = (carry, torch.cat(rows).cpu().numpy(),
                       _chunk_launches(before), chunk)
    (c_e, r_e, l_e, _), (c_g, r_g, l_g, chunk) = out[False], out[True]
    np.testing.assert_array_equal(r_g, r_e)
    for f in c_e.m._fields:
        assert torch.equal(getattr(c_g.m, f), getattr(c_e.m, f)), f
    assert l_g == l_e and l_e["slam_pose_lm_batched"] == 12
    n_any = int((r_e[..., 34] > 0.5).any(1).sum())
    assert n_any >= 1
    st = chunk.graph_stats()
    assert st["captures"] == 1 and st["replays"] == {"chunk": 3}
    assert st["while_runs"] == {"frame": 12}
    assert st["if_runs"] == {"keyframe": n_any}
    assert syncs == [0, 0]


@pytest.mark.parametrize("method", ["indirect", "hybrid", "direct"])
def test_graphed_process_matches_eager(dev, method):
    """SlamEngine.process replaying its CUDA graphs (_build, then _track
    or _track_direct; the keyframe programs stereo, insert, ba, snapshot
    and the culls) against the eager programs (graphs=False) on the card,
    tiny config, 17 frames past a small keyframe ring that culls: every
    pose, flag, inlier count and map field bit-equal, the kernels' launch
    counts (from the replays) equal, the culls run from their graphs, one
    capture a program for the engine's life."""
    import dataclasses

    from slam_toolkit_tpu_torch.config import SlamConfig
    from slam_toolkit_tpu_torch.pipeline.engine import SlamEngine
    from slam_toolkit_tpu_torch.utils import cuda_lib
    cfg = SlamConfig.tiny()
    cfg = dataclasses.replace(
        cfg, tracker=dataclasses.replace(cfg.tracker, method=method),
        map=dataclasses.replace(cfg.map, max_keyframes=9),
        keyframe=dataclasses.replace(cfg.keyframe, decay_ratio=0.95))
    imgs = _tiny_images(17)
    out = {}
    for graphs in (False, True):
        before = {c: c.launches for c in cuda_lib.launch_counts()}
        eng = SlamEngine(cfg, device=dev, graphs=graphs)
        for left, right in imgs:
            eng.process(left, right)
        torch.cuda.synchronize()
        launched = {c.symbol: c.launches - before.get(c, 0)
                    for c in cuda_lib.launch_counts()
                    if isinstance(c, cuda_lib.CudaKernel)}
        out[graphs] = (eng, launched)
    (e, e_l), (g, g_l) = out[False], out[True]
    np.testing.assert_array_equal(np.stack(g.trajectory),
                                  np.stack(e.trajectory))
    assert [(s["kf"], s["inliers"]) for s in g.frame_stats] == \
        [(s["kf"], s["inliers"]) for s in e.frame_stats]
    assert int(e.map.kf_valid.sum()) < e.n_keyframes      # culled
    for f in e.map._fields:
        assert torch.equal(getattr(g.map, f), getattr(e.map, f)), f
    assert g_l == e_l and g_l["slam_gather_blocks"] > 0
    if method != "direct":
        assert g_l["slam_topk2_match"] > 0 and g_l["slam_pose_lm"] > 0
    runs = g._kf.runs
    assert runs["cull"] >= 1 and all(
        runs[n] for n in ("stereo", "insert", "ba", "snapshot")), runs
    assert g.graph_stats()["captures"] == 2 + sum(1 for v in runs.values()
                                                  if v)
    assert e.graph_stats() is None


def test_graphed_fused_tracker_matches_eager(dev):
    """FusedDenseTracker replaying its CUDA graph (the skip gate's sides
    and each RANSAC round IF nodes) against the eager step (graphs=False,
    the flags read on the host) on the card, on
    tests/test_dense_tracker.py's tiny scene over 10 frames with frame
    4's pair given twice (a skipped frame): every row's labels, flags,
    counts, sizes and motions bit-equal, one capture, each IF body run
    as often as the eager step ran it, one row wait a frame and no host
    sync the sync debug mode sees."""
    from slam_toolkit_tpu_torch.cluster.tracker import (DenseConfig,
                                                        FusedDenseTracker)
    from slam_toolkit_tpu_torch.utils.timing import count_syncs
    from torch_cluster_scene import make_scene, tracker_args
    cam, kw = tracker_args()
    cfg = DenseConfig(**kw)
    from slam_toolkit_tpu_torch.utils import cuda_graphs
    frames = [make_scene(t) for t in (0, 1, 2, 3, 4, 4, 5, 6, 7, 8)]
    outs, syncs, runs = {}, {}, {}
    for graphs in (False, True):
        ran = dict(cuda_graphs.plain_runs)
        tr = FusedDenseTracker(cam, cfg, device=dev, graphs=graphs)
        for left, right in frames[:3]:
            tr.process(left, right)

        def run(rest, tr=tr):
            return [tr.process(left, right) for left, right in rest]
        mid, syncs[graphs] = count_syncs(run, frames[3:])
        o = [x for x in mid if x is not None] + tr.flush()
        outs[graphs] = (tr, o)
        runs[graphs] = {k: n - ran.get(k, 0)
                        for k, n in cuda_graphs.plain_runs.items()
                        if k in ("skip", "run", "round")}
    (e, eo), (g, go) = outs[False], outs[True]
    assert len(go) == len(eo) == len(frames) - 1
    assert any(x["skipped"] for x in go) and any(
        x["n_new_clusters"] for x in go)
    for a, b in zip(go, eo):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    assert g.graph_stats()["captures"] == 1 and e.graph_stats() is None
    assert g.waits == e.waits == len(frames) - 1
    assert syncs[True] == 0 < syncs[False], syncs    # eager reads flags
    st = g.graph_stats()
    assert st["if_nodes"] == 2 + cfg.max_ransac_rounds
    assert st["if_runs"] == runs[False] and runs[False]["round"] > 0
    assert runs[False]["skip"] == sum(x["skipped"] for x in eo)
    assert runs[False]["run"] == sum(not x["skipped"] for x in eo)


def _same_result(a, b):
    """Two DenseTracker result dicts equal value for value."""
    assert a.keys() == b.keys()
    for k in a:
        if k == "clusters":
            assert len(a[k]) == len(b[k])
            for x, y in zip(a[k], b[k]):
                assert x.keys() == y.keys()
                for f in x:
                    np.testing.assert_array_equal(x[f], y[f])
        else:
            np.testing.assert_array_equal(a[k], b[k])


def test_graphed_stepwise_tracker_matches_eager(dev):
    """The stepwise DenseTracker's three programs (frame, track, round)
    replayed as CUDA graphs against graphs=False on the card, over 8
    frames of tests/test_dense_tracker.py's tiny scene with frame 3's
    pair given twice (a skipped frame): every result (labels, skip flags,
    new-cluster counts, each cluster's slot, size and motion T) equal,
    the same programs run, 3 captures, and once captured no host sync but
    one readback a program run."""
    from slam_toolkit_tpu_torch.cluster.tracker import (DenseConfig,
                                                        DenseTracker)
    from slam_toolkit_tpu_torch.utils.timing import count_syncs
    from torch_cluster_scene import make_scene, tracker_args
    cam, kw = tracker_args()
    cfg = DenseConfig(**kw)
    frames = [make_scene(t) for t in (0, 1, 2, 3, 3, 4, 5, 6)]
    outs, syncs, trackers, runs = {}, {}, {}, {}
    for graphs in (False, True):
        tr = DenseTracker(cam, cfg, device=dev, graphs=graphs)
        first = [tr.track(left, right) for left, right in frames[:3]]
        before = dict(tr.runs)

        def run(rest, tr=tr):
            return [tr.track(left, right) for left, right in rest]
        rest, syncs[graphs] = count_syncs(run, frames[3:])
        outs[graphs], trackers[graphs] = first + rest, tr
        runs[graphs] = {k: n - before[k] for k, n in tr.runs.items()}
    assert any(o["skipped"] for o in outs[True][1:])
    assert any(o.get("n_new_clusters") for o in outs[True])
    for a, b in zip(outs[True], outs[False]):
        _same_result(a, b)
    g, e = trackers[True], trackers[False]
    assert g.runs == e.runs and g.runs["round"] > 0 and g.runs["track"] > 0
    st = g.graph_stats()
    assert st["captures"] == 3 and e.graph_stats() is None
    assert st["replays"] == g.runs
    assert syncs[True] <= sum(runs[True].values()), (syncs, runs)
    assert torch.equal(g.prev_gray, e.prev_gray)
    assert torch.equal(g.prev_depth, e.prev_depth)


def test_graphed_vocab_extract_matches_eager(dev):
    """run_kitti --train-vocab's extract as one CUDA graph against the
    eager extract on the card, over tests/fixtures/kitti_mini/'s six
    frames (SlamConfig.tiny()): each frame's valid descriptors equal,
    one capture replayed a frame, one gather launch and one FAST+NMS
    launch a frame with fused_fast on or off (the flag selects nothing
    in the port), and one host sync (the readback) a frame once
    captured."""
    import dataclasses
    import os

    from slam_toolkit_tpu_torch import run_kitti
    from slam_toolkit_tpu_torch.data.kitti import KittiDataset
    from slam_toolkit_tpu_torch.ops import fast_kernel, patches
    from slam_toolkit_tpu_torch.utils.timing import count_syncs
    ds = KittiDataset("00", root=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "fixtures",
        "kitti_mini"))
    imgs = [ds[i][0] for i in range(len(ds))]
    cfg = run_kitti._auto_config(imgs[0].shape).extractor
    for fused in (False, True):
        c = dataclasses.replace(cfg, fused_fast=fused)
        eager = run_kitti.VocabExtract(c, dev, graphs=False)
        want = [eager(im) for im in imgs]
        ex = run_kitti.VocabExtract(c, dev)
        ex(imgs[0])
        g0, f0 = patches.KERNEL.launches, fast_kernel.KERNEL.launches
        got, syncs = count_syncs(lambda: [ex(im) for im in imgs[1:]])
        for a, b in zip([ex(imgs[0])] + got, want):
            np.testing.assert_array_equal(a, b)
        st = ex.graph_stats()
        assert st["captures"] == 1 and st["replays"] == {
            "extract": len(imgs) + 1}
        assert patches.KERNEL.launches - g0 == len(imgs)
        assert fast_kernel.KERNEL.launches - f0 == len(imgs)
        assert syncs == len(imgs) - 1, syncs


def test_main_path_chunk_fast_kernel_cuda(dev, monkeypatch):
    """The main path's chunk graph at full width (SlamConfig(), chunks
    of 16, one WHILE node a chunk) over the first 49 frames of a
    rendered circuit (loop_track's 272-frame lap at 0.8 m a frame in a
    box world): the fused FAST+NMS kernel launched once a frame across
    the replays (a frame's 8 levels in one launch), and the rows and the
    map bit-equal to the same chunks run with the plain detector
    (fast_kernel.detect_levels swapped for detect_levels_plain) captured
    in its place, which launches no FAST kernel."""
    from slam_toolkit_tpu_torch.config import SlamConfig
    from slam_toolkit_tpu_torch.data.synthetic import loop_track
    from slam_toolkit_tpu_torch.ops import fast_kernel
    from slam_toolkit_tpu_torch.pipeline.scan_engine import ChunkedSlamEngine
    from slam_toolkit_tpu_torch.tools.bench import render_stack
    cfg = SlamConfig()
    world = dict(cfg=cfg, seed=7, half_width=66.4, half_length=66.4,
                 ground_y=1.6, tex_size=2048, texels_per_m=12.0)
    imgs = render_stack(world, loop_track(272, 0.8, 12)[:49]).astype(
        np.float32)
    out = {}
    for plain in (False, True):
        if plain:
            monkeypatch.setattr(fast_kernel, "detect_levels",
                                fast_kernel.detect_levels_plain)
        eng = ChunkedSlamEngine(cfg, chunk_size=16, device=dev)
        rows, launched = [eng.process_chunk(imgs[:17])], []
        for a in (17, 33):
            torch.cuda.synchronize()
            n0 = fast_kernel.KERNEL.launches
            rows.append(eng.process_chunk(imgs[a:a + 16]))
            torch.cuda.synchronize()
            launched.append(fast_kernel.KERNEL.launches - n0)
        out[plain] = (eng, rows, launched)
    (k_eng, k_rows, k_l), (p_eng, p_rows, p_l) = out[False], out[True]
    assert k_l == [16, 16] and p_l == [0, 0], (k_l, p_l)
    assert [len(r) for r in k_rows] == [16, 16, 16]
    for a, b in zip(k_rows, p_rows):
        np.testing.assert_array_equal(a, b)
    for f in p_eng.map._fields:
        assert torch.equal(getattr(k_eng.map, f), getattr(p_eng.map, f)), f
    for eng in (k_eng, p_eng):
        st = eng._chunk.graph_stats()
        assert st["captures"] == 1 and st["replays"] == {"chunk": 3}
        assert st["while_nodes"] == 1 and st["while_runs"] == {"frame": 48}


@pytest.mark.parametrize("thread", [False, True])
def test_graphed_pipelined_engine_cuda(dev, thread):
    """The pipelined schedule on the card, graphed, tiny config, 17
    frames in chunks of 4 past a small keyframe ring: without a
    vocabulary, the rows returned at queue depth 2 (none from the first
    call; the ring's headroom flushes the queue before a cull),
    concatenated with the flush's, equal depth 0's bit for bit; with one, at depth 2 with the loop phases inline or on the
    mapping worker's stream, the graphs are captured once, in the first
    chunk (before any job), the culls fall as depth 0's, every pose is
    finite and the worker ends with no error and no work left."""
    import dataclasses

    from slam_toolkit_tpu_torch.config import SlamConfig
    from slam_toolkit_tpu_torch.loop import vocab as V
    from slam_toolkit_tpu_torch.pipeline.scan_engine import ChunkedSlamEngine
    cfg = SlamConfig.tiny()
    cfg = dataclasses.replace(
        cfg, map=dataclasses.replace(cfg.map, max_keyframes=11),
        keyframe=dataclasses.replace(cfg.keyframe, decay_ratio=0.95))
    imgs = _tiny_images(17)

    def run(**kw):
        eng = ChunkedSlamEngine(cfg, chunk_size=4, device=dev, **kw)
        got = [eng.process_chunk(imgs[a:a + 4 + (a == 0)])
               for a in (0, 5, 9, 13)] + [eng.flush()]
        torch.cuda.synchronize()
        return eng, got
    e0, g0 = run(queue_depth=0)
    e2, g2 = run(queue_depth=2, loop_thread=thread)
    assert len(g2[0]) == 0
    np.testing.assert_array_equal(np.concatenate(g2), np.concatenate(g0))
    ev, _ = run(vocab=V.synthesize(4, 3, seed=0), queue_depth=2,
                loop_thread=thread)
    assert ev.loop_thread == thread
    assert ev._chunk.graph_stats()["captures"] == 1
    assert ev.n_culls == e0.n_culls >= 1
    assert all(np.isfinite(T).all() for T in ev.trajectory_refined())
    if thread:
        w = ev._worker
        assert w.error is None and w.outstanding == 0 and not w.requests
    assert ev._closure_pend == [] and ev._loop_stash == []


def _anchored(carry, lefts, cam, cfg):
    """batched_bootstrap's carry with the photometric anchor added as
    ChunkedSlamEngine builds its own (frame 0's left image, (a, b) = (0,
    0), each lane's pattern intensities by the single reference_values)."""
    from slam_toolkit_tpu_torch.optim import direct_lm
    if cfg.tracker.method == "indirect":
        return carry
    B = lefts.shape[0]
    kf_ab = torch.zeros((B, 2), dtype=torch.float32, device=lefts.device)
    refvals = None
    if cfg.tracker.method == "hybrid":
        refvals = torch.stack([direct_lm.reference_values(
            direct_lm.DirectState(T_cw=carry.latest_T[b], a=kf_ab[b, 0],
                                  b=kf_ab[b, 1]),
            lefts[b], cam.left, carry.lm_Xw[b], carry.lm_valid[b], 1.0)
            for b in range(B)])
    return carry._replace(kf_img=lefts.clone(), kf_ab=kf_ab,
                          kf_refvals=refvals)


def _batched_gather_by_shape(monkeypatch) -> dict:
    """Counts the batched gather's launches by window (bh, bw) from here
    on, as LaunchCounts: a CUDA graph that captured a call adds its
    launches on every replay, as it does the kernel's own count."""
    from slam_toolkit_tpu_torch.ops import patches
    from slam_toolkit_tpu_torch.utils.cuda_lib import LaunchCount
    orig, by_shape = patches.gather_blocks_batched_cuda, {}

    def counted(images, ys, xs, counts, bh, bw):
        n0 = patches.BATCHED_KERNEL.launches
        out = orig(images, ys, xs, counts, bh, bw)
        by_shape.setdefault((bh, bw), LaunchCount()).add(
            patches.BATCHED_KERNEL.launches - n0)
        return out
    monkeypatch.setattr(patches, "gather_blocks_batched_cuda", counted)
    return by_shape


@pytest.mark.parametrize("method", ["indirect", "hybrid", "direct"])
@pytest.mark.parametrize("lanes", [1, 2, 4])
def test_graphed_batched_chunks_match_eager(dev, lanes, method, monkeypatch):
    """multi_sequence_chunk's frame graph (any B; the keyframe event an IF
    node on any lane's flag) against the eager batched step on the card,
    tiny config, B lanes of distinct sequences over two chunks, every
    tracker: rows and maps bit-equal, launches equal, the IF body run on
    each frame with a flagged lane, no host sync inside the second
    chunk, the batched SAD and local-BA entries launched and their single
    entries never; the batched gather at 31x31 once a frame (and the
    bootstrap), at 8x8 exactly as the photometric tracker needs."""
    import dataclasses

    from slam_toolkit_tpu_torch.config import SlamConfig
    from slam_toolkit_tpu_torch.frontend import direct_tracker
    from slam_toolkit_tpu_torch.geometry.camera import StereoCamera
    from slam_toolkit_tpu_torch.parallel import mesh
    from slam_toolkit_tpu_torch.utils import cuda_lib
    cfg = SlamConfig.tiny()
    cfg = dataclasses.replace(cfg, tracker=dataclasses.replace(
        cfg.tracker, method=method))
    cam = StereoCamera.from_config(cfg.camera, dev)
    seqs = np.stack([_tiny_images(13, seed=3 + b) for b in range(lanes)],
                    axis=1)
    imgs = torch.from_numpy(seqs).to(dev)
    by_shape = _batched_gather_by_shape(monkeypatch)
    syncs = _chunk_syncs(monkeypatch)
    out = {}
    for graphs in (False, True):
        before = {c: c.launches for c in cuda_lib.launch_counts()}
        shapes0 = {k: c.launches for k, c in by_shape.items()}
        carry = _anchored(mesh.batched_bootstrap(cfg, cam)(
            mesh.batched_empty_map(cfg, lanes, dev), imgs[0, :, 0],
            imgs[0, :, 1]), imgs[0, :, 0], cam, cfg)
        chunk = mesh.multi_sequence_chunk(cfg, cam, graphs=graphs)
        carry, p0 = chunk(carry, imgs[1:7])
        carry, p1 = chunk(carry, imgs[7:])
        torch.cuda.synchronize()
        launched = {c.symbol: c.launches - before.get(c, 0)
                    for c in cuda_lib.launch_counts()
                    if isinstance(c, cuda_lib.CudaKernel)}
        launched.update({f"batched {bh}x{bw}": c.launches - shapes0.get(
            (bh, bw), 0) for (bh, bw), c in by_shape.items()})
        out[graphs] = (carry, torch.cat([p0, p1]).cpu().numpy(), launched,
                       chunk)
    (c_e, r_e, l_e, _), (c_g, r_g, l_g, chunk) = out[False], out[True]
    assert (r_e[..., 34] > 0.5).any()
    np.testing.assert_array_equal(r_g, r_e)
    for f in c_e.m._fields:
        assert torch.equal(getattr(c_g.m, f), getattr(c_e.m, f)), f
    n_kf = int((r_e[..., 34] > 0.5).any(1).sum())
    # 8x8 windows a frame: the photometric LM reads them once for its
    # first cost, twice an iteration (residuals, trial cost) and once for
    # the final residuals; "hybrid" polishes once a frame and takes the
    # new anchor's intensities on a keyframe frame, "direct" runs 7
    # iterations at each pyramid level after that level's intensities
    n8 = {"indirect": 0,
          "hybrid": 12 * (2 * cfg.tracker.hybrid_iters + 2) + n_kf,
          "direct": 12 * direct_tracker.PYRAMID_LEVELS * (1 + 2 * 7 + 2)}
    assert l_g == l_e
    assert l_e["batched 31x31"] == 13                  # + the bootstrap
    assert l_e.get("batched 8x8", 0) == n8[method]
    assert l_e["slam_gather_blocks_batched"] == 13 + n8[method]
    assert l_e["slam_sad_curve_batched"] == 1 + n_kf   # + the bootstrap
    assert l_e["slam_local_ba_batched"] == n_kf
    assert l_e["slam_sad_curve"] == l_e["slam_local_ba"] == 0
    st = chunk.graph_stats()
    assert st["captures"] == 1 and st["if_runs"]["keyframe"] == n_kf
    assert syncs == [0]


def _sad_lanes(dev, lanes, k, max_disp, seed):
    """B lanes of _sad_args at one shape; the last of several lanes is
    empty: every corner far outside its images, which are constant."""
    per = [_sad_args(dev, 60, 400, k, max_disp, seed=seed + b)
           for b in range(lanes)]
    if lanes > 1:
        img_l, img_r, ys, xl, xs, _ = per[-1]
        per[-1] = (torch.zeros_like(img_l), torch.zeros_like(img_r),
                   torch.full_like(ys, -999), torch.full_like(xl, 9999),
                   torch.full_like(xs, -999), max_disp)
    return [torch.stack(f) for f in list(zip(*per))[:5]]


@pytest.mark.parametrize("lanes", [1, 2, 4])
@pytest.mark.parametrize("k,max_disp", [(2048, 100), (77, 130), (0, 37)])
def test_sad_curve_batched_cuda_exact(dev, lanes, k, max_disp):
    """B lanes of SAD curves in one launch (K = 2048 at max_disp 100 is a
    keyframe of the main path; K = 0 launches nothing), the last of
    several lanes empty and, at B = 4, lane 1 masked: each kept lane
    exactly its single launch and within the SAD bar of the batched plain
    version (a masked lane's rows are left unwritten, not defined)."""
    from slam_toolkit_tpu_torch.ops import stereo_sad as sad
    t = _sad_lanes(dev, lanes, k, max_disp, seed=k + lanes)
    mask = torch.ones(lanes, dtype=torch.bool, device=dev)
    if lanes == 4:
        mask[1] = False
    n0, s0 = sad.BATCHED_KERNEL.launches, sad.KERNEL.launches
    out = sad.sad_curve_batched(*t, max_disp, mask)
    assert sad.BATCHED_KERNEL.launches == n0 + (k > 0)
    assert sad.KERNEL.launches == s0
    assert out.shape == (lanes, k, max_disp + 3)
    kept = mask.cpu().numpy()
    for b in np.flatnonzero(kept):
        assert torch.equal(out[b], sad.sad_curve(*(x[b] for x in t),
                                                 max_disp))
    torch.testing.assert_close(out[mask], sad.sad_curve_batched_plain(
        *t, max_disp, mask)[mask], rtol=1e-5, atol=1e-3)


def _ba_lanes(dev, lanes, W, P):
    """B problems of _ba_problem at one shape; the last of several lanes
    is empty (no valid point, every pose fixed)."""
    from slam_toolkit_tpu_torch.optim.local_ba import BAProblem
    per = [_ba_problem(dev, W=W, P=P, seed=W + P + b, one_outlier=True)
           for b in range(lanes)]
    if lanes > 1:
        per[-1] = per[-1]._replace(
            point_valid=torch.zeros_like(per[-1].point_valid),
            pose_fixed=torch.ones_like(per[-1].pose_fixed))
    return BAProblem(*(f[0] if n == "baseline" else torch.stack(f)
                       for n, f in zip(BAProblem._fields, zip(*per))))


@pytest.mark.parametrize("lanes", [1, 2, 4])
@pytest.mark.parametrize("W,P", [(8, 1024), (4, 37)])
def test_local_ba_batched_cuda_exact(dev, lanes, W, P):
    """B local-BA problems in one launch of 8-CTA clusters (W = 8, P =
    1024 as the main path's), the last of several lanes empty and, at
    B = 4, lane 1 masked (its cluster leaves before any cluster barrier,
    its outputs unwritten): each kept lane bit for bit its single launch,
    the batched plain version within the local-BA bar (T 3e-3; X against
    the plain float64 run as test_local_ba_cuda_cluster_shapes)."""
    from slam_toolkit_tpu_torch.ops import ba_kernel
    p = _ba_lanes(dev, lanes, W, P)
    mask = torch.ones(lanes, dtype=torch.bool, device=dev)
    if lanes == 4:
        mask[1] = False
    n0, s0 = ba_kernel.BATCHED_KERNEL.launches, ba_kernel.KERNEL.launches
    out = ba_kernel.solve_ba_batched(p, mask, iters=10, trim_sigma=5.0)
    assert ba_kernel.BATCHED_KERNEL.launches == n0 + 1
    assert ba_kernel.KERNEL.launches == s0
    ref = ba_kernel.solve_ba_batched_plain(p, mask, iters=10,
                                           trim_sigma=5.0)
    torch.cuda.synchronize()
    for b in range(lanes):
        one = ba_kernel._problem_lane(p, b)
        if not mask[b]:
            continue
        single = ba_kernel.solve_ba(one, iters=10, trim_sigma=5.0)
        for a, c in zip(out, single):
            assert torch.equal(a[b], c)
        torch.testing.assert_close(out.T_cw[b], ref.T_cw[b], rtol=0,
                                   atol=3e-3)
        pv = one.point_valid
        if bool(pv.any()):
            ref64 = ba_kernel.solve_ba_plain(as_float64(one), iters=10,
                                             trim_sigma=5.0)
            spread = float((ref.Xw[b][pv].double() - ref64.Xw[pv]).abs()
                           .max())
            err = float((out.Xw[b][pv].double() - ref64.Xw[pv]).abs().max())
            assert err <= 2e-2 + spread, (b, err, spread)


@pytest.mark.parametrize("lanes", [1, 2, 4])
def test_gather_8x8_batched_cuda_exact(dev, lanes):
    """The direct LM's windows over lanes: 3072 windows 8x8 a lane on a
    full-size image (B, 376, 1241), some corners outside it, in one
    batched launch: each lane exactly its single launch and the batched
    plain version."""
    from slam_toolkit_tpu_torch.ops import patches
    rng = np.random.default_rng(lanes + 8)
    img = _dev(rng.uniform(0, 255, (lanes, 376, 1241)).astype(np.float32),
               dev)
    ys = _i32(rng.integers(-10, 376, (lanes, 3072)), dev)
    xs = _i32(rng.integers(-10, 1241, (lanes, 3072)), dev)
    n0 = patches.BATCHED_KERNEL.launches
    out = patches.gather_blocks_batched([img], ys, xs, [3072], 8, 8)
    assert patches.BATCHED_KERNEL.launches == n0 + 1
    assert out.shape == (lanes, 3072, 8, 8)
    for b in range(lanes):
        assert torch.equal(out[b], patches.gather_blocks(img[b], ys[b],
                                                         xs[b], 8, 8))
    assert torch.equal(out, patches.gather_blocks_batched_plain(
        [img], ys, xs, [3072], 8, 8))


# ---- the option sets' shapes: the bfloat16 gather, poly levels, the
# closer's augmented top-2 problem
def _poly_levels(dev, lanes, seed):
    """B lanes of a KITTI-size frame's 8 poly pyramid levels (odd widths:
    1035, 865, ...), raw and blurred to bfloat16, with each lane's 31x31
    corners at the level budgets, some outside their level."""
    import dataclasses

    from slam_toolkit_tpu_torch.config import ExtractorConfig
    from slam_toolkit_tpu_torch.ops import pyramid
    from slam_toolkit_tpu_torch.ops.extractor import level_budgets
    rng = np.random.default_rng(seed)
    cfg = dataclasses.replace(ExtractorConfig(), pyramid_mode="poly")
    img = _dev(rng.uniform(0, 255, (lanes, 376, 1241)).astype(np.float32),
               dev)
    raw = pyramid.build_pyramid(img, cfg)
    assert [tuple(lv.shape[-2:]) for lv in raw] == \
        pyramid.level_shapes(376, 1241, cfg)
    blurred = [pyramid.gaussian_blur(lv, 7, 2.0).to(torch.bfloat16)
               for lv in raw]
    counts = level_budgets(cfg)
    ys = np.concatenate([rng.integers(-20, lv.shape[-2], (lanes, k))
                         for lv, k in zip(raw, counts)], 1)
    xs = np.concatenate([rng.integers(-20, lv.shape[-1], (lanes, k))
                         for lv, k in zip(raw, counts)], 1)
    return raw, blurred, _i32(ys, dev), _i32(xs, dev), counts


def test_gather_bf16_cuda_exact(dev):
    """The bfloat16 entries on a frame's 8 poly levels (rows starting on
    any 2-byte boundary): single, multi and batched (B = 1, 2, 4)
    launches exact against the bfloat16 plain versions, each counted on
    its own bfloat16 kernel and none on the float32 ones; bfloat16 out."""
    from slam_toolkit_tpu_torch.ops import patches
    raw, blurred, ys, xs, counts = _poly_levels(dev, 4, 21)
    one = [b[0] for b in blurred]
    f32 = (patches.KERNEL.launches, patches.BATCHED_KERNEL.launches)
    n0 = patches.KERNEL_BF16.launches
    out = patches.gather_blocks_multi(one, ys[0], xs[0], counts, 31, 31)
    assert patches.KERNEL_BF16.launches == n0 + 1
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, patches.gather_blocks_multi_plain(
        one, ys[0], xs[0], counts, 31, 31))
    for bh, bw in ((31, 31), (11, 17), (8, 8)):
        single = patches.gather_blocks(one[1], ys[0], xs[0], bh, bw)
        assert torch.equal(single, patches.gather_blocks_plain(
            one[1], ys[0], xs[0], bh, bw))
    for lanes in (1, 2, 4):
        b0 = patches.BATCHED_KERNEL_BF16.launches
        lv = [b[:lanes].contiguous() for b in blurred]
        got = patches.gather_blocks_batched(lv, ys[:lanes], xs[:lanes],
                                            counts, 31, 31)
        assert patches.BATCHED_KERNEL_BF16.launches == b0 + 1
        assert torch.equal(got, patches.gather_blocks_batched_plain(
            lv, ys[:lanes], xs[:lanes], counts, 31, 31))
    assert (patches.KERNEL.launches, patches.BATCHED_KERNEL.launches) == f32


def test_gather_option_shapes_cuda_exact(dev):
    """The float32 gather at subpixel's 11x11 and 11x17 (2048 windows on a
    full-size image, corners clamped at every edge) and at ic_angle's
    31x31 over the 8 raw poly levels in one launch."""
    from slam_toolkit_tpu_torch.ops import patches
    raw, _, ys, xs, counts = _poly_levels(dev, 1, 22)
    rng = np.random.default_rng(23)
    img = raw[0][0]
    for bh, bw in ((11, 11), (11, 17)):
        y = _i32(rng.integers(-6, 380, 2048), dev)
        x = _i32(rng.integers(-9, 1245, 2048), dev)
        assert torch.equal(patches.gather_blocks(img, y, x, bh, bw),
                           patches.gather_blocks_plain(img, y, x, bh, bw))
    lv = [r[0] for r in raw]
    n0 = patches.KERNEL.launches
    out = patches.gather_blocks_multi(lv, ys[0], xs[0], counts, 31, 31)
    assert patches.KERNEL.launches == n0 + 1
    assert torch.equal(out, patches.gather_blocks_multi_plain(
        lv, ys[0], xs[0], counts, 31, 31))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_empty_window_list_cuda(dev, dtype):
    """No window at all: an empty result of the image's dtype and no
    launch, through every entry."""
    from slam_toolkit_tpu_torch.ops import patches
    img = torch.zeros((40, 60), dtype=dtype, device=dev)
    e = torch.zeros(0, dtype=torch.int32, device=dev)
    counts = [c.launches for c in (patches.KERNEL, patches.KERNEL_BF16,
                                   patches.BATCHED_KERNEL,
                                   patches.BATCHED_KERNEL_BF16)]
    for out in (patches.gather_blocks(img, e, e, 31, 31),
                patches.gather_blocks_multi([img, img], e, e, [0, 0], 11,
                                            17)):
        assert out.shape[0] == 0 and out.dtype == dtype
    out = patches.gather_blocks_batched([img[None].expand(2, 40, 60)
                                         .contiguous()],
                                        e.view(2, 0), e.view(2, 0), [0], 8, 8)
    assert out.shape == (2, 0, 8, 8) and out.dtype == dtype
    assert [c.launches for c in (patches.KERNEL, patches.KERNEL_BF16,
                                 patches.BATCHED_KERNEL,
                                 patches.BATCHED_KERNEL_BF16)] == counts


@pytest.mark.parametrize("dual", [True, False])
def test_fast_levels_cuda_poly_shapes(dev, dual):
    """detect_levels on the 8 poly levels of a full-size frame in one
    launch, bit-exact against the plain detector on every level."""
    from slam_toolkit_tpu_torch.ops import fast_kernel
    raw, _, _, _, _ = _poly_levels(dev, 1, 24)
    levels = [lv[0] for lv in raw]
    thr_hi = 20.0 if dual else None
    n0 = fast_kernel.KERNEL.launches
    outs = fast_kernel.detect_levels(levels, thr_hi, 7.0, 16)
    assert fast_kernel.KERNEL.launches == n0 + 1
    for lv, out, ref in zip(levels, outs, fast_kernel.detect_levels_plain(
            levels, thr_hi, 7.0, 16)):
        assert torch.equal(out, ref), tuple(lv.shape)


def test_topk2_cuda_augmented_rows(dev):
    """The loop closer's top-2 problem with relpose_stereo_aug: 4096
    landmark rows + 2048 keypoint rows against 2048 keypoints, every
    column exact (rows have no limit; MAX_TARGETS bounds the columns)."""
    from slam_toolkit_tpu_torch.ops import match_kernel
    a_desc, b_desc, a_uv, b_xy = _topk2_edges(6144, 2048, 50.0, 31)
    args = [_dev(a, dev) for a in (a_desc, b_desc, a_uv, b_xy)]
    out = match_kernel.topk2_match(*args, 50.0)
    assert out.shape == (6144, 8)
    assert torch.equal(out, match_kernel.topk2_match_plain(*args, 50.0))


def test_option_extract_cuda_matches_cpu(dev):
    """extract under O1 and O3 (tiny) on the card against the CPU path:
    keypoints, octaves and validity exact, angles within 1e-5, and the
    descriptor bits that differ counted (bounded at 0.05%)."""
    from slam_toolkit_tpu_torch.config import SlamConfig
    from slam_toolkit_tpu_torch.ops.extractor import extract
    from slam_toolkit_tpu_torch.tools.bench import with_option
    img = torch.from_numpy(_tiny_images(1)[0, 0])
    for name in ("O1", "O3"):
        cfg = with_option(SlamConfig.tiny(), name).extractor
        gpu, cpu = extract(img.to(dev), cfg), extract(img, cfg)
        for f in ("xy", "octave", "valid", "sigma2"):
            assert torch.equal(getattr(gpu, f).cpu(), getattr(cpu, f)), f
        torch.testing.assert_close(gpu.angle.cpu(), cpu.angle, rtol=0,
                                   atol=1e-5)
        diff = (gpu.desc.cpu() ^ cpu.desc).numpy().view(np.uint8)
        apart = int(np.unpackbits(diff).sum())
        print(f"{name}: {apart} of {diff.size * 8} descriptor bits differ")
        assert apart <= diff.size * 8 // 2000


@pytest.mark.parametrize("name", ["O1", "O2", "O3"])
def test_graphed_option_chunks_match_eager(dev, name):
    """The chunked engine under each option set on the card (tiny, 9
    frames): the graphed step against the eager one, rows and maps
    bit-equal, launch counts equal."""
    from slam_toolkit_tpu_torch.config import SlamConfig
    from slam_toolkit_tpu_torch.pipeline.scan_engine import ChunkedSlamEngine
    from slam_toolkit_tpu_torch.tools.bench import with_option
    from slam_toolkit_tpu_torch.utils import cuda_lib
    cfg = with_option(SlamConfig.tiny(), name)
    imgs = _tiny_images(9)
    out = {}
    for graphs in (False, True):
        before = {c: c.launches for c in cuda_lib.launch_counts()}
        eng = ChunkedSlamEngine(cfg, chunk_size=4, device=dev, graphs=graphs)
        rows = np.concatenate([eng.process_chunk(imgs[a:b])
                               for a, b in ((0, 5), (5, 9))])
        torch.cuda.synchronize()
        out[graphs] = (eng, rows, {
            c.symbol: c.launches - before.get(c, 0)
            for c in cuda_lib.launch_counts()
            if isinstance(c, cuda_lib.CudaKernel)})
    (e_eng, e_rows, e_l), (g_eng, g_rows, g_l) = out[False], out[True]
    np.testing.assert_array_equal(g_rows, e_rows)
    for f in e_eng.map._fields:
        assert torch.equal(getattr(g_eng.map, f), getattr(e_eng.map, f)), f
    assert g_l == e_l
    assert (e_l["slam_gather_blocks_bf16"] > 0) == (name == "O3")
    assert (e_l["slam_sad_curve"] > 0) == (name == "O2")


def _loop_world():
    """tests/test_loop_e2e.py's circle_setup world in the port's terms
    (no jax): 1.5 laps of a 48-frame circle in a box room with a blind
    window over frames 24-35, tiny config, and a vocabulary trained on
    every 4th frame's descriptors."""
    from slam_toolkit_tpu_torch.config import SlamConfig
    from slam_toolkit_tpu_torch.data.synthetic import make_world, \
        render_stereo
    from slam_toolkit_tpu_torch.geometry import se3
    from slam_toolkit_tpu_torch.loop import vocab as V
    from slam_toolkit_tpu_torch.ops.extractor import extract
    cfg = SlamConfig.tiny()
    world = make_world(cfg, seed=5, half_width=15.0, half_length=15.0,
                       ground_y=1.6, tex_size=1024)
    n, radius = 48, 6.0
    dT = se3.exp(torch.tensor([0, 0, 2 * np.pi * radius / n, 0,
                               2 * np.pi / n, 0.0]))
    T, gt = torch.eye(4), []
    for _ in range(n):
        gt.append(T.numpy().copy())
        T = se3.normalize(dT @ T)
    gt = gt + gt[:24]
    frames = [render_stereo(world, T) for T in gt]
    blind = np.random.default_rng(0)
    for i in range(24, 36):
        frames[i] = tuple(blind.uniform(0, 255, f.shape).astype(np.float32)
                          for f in frames[i])
    corpus = torch.cat([f.desc[f.valid] for f in (
        extract(torch.from_numpy(lf), cfg.extractor)
        for lf, _ in frames[::4])]).numpy()
    voc = V.train(corpus, k=6, levels=3, seed=0)
    arr = np.stack([np.stack([l, r]) for l, r in frames]).astype(np.float32)
    return cfg, arr, voc


@pytest.fixture(scope="module")
def loop_runs():
    """The chunked engine over _loop_world on the card, chunks of 8, with
    the loop graphs and with the loop programs eager (the host's
    `graphs` set to False; the chunk graphed in both): each run's engine
    and the kernels' launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    from slam_toolkit_tpu_torch.pipeline.scan_engine import ChunkedSlamEngine
    from slam_toolkit_tpu_torch.utils import cuda_lib
    cfg, arr, voc = _loop_world()
    out = {}
    for loop_graphs in (True, False):
        eng = ChunkedSlamEngine(cfg, vocab=voc, chunk_size=8, device="cuda")
        eng._host.graphs = loop_graphs
        with cuda_lib.counting() as launched:
            for i in range(0, len(arr), 8):
                eng.process_chunk(arr[i:i + 8])
            eng.flush()
        torch.cuda.synchronize()
        out[loop_graphs] = (eng, {c.symbol: n for c, n in launched.items()
                                  if isinstance(c, cuda_lib.CudaKernel)})
    return out


def _closure_pair(eng):
    e = next(e for e in eng.loop_events if "cand" in e)
    return e["kf_slot"], e["cand"]


def test_graphed_loop_engine_matches_eager(loop_runs):
    """The chunked engine with its loop programs replayed as CUDA graphs
    against the eager loop programs on the card: the same events (a
    relocalization and a closure), replays, refined poses and map bit for
    bit, the same kernel launches (from the replays), every graph
    captured on the main thread."""
    (g, gl), (e, el) = loop_runs[True], loop_runs[False]
    assert {k for ev in g.loop_events for k in ("cand", "reloc_to")
            if k in ev} == {"cand", "reloc_to"}, g.loop_events
    assert g.loop_events == e.loop_events and g.n_replays == e.n_replays
    np.testing.assert_array_equal(np.stack(g.trajectory_refined()),
                                  np.stack(e.trajectory_refined()))
    for f in g.map._fields:
        assert torch.equal(getattr(g.map, f), getattr(e.map, f)), f
    assert torch.equal(g._host.bow_db, e._host.bow_db)
    assert gl == el and gl["slam_topk2_match"] > 0
    st = g._host.loop_graph_stats()
    assert len(st["closes"]) == 1 and st["captures"] == 7 and \
        st["capture_threads"] == ["MainThread"]
    assert st["runs"]["relpose"] > 0 and st["runs"]["reloc"] > 0
    assert g._host.graph_stats()["captures"] == 3     # culls, snapshot
    assert not any(e._host._loop.runs.values())


def test_graphed_loop_programs_match_eager(loop_runs):
    """One relative pose, one register, one covisibility batch (two
    replays) and one seam BA, each replayed from its CUDA graph on the
    engine's map against the eager program on the same inputs: bit-equal
    outputs (the seam BA's map, every field) and equal launch counts."""
    from slam_toolkit_tpu_torch.loop import vocab as V
    from slam_toolkit_tpu_torch.mapping.ba_adapter import seam_ba_step
    from slam_toolkit_tpu_torch.mapping.map_state import (MapState,
                                                          covisibility_counts)
    from slam_toolkit_tpu_torch.utils import cuda_lib
    g, _ = loop_runs[True]
    h, m = g._host, g.carry.m
    cur, cand = _closure_pair(g)

    def counted(fn, *a):
        with cuda_lib.counting() as d:
            out = fn(*a)
        torch.cuda.synchronize()
        return out, {c.symbol: n for c, n in d.items()}

    (rel, pk), n_graph = counted(h._relpose, m, cur, cand)
    (rel_e, pk_e), n_eager = counted(h._relpose_program, m, cur, cand)
    assert torch.equal(pk, pk_e) and n_graph == n_eager
    assert n_graph["slam_topk2_match"] >= 1
    for a, b in zip(rel, rel_e):
        assert torch.equal(a, b)

    slots = torch.tensor([cur, cand, 0, 0], device="cuda")
    valid = torch.tensor([True, True, False, False], device="cuda")
    db0 = V.db_rows(h._db_buf).clone()
    sc = h._loop.run("register", m, slots, valid, copy_out=True)
    store = []

    def write(safe, qs):
        store.append(V.db_set(db0, safe, qs))
        return store[0]
    sc_e = h._register_core(m, slots, valid, write)
    for a, b in zip(sc, sc_e):
        assert torch.equal(a, b)
    assert torch.equal(h.bow_db, store[0])

    ids = np.array([cur, cand] + list(range(1, 10)))
    rows = h._covis(m, ids)
    want = torch.stack([covisibility_counts(m, int(s)) for s in ids])
    assert torch.equal(rows, want)

    saved = MapState(*(t.clone() for t in m))
    ref = MapState(*(t.clone() for t in m))
    _, n_e = counted(seam_ba_step, ref, cur, cand, g.cam, g.cfg)
    _, n_g = counted(h._seam_ba, m, cur, cand)
    for f in MapState._fields:
        assert torch.equal(getattr(m, f), getattr(ref, f)), f
    assert n_g == n_e and n_g["slam_local_ba"] == 1
    for dst, src in zip(m, saved):
        dst.copy_(src)


def test_graphed_close_matches_eager(loop_runs):
    """The closure's close@tier graph replayed against its body run eagerly
    on the same static inputs and the same map and ring: every map field
    and the ring bit-equal, equal launch counts (the merge's top-2); the
    map and ring put back after."""
    from slam_toolkit_tpu_torch.mapping.map_state import MapState
    from slam_toolkit_tpu_torch.utils import cuda_lib
    g, _ = loop_runs[True]
    h = g._host
    prog = next(p for p in h._loop._progs.values()
                if p.late and p.gname in h._loop.graphs)
    m = prog.inputs[0]
    ring = (h.closed_i, h.closed_j, h.closed_T, h.closed_valid, h.closed_w)
    saved = [t.clone() for t in (*m, *ring)]
    ref = MapState(*(t.clone() for t in m))
    with cuda_lib.counting() as d_e:
        ring_e = prog.fn(h, ref, *prog.inputs[1:])
    with cuda_lib.counting() as d_g:
        h._loop.graphs.replay(prog.gname)
    torch.cuda.synchronize()
    ring_g = h._loop._out[prog.gname]
    for f in MapState._fields:
        assert torch.equal(getattr(m, f), getattr(ref, f)), f
    for a, b in zip(ring_g, ring_e):
        assert torch.equal(a, b)
    n_e = {c.symbol: n for c, n in d_e.items()}
    assert {c.symbol: n for c, n in d_g.items()} == n_e
    assert n_e["slam_topk2_match"] >= 1
    for dst, src in zip((*m, *ring), saved):
        dst.copy_(src)


def test_graphed_chunked_culls_match_eager(dev):
    """The chunked engine's headroom culls from their CUDA graphs against
    their eager bodies (the host's `graphs` off; the chunk graphed in
    both), tiny config, 32 frames in chunks of 4 past a ring of 12: at
    least 2 culls, rows, anchors and map bit-equal, equal launches, one
    capture a cull program run."""
    import dataclasses

    from slam_toolkit_tpu_torch.config import SlamConfig
    from slam_toolkit_tpu_torch.pipeline.scan_engine import ChunkedSlamEngine
    from slam_toolkit_tpu_torch.utils import cuda_lib
    cfg = SlamConfig.tiny()
    cfg = dataclasses.replace(
        cfg, map=dataclasses.replace(cfg.map, max_keyframes=12),
        keyframe=dataclasses.replace(cfg.keyframe, decay_ratio=0.95))
    imgs = _tiny_images(32)
    out = {}
    for cull_graphs in (True, False):
        eng = ChunkedSlamEngine(cfg, chunk_size=4, device=dev)
        eng._mapper.graphs = cull_graphs
        with cuda_lib.counting() as launched:
            rows = [eng.process_chunk(imgs[i:i + 4])
                    for i in range(0, 32, 4)] + [eng.flush()]
        torch.cuda.synchronize()
        out[cull_graphs] = (eng, np.concatenate(rows),
                            {c.symbol: n for c, n in launched.items()
                             if isinstance(c, cuda_lib.CudaKernel)})
    (g, gr, gl), (e, er, el) = out[True], out[False]
    assert g.n_culls == e.n_culls >= 2
    np.testing.assert_array_equal(gr, er)
    assert [s for s, _ in g._traj_anchor] == [s for s, _ in e._traj_anchor]
    for f in g.map._fields:
        assert torch.equal(getattr(g.map, f), getattr(e.map, f)), f
    assert gl == el
    runs = g._mapper._kf.runs
    assert runs["cull"] >= 2 and not any(e._mapper._kf.runs.values())
    assert g._mapper.graph_stats()["captures"] == sum(
        1 for v in runs.values() if v)


def _threaded_run(cfg, arr, voc, lockstep: bool = False,
                  profile_last: int = 0):
    """A ChunkedSlamEngine at queue depth 2 with the mapping worker over
    `arr` in chunks of 8 on the card (graphed, the loop graphs on): (the
    engine, the rows returned, the jobs the profiled chunks' folds
    submitted to the worker). lockstep: the worker drained after
    each chunk and each relative pose waited for where it is measured.
    profile_last: that many last chunks under torch.profiler (CPU and
    CUDA activity), the worker drained just before the profiler starts
    and just before it stops (the profiler's stop racing a graph launch
    on the worker's thread deadlocked it, PERF.md section 7); the
    worker's jobs run between, beside the profiled chunks' graphs."""
    from slam_toolkit_tpu_torch.pipeline.scan_engine import ChunkedSlamEngine
    eng = ChunkedSlamEngine(cfg, vocab=voc, chunk_size=8, device="cuda",
                            queue_depth=2, loop_thread=True)
    if lockstep:
        measure = eng._measure

        def waited(*args):
            out = measure(*args)
            torch.cuda.synchronize()
            return out
        eng._measure = waited
    jobs = {"on": False, "queued": 0}
    submit = eng._worker.submit

    def counted(kind, args):
        jobs["queued"] += jobs["on"]
        submit(kind, args)
    eng._worker.submit = counted
    starts = list(range(0, len(arr), 8))
    rows, prof = [], None
    for k, i in enumerate(starts):
        if profile_last and k == len(starts) - profile_last:
            eng._worker.drain()
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
            jobs["on"] = True
        rows.append(eng.process_chunk(arr[i:i + 8]))
        if lockstep:
            eng._worker.drain()
    if prof is not None:
        eng._worker.drain()
        jobs["on"] = False
        torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        prof.events()
    rows.append(eng.flush())
    torch.cuda.synchronize()
    return eng, np.concatenate(rows), jobs["queued"]


def test_free_running_profiled_pipeline_cuda(dev):
    """The threaded schedule free-running on the card with torch.profiler
    over its last two one-launch chunks, the worker's jobs running beside
    them (what chip_smoke's phase 16 (b) did at full width when it once
    ended in an illegal memory access; the profiler starts and stops with
    the worker drained, see _threaded_run), three times against one
    lockstep run, tiny config on _loop_world: no CUDA error (each run
    ends in a synchronise), the rows returned before the first closure
    landed bit-equal to lockstep's, every closure one that lockstep took
    (slot, candidate), and the worker ends with no error and no work
    left."""
    cfg, arr, voc = _loop_world()
    lock, lock_rows, _ = _threaded_run(cfg, arr, voc, lockstep=True)
    lock_closures = {(e["kf_slot"], e["cand"]) for e in lock.loop_events
                     if "cand" in e}
    assert lock_closures
    for _ in range(3):
        eng, rows, queued = _threaded_run(cfg, arr, voc, profile_last=2)
        assert queued > 0      # jobs ran beside the profiled chunks
        first = min(eng.closures_landed[:1] + lock.closures_landed[:1]
                    + [len(arr) + 1])
        np.testing.assert_array_equal(rows[:first - 1],
                                      lock_rows[:first - 1])
        closures = {(e["kf_slot"], e["cand"]) for e in eng.loop_events
                    if "cand" in e}
        assert closures and closures <= lock_closures
        w = eng._worker
        assert w.error is None and w.outstanding == 0 and not w.requests
        assert eng._closure_pend == [] and eng._loop_stash == []
        assert all(np.isfinite(T).all() for T in eng.trajectory_refined())


def test_threaded_engine_alive_at_exit_cuda(dev):
    """A threaded engine on the card still alive when the interpreter
    exits, in three processes: its worker is stopped and joined at exit,
    before finalization, and each process ends with code 0 (a mapping
    thread that ran torch work and outlived the interpreter's
    finalization aborted 2 of 5 such processes on an H100,
    std::terminate; PERF.md section 7)."""
    import pathlib
    import subprocess
    import sys
    import textwrap
    code = textwrap.dedent("""
        import numpy as np
        from slam_toolkit_tpu_torch.config import SlamConfig
        from slam_toolkit_tpu_torch.loop import vocab as V
        from slam_toolkit_tpu_torch.pipeline.scan_engine import \\
            ChunkedSlamEngine
        cfg = SlamConfig.tiny()
        rng = np.random.default_rng(0)
        imgs = rng.uniform(0, 255, (9, 2, cfg.camera.height,
                                    cfg.camera.width)).astype(np.float32)
        eng = ChunkedSlamEngine(cfg, vocab=V.synthesize(4, 3, seed=0),
                                chunk_size=4, device="cuda", queue_depth=2,
                                loop_thread=True)
        eng.process_chunk(imgs[:5])
        eng.process_chunk(imgs[5:])
        eng.flush()
        print("ran", flush=True)
    """)
    for _ in range(3):
        p = subprocess.run(
            [sys.executable, "-c", code], capture_output=True, text=True,
            timeout=80, cwd=str(pathlib.Path(__file__).resolve().parents[1]))
        assert p.returncode == 0 and "ran" in p.stdout, p.stderr[-2000:]
