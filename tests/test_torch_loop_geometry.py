"""The loop slice's geometry against the JAX package on the CPU: se3.log
and its SO(3) parts, Sim(3), the SE(3) and Sim(3) pose graphs on the
problems of tests/test_pose_graph.py and tests/test_sim3.py, and the
threefry draws the loop closer seeds its RANSAC with (bit for bit)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from slam_toolkit_tpu.geometry import se3 as j_se3
from slam_toolkit_tpu.geometry import sim3 as j_sim3
from slam_toolkit_tpu.optim import pose_graph as j_pg
from slam_toolkit_tpu_torch.geometry import se3, sim3
from slam_toolkit_tpu_torch.optim import pose_graph as t_pg
from slam_toolkit_tpu_torch.utils import threefry

from test_pose_graph import circle_poses
from test_sim3 import _rand_xi, _scale_drifted_loop

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _twists(rng, n):
    """Random twists, and rotations near 0, near pi and at the branches."""
    xi = rng.normal(size=(n, 6)).astype(np.float32)
    xi[:4, 3:] *= 1e-6
    ax = rng.normal(size=(4, 3))
    ax /= np.linalg.norm(ax, axis=1, keepdims=True)
    xi[4:8, 3:] = (ax * np.array([[3.05], [3.1], [2.5], [1e-3]])).astype(
        np.float32)
    return xi


def test_se3_log_and_so3_match_jax():
    """so3_exp, so3_log (near-pi branch included), vee and identity
    against the JAX package; log against it within 2e-5 where the JAX
    package's float32 form is sound (theta^2 < 1e-8 and theta > 0.3),
    and log(exp(xi)) = xi (theta < 3) within 2e-5 (the JAX package's
    1 - A/(2B) cancels in between: on the 1e-3 rad row its rho is off)."""
    xi = _twists(np.random.default_rng(0), 64)
    T = np.asarray(j_se3.exp(jnp.asarray(xi)))
    log_t = se3.log(_t(T)).numpy()
    log_j = np.asarray(j_se3.log(jnp.asarray(T)))
    theta = np.linalg.norm(log_j[:, 3:], axis=1)
    sound = (theta < 1e-4) | (theta > 0.3)
    assert sound.sum() > 50 and not sound.all()
    np.testing.assert_allclose(log_t[sound], log_j[sound], atol=2e-5, rtol=0)
    xi64 = xi.astype(np.float64)
    T64 = se3.exp(torch.from_numpy(xi64))
    near = np.linalg.norm(xi[:, 3:], axis=1) < 3.0     # no wrap at pi
    np.testing.assert_allclose(se3.log(T64).numpy()[near], xi64[near],
                               atol=1e-9)
    np.testing.assert_allclose(se3.log(T64.float()).numpy()[near],
                               xi[near], atol=2e-5 * max(
                                   1.0, float(np.abs(xi).max())))
    np.testing.assert_allclose(
        se3.so3_exp(_t(xi[:, 3:])).numpy(),
        np.asarray(j_se3.so3_exp(jnp.asarray(xi[:, 3:]))), atol=2e-6)
    R = T[:, :3, :3]
    np.testing.assert_allclose(se3.so3_log(_t(R)).numpy(),
                               np.asarray(j_se3.so3_log(jnp.asarray(R))),
                               atol=2e-5)
    np.testing.assert_array_equal(se3.vee(_t(R)).numpy(),
                                  np.asarray(j_se3.vee(jnp.asarray(R))))
    np.testing.assert_array_equal(se3.identity((2, 3)).numpy(),
                                  np.asarray(j_se3.identity((2, 3))))


@pytest.mark.parametrize("rho,phi,sigma", [(1.0, 1.0, 0.3), (1.0, 1e-6, 1e-7),
                                           (1.0, 1e-6, 0.4),
                                           (1.0, 0.8, 1e-7)])
def test_sim3_matches_jax(rho, phi, sigma):
    """exp, log (batched LU), inv, adjoint, normalize, scale_of, to_se3
    and from_se3 against the JAX package across the small-angle and
    small-scale branches (float32, 1e-4)."""
    xi = np.asarray(_rand_xi(np.random.default_rng(1), 16, rho, phi, sigma))
    S_j = j_sim3.exp(jnp.asarray(xi))
    S = sim3.exp(_t(xi))
    np.testing.assert_allclose(S.numpy(), np.asarray(S_j), atol=1e-5)
    Sn = np.asarray(S_j)
    for name in ("log", "inv", "adjoint", "normalize", "scale_of", "to_se3",
                 "rotation_of"):
        np.testing.assert_allclose(
            getattr(sim3, name)(_t(Sn)).numpy(),
            np.asarray(getattr(j_sim3, name)(jnp.asarray(Sn))), atol=1e-4,
            err_msg=name)
    T = np.asarray(j_se3.exp(jnp.asarray(_twists(np.random.default_rng(2),
                                                     8))))
    np.testing.assert_allclose(sim3.from_se3(_t(T), 1.3).numpy(),
                               np.asarray(j_sim3.from_se3(jnp.asarray(T),
                                                          1.3)), atol=1e-6)


def _drift_problem(torch_side: bool):
    """tests/test_pose_graph.py's drifting circle: 24 poses, a biased
    odometry chain, one true loop edge, 8 empty edge slots."""
    n = 24
    T_true = circle_poses(n)
    bias = j_se3.exp(jnp.array([0.01, 0.0, 0.005, 0.0, 0.004, 0.0]))
    T_est, rel = [T_true[0]], []
    for i in range(1, n):
        d = j_se3.normalize(bias @ (T_true[i] @ j_se3.inv(T_true[i - 1])))
        rel.append(d)
        T_est.append(j_se3.normalize(d @ T_est[-1]))
    E = n + 8
    ei, ej = np.zeros(E, np.int32), np.zeros(E, np.int32)
    eT = np.tile(np.eye(4, dtype=np.float32), (E, 1, 1))
    ev = np.zeros(E, bool)
    ei[:n - 1], ej[:n - 1] = np.arange(n - 1), np.arange(1, n)
    eT[:n - 1] = np.stack([np.asarray(r) for r in rel])
    ev[:n] = True
    ei[n - 1], ej[n - 1] = n - 1, 0
    eT[n - 1] = np.asarray(T_true[0] @ j_se3.inv(T_true[n - 1]))
    info = np.tile(np.array([[100.0, 100, 100, 100, 0.01, 100]], np.float32),
                   (E, 1))
    fixed = np.arange(n) == 0
    args = dict(T_cw=np.asarray(jnp.stack(T_est)), pose_valid=np.ones(n, bool),
                pose_fixed=fixed, edge_i=ei, edge_j=ej, edge_T_ji=eT,
                edge_info=info, edge_valid=ev)
    if torch_side:
        return t_pg.PoseGraphProblem(**{k: torch.from_numpy(np.array(v))
                                        for k, v in args.items()})
    return j_pg.PoseGraphProblem(**{k: jnp.asarray(v)
                                    for k, v in args.items()})


def _pg_cost(p, T) -> float:
    r = se3.log(T[p.edge_j.long()] @ se3.inv(T[p.edge_i.long()])
                @ se3.inv(p.edge_T_ji))
    return float(0.5 * torch.sum(torch.sum(r * r * p.edge_info, -1)
                                 * p.edge_valid.float()))


def test_se3_pose_graph_matches_jax():
    """The SE(3) graph on the drifting circle. One LM step: every pose
    within 1e-3 of the JAX solve's. 25 steps: a cost within 5% of the
    same solver's float64 run (the yaw-damped information, 0.01, leaves a
    flat valley along which float32 moves the poses by centimetres) and
    no higher than the JAX solve's; the fixed pose unmoved; two runs bit
    for bit. (The JAX solve stalls after its first step here: its
    se3.log cancels at small rotations and goes NaN where float32 cos
    rounds to 1, so its later steps are rejected; the port's log keeps
    its series to theta^2 = 1e-2.)"""
    prob = _drift_problem(True)
    j_solve = jax.jit(lambda p, n: j_pg.solve_pose_graph(p, iters=n),
                      static_argnums=1)
    T1_j = np.asarray(j_solve(_drift_problem(False), 1))
    np.testing.assert_allclose(t_pg.solve_pose_graph(prob, iters=1).numpy(),
                               T1_j, atol=1e-3)
    T = t_pg.solve_pose_graph(prob, iters=25)
    T64 = t_pg.solve_pose_graph(prob._replace(
        T_cw=prob.T_cw.double(), edge_T_ji=prob.edge_T_ji.double(),
        edge_info=prob.edge_info.double()), iters=25)
    assert abs(_pg_cost(prob, T) - _pg_cost(prob, T64.float())) <= \
        0.05 * _pg_cost(prob, T64.float())
    assert _pg_cost(prob, T) < 1e-4 * _pg_cost(prob, prob.T_cw)
    T25_j = torch.from_numpy(np.array(j_solve(_drift_problem(False), 25)))
    assert _pg_cost(prob, T) <= _pg_cost(prob, T25_j) + 1e-6
    assert torch.equal(T, t_pg.solve_pose_graph(prob, iters=25))
    np.testing.assert_array_equal(T[0].numpy(), prob.T_cw[0].numpy())


def test_sim3_pose_graph_matches_jax():
    """tests/test_sim3.py's scale-drifted loop through the Sim(3) graph
    (30 iterations): similarities within 2e-3 of the JAX solve, and the
    recovered scales within 1e-4."""
    n = 24
    _, T_init, eij, _, eT7, _ = _scale_drifted_loop(n)
    E = eT7.shape[0]
    args = dict(T_cw=np.asarray(j_sim3.from_se3(jnp.asarray(T_init))),
                pose_valid=np.ones(n, bool), pose_fixed=np.arange(n) == 0,
                edge_i=eij[:, 0], edge_j=eij[:, 1], edge_T_ji=eT7,
                edge_info=np.ones((E, 7), np.float32),
                edge_valid=np.ones(E, bool))
    S_j = np.asarray(jax.jit(lambda p: j_pg.solve_pose_graph_sim3(
        p, iters=30))(j_pg.PoseGraphProblem(
            **{k: jnp.asarray(v) for k, v in args.items()})))
    S = t_pg.solve_pose_graph_sim3(t_pg.PoseGraphProblem(
        **{k: torch.from_numpy(np.array(v)) for k, v in args.items()}),
        iters=30)
    np.testing.assert_allclose(S.numpy(), S_j, atol=2e-3)
    np.testing.assert_allclose(sim3.scale_of(S).numpy(),
                               np.asarray(j_sim3.scale_of(jnp.asarray(S_j))),
                               atol=1e-4)


def test_segment_sum_matches_in_order_scatter():
    """The pose graph's fixed-order scatter-add: repeated keys summed as
    an in-order .at[].add sums them (float64 reference), unused slots 0
    (the table as wide as the keys, which bounds any multiplicity)."""
    rng = np.random.default_rng(3)
    keys = rng.integers(0, 9, 40)
    rows = rng.normal(size=(40, 2, 3)).astype(np.float32)
    out = t_pg.SegmentSum(torch.from_numpy(keys), 12, len(keys))(
        torch.from_numpy(rows))
    ref = np.zeros((12, 2, 3))
    np.add.at(ref, keys, rows.astype(np.float64))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)


def test_threefry_bit_exact():
    """PRNGKey, fold_in, random bits, uniforms and choice(p) at the
    relative pose's shapes (64 hypotheses of 4 over L = 4096 and 100
    putative matches, a third of them weighted) equal jax.random's."""
    assert jax.config.jax_threefry_partitionable
    key = threefry.prng_key(7)
    assert key == tuple(int(v) for v in np.asarray(
        jax.random.key_data(jax.random.PRNGKey(7))))
    jkey = jax.random.PRNGKey(7)
    for data in (0, 1, 77, 1023 * 1024 + 1023, 2 ** 31 + 5):
        k = threefry.fold_in(key, data)
        jk = jax.random.fold_in(jkey, data)
        assert k == tuple(int(v) for v in np.asarray(jk))
        for salt in (0, 1, 2):
            ks, jks = threefry.fold_in(k, salt), jax.random.fold_in(jk, salt)
            np.testing.assert_array_equal(
                threefry.uniform(ks, (64, 4)),
                np.asarray(jax.random.uniform(jks, (64, 4))))
            np.testing.assert_array_equal(
                threefry.random_bits(ks, (7, 3)),
                np.asarray(jax.random.bits(jks, (7, 3))))
            for L, frac in ((4096, 0.3), (100, 0.3), (33, 1.0), (16, 0.1)):
                ok = np.random.default_rng(data + salt + L).random(L) < frac
                p = ok.astype(np.float32)
                p = p / np.maximum(p.sum(), np.float32(1.0))
                jidx = jax.jit(lambda kk, pp: jax.random.choice(
                    kk, pp.shape[0], (64, 4), replace=True, p=pp))(
                        jks, jnp.asarray(p))
                idx = threefry.choice_p(ks, torch.from_numpy(p), (64, 4))
                np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))


def test_xla_cumsum_order():
    """The float32 cumulative sum in XLA's CPU order, bit for bit, at
    lengths around the row of 16 and the relative pose's 4096."""
    f = jax.jit(jnp.cumsum)
    rng = np.random.default_rng(4)
    for n in (1, 15, 16, 17, 255, 256, 257, 1000, 4096):
        p = (rng.random(n) * (rng.random(n) < 0.4)).astype(np.float32)
        p = p / np.float32(max(p.sum(), 1.0))
        np.testing.assert_array_equal(
            threefry.xla_cumsum(torch.from_numpy(p)).numpy(),
            np.asarray(f(jnp.asarray(p))))
