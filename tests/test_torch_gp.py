"""The port's searcher and its device GP tiers against the JAX package, on the CPU.

* The plain versions of K1a/K1b (``gp_append``) and K2 (``gp_fused_ehvi``)
  in ``repro_torch.kernels.gp_ops`` against the Pallas kernels of
  ``repro.kernels.gp_ops`` run in interpret mode inside a scoped
  ``jax.enable_x64(True)``: factors within 1e-12, EHVI within 1e-8.
* The ``"torch"`` and ``"cuda"`` tiers (``device="cpu"``, so the wrappers
  take the plain versions) against the reference numpy ``IncrementalGP``
  across doubling boundaries and tile edges: posteriors within 1e-10.
* BayesOpt (ehvi, parego) and PAL picks equal to the reference's
  ``gp_mode="incremental"``; state round trips with bit-identical picks.
* The numpy-only modules (space, hypervolume, nondominated mask, the numpy
  searchers) bit-identical to the reference's.

The same inputs, made with numpy from a seed, go through both packages.
"""
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.results import nondominated_mask as ref_nondominated_mask
from repro.core.search import bayesopt as ref_bo
from repro.core.search.hypervolume import hypervolume as ref_hypervolume
from repro.core.space import tpu_pod_space as ref_space
from repro.kernels import gp_ops as ref_ops
from repro_torch.core.results import _nondominated_mask_loop, nondominated_mask
from repro_torch.core.search import bayesopt as bo
from repro_torch.core.search.hypervolume import hypervolume
from repro_torch.core.search.gp_cuda import CudaIncrementalGP
from repro_torch.core.search.gp_torch import TorchIncrementalGP
from repro_torch.core.space import DesignSpace, KIND_HW, KIND_SW, Knob, tpu_pod_space
from repro_torch.kernels import gp_ops

TIERS = {"torch": TorchIncrementalGP, "cuda": CudaIncrementalGP}


def _gp(mode, **kw):
    return TIERS[mode](device="cpu", **kw)


def _toy_objectives(space, knobs):
    x = space.encode(knobs)
    time = 2.0 - 1.2 * x[0] + 0.4 * x[1] + 0.1 * np.sin(7 * x.sum())
    power = 0.5 + 1.5 * x[0] ** 2 + 0.2 * x[2]
    return np.array([time, power])


def _t(a):
    return torch.as_tensor(np.asarray(a, float), dtype=torch.float64)


# ---------------------------------------------------------------------------
# plain kernels vs the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------


def _factor_state(rng, cap, n, d, ls):
    """Buffers of a real GP state: n rows factored by the numpy reference,
    zero-padded to capacity ``cap``."""
    xb, lb, lib = np.zeros((cap, d)), np.zeros((cap, cap)), np.zeros((cap, cap))
    if n:
        g = ref_bo.IncrementalGP(lengthscale=ls).fit_x(rng.random((n, d)))
        xb[:n], lb[:n, :n], lib[:n, :n] = g._x, g._l, g._li
    return xb, lb, lib


@pytest.mark.parametrize("cap,n,m,d,ard", [
    (32, 0, 3, 4, False),      # the first append, padded 3 -> 4
    (64, 16, 7, 5, False),     # n on a 16-row tile edge, 7 -> 8
    (64, 17, 16, 3, False),    # just past a tile edge, a full block
    (64, 30, 1, 6, True),      # one row, ARD lengthscales
    (64, 20, 9, 4, True),      # 9 -> 16, ARD
])
def test_plain_append_matches_pallas_interpret(cap, n, m, d, ard):
    rng = np.random.default_rng(cap + n + m)
    ls = rng.uniform(0.3, 0.9, d) if ard else 0.4
    xb, lb, lib = _factor_state(rng, cap, n, d, ls)
    B = 1
    while B < m:
        B *= 2
    xnew = np.zeros((B, d))
    xnew[:m] = rng.random((m, d))
    ils = 1.0 / ls if ard else None
    ls2 = 1.0 if ard else ls * ls
    with jax.enable_x64(True):
        want = ref_ops.gp_append(
            jnp.asarray(xb), jnp.asarray(lb), jnp.asarray(lib), np.int32(n),
            np.int32(m), jnp.asarray(xnew), None if ils is None else jnp.asarray(ils),
            1e-3, ls2=ls2, signal=1.0, block=16, interpret=True)
        want = [np.asarray(a) for a in want]
    got = [_t(xb), _t(lb), _t(lib)]
    ok = gp_ops.gp_append(*got, n, m, _t(xnew), None if ils is None else _t(ils), 1e-3,
                          ls2=ls2, signal=1.0)
    assert ok == bool(want[3]) is True
    for g, w in zip(got, want[:3]):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-12, rtol=0)
    for buf in got[1:]:          # the zero invariant past the new rows
        assert not buf[n + m:].any() and not buf[:, n + m:].any()


@pytest.mark.parametrize("cap,n,P,d,n_front,ard", [
    (64, 40, 16, 4, 1, False),   # S = 2: a one-point front
    (64, 64, 8, 3, 5, False),    # every row active, front padded 5 -> 8
    (32, 17, 32, 5, 12, True),   # ARD, S = 17
])
def test_plain_ehvi_matches_pallas_interpret(cap, n, P, d, n_front, ard):
    rng = np.random.default_rng(cap + n + P)
    ls = rng.uniform(0.3, 0.9, d) if ard else 0.35
    xb = np.zeros((cap, d))
    xb[:n] = rng.random((n, d))
    alpha = np.zeros((cap, 2))
    alpha[:n] = rng.standard_normal((n, 2))
    xq = rng.random((P, d))
    front = np.sort(rng.random(n_front))
    F = 1
    while F < n_front:
        F *= 2
    x = np.concatenate([front, np.full(F - n_front, 1.2)])
    y = np.concatenate([1.0 - front, np.full(F - n_front, 1.0 - front[-1])])
    ref = np.array([1.2, 1.1])
    stair = np.stack([np.concatenate([[-np.inf], x]), np.concatenate([x, ref[:1]]),
                      np.concatenate([ref[1:], y])])
    ymd = np.array([[0.2, 0.3], [0.2, 0.3]])
    ils = 1.0 / ls if ard else None
    ls2 = 1.0 if ard else ls * ls
    with jax.enable_x64(True):
        want = np.asarray(ref_ops.gp_fused_ehvi(
            jnp.asarray(xb), jnp.asarray(alpha), np.int32(n), jnp.asarray(xq),
            jnp.asarray(stair), jnp.asarray(ymd), None if ils is None else jnp.asarray(ils),
            ls2=ls2, signal=1.0, block=16, pool_block=8, interpret=True))
    got = gp_ops.gp_fused_ehvi(_t(xb), _t(alpha), n, _t(xq), _t(stair), _t(ymd),
                               None if ils is None else _t(ils), ls2=ls2, signal=1.0)
    assert got.dtype == torch.float64 and got.shape == (P,)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-8, rtol=0)
    assert np.any(want > 0)


def test_cpu_tensors_take_plain_versions_and_other_devices_raise():
    rng = np.random.default_rng(0)
    lib = np.tril(rng.standard_normal((32, 32)))
    lib[20:] = 0.0
    lib[:, 20:] = 0.0
    xs, xq = rng.random((32, 3)), rng.random((4, 3))
    before = (gp_ops.gp_w.launches, gp_ops.gp_g.launches, gp_ops.gp_ehvi.launches)
    w = gp_ops.gp_w(_t(lib), _t(xs), _t(xq), 20, 3, ls2=0.09, signal=1.0)
    g = gp_ops.gp_g(w, _t(lib), 20)
    assert (gp_ops.gp_w.launches, gp_ops.gp_g.launches, gp_ops.gp_ehvi.launches) == before
    assert torch.equal(w, gp_ops.gp_w_plain(_t(lib), _t(xs), _t(xq), 20, 3, ls2=0.09, signal=1.0))
    assert torch.equal(g, w.T @ _t(lib))        # rows >= n of w are zero
    meta = torch.empty((32, 32), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        gp_ops.gp_g(torch.empty((32, 4), dtype=torch.float64, device="meta"), meta, 20)


# ---------------------------------------------------------------------------
# the device tiers vs the numpy IncrementalGP
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", list(TIERS))
@pytest.mark.parametrize("steps,d", [
    ((1, 1, 3, 1, 10, 1, 2, 17), 5),   # capacities 16 -> 32 -> 64
    ((8, 16, 7, 9, 8), 4),             # blocks on, above and below 8/16 edges
], ids=["doubling", "tile_edges"])
def test_tier_matches_numpy(mode, steps, d):
    rng = np.random.default_rng(0)
    ref = ref_bo.IncrementalGP()
    gp = _gp(mode)
    for step in steps:
        xn = rng.random((step, d))
        ref.observe(xn)
        gp.observe(xn)
        assert len(gp) == len(ref)
    assert gp.stats()["appends"] == len(steps)
    if mode == "cuda":
        assert gp.stats()["cuda_appends"] == len(steps)
    y, Y, q = rng.random(len(ref)), rng.random((len(ref), 2)), rng.random((9, d))
    for got, want in ((gp.fit_y(y).predict(q), ref.fit_y(y).predict(q)),
                      (gp.fit_y_multi(Y).predict_multi(q), ref.fit_y_multi(Y).predict_multi(q))):
        np.testing.assert_allclose(got[0], want[0], atol=1e-10)
        np.testing.assert_allclose(got[1], want[1], atol=1e-10)
    np.testing.assert_allclose(gp.predict_mean_multi(q), ref.predict_mean_multi(q), atol=1e-10)


def test_cuda_and_torch_factors_agree_with_zero_invariant():
    rng = np.random.default_rng(1)
    tgp, cgp = _gp("torch"), _gp("cuda")
    for step in (4, 13, 1, 30):            # lands exactly on a 16-multiple too
        xn = rng.random((step, 3))
        tgp.observe(xn)
        cgp.observe(xn)
    n = len(cgp)
    for a, b in ((tgp._lb, cgp._lb), (tgp._lib, cgp._lib)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-12)
        assert not b[n:].any() and not b[:, n:].any()


@pytest.mark.parametrize("mode", list(TIERS))
def test_degenerate_append_refactors_through_cholesky_ex(mode):
    """Zero noise + duplicated rows: the Schur block is not PD, cholesky_ex's
    info (not an exception) trips the flag, and the masked refactor runs."""
    rng = np.random.default_rng(3)
    xs = rng.random((12, 3))
    gp = _gp(mode, noise=0.0).fit_x(xs)
    before = gp.n_refactors
    gp.observe(np.vstack([xs[3][None], xs[3][None]]))
    assert gp.n_refactors == before + 1
    assert len(gp) == 14                     # the data still landed


@pytest.mark.parametrize("mode", list(TIERS))
def test_fused_ehvi_matches_numpy_staircase(mode):
    rng = np.random.default_rng(4)
    xs, Y, pool = rng.random((30, 4)), rng.random((30, 2)), rng.random((25, 4))
    ref_pt = Y.max(0) * 1.1 + 1e-9
    ref = ref_bo.IncrementalGP().fit_x(xs).fit_y_multi(Y)
    want = ref_bo.ehvi_improvements(Y, ref_pt, ref.predict_mean_multi(pool))
    gp = _gp(mode).fit_x(xs)
    gp.fit_y_multi(Y)
    np.testing.assert_allclose(gp.score_ehvi(pool, Y, ref_pt), want, atol=1e-8)
    if mode == "cuda":
        assert gp.stats()["cuda_scores"] == 1


@pytest.mark.parametrize("mode", list(TIERS))
def test_fused_ehvi_empty_front_and_empty_pool(mode):
    rng = np.random.default_rng(5)
    xs, Y = rng.random((10, 3)), rng.random((10, 2))
    gp = _gp(mode).fit_x(xs)
    gp.fit_y_multi(Y)
    s = gp.score_ehvi(rng.random((4, 3)), Y, Y.min(0) - 1.0)   # nothing beats ref
    assert s.shape == (4,) and np.all(s == 0.0)
    assert gp.score_ehvi(np.zeros((0, 3)), Y, Y.max(0) + 1).shape == (0,)


@pytest.mark.parametrize("mode", list(TIERS))
def test_inducing_rethin_reuses_buffers_in_place(mode):
    rng = np.random.default_rng(6)
    gp = _gp(mode, inducing_threshold=64)
    xs = rng.random((300, 3))
    for i in range(0, 300, 25):
        xb = gp._xb
        gp.observe(xs[i:i + 25])
        if gp.n_rethins and xb is not None and gp._cap == 128:
            assert gp._xb is xb              # rewritten in place, not reallocated
    s = gp.stats()
    assert s["n_total"] == 300 and s["thins"] > 1
    assert s["rethins"] == s["thins"] and s["capacity"] == 128
    assert len(gp) <= int(64 * gp.inducing_overflow)
    y = np.sin(3 * xs[:, 0]) + 0.5 * np.cos(2 * xs[:, 1])
    q = rng.random((40, 3))
    mu, _ = gp.fit_y(y).predict(q)
    want = np.sin(3 * q[:, 0]) + 0.5 * np.cos(2 * q[:, 1])
    assert float(np.sqrt(np.mean((mu - want) ** 2))) < 0.15


def test_ard_lengthscale_parity_across_modes():
    """An ARD vector through set_lengthscale (the refactor path) and from the
    start (the append path) gives the numpy posterior in both tiers."""
    rng = np.random.default_rng(7)
    d = 4
    ls = np.array([0.2, 0.5, 0.9, 0.35])
    xs, y, q = rng.random((23, d)), rng.random(23), rng.random((9, d))
    want = ref_bo.IncrementalGP().fit_x(xs).set_lengthscale(ls).fit_y(y).predict(q)
    blocks = [rng.random((k, d)) for k in (3, 14, 6)]
    ref = ref_bo.IncrementalGP(lengthscale=ls)
    for b in blocks:
        ref.observe(b)
    y2 = rng.random(len(ref))
    want2 = ref.fit_y(y2).predict(q)
    for mode in TIERS:
        got = _gp(mode).fit_x(xs).set_lengthscale(ls).fit_y(y).predict(q)
        gp = _gp(mode, lengthscale=ls)
        for b in blocks:
            gp.observe(b)
        got2 = gp.fit_y(y2).predict(q)
        for g, w in ((got, want), (got2, want2)):
            np.testing.assert_allclose(g[0], w[0], atol=1e-10)
            np.testing.assert_allclose(g[1], w[1], atol=1e-10)


@pytest.mark.parametrize("mode", list(TIERS))
def test_float64_end_to_end_no_global_leak(mode):
    rng = np.random.default_rng(1)
    xs, y, q = rng.random((40, 4)), rng.random(40), rng.random((8, 4))
    gp = _gp(mode).fit_x(xs).fit_y(y)
    assert gp._xb.dtype == gp._lb.dtype == gp._lib.dtype == torch.float64
    mu, sig = gp.predict(q)
    want = ref_bo.IncrementalGP().fit_x(xs).fit_y(y).predict(q)
    np.testing.assert_allclose(mu, want[0], atol=1e-12)
    np.testing.assert_allclose(sig, want[1], atol=1e-12)
    assert mu.dtype == np.float64
    assert torch.get_default_dtype() == torch.float32
    assert torch.zeros(1).dtype == torch.float32


# ---------------------------------------------------------------------------
# the searchers: picks equal to the reference's numpy mode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", list(TIERS))
@pytest.mark.parametrize("algo,kw,steps", [
    ("bayesopt", {"strategy": "ehvi"}, 30),
    ("bayesopt", {"strategy": "parego"}, 20),
    ("pal", {}, 20),
], ids=["ehvi", "parego", "pal"])
def test_picks_match_reference_incremental(mode, algo, kw, steps):
    space = tpu_pod_space(n_chips=256)
    rspace = ref_space(n_chips=256)
    ref_cls = {"bayesopt": ref_bo.BayesOpt, "pal": ref_bo.PAL}[algo]
    cls = {"bayesopt": bo.BayesOpt, "pal": bo.PAL}[algo]
    ref = ref_cls(rspace, seed=3, n_init=6, pool_size=64, gp_mode="incremental", **kw)
    port = cls(space, seed=3, n_init=6, pool_size=64, gp_mode=mode, device="cpu", **kw)
    for _ in range(steps):
        c, rc = port.ask(1)[0], ref.ask(1)[0]
        assert c == rc
        port.tell(c, _toy_objectives(space, c))
        ref.tell(rc, _toy_objectives(rspace, rc))
    if mode == "cuda" and kw.get("strategy") == "ehvi":
        assert port._gp.stats()["cuda_scores"] > 0


@pytest.mark.parametrize("mode", ["incremental", "refit"])
@pytest.mark.parametrize("algo", ["bayesopt", "pal"])
def test_numpy_modes_bit_identical_to_reference(mode, algo):
    space, rspace = tpu_pod_space(n_chips=256), ref_space(n_chips=256)
    cls = {"bayesopt": (bo.BayesOpt, ref_bo.BayesOpt), "pal": (bo.PAL, ref_bo.PAL)}[algo]
    port, ref = (c(s, seed=1, n_init=6, pool_size=48, gp_mode=mode, hyper_refresh_every=7)
                 for c, s in zip(cls, (space, rspace)))
    for _ in range(16):
        c, rc = port.ask(2), ref.ask(2)
        assert c == rc
        for k in c:
            port.tell(k, _toy_objectives(space, k))
            ref.tell(k, _toy_objectives(rspace, k))
    assert np.array_equal(np.atleast_1d(port._gp.ls if mode == "incremental" else port._ls),
                          np.atleast_1d(ref._gp.ls if mode == "incremental" else ref._ls))


def _durable_space():
    return DesignSpace([
        Knob("clock_scale", (0.5, 0.75, 1.0), KIND_HW),
        Knob("hbm_scale", (0.25, 0.5, 1.0), KIND_HW),
        Knob("blk", (64, 128, 256, 512), KIND_SW),
        Knob("dtype", ("bfloat16", "float32"), KIND_SW),
    ])


def _durable_objective(space, knobs):
    x = space.encode(knobs)
    return np.array([1.0 + float(x.sum()), 2.0 - float(x[0]) + 0.3 * float(x[1])])


@pytest.mark.parametrize("algo", ["bayesopt", "pal"])
@pytest.mark.parametrize("mode", list(TIERS))
@pytest.mark.parametrize("seed", [0, 7])
def test_snapshot_restore_bit_identical_picks(algo, mode, seed):
    """As ``tests/test_durable.py``: a fresh searcher restored from a pickled
    state_dict continues with exactly the original's picks."""
    space = _durable_space()
    cls = {"bayesopt": bo.BayesOpt, "pal": bo.PAL}[algo]

    def mk():
        return cls(space, seed=seed, n_init=6, pool_size=48, gp_mode=mode, device="cpu")

    a = mk()
    for _ in range(3):
        for c in a.ask(4):
            a.tell(c, _durable_objective(space, c))
    state = pickle.loads(pickle.dumps(a.state_dict()))
    assert state["attrs"]["_gp_state"]["kind"] == mode
    b = mk()
    b.load_state(state)
    for _ in range(4):
        pa, pb = a.ask(4), b.ask(4)
        assert pa == pb
        for c in pa:
            y = _durable_objective(space, c)
            a.tell(c, y)
            b.tell(c, y)


@pytest.mark.parametrize("mode", list(TIERS))
@pytest.mark.parametrize("kind", ["incremental", "jax"])
def test_load_state_from_reference(mode, kind):
    """A reference checkpoint continues on the device tier with the same
    posterior: a numpy ``IncrementalGP.state_dict()``, and a state with the
    reference device tier's keys and kind."""
    rng = np.random.default_rng(9)
    xs, more, q = rng.random((21, 4)), rng.random((6, 4)), rng.random((7, 4))
    ref = ref_bo.IncrementalGP().fit_x(xs)
    if kind == "incremental":
        state = ref.state_dict()
    else:
        state = dict(_gp("torch").fit_x(xs).state_dict(), kind="jax")
    gp = _gp(mode).load_state(pickle.loads(pickle.dumps(state)))
    assert len(gp) == gp.n_total == 21
    assert np.array_equal(gp._lib[:21, :21].numpy(), state["lib"])
    ref.observe(more)
    gp.observe(more)
    Y = rng.random((27, 2))
    want, got = ref.fit_y_multi(Y).predict_multi(q), gp.fit_y_multi(Y).predict_multi(q)
    np.testing.assert_allclose(got[0], want[0], atol=1e-10)
    np.testing.assert_allclose(got[1], want[1], atol=1e-10)
    with pytest.raises(ValueError, match="kind"):
        _gp(mode).load_state(dict(state, kind="gp"))


# ---------------------------------------------------------------------------
# numpy-only modules: bit-identical to the reference
# ---------------------------------------------------------------------------


def test_space_bit_identical():
    space, rspace = tpu_pod_space(n_chips=256), ref_space(n_chips=256)
    assert [(k.name, k.values, k.kind) for k in space.knobs] == \
        [(k.name, k.values, k.kind) for k in rspace.knobs]
    assert space.size() == rspace.size() == 3_421_440
    idx = space.sample_index_batch(np.random.default_rng(0), 300)
    assert np.array_equal(idx, rspace.sample_index_batch(np.random.default_rng(0), 300))
    assert np.array_equal(space.encode_index_batch(idx), rspace.encode_index_batch(idx))
    cfgs = space.index_decode_batch(idx[:20])
    assert np.array_equal(space.encode_batch(cfgs), rspace.encode_batch(cfgs))
    assert [space.mutate(c, np.random.default_rng(1)) for c in cfgs] == \
        [rspace.mutate(c, np.random.default_rng(1)) for c in cfgs]
    a = bo.BayesOpt(space, seed=4)
    r = ref_bo.BayesOpt(rspace, seed=4)
    for got, want in zip(a._fresh_pool(512, exclude={3, 5}), r._fresh_pool(512, exclude={3, 5})):
        assert np.array_equal(got, want)


def test_pareto_and_hypervolume_bit_identical():
    rng = np.random.default_rng(2)
    for pts in (rng.random((700, 2)), rng.random((60, 3)), np.round(rng.random((80, 2)), 1)):
        mask = nondominated_mask(pts)
        assert np.array_equal(mask, ref_nondominated_mask(pts))
        assert np.array_equal(mask, _nondominated_mask_loop(pts))
        ref_pt = pts.max(0) * 1.1
        assert hypervolume(pts, ref_pt) == ref_hypervolume(pts, ref_pt)
    ys, cand = rng.random((50, 2)), rng.random((64, 2))
    ref_pt = np.array([1.1, 1.1])
    assert np.array_equal(bo.ehvi_improvements(ys, ref_pt, cand),
                          ref_bo.ehvi_improvements(ys, ref_pt, cand))
    np.testing.assert_allclose(bo.ehvi_improvements(ys, ref_pt, cand),
                               bo._ehvi_improvements_loop(ys, ref_pt, cand), atol=1e-12)
    lcb = rng.random((64, 2))
    assert np.array_equal(bo.pal_maybe_pareto(ys, lcb), ref_bo.pal_maybe_pareto(ys, lcb))
    xs = rng.random((80, 3)) * np.array([1.0, 0.05, 1.0])
    y = np.sin(6 * xs[:, 0]) + 50.0 * xs[:, 1]
    assert np.array_equal(np.atleast_1d(bo.tune_lengthscale(xs, y, 0.3)),
                          np.atleast_1d(ref_bo.tune_lengthscale(xs, y, 0.3)))
