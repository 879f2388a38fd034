"""The port's sphere trace — the trace kernel's plain version
(ops.sdf_mlp_kernels.trace_steps_plain, B4) and the staged trace of
render.raymarching — held against the JAX package on the CPU.

Inputs are made with numpy from a seed and handed to both packages. Two
full-width networks: the JAX package's init with a latent code (as its own
trace tests use), and a network built by hand with an exact surface, the
octahedron (|x| + |y| + |z| - 0.45) / sqrt(3) (shapegan_tpu_torch.examples).
The Pallas trace kernel runs in interpret mode, as the JAX package's own
tests run it.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from shapegan_tpu.ops import sdf_mlp as jax_mlp
from shapegan_tpu.ops.sdf_mlp_pallas import trace_steps_fused as jax_trace_steps_fused
from shapegan_tpu.render import raymarching as jax_rm
from shapegan_tpu_torch.examples import octahedron_params
from shapegan_tpu_torch.ops import sdf_mlp
from shapegan_tpu_torch.ops import sdf_mlp_kernels as K
from shapegan_tpu_torch.render import raymarching as rm

# B4's plain version against the Pallas kernel, both in bf16 at the same
# rounding points: a lane's SDF differs only by float32 rounding (tanh, the
# head's summation order), which rarely moves a point by an ulp and more
# rarely flips its bf16 rounding. Measured on the CPU over the cases below:
# statuses agree on every lane; points differ by at most 5.4e-7, except one
# lane of 1500 (6.9e-5, a flipped rounding) in the octahedron's primary
# case. The bounds: statuses agree on > 0.997 of lanes (the JAX package's
# own bf16 bound is 0.97) and points on agreeing lanes within 1e-5, except
# a share <= 0.003 of lanes.
STATUS_AGREE = 0.997
POINT_ATOL = 1e-5
FLIPPED_SHARE = 0.003
# The port's bf16 staged trace against the JAX package's float32 one (the
# JAX package's own bf16-vs-f32 bounds, test_pallas_kernels.py:300-324).
BF16_VS_F32_AGREE = 0.97
BF16_VS_F32_HIT_ATOL = 0.02


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread per test: under pytest-xdist the workers share
    the cores, and PyTorch's default of a thread per core oversubscribes
    them (the trace's many small bf16 products then run ~100x slower)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _network(kind):
    """(numpy params, latent [128]) of 'init' (the JAX init, latent drawn
    from a seed) or 'octahedron' (any latent)."""
    if kind == "init":
        params = {k: np.asarray(v) for k, v in jax_mlp.init(jax.random.PRNGKey(0)).items()}
        latent = (np.random.default_rng(1).normal(size=128) * 0.1).astype(np.float32)
    else:
        params = octahedron_params()
        latent = np.zeros(128, np.float32)
    return params, latent


def _jparams(params):
    return {k: jnp.asarray(v) for k, v in params.items()}


def _tparams(params):
    return sdf_mlp.params_from_jax(params)


def _inward_rays(n, seed):
    """Rays from the unit sphere toward targets in [-0.3, 0.3]^3; lanes 5
    and every 97th HIT, 11 and every 89th MISS (pre-resolved)."""
    rng = np.random.default_rng(seed)
    origins = rng.normal(size=(n, 3))
    origins /= np.linalg.norm(origins, axis=1, keepdims=True)
    dirs = rng.uniform(-0.3, 0.3, (n, 3)) - origins
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    status = np.zeros(n, np.int32)
    status[::97] = K.TRACE_HIT
    status[::89] = K.TRACE_MISS
    status[5], status[11] = K.TRACE_HIT, K.TRACE_MISS
    return origins.astype(np.float32), dirs.astype(np.float32), status


def _upward_rays(n, seed):
    """Shadow rays from the upper half of the ball's interior, mostly up;
    escape heights 1.0 and 1.6 on alternate lanes."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-0.6, 0.6, (n, 3))
    pts[:, 1] = rng.uniform(0.0, 0.5, n)
    dirs = np.concatenate([pts[:, :1] * 0.2, np.ones((n, 1)), pts[:, 2:] * 0.2], axis=1)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    escape = np.where(np.arange(n) % 2 == 0, 1.0, 1.6).astype(np.float32)
    return pts.astype(np.float32), dirs.astype(np.float32), np.zeros(n, np.int32), escape


def _assert_traces_close(got, want, start=None):
    (g_pts, g_st), (w_pts, w_st) = got, want
    g_pts, g_st = np.asarray(g_pts), np.asarray(g_st)
    w_pts, w_st = np.asarray(w_pts), np.asarray(w_st)
    agree = g_st == w_st
    assert agree.mean() > STATUS_AGREE, agree.mean()
    dp = np.abs(g_pts - w_pts).max(axis=1)[agree]
    assert (dp > POINT_ATOL).mean() <= FLIPPED_SHARE, ((dp > POINT_ATOL).mean(), dp.max())
    if start is not None:  # pre-resolved lanes never change
        s_pts, s_st = start
        resolved = s_st != K.TRACE_ACTIVE
        np.testing.assert_array_equal(g_pts[resolved], s_pts[resolved])
        np.testing.assert_array_equal(g_st[resolved], s_st[resolved])


CASES = {
    # name: (network, rays, keywords, k)
    "primary init": ("init", "inward", dict(shadow=False, threshold=0.005, step_clamp=0.02,
                                            sdf_offset=0.0, radius=1.0), 12),
    "primary octahedron": ("octahedron", "inward", dict(shadow=False, threshold=0.005,
                                                        step_clamp=0.05, sdf_offset=0.0,
                                                        radius=1.0), 24),
    "shadow octahedron": ("octahedron", "upward", dict(shadow=True, threshold=0.005,
                                                       step_clamp=0.1, sdf_offset=0.0,
                                                       radius=1.0), 20),
    "shadow escape init": ("init", "upward-escape", dict(shadow=True, threshold=0.005,
                                                         step_clamp=0.1, sdf_offset=0.15,
                                                         radius=1.0), 40),
}


@pytest.mark.parametrize("case", list(CASES))
def test_trace_plain_matches_pallas_interpreted(case):
    """B4's plain version (through the port's trace_steps_fused, latent
    folded first) against the Pallas trace kernel: N = 1500 lanes in tiles
    of 1024 (a padded tail), with pre-resolved lanes on the primary rays."""
    network, rays, kw, k = CASES[case]
    params, latent = _network(network)
    escape = None
    if rays == "inward":
        pts, dirs, status = _inward_rays(1500, seed=4)
    else:
        pts, dirs, status, escape = _upward_rays(1500, seed=7)
        if rays == "upward":
            escape = None
    got = K.trace_steps_fused(
        _tparams(params), torch.tensor(latent), torch.tensor(pts), torch.tensor(dirs),
        torch.tensor(status), k=k, escape=None if escape is None else torch.tensor(escape), **kw)
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32
    with pltpu.force_tpu_interpret_mode():
        want = jax_trace_steps_fused(
            _jparams(params), jnp.asarray(latent), jnp.asarray(pts), jnp.asarray(dirs),
            jnp.asarray(status), k=k, tile=1024,
            escape=None if escape is None else jnp.asarray(escape), **kw)
    w_st = np.asarray(want[1])
    # The fixture must resolve lanes both ways or march them far.
    assert (w_st != K.TRACE_ACTIVE).mean() > 0.3, np.bincount(w_st)
    _assert_traces_close([t.numpy() for t in got], want, start=(pts, status))
    if rays == "upward-escape":  # the per-lane heights bite
        y = got[0].numpy()[:, 1]
        missed = got[1].numpy() == K.TRACE_MISS
        low, high = missed & (np.arange(1500) % 2 == 0), missed & (np.arange(1500) % 2 == 1)
        assert (y[low] <= 1.0 + 0.11).all() and (y[high] > 1.6).mean() > 0.9


def test_trace_update_hit_beats_miss_and_resolved_lanes_stay():
    """One update on hand-made lanes: a lane both outside and in the hit
    window hits; resolved lanes neither move nor change; a shadow lane
    misses above its own escape height."""
    pts = torch.tensor([[0.0, 0.0, 0.99], [0.0, 0.0, 0.5], [0.0, 0.0, 0.995],
                        [0.0, 0.0, 0.5], [0.0, 0.9, 0.0]])
    dirs = torch.tensor([[0.0, 0.0, 1.0]] * 4 + [[0.0, 1.0, 0.0]])
    status = torch.tensor([0, 0, 1, 2, 0], dtype=torch.int32)
    sdf = torch.tensor([0.004, 0.004, 0.03, 0.03, 0.05])
    kw = dict(threshold=0.005, step_clamp=0.02, sdf_offset=0.0, radius=1.0)
    p, s = K.trace_update(pts, dirs, status, sdf, shadow=False, **kw)
    assert s.tolist()[:4] == [K.TRACE_HIT, K.TRACE_HIT, K.TRACE_HIT, K.TRACE_MISS]
    assert float(p[0, 2]) > 0.99 and torch.equal(p[2:4], pts[2:4])
    p, s = K.trace_update(pts, dirs, status, sdf, shadow=True,
                          escape=torch.tensor([9.0, 9.0, 9.0, 9.0, 0.91]), **kw)
    assert int(s[4]) == K.TRACE_MISS and abs(float(p[4, 1]) - 0.92) < 1e-6


def _plain_trace_case(kind, n, seed):
    """Operands and keywords of B4's plain version on the octahedron:
    inward rays with pre-resolved lanes (primary) or upward rays with
    escape heights (shadow)."""
    params, latent = _network("octahedron")
    weights = K.point_weights(_tparams(params), torch.tensor(latent))
    if kind == "primary":
        pts, dirs, status = _inward_rays(n, seed)
        escape = None
        kw = dict(shadow=False, threshold=0.005, step_clamp=0.05, sdf_offset=0.0, radius=1.0)
    else:
        pts, dirs, status, escape = _upward_rays(n, seed)
        escape = torch.tensor(escape)
        kw = dict(shadow=True, threshold=0.005, step_clamp=0.1, sdf_offset=0.0, radius=1.0)
    return (torch.tensor(pts), torch.tensor(dirs), torch.tensor(status), escape) + weights, kw


@pytest.mark.parametrize("kind", ["primary", "shadow"])
def test_trace_plain_is_permutation_equivariant(kind):
    """The trace kernel hands lanes to slots in any order: permuting the
    lanes permutes the plain version's outputs bit for bit."""
    ops, kw = _plain_trace_case(kind, 300, seed=21)
    perm = torch.tensor(np.random.default_rng(22).permutation(300))
    lanes = [t if t is None else t[perm] for t in ops[:4]]
    want = K.trace_steps_plain(*ops, k=16, **kw)
    got = K.trace_steps_plain(*lanes, *ops[4:], k=16, **kw)
    assert torch.equal(got[0], want[0][perm]) and torch.equal(got[1], want[1][perm])
    assert (want[1] != K.TRACE_ACTIVE).any() and (want[1] == K.TRACE_ACTIVE).any()


@pytest.mark.parametrize("kind, k1, k2", [("primary", 5, 11), ("primary", 1, 15), ("shadow", 7, 9)])
def test_trace_plain_steps_compose(kind, k1, k2):
    """Each lane's steps depend on the lane alone, so k1 steps and then k2
    more equal k1 + k2 steps in one call, bit for bit: the kernel may run a
    lane's steps in any evaluations of any slot."""
    ops, kw = _plain_trace_case(kind, 300, seed=23)
    mid_pts, mid_status = K.trace_steps_plain(*ops, k=k1, **kw)
    got = K.trace_steps_plain(mid_pts, ops[1], mid_status, *ops[3:], k=k2, **kw)
    want = K.trace_steps_plain(*ops, k=k1 + k2, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    # lanes still marching after k1 steps, and lanes that resolve in the k2
    assert (mid_status == K.TRACE_ACTIVE).any()
    assert ((mid_status == K.TRACE_ACTIVE) & (want[1] != K.TRACE_ACTIVE)).any()


def test_trace_cuda_wrapper_raises_on_cpu_tensors():
    """The trace kernel's wrapper launches or raises; it never falls back."""
    params, latent = _network("octahedron")
    pts, dirs, status = _inward_rays(64, seed=1)
    weights = K.point_weights(_tparams(params), torch.tensor(latent))
    before = K.trace_steps_cuda.launch_count
    with pytest.raises(ValueError, match="CUDA kernel"):
        K.trace_steps_cuda(torch.tensor(pts), torch.tensor(dirs), torch.tensor(status), None,
                           *weights, k=2, shadow=False, threshold=0.005, step_clamp=0.02,
                           sdf_offset=0.0, radius=1.0)
    assert K.trace_steps_cuda.launch_count == before


def _camera_fixture(size, escape=False):
    cam = np.asarray(jax_rm.CAMERA_POSITION, np.float32)
    pts, dirs, entered = jax_rm.camera_rays(cam, size)
    status = np.where(entered, K.TRACE_ACTIVE, K.TRACE_MISS).astype(np.int32)
    esc = np.where(np.arange(size * size) % 2 == 0, 1.0, 0.6).astype(np.float32) if escape else None
    return pts.astype(np.float32), dirs.astype(np.float32), status, esc


def _port_staged(kind, params, pts, dirs, status, budget, kw, schedule, escape=None, tail_cap=120):
    return rm._trace_staged(
        kind, _tparams(params), torch.zeros(128), torch.tensor(pts), torch.tensor(dirs),
        torch.tensor(status), budget, kw["threshold"], kw["step_clamp"], kw["sdf_offset"],
        kw["radius"], schedule, tail_cap=tail_cap,
        escape=None if escape is None else torch.tensor(escape))


def test_compaction_is_invisible():
    """A schedule with real buckets gives bit for bit the points and status
    of the same stages with no-op buckets (size >= n skips the gather and
    scatter): 56^2 camera rays at the octahedron with a positive SDF offset,
    so lanes march slowly and irregularly across every stage boundary."""
    params, _ = _network("octahedron")
    pts, dirs, status, esc = _camera_fixture(56, escape=True)
    n = pts.shape[0]
    kw = dict(threshold=0.0005, step_clamp=0.02, sdf_offset=0.03, radius=1.0)
    real = ((0, -(-n * 9 // 10)), (60, -(-n * 3 // 4)), (40, -(-n // 2)))
    noop = ((0, n), (60, n), (40, n))
    a = _port_staged("primary", params, pts, dirs, status, 220, kw, real)
    b = _port_staged("primary", params, pts, dirs, status, 220, kw, noop)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert set(np.unique(a[1].numpy())) == {K.TRACE_ACTIVE, K.TRACE_HIT, K.TRACE_MISS}
    # Shadow rays carry per-lane escape heights through the bucket.
    shadow_kw = dict(kw, step_clamp=0.1)
    a = _port_staged("shadow", params, pts, dirs, status, 80, shadow_kw, ((40, -(-n * 3 // 4)),),
                     escape=esc, tail_cap=None)
    b = _port_staged("shadow", params, pts, dirs, status, 80, shadow_kw, ((40, n),), escape=esc,
                     tail_cap=None)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("kind", ["primary", "shadow"])
def test_staged_trace_switch_on_equals_off(kind, monkeypatch):
    """The fused switch changes how the trace runs, not what it computes:
    on the CPU both settings run the plain versions of B3 (per iteration) or
    B4 (K per call) at the same rounding points, and agree bit for bit,
    through the compaction schedule and the chunked early-exit tail."""
    params, _ = _network("octahedron")
    pts, dirs, status, esc = _camera_fixture(56, escape=kind == "shadow")
    n = pts.shape[0]
    kw = dict(threshold=0.0005, step_clamp=0.02 if kind == "primary" else 0.1, sdf_offset=0.0,
              radius=1.0)
    schedule = rm._default_schedule(kind, n, 1000)
    assert schedule and n >= rm.FUSED_MIN_LANES
    runs = []
    for fused in (False, True):
        monkeypatch.setattr(rm, "_FORCE_FUSED_TRACE", fused)
        runs.append(_port_staged(kind, params, pts, dirs, status, 1000 if kind == "primary" else 200,
                                 kw, schedule, escape=esc,
                                 tail_cap=rm.TAIL_ITERS if kind == "primary" else None))
    torch.testing.assert_close(runs[0], runs[1], rtol=0, atol=0)
    assert (runs[0][1] != K.TRACE_ACTIVE).float().mean() > 0.3


@pytest.mark.parametrize("fused", [False, True])
def test_staged_trace_matches_jax_f32(fused, monkeypatch):
    """The port's bf16 staged trace against the JAX package's _trace_staged,
    which runs the float32 network on the CPU: 64^2 camera rays at the
    octahedron through the primary schedule (compaction and the tail cap
    engage). Bounds: the JAX package's own for bf16 against float32."""
    monkeypatch.setattr(rm, "_FORCE_FUSED_TRACE", fused)
    params, _ = _network("octahedron")
    pts, dirs, status, _ = _camera_fixture(64)
    n = pts.shape[0]
    kw = dict(threshold=0.0005, step_clamp=0.02, sdf_offset=0.0, radius=1.0)
    schedule = rm._default_schedule("primary", n, 1000)
    assert schedule == jax_rm._default_schedule("primary", n, 1000)
    got = _port_staged("primary", params, pts, dirs, status, 1000, kw, schedule)
    want = jax_rm._trace_staged("primary", _jparams(params), jnp.zeros(128), jnp.asarray(pts),
                                jnp.asarray(dirs), jnp.asarray(status), 1000, 0.0005, 0.02, 0.0,
                                1.0, schedule, tail_cap=jax_rm.TAIL_ITERS)
    g_pts, g_st = got[0].numpy(), got[1].numpy()
    w_pts, w_st = np.asarray(want[0]), np.asarray(want[1])
    agree = g_st == w_st
    assert agree.mean() > BF16_VS_F32_AGREE, agree.mean()
    hit = agree & (g_st == K.TRACE_HIT)
    assert hit.sum() > 0.05 * n
    np.testing.assert_allclose(g_pts[hit], w_pts[hit], atol=BF16_VS_F32_HIT_ATOL)
