"""The rowwise kernels (B6) of the port — the plain versions
``sdf_mlp_kernels.rowwise_forward_plain`` / ``rowwise_backward_plain`` behind
``apply_rowwise_trainable`` and ``apply_rowwise`` — held against the JAX
package's ``apply_rowwise_trainable`` / ``apply_rowwise`` with its Pallas
``_rowwise_kernel`` / ``_rowwise_bwd_kernel`` in interpret mode, on the CPU.

Inputs are made with numpy from a seed: n = 1000 points at tile 256 (four
tiles, a padded tail of 24 rows), per-point latents drawn from a 5-row
table, the weights from the JAX package's init.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from shapegan_tpu.ops import sdf_mlp as jax_mlp
from shapegan_tpu.ops import sdf_mlp_pallas
from shapegan_tpu_torch.ops import sdf_mlp, sdf_mlp_kernels
from shapegan_tpu.models.sdf_net import SDFNet as JaxSDFNet
from shapegan_tpu.train import sdf_autodecoder as jax_trainer
from shapegan_tpu_torch.train import sdf_autodecoder

N, TILE, SHAPES = 1000, 256, 5
BF16 = torch.bfloat16

# B6a's plain version against the Pallas forward on the same bf16 zz1/zz5:
# the same rounding points, so only the head's float32 summation order
# differs (reading: max 2.2e-8). Through apply_rowwise the zz products are
# bf16 matmuls of both frameworks, which round 1.2e-5 of the zz entries the
# other way; one bf16 step there moves an output by up to ~2e-4 (reading:
# max 1.6e-4, mean 9e-6).
FWD_MAX, FWD_MEAN = 1e-5, 1e-6
APPLY_MAX, APPLY_MEAN = 1e-3, 5e-5
# B6b's plain version against jax.vjp of the Pallas custom VJP, per
# gradient, ||d||_2 / ||ref||_2 and max|d| / max|ref|. Each dz is rounded to
# bf16 and feeds the next layer, so float32 sums in another order flip a
# few roundings and the flips spread (as for the grid backward,
# test_torch_grid_backward.py). Reading of the sound plain version (worst
# over the 18 outputs): L2 3.0e-4 (w8), max 1.6e-3 (zz1). The mutant at
# B2's rounding points (test_rowwise_backward_rounding_mutant_fails_bounds)
# reads L2 >= 8e-2 and max >= 0.1 on the trunk's gradients. The bounds sit
# ten times above the sound reading and ten times below the mutant's.
BWD_BOUNDS = {"l2": 3e-3, "max": 1.5e-2}
# The whole loss gradient (the gather, the bf16 zz products and B6) against
# jax.grad through the JAX package's apply_rowwise, by BWD_BOUNDS. Readings:
# L2 <= 3.5e-4 and max <= 2.0e-3 (w1z) for the trunk, w1z, w5z and the
# table, but b1 5.5e-3 / 7.8e-3 and b5 6.4e-3 / 1.3e-2: their gradients are
# bf16 sums over the batch in both frameworks (autograd through the bf16 zz
# products), and one bf16 step is 2^-8 = 3.9e-3 relative; they get bounds
# of a few bf16 steps.
BF16_SUM_KEYS = ("b1", "b5")
BF16_SUM_BOUNDS = {"l2": 2e-2, "max": 3e-2}
# Against float32 truth, by cosine: the criterion of the JAX package's own
# bf16 step test (tests/test_train_autodecoder.py). Readings, lowest over the
# parameters: the port 0.99942 (w1p), the JAX package's XLA bf16 step
# 0.99931 (w1p); the table 0.99995 for both.
COSINE = 0.98


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread per test: under pytest-xdist the workers share
    the cores, and PyTorch's default of a thread per core oversubscribes
    them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=1)
def _params():
    np_params = {k: np.asarray(v) for k, v in jax_mlp.init(jax.random.PRNGKey(0)).items()}
    return np_params, sdf_mlp.params_from_jax(np_params)


@functools.lru_cache(maxsize=1)
def _inputs():
    rng = np.random.default_rng(11)
    pts = rng.uniform(-1, 1, (N, 3)).astype(np.float32)
    table = (rng.normal(size=(SHAPES, 128)) * 0.3).astype(np.float32)
    idx = rng.integers(0, SHAPES, N).astype(np.int32)
    g = rng.normal(size=N).astype(np.float32)
    sdf = np.clip(rng.normal(0, 0.05, N), -0.1, 0.1).astype(np.float32)
    return pts, table, idx, g, sdf


@functools.lru_cache(maxsize=1)
def _zz():
    """zz1/zz5 as the port computes them (bf16), handed to both sides."""
    _, params = _params()
    pts, table, idx, _, _ = _inputs()
    zz1, zz5 = sdf_mlp_kernels.latent_terms(params, torch.tensor(table[idx]))
    return zz1, zz5


def _to_jax_bf16(t: torch.Tensor):
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


@functools.lru_cache(maxsize=1)
def _jax_trainable_vjp():
    """Forward and every cotangent of the Pallas apply_rowwise_trainable."""
    np_params, _ = _params()
    pts, _, _, g, _ = _inputs()
    zz1, zz5 = _zz()
    with pltpu.force_tpu_interpret_mode():
        out, vjp = jax.vjp(
            lambda p, x, a, b: sdf_mlp_pallas.apply_rowwise_trainable(p, x, a, b, TILE),
            {k: jnp.asarray(v) for k, v in np_params.items()}, jnp.asarray(pts),
            _to_jax_bf16(zz1), _to_jax_bf16(zz5))
        d_params, d_pts, d_zz1, d_zz5 = vjp(jnp.asarray(g))
    return np.asarray(out), d_params, d_pts, d_zz1, d_zz5


def _rel_errors(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    diff = got - ref
    return (np.linalg.norm(diff) / max(np.linalg.norm(ref), 1e-30),
            np.abs(diff).max() / max(np.abs(ref).max(), 1e-30))


def _port_trainable_grads(backward_plain=None, monkeypatch=None):
    """Forward and gradients of the port's apply_rowwise_trainable (plain
    versions), optionally with another backward plain version."""
    _, params = _params()
    pts, _, _, g, _ = _inputs()
    zz1, zz5 = _zz()
    if backward_plain is not None:
        monkeypatch.setattr(sdf_mlp_kernels, "rowwise_backward_plain", backward_plain)
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    x = torch.tensor(pts, requires_grad=True)
    a, b = zz1.clone().requires_grad_(True), zz5.clone().requires_grad_(True)
    out = sdf_mlp_kernels.apply_rowwise_trainable(leaves, x, a, b)
    out.backward(torch.tensor(g))
    grads = {k: leaves[k].grad for k in sdf_mlp_kernels._ROWWISE_KEYS}
    grads.update(points=x.grad, zz1=a.grad, zz5=b.grad)
    return out.detach(), grads


def _trainable_errors(grads):
    _, d_params, d_pts, d_zz1, d_zz5 = _jax_trainable_vjp()
    refs = {k: d_params[k] for k in sdf_mlp_kernels._ROWWISE_KEYS}
    refs.update(points=d_pts, zz1=np.asarray(d_zz1.astype(jnp.float32)),
                zz5=np.asarray(d_zz5.astype(jnp.float32)))
    return {k: _rel_errors(grads[k].float().numpy(), refs[k]) for k in refs}


def test_rowwise_forward_plain_matches_pallas_interpreted():
    """B6a's plain version on the same bf16 zz1/zz5 as the Pallas
    forward (n=1000, tile 256: a padded tail)."""
    _, params = _params()
    pts, *_ = _inputs()
    zz1, zz5 = _zz()
    ref = _jax_trainable_vjp()[0]
    got = sdf_mlp_kernels.rowwise_forward(
        *sdf_mlp_kernels.rowwise_operands(params, torch.tensor(pts), zz1, zz5)).numpy()
    diff = np.abs(got - ref)
    assert got.shape == (N,) and got.dtype == np.float32
    assert diff.max() <= FWD_MAX and diff.mean() <= FWD_MEAN, (diff.max(), diff.mean())


def test_apply_rowwise_matches_pallas_interpreted():
    """The port's apply_rowwise (zz products and B6a's plain version)
    against the JAX package's apply_rowwise with latents gathered from a
    table."""
    np_params, params = _params()
    pts, table, idx, _, _ = _inputs()
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(sdf_mlp_pallas.apply_rowwise(
            {k: jnp.asarray(v) for k, v in np_params.items()}, jnp.asarray(pts),
            jnp.asarray(table[idx]), tile=TILE))
    got = sdf_mlp_kernels.apply_rowwise(params, torch.tensor(pts), torch.tensor(table[idx]))
    diff = np.abs(got.detach().numpy() - ref)
    assert diff.max() <= APPLY_MAX and diff.mean() <= APPLY_MEAN, (diff.max(), diff.mean())


def test_rowwise_backward_plain_matches_pallas_interpreted():
    """B6b's plain version through the autograd function: dzz1, dzz5 (in
    bf16, as the JAX VJP returns them), every parameter cotangent the
    kernel gives and d_points, against jax.vjp of the Pallas custom VJP."""
    out, grads = _port_trainable_grads()
    assert grads["zz1"].dtype == BF16 and grads["zz5"].dtype == BF16
    for name, (l2, mx) in _trainable_errors(grads).items():
        assert l2 <= BWD_BOUNDS["l2"] and mx <= BWD_BOUNDS["max"], (name, l2, mx)


def _backward_from(p, pp1, pp5, zz1, zz5, w, b, w8, g):
    """B6b's plain math (as ``rowwise_backward_plain``) from given float32
    layer-1 and layer-5 point projections ``pp1``/``pp5``."""
    wf, bf, w8f = w.float(), b.float(), w8.float()
    keys, skip = sdf_mlp_kernels.TRUNK_KEYS, sdf_mlp_kernels.SKIP_LAYER
    h = [torch.relu(pp1 + zz1.float()).to(BF16)]
    for layer in range(len(keys)):
        acc = h[-1].float() @ wf[layer].t()
        acc = acc + pp5 + zz5.float() if layer == skip else acc + bf[layer]
        h.append(torch.relu(acc).to(BF16))
    out = torch.tanh(h[-1].float() @ w8f + bf[sdf_mlp_kernels.HEAD_BIAS_ROW, 0])
    gz = g.float() * (1.0 - out * out)
    d_w = torch.zeros(wf.shape)
    d_b = torch.zeros((8, sdf_mlp_kernels.WIDTH))
    dh = gz[:, None] * w8f[None, :]
    for layer in reversed(range(len(keys))):
        dz = (dh * (h[layer + 1] > 0)).to(BF16).float()
        d_w[layer] = h[layer].float().t() @ dz
        if layer == skip:
            dzz5 = dz
        else:
            d_b[layer] = dz.sum(0)
        dh = dz @ wf[layer]
    return dh * (h[0] > 0), dzz5, d_w, d_b, h[-1].float().t() @ gz, gz.sum().reshape(1)


def _mutant_b2_rounding(pts, w1p, w5p, zz1, zz5, w, b, w8, g):
    """B6b's plain version at the grid backward's (B2's) rounding points:
    the point projections rounded to bf16 before they are added."""
    p = pts.to(BF16).float()
    return _backward_from(p, (p @ w1p.float()).to(BF16).float(), (p @ w5p.float()).to(BF16).float(),
                          zz1, zz5, w, b, w8, g)


def _sound_from(pts, w1p, w5p, zz1, zz5, w, b, w8, g):
    p = pts.to(BF16).float()
    return _backward_from(p, p @ w1p.float(), p @ w5p.float(), zz1, zz5, w, b, w8, g)


def test_rowwise_backward_rounding_mutant_fails_bounds(monkeypatch):
    """The bounds of test_rowwise_backward_plain_matches_pallas_interpreted
    tell B6b's rounding points from B2's: the mutant fails them, while the
    same math at the sound rounding points (``_backward_from``, a second
    writing of the plain version) passes."""
    _, sound = _port_trainable_grads(_sound_from, monkeypatch)
    _, mutant = _port_trainable_grads(_mutant_b2_rounding, monkeypatch)
    ok = lambda errs: all(l2 <= BWD_BOUNDS["l2"] and mx <= BWD_BOUNDS["max"]  # noqa: E731
                          for l2, mx in errs.values())
    sound_errs, mutant_errs = _trainable_errors(sound), _trainable_errors(mutant)
    print({k: (f"{v[0]:.2e}", f"{v[1]:.2e}") for k, v in mutant_errs.items()})
    assert ok(sound_errs)
    assert not ok(mutant_errs), mutant_errs


def _port_loss_grads(params):
    """The trainer's loss_and_grads on a dataset laid out so that batch row
    j is point j of shape idx[j]: SHAPES copies of the N points."""
    pts, table, idx, _, sdf = _inputs()
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    codes = torch.tensor(table, requires_grad=True)
    indices = torch.tensor(idx.astype(np.int64) * N + np.arange(N))
    loss, grads, code_grad = sdf_autodecoder.loss_and_grads(
        leaves, codes, torch.tensor(np.tile(pts, (SHAPES, 1))), torch.tensor(np.tile(sdf, SHAPES)),
        indices, N)
    return float(loss), grads, code_grad


def _jax_loss(apply):
    pts, _, idx, _, sdf = _inputs()

    def loss_fn(p, codes):
        rows = codes[jnp.asarray(idx)]
        out = apply(p, jnp.asarray(pts), rows)
        return (jnp.mean(jnp.abs(out - jnp.asarray(sdf)))
                + jax_trainer.SIGMA * jnp.mean(rows**2))

    return loss_fn


def test_loss_gradient_matches_jax_apply_rowwise():
    """The autodecoder loss's gradient for every parameter and the latent
    table (gather, zz products, B6a/B6b plain versions, the table's
    scatter-add) against jax.grad through the JAX package's apply_rowwise
    with the Pallas kernels in interpret mode."""
    np_params, params = _params()
    _, table, _, _, _ = _inputs()
    loss_fn = _jax_loss(lambda p, x, z: sdf_mlp_pallas.apply_rowwise(p, x, z, tile=TILE))
    with pltpu.force_tpu_interpret_mode():
        ref_loss, (ref_params, ref_codes) = jax.value_and_grad(loss_fn, argnums=(0, 1))(
            {k: jnp.asarray(v) for k, v in np_params.items()}, jnp.asarray(table))
    loss, grads, code_grad = _port_loss_grads(params)
    assert abs(loss - float(ref_loss)) <= 1e-6 * max(1.0, abs(float(ref_loss)))
    pairs = [(k, grads[k], ref_params[k]) for k in sdf_mlp.PARAM_KEYS] + [
        ("latent table", code_grad, ref_codes)]
    errs = {name: _rel_errors(got.numpy(), ref) for name, got, ref in pairs}
    for name, (l2, mx) in errs.items():
        bounds = BF16_SUM_BOUNDS if name in BF16_SUM_KEYS else BWD_BOUNDS
        assert l2 <= bounds["l2"] and mx <= bounds["max"], (name, l2, mx)


def test_loss_gradient_tracks_float32_like_the_jax_bf16_step():
    """Against the float32 truth (the JAX package's sdf_mlp.apply in
    float32), the port's kernel-path gradient passes the cosine criterion
    the JAX trainer's own XLA bf16 step is held to, for every parameter and
    the latent table."""
    np_params, params = _params()
    _, table, _, _, _ = _inputs()
    net = JaxSDFNet()
    jp = {k: jnp.asarray(v) for k, v in np_params.items()}
    truth = jax.grad(_jax_loss(lambda p, x, z: net.apply(p, x, z)), argnums=(0, 1))(
        jp, jnp.asarray(table))
    xla_bf16 = jax.grad(_jax_loss(lambda p, x, z: net.apply(p, x, z, dtype=jax_trainer.COMPUTE_DTYPE)),
                        argnums=(0, 1))(jp, jnp.asarray(table))
    _, grads, code_grad = _port_loss_grads(params)

    def cosine(a, b):
        a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
        return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))

    for key in sdf_mlp.PARAM_KEYS:
        assert cosine(xla_bf16[0][key], truth[0][key]) > COSINE, key  # the JAX step's own bar
        assert cosine(grads[key].numpy(), truth[0][key]) > COSINE, key
    assert cosine(code_grad.numpy(), truth[1]) > COSINE


def test_rowwise_wrappers_launch_or_raise():
    """The B6 wrappers launch or raise; they never fall back, and a refused
    call does not count as a launch. The dispatchers take the plain versions
    only for CPU tensors."""
    _, params = _params()
    pts, *_ = _inputs()
    g = torch.tensor(_inputs()[3])
    ops = sdf_mlp_kernels.rowwise_operands(params, torch.tensor(pts), *_zz())
    before = (sdf_mlp_kernels.rowwise_forward_cuda.launch_count,
              sdf_mlp_kernels.rowwise_backward_cuda.launch_count)
    with pytest.raises(ValueError, match="CUDA kernel"):
        sdf_mlp_kernels.rowwise_forward_cuda(*ops)
    with pytest.raises(ValueError, match="CUDA kernel"):
        sdf_mlp_kernels.rowwise_backward_cuda(*ops, g)
    with pytest.raises(ValueError, match="CUDA kernel"):  # one row: a tail inside one tile
        sdf_mlp_kernels.rowwise_backward_cuda(*(t[:1] if t.shape[0] == N else t for t in ops), g[:1])
    with pytest.raises(ValueError, match="CUDA kernel"):  # a non-CPU, non-CUDA device
        sdf_mlp_kernels.rowwise_backward(*(t.to("meta") for t in ops), g.to("meta"))
    assert (sdf_mlp_kernels.rowwise_forward_cuda.launch_count,
            sdf_mlp_kernels.rowwise_backward_cuda.launch_count) == before
    outs = sdf_mlp_kernels.rowwise_backward(*ops, g)
    assert [tuple(t.shape) for t in outs] == [(N, 256), (N, 256), (6, 256, 256), (8, 256), (256,), (1,)]
    assert not outs[3][[3, 6, 7]].any()


# The row-locality of B6b's plain version: its per-row outputs of rows
# computed in two calls equal one call's bit for bit (the property the
# kernel's 64-row tiles rely on); its summed outputs differ by the float32
# order of the sums only (readings on the CPU: relative L2 <= 1e-7).
SPLIT_N = 3200
SPLIT_SUMS_L2 = 1e-5


@functools.lru_cache(maxsize=1)
def _split_case():
    _, params = _params()
    rng = np.random.default_rng(23)
    pts = torch.tensor(rng.uniform(-1, 1, (SPLIT_N, 3)).astype(np.float32))
    table = torch.tensor((rng.normal(size=(SHAPES, 128)) * 0.3).astype(np.float32))
    rows = table[torch.tensor(rng.integers(0, SHAPES, SPLIT_N))]
    g = torch.tensor(rng.normal(size=SPLIT_N).astype(np.float32))
    ops = sdf_mlp_kernels.rowwise_operands(params, pts, *sdf_mlp_kernels.latent_terms(params, rows))
    return ops, g, sdf_mlp_kernels.rowwise_backward_plain(*ops, g)


@pytest.mark.parametrize("split", [63, 65, 3001])
def test_rowwise_backward_plain_is_row_local(split):
    """N = 3200 rows in two calls, split at an odd point: dzz1 and dzz5
    equal one call's bit for bit, and the two calls' d_w, d_b, d_w8 and d_b8
    add up to one call's within float32 sum order."""
    (pts, w1p, w5p, zz1, zz5, w, b, w8), g, whole = _split_case()
    parts = [sdf_mlp_kernels.rowwise_backward_plain(pts[sl], w1p, w5p, zz1[sl], zz5[sl], w, b, w8, g[sl])
             for sl in (slice(0, split), slice(split, None))]
    for name, one, a, c in zip(("dzz1", "dzz5"), whole, *parts):
        assert torch.equal(torch.cat([a, c]), one), name
    for name, one, a, c in zip(("d_w", "d_b", "d_w8", "d_b8"), whole[2:], parts[0][2:], parts[1][2:]):
        l2 = float(((a + c).double() - one.double()).norm() / one.double().norm())
        assert l2 <= SPLIT_SUMS_L2, (name, l2)

