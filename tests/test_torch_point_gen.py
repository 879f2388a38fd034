"""The port's point-GAN networks and its generator kernel's plain version held
against the JAX package on the CPU: ``generate_plain`` against the Pallas
kernel (``point_gen_pallas.generate_fused``) in interpret mode, the modules
against flax ``apply`` in float32 and bf16, the parameter converters, and the
``generate_best`` switch."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from shapegan_tpu.models.point_sdf_net import PointNet as JaxPointNet
from shapegan_tpu.models.point_sdf_net import SDFGenerator as JaxSDFGenerator
from shapegan_tpu.ops.point_gen_pallas import generate_fused as jax_generate_fused
from shapegan_tpu_torch.models import point_sdf_net as P
from shapegan_tpu_torch.ops import point_gen_kernels as PG

# generate_plain against the Pallas kernel in interpret mode, both at the
# kernel's rounding points. The LayerNorm sums and the products run in
# another order, so now and then an activation lands on the other side of a
# bf16 rounding and the flip spreads through the later layers: read max
# 3.4e-3, mean 8.2e-6 (output scale 0.37). A plain version with the pre-norm
# sum rounded to bf16 (flax's rounding point) reads max 7.2e-3, mean 1.6e-3:
# the mean bound tells it apart, the max bound only catches gross errors.
PALLAS_MAX_ABS = 1e-2
PALLAS_MEAN_ABS = 1e-4
# The modules against flax in float32: summation order only (read 9e-7 on
# the generator, 6e-9 on the critic).
F32_ATOL = 1e-5
# In bf16: the same rounding points, but a product's float32 sum in another
# order flips a bf16 rounding now and then (read: generator max 3.9e-3, one
# bf16 step of its 0.66 output, mean 1.8e-5; critic exact).
BF16_MAX_ABS = 1e-2
BF16_MEAN_ABS = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread per test: under pytest-xdist the workers share
    the cores, and PyTorch's default of a thread per core oversubscribes
    them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(batch, n, seed=0):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-1, 1, (batch, n, 3)).astype(np.float32)
    z = rng.normal(size=(batch, 128)).astype(np.float32)
    dist = rng.uniform(-0.1, 0.1, (batch, n, 1)).astype(np.float32)
    return pos, z, dist


def _port_generator(params, dtype):
    gen = P.SDFGenerator(dtype=dtype)
    gen.load_state_dict(P.params_from_jax(jax.tree.map(np.asarray, params)))
    return gen


def _pallas_case():
    pos, z, _ = _inputs(3, 1024)
    gen = JaxSDFGenerator(dtype=jnp.bfloat16)
    params = gen.init(jax.random.PRNGKey(2), pos, z)["params"]
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_generate_fused(params, pos, z, tile=512))
    port = dict(_port_generator(params, torch.bfloat16).named_parameters())
    return port, torch.tensor(pos), torch.tensor(z), want


def test_generate_plain_matches_pallas_interpreted():
    """B = 3, N = 1024, tile 512: tiles of several items (the JAX package's
    own test shape)."""
    params, pos, z, want = _pallas_case()
    with torch.no_grad():
        got = PG.generate_fused(params, pos, z).numpy()
    assert got.shape == want.shape == (3, 1024, 1)
    diff = np.abs(got - want)
    print(f"max {diff.max():.3e} mean {diff.mean():.3e}")
    assert diff.max() <= PALLAS_MAX_ABS and diff.mean() <= PALLAS_MEAN_ABS
    assert np.abs(got[0] - got[1]).max() > 1e-3  # each item reads its own latent rows


def test_generate_plain_mutant_fails_the_bound(monkeypatch):
    """The pre-norm sum rounded to bf16 before the LayerNorm (flax's
    rounding point, not the kernel's) falls outside the bounds above."""
    params, pos, z, want = _pallas_case()
    ln_relu = PG._ln_relu
    monkeypatch.setattr(PG, "_ln_relu", lambda x, g, b: ln_relu(x.to(torch.bfloat16).float(), g, b))
    with torch.no_grad():
        got = PG.generate_fused(params, pos, z).numpy()
    diff = np.abs(got - want)
    assert diff.mean() > PALLAS_MEAN_ABS, diff.mean()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_generator_matches_flax(dtype):
    pos, z, _ = _inputs(3, 256, seed=1)
    jdtype, tdtype = getattr(jnp, dtype), getattr(torch, dtype)
    gen = JaxSDFGenerator(dtype=jdtype)
    params = gen.init(jax.random.PRNGKey(0), pos, z)["params"]
    want = np.asarray(gen.apply({"params": params}, pos, z))
    with torch.no_grad():
        got = _port_generator(params, tdtype)(torch.tensor(pos), torch.tensor(z)).numpy()
        # the dtype override: the bf16 module run in float32 is the float32 module
        f32 = _port_generator(params, torch.bfloat16)(torch.tensor(pos), torch.tensor(z),
                                                       dtype=torch.float32).numpy()
    assert got.shape == want.shape == (3, 256, 1) and got.dtype == np.float32
    diff = np.abs(got - want)
    print(f"{dtype}: max {diff.max():.3e} mean {diff.mean():.3e}")
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=0)
        np.testing.assert_array_equal(f32, got)
    else:
        assert diff.max() <= BF16_MAX_ABS and diff.mean() <= BF16_MEAN_ABS
    # unbatched inputs take the batch of one
    with torch.no_grad():
        one = _port_generator(params, tdtype)(torch.tensor(pos[0]), torch.tensor(z[0])).numpy()
    np.testing.assert_allclose(one, got[:1], atol=F32_ATOL if dtype == "float32" else BF16_MAX_ABS)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pointnet_matches_flax(dtype):
    """Plain max pool, a mask, and a ragged batch vector with an empty
    segment (-inf features there, as jax.ops.segment_max, so NaN scores in
    both: assert_allclose holds NaN to NaN)."""
    pos, _, dist = _inputs(2, 128, seed=2)
    jdtype, tdtype = getattr(jnp, dtype), getattr(torch, dtype)
    critic = JaxPointNet(dtype=jdtype)
    params = critic.init(jax.random.PRNGKey(1), pos, dist)["params"]
    port = P.PointNet(dtype=tdtype)
    port.load_state_dict(P.params_from_jax(jax.tree.map(np.asarray, params)))
    mask = np.random.default_rng(3).random((2, 128)) < 0.6
    flat_pos, flat_dist = pos.reshape(-1, 3), dist.reshape(-1)
    batch = np.repeat(np.array([0, 2], np.int32), 128)  # segment 1 empty
    cases = {
        "plain": (critic.apply({"params": params}, pos, dist),
                  lambda: port(torch.tensor(pos), torch.tensor(dist))),
        "mask": (critic.apply({"params": params}, pos, dist, mask=mask),
                 lambda: port(torch.tensor(pos), torch.tensor(dist), mask=torch.tensor(mask))),
        "batch": (critic.apply({"params": params}, flat_pos, flat_dist, batch=batch, num_segments=3),
                  lambda: port(torch.tensor(flat_pos), torch.tensor(flat_dist),
                               batch=torch.tensor(batch, dtype=torch.int64), num_segments=3)),
    }
    for name, (want, run) in cases.items():
        want = np.asarray(want)
        with torch.no_grad():
            got = run().numpy()
        assert got.shape == want.shape and got.dtype == np.float32, name
        tol = F32_ATOL if dtype == "float32" else BF16_MAX_ABS
        np.testing.assert_allclose(got, want, atol=tol, rtol=0, err_msg=name)


def test_params_round_trip():
    """flax tree → port → flax tree, and the port's names and layouts."""
    pos, z, dist = _inputs(2, 64)
    g_params = JaxSDFGenerator().init(jax.random.PRNGKey(0), pos, z)["params"]
    d_params = JaxPointNet().init(jax.random.PRNGKey(1), pos, dist)["params"]
    for tree, module in ((g_params, P.SDFGenerator()), (d_params, P.PointNet())):
        tree = jax.tree.map(np.asarray, tree)
        state = P.params_from_jax(tree)
        assert set(state) == set(dict(module.named_parameters()))
        module.load_state_dict(state)
        back = P.params_to_jax(dict(module.named_parameters()))
        assert jax.tree.structure(jax.tree.map(lambda t: 0, back)) == jax.tree.structure(
            jax.tree.map(lambda a: 0, tree))
        jax.tree.map(lambda a, b: np.testing.assert_array_equal(a.numpy(), b), back, tree)
    assert tuple(state["Dense_0.weight"].shape) == (64, 4)  # torch [out, in]


def test_fresh_init_bounds():
    """U(±1/sqrt(fan_in)) weights and biases, LayerNorm 1 / 0, from the given
    generator: the same seed gives the same parameters."""
    a = P.SDFGenerator(generator=torch.Generator().manual_seed(7))
    b = P.SDFGenerator(generator=torch.Generator().manual_seed(7))
    for (name, p), q in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(p, q), name
        if name.startswith("norm"):
            assert torch.equal(p, torch.ones_like(p) if name.endswith("scale") else torch.zeros_like(p))
        else:
            layer = getattr(a, name.split(".")[0])
            assert float(p.abs().max()) <= 1.0 / np.sqrt(layer.in_features)


def test_generator_dropout_draws_from_the_given_generator():
    """Dropout only with ``train``, its mask from the ``generator`` passed."""
    gen = P.SDFGenerator(dropout=0.5, generator=torch.Generator().manual_seed(5))
    pos, z, _ = (torch.tensor(a) for a in _inputs(2, 64, seed=6))
    with torch.no_grad():
        runs = [gen(pos, z, train=True, generator=torch.Generator().manual_seed(s)) for s in (1, 1, 2)]
        assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])
        assert torch.equal(gen(pos, z), gen(pos, z, generator=torch.Generator().manual_seed(1)))
        assert not torch.equal(gen(pos, z), runs[0])


@pytest.mark.parametrize("fused", [True, False])
def test_generate_best_switch_on_cpu(monkeypatch, fused):
    """CPU tensors take the module in its own dtype with the switch on or
    off (the JAX package's choice off a TPU); the kernel's plain version is
    another computation."""
    monkeypatch.setattr(PG, "_FORCE_FUSED_GENERATE", fused)
    gen = P.SDFGenerator(dtype=torch.bfloat16, generator=torch.Generator().manual_seed(3))
    params = dict(gen.named_parameters())
    pos, z, _ = (torch.tensor(a) for a in _inputs(2, 200, seed=4))
    with torch.no_grad():
        got = PG.generate_best(gen, params, pos, z)
        plain = PG.generate_plain(*PG.generate_operands(params, pos, z))[..., None]
        module = gen(pos, z)
    assert got.shape == (2, 200, 1)
    assert torch.equal(got, module)
    assert not torch.equal(plain, module)
    # a generator the kernel does not cover takes the module either way
    gen_dropout = P.SDFGenerator(dtype=torch.bfloat16, dropout=0.1)
    with torch.no_grad():
        out = PG.generate_best(gen_dropout, dict(gen_dropout.named_parameters()), pos, z)
        assert torch.equal(out, gen_dropout(pos, z))


def test_generate_cuda_refuses_cpu_tensors():
    gen = P.SDFGenerator()
    pos, z, _ = (torch.tensor(a) for a in _inputs(1, 16))
    with torch.no_grad():
        ops = PG.generate_operands(dict(gen.named_parameters()), pos, z)
    before = PG.generate_cuda.launch_count
    with pytest.raises(ValueError, match="on cpu"):
        PG.generate_cuda(*ops)
    assert PG.generate_cuda.launch_count == before
