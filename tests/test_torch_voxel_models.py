"""The port's voxel networks held against the JAX package's flax modules on
the CPU: the voxel GAN's Generator, the autoencoder (classic and VAE) and
the classifier, forward in train and eval mode with the same parameters
(a JAX init and the bundled checkpoints) and the same numpy inputs; flax's
BatchNorm statistics after a train-mode call; the layout converters both
ways, with the ConvTranspose flip shown to matter; the (V)AE's losses.

Both sides compute in float32; only the summation order differs, so the
tolerances are float32 noise amplified by the small batches' BatchNorm.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shapegan_tpu.models.autoencoder import Autoencoder as JaxAutoencoder
from shapegan_tpu.models.classifier import Classifier as JaxClassifier
from shapegan_tpu.models.gan import Generator as JaxGenerator
from shapegan_tpu.ops import losses as jax_losses
from shapegan_tpu_torch.models import flax_layers
from shapegan_tpu_torch.models.autoencoder import Autoencoder
from shapegan_tpu_torch.models.classifier import Classifier
from shapegan_tpu_torch.models.gan import Generator
from shapegan_tpu_torch.ops import losses

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "shapegan_tpu", "examples")
BATCH = 3
# Generator volumes (tanh, in [-1, 1]): read <= 3.5e-6; a converter without
# the ConvTranspose flip misses by 1.99.
GEN_ATOL = 1e-4
# Autoencoder reconstructions and codes, against the largest entry: BatchNorm
# over 3 values a channel at the 1^3 layers amplifies float32 noise (read
# <= 9.8e-6).
AE_REL = 1e-4
# Classifier probabilities and logits (read <= 3e-8 on probabilities).
CLS_ATOL = 1e-5
# Running statistics after one train-mode call (read <= 4.8e-7).
STATS_ATOL = 1e-5
# A running variance from zeroed statistics, against its largest entry
# (read <= 2.5e-6); torch's unbiased one is 1 / (n - 1) off: 5.2e-3 at n = 192.
STATS_REL = 1e-4
# The losses: float32 sums over 2 x 32^3 elements (read 5.7e-6).
LOSS_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def warm_cpu_tanh():
    """The first multithreaded ``torch.tanh`` of a CPU process has been seen
    to miss tanh by up to 7e-5 on saturated inputs (|x| > 4; every later
    call: 3e-8), which the discriminator's LeakyReLU kinks turn into 1e-3
    of gradient. One call first keeps the comparisons on the port's own
    numbers."""
    torch.tanh(torch.randn(2, 32, 32, 32, generator=torch.Generator().manual_seed(0)))


def _npz_variables(name):
    """A bundled checkpoint (fp16) as flax's nested variables, float32."""
    tree = {}
    with np.load(os.path.join(EXAMPLES, f"{name}.npz")) as data:
        for key in data.files:
            *path, leaf = key.split("/")
            node = tree
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = data[key].astype(np.float32)
    return tree


JAX_MODULES = {"generator": JaxGenerator(), "classic": JaxAutoencoder(is_variational=False),
               "vae": JaxAutoencoder(is_variational=True), "classifier": JaxClassifier(4)}


@functools.lru_cache(maxsize=None)
def _jax(kind, source):
    """(flax module, numpy variables): a JAX init (seed 0) or a bundled file."""
    module = JAX_MODULES[kind]
    if source != "init":
        return module, _npz_variables(source)
    key = jax.random.PRNGKey(0)
    if kind == "generator":
        variables = jax.jit(functools.partial(module.init, train=True))(key, jnp.zeros((2, 128)))
    elif kind == "classifier":
        variables = jax.jit(module.init)(key, jnp.zeros((2, 32, 32, 32)))
    else:
        variables = jax.jit(functools.partial(module.init, train=True))(
            {"params": key, "reparam": key}, jnp.zeros((2, 32, 32, 32)))
    return module, jax.tree.map(np.asarray, variables)


@functools.lru_cache(maxsize=None)
def _apply(kind, train):
    """The flax module's jitted apply, compiled once for every source:
    train mode returns the updated ``batch_stats`` too."""
    if train:
        return jax.jit(functools.partial(JAX_MODULES[kind].apply, train=True,
                                         mutable=["batch_stats"]))
    return jax.jit(functools.partial(JAX_MODULES[kind].apply, train=False))


def _port(kind, variables):
    module = {"generator": Generator, "classic": lambda: Autoencoder(False), "vae": Autoencoder,
              "classifier": lambda: Classifier(4)}[kind]()
    flax_layers.load_variables(module, variables)
    return module


def _volumes(seed, batch=BATCH):
    return np.random.default_rng(seed).uniform(-1, 1, (batch, 32, 32, 32)).astype(np.float32)


def _latents(seed, batch=BATCH):
    return np.random.default_rng(seed).standard_normal((batch, 128)).astype(np.float32)


def _max_err(got, want):
    return float(np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)).max())


def _check_stats(module, jax_stats):
    got = flax_layers.variables_to_jax(module)["batch_stats"]
    assert set(got) == set(jax_stats)
    for layer, leaves in jax_stats.items():
        for leaf, want in leaves.items():
            err = _max_err(got[layer][leaf].numpy(), want)
            assert err <= STATS_ATOL, (layer, leaf, err)


@pytest.mark.parametrize("source", ["init", "generator", "wgan-generator"])
def test_generator_matches_flax(source):
    """Train mode (batch statistics, the running ones stored) and then eval
    mode on the stored statistics, against flax."""
    jgen, variables = _jax("generator", source)
    z = _latents(1)
    want, updates = _apply("generator", True)(variables, z)
    gen = _port("generator", variables)
    got = gen(torch.tensor(z), train=True)
    assert got.shape == (BATCH, 32, 32, 32)
    assert _max_err(got.detach().numpy(), want) <= GEN_ATOL
    _check_stats(gen, jax.tree.map(np.asarray, updates["batch_stats"]))

    stored = {"params": variables["params"], "batch_stats": updates["batch_stats"]}
    want_eval = _apply("generator", False)(stored, z)
    got_eval = gen(torch.tensor(z), train=False)
    assert _max_err(got_eval.detach().numpy(), want_eval) <= GEN_ATOL


@pytest.mark.parametrize("kind,source", [("classic", "init"), ("classic", "autoencoder-128"),
                                         ("vae", "init")])
def test_autoencoder_matches_flax(kind, source):
    """The reconstruction (the VAE's with the same noise, and its mean and
    log-variance), the running statistics, then eval mode, against flax."""
    jmodel, variables = _jax(kind, source)
    x = _volumes(2)
    rng = jax.random.PRNGKey(7)
    eps = np.asarray(jax.random.normal(rng, (BATCH, 128)))  # what the flax module draws from rng
    want, updates = _apply(kind, True)(variables, x, rng=rng)
    model = _port(kind, variables)
    got = model(torch.tensor(x), train=True, eps=torch.tensor(eps))
    if kind == "classic":
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        g, w = g.detach().numpy(), np.asarray(w)
        assert g.shape == w.shape
        assert _max_err(g, w) <= AE_REL * np.abs(w).max()
    _check_stats(model, jax.tree.map(np.asarray, updates["batch_stats"]))

    stored = {"params": variables["params"], "batch_stats": updates["batch_stats"]}
    want_eval = _apply(kind, False)(stored, x)
    got_eval = model(torch.tensor(x), train=False)
    if kind == "vae":  # (mean, mean, None): eval mode decodes the mean
        want_eval, got_eval = want_eval[0], got_eval[0]
    w = np.asarray(want_eval)
    assert _max_err(got_eval.detach().numpy(), w) <= AE_REL * np.abs(w).max()


def test_classifier_matches_flax():
    jmodel, variables = _jax("classifier", "init")
    x = _volumes(3)
    model = _port("classifier", variables)
    for logits in (False, True):
        want = jmodel.apply(variables, x, return_logits=logits)
        got = model(torch.tensor(x), return_logits=logits).detach().numpy()
        assert got.shape == (BATCH, 4)
        assert _max_err(got, want) <= CLS_ATOL
    np.testing.assert_allclose(model(torch.tensor(x)).detach().sum(1).numpy(), 1.0, rtol=1e-6)


def _zero_stats(variables):
    """The variables with every running statistic 0, so that after one
    train-mode call a running variance is 0.1 x the batch's variance."""
    return {**variables, "batch_stats": jax.tree.map(np.zeros_like, variables["batch_stats"])}


def test_batch_norm_keeps_flax_biased_running_variance():
    """From zeroed statistics, a train-mode call leaves 0.1 x flax's biased
    batch variance; torch's BatchNorm (the unbiased variance, n / (n - 1)
    larger) misses it by more than the tolerance, at the generator's first
    layer (n = 3 x 4^3) and the VAE's code BatchNorm (n = 3). With
    ``update_stats=False`` (the D steps' fakes) the output is the same and
    the statistics stay."""
    _, variables = _jax("generator", "generator")
    variables = _zero_stats(variables)
    z = _latents(4)
    _, updates = _apply("generator", True)(variables, z)
    want = np.asarray(updates["batch_stats"]["bn0"]["var"])
    gen = _port("generator", variables)
    before = {k: v.clone() for k, v in gen.state_dict().items()}
    quiet = gen(torch.tensor(z), train=True, update_stats=False)
    assert all(torch.equal(v, before[k]) for k, v in gen.state_dict().items())
    loud = gen(torch.tensor(z), train=True)
    assert torch.equal(quiet, loud)
    assert _max_err(gen.bn0.var.numpy(), want) <= STATS_REL * want.max()

    torch_bn = torch.nn.BatchNorm3d(256, momentum=0.1, eps=1e-5)
    torch_bn.running_var.zero_()
    with torch.no_grad():
        torch_bn(gen.convt0(torch.tensor(z).reshape(BATCH, 128, 1, 1, 1)))
    assert _max_err(torch_bn.running_var.numpy(), want) > 10 * STATS_REL * want.max()

    _, vae_vars = _jax("vae", "init")
    vae_vars = _zero_stats(vae_vars)
    x = _volumes(5)
    _, updates = _apply("vae", True)(vae_vars, x, rng=jax.random.PRNGKey(1))
    want = np.asarray(updates["batch_stats"]["vae_bn"]["var"])
    vae = _port("vae", vae_vars)
    vae(torch.tensor(x), train=True, eps=torch.zeros(BATCH, 128))
    assert _max_err(vae.vae_bn.var.numpy(), want) <= STATS_REL * want.max()
    unbiased = want * BATCH / (BATCH - 1)
    assert _max_err(unbiased, want) > 10 * STATS_REL * want.max()


def test_conv_transpose_flip_is_needed():
    """A converter that permutes the flax ConvTranspose kernels without
    flipping them gives other volumes: the flip is tested, not assumed."""
    jgen, variables = _jax("generator", "generator")
    z = _latents(6)
    want = _apply("generator", False)(variables, z)
    gen = _port("generator", variables)
    assert _max_err(gen(torch.tensor(z), train=False).detach().numpy(), want) <= GEN_ATOL
    with torch.no_grad():
        for i in range(4):
            weight = getattr(gen, f"convt{i}").weight
            weight.copy_(weight.flip((2, 3, 4)))
    assert _max_err(gen(torch.tensor(z), train=False).detach().numpy(), want) > 100 * GEN_ATOL


@pytest.mark.parametrize("kind", ["generator", "classic", "vae", "classifier"])
def test_converters_round_trip(kind):
    """flax → port → flax is exact, with flax's names and shapes."""
    _, variables = _jax(kind, "init")
    back = flax_layers.variables_to_jax(_port(kind, variables))
    assert set(back) == set(variables)
    for collection, layers in variables.items():
        assert set(back[collection]) == set(layers), collection
        for layer, leaves in layers.items():
            for leaf, value in leaves.items():
                np.testing.assert_array_equal(back[collection][layer][leaf].numpy(), value)
    if kind in ("classic", "vae"):
        assert "enc_convs_0" in back["params"] and "dec_bn_dense" in back["batch_stats"]


def test_losses_match_jax():
    rng = np.random.default_rng(8)
    out, target = rng.uniform(-1, 1, (2, 2, 32, 32, 32)).astype(np.float32)
    mean, log_variance = rng.standard_normal((2, 4, 128)).astype(np.float32)
    pairs = [
        (losses.sdf_reconstruction_loss(torch.tensor(out), torch.tensor(target)),
         jax_losses.sdf_reconstruction_loss(out, target)),
        (losses.kld_loss(torch.tensor(mean), torch.tensor(log_variance)),
         jax_losses.kld_loss(mean, log_variance)),
        (losses.voxel_sign_difference(torch.tensor(out), torch.tensor(target)),
         jax_losses.voxel_sign_difference(out, target)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)
    assert 0.3 < float(pairs[2][0]) < 0.7
