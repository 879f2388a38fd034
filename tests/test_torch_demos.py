"""The port's demos and their bootstrap (``python -m shapegan_tpu_torch.
{make_examples,demo_gan,demo_autoencoder,demo_training,demo_latent_space}``)
held against the repo's root scripts of the JAX package on the CPU.

The root scripts run as they stand where a test needs what they draw: their
``jax.jit``-decorated step or decode is swapped for a recorder (every other
``jax.jit`` passes through), their trainers and mesh sampler for stand-ins,
so the codes and index batches they would feed are read off without
training. Nothing is written under ``shapegan_tpu/``: the JAX bundle's
``EXAMPLES_PATH`` is pointed at a temporary directory, and the JAX
training demo's chair path is replaced."""

import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import shapegan_tpu.checkpoints as jax_checkpoints
from shapegan_tpu.models.autoencoder import Autoencoder as JaxAutoencoder
from shapegan_tpu.models.gan import Generator as JaxGenerator
from shapegan_tpu.models.sdf_net import SDFNet as JaxSDFNet
from shapegan_tpu_torch import checkpoints
from shapegan_tpu_torch import demo_autoencoder, demo_gan, demo_latent_space, demo_training
from shapegan_tpu_torch import make_examples
from shapegan_tpu_torch.core.config import TrainConfig
from shapegan_tpu_torch.models.sdf_net import SDFNet
from shapegan_tpu_torch.ops import sdf_mlp
from shapegan_tpu_torch.train.common import resolve_voxel_dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import demo_gan as jax_demo_gan  # noqa: E402
import demo_training as jax_demo_training  # noqa: E402
import make_examples as jax_make_examples  # noqa: E402

EXAMPLES = os.path.join(REPO, "shapegan_tpu", "examples")
# Generator volumes (tanh) from the bundled weights, float32 both sides
# (tests/test_torch_voxel_models.py reads <= 3.5e-6).
GEN_ATOL = 1e-4
# Autoencoder codes and volumes, against the largest entry (as there).
AE_REL = 1e-4
# Two Adam steps of the training demo: float32 losses over 512 points and
# the updated parameters, against each tensor's largest entry.
ADAM_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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


def _recording_jit(monkeypatch, names, outputs):
    """Swap ``jax.jit`` so the functions called ``names`` only record their
    arguments (``outputs[name](*args)`` gives what they return); returns
    the record."""
    real_jit, calls = jax.jit, {name: [] for name in names}

    def fake_jit(fn, *args, **kwargs):
        if getattr(fn, "__name__", None) not in names:
            return real_jit(fn, *args, **kwargs)

        def record(*call_args):
            calls[fn.__name__].append([np.asarray(a) if isinstance(a, jax.Array) else a
                                       for a in call_args])
            return outputs[fn.__name__](*call_args)
        return record

    monkeypatch.setattr(jax, "jit", fake_jit)
    return calls


@pytest.mark.parametrize("module, argv", [
    (make_examples, ["quick"]), (demo_gan, ["frames=1"]), (demo_autoencoder, ["classic"]),
    (demo_training, ["steps=1"]), (demo_latent_space, ["resolution=8"]),
])
def test_entry_points_need_cuda_unless_cpu(module, argv, tmp_path, monkeypatch):
    """On CUDA by default: without a card they raise before any work."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        module.main(argv)
    assert not os.listdir(tmp_path)


class _Recorder:
    """A stand-in for the live viewer: keeps what it is shown."""

    def __init__(self):
        self.calls = []

    def set_voxels(self, voxels, *args, **kwargs):
        if isinstance(voxels, torch.Tensor):
            voxels = voxels.detach().cpu()
        self.calls.append(("voxels", np.asarray(voxels)))

    def set_mesh(self, mesh, *args, **kwargs):
        self.calls.append(("mesh", mesh))

    def stop(self):
        self.calls.append(("stop", None))


def _gui_demo_training(monkeypatch, steps):
    """Both training demos with ``gui`` on 1000 stand-in samples, their
    steps recording the index batches and ``get_mesh`` a stand-in: the
    viewer calls and the index batches of each."""
    theirs, ours, their_idx, our_idx = _Recorder(), _Recorder(), [], []
    monkeypatch.setattr(jax_demo_training, "make_viewer", lambda nogui: theirs)
    monkeypatch.setattr(demo_training, "make_viewer", lambda nogui: ours)

    class Mesh:
        def scaled_to_unit_sphere(self):
            return self

    samples = (np.zeros((1000, 3), np.float32), np.zeros(1000, np.float32))
    monkeypatch.setattr(jax_demo_training, "example_chair_path", lambda: "chair.obj")
    monkeypatch.setattr(jax_demo_training, "load_mesh", lambda path: Mesh())
    monkeypatch.setattr(jax_demo_training, "sample_sdf_near_surface", lambda mesh, n: samples)
    calls = _recording_jit(monkeypatch, {"step"}, {"step": lambda p, o, idx: (p, o, jnp.float32(0))})
    monkeypatch.setattr(JaxSDFNet, "get_mesh", lambda self, params, code, **kw: "mesh")
    monkeypatch.setattr(sys, "argv", ["demo_training.py", "gui", f"steps={steps}"])
    jax_demo_training.main()
    their_idx = [args[2] for args in calls["step"]]

    monkeypatch.setattr(demo_training, "chair_samples", lambda count, seed, device: samples)
    monkeypatch.setattr(demo_training, "make_step", lambda *args: (
        lambda idx: (our_idx.append(idx.numpy()), torch.zeros(()))[1]))
    monkeypatch.setattr(SDFNet, "get_mesh", lambda self, code, **kw: "mesh")
    demo_training.main(["gui", "cpu", f"steps={steps}"])
    return theirs.calls, ours.calls, their_idx, our_idx


@pytest.mark.parametrize("module", [demo_gan, demo_autoencoder, demo_training])
def test_demos_refuse_gui(module, tmp_path, monkeypatch):
    """``gui`` is no longer refused: with ``make_viewer`` a recorder in
    both packages, each demo shows at the root script's frames what the
    root script would show (the GAN's volumes and the AE's, every
    transition, against the flax models on the root script's codes within
    the file's bounds; the training demo's meshes at steps 0 and 100, the
    same index batches), then stops its viewer."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr("time.sleep", lambda seconds: None)
    if module is demo_training:
        theirs, ours, their_idx, our_idx = _gui_demo_training(monkeypatch, 101)
        assert ours == theirs == [("mesh", "mesh"), ("mesh", "mesh"), ("stop", None)]
        assert len(our_idx) == len(their_idx) == 101
        for a, b in zip(our_idx, their_idx):
            np.testing.assert_array_equal(a, b)
        return
    theirs, ours = _Recorder(), _Recorder()
    if module is demo_gan:
        # The root script's decode records its codes; the flax generator
        # gives their volumes afterwards.
        calls = _recording_jit(monkeypatch, {"decode"}, {"decode": lambda z: jnp.zeros((32,) * 3)})
        state = types.SimpleNamespace(params={}, batch_stats={})
        monkeypatch.setattr(jax_demo_gan, "create_states", lambda key: (None, None, state, None))
        monkeypatch.setattr(jax_checkpoints, "load", lambda template, name, base: template)
        monkeypatch.setattr(jax_demo_gan, "make_viewer", lambda nogui: theirs)
        monkeypatch.setattr(demo_gan, "make_viewer", lambda nogui: ours)
        monkeypatch.setattr(sys, "argv", ["demo_gan.py", "gui", "frames=3"])
        jax_demo_gan.main()
        demo_gan.main(["gui", "cpu", "frames=3"])
        codes = np.stack([args[0] for args in calls["decode"]])
        want = np.asarray(_jax_generator(_npz_variables("generator"), jnp.asarray(codes)))
        frames, checked, bound = 3, range(3), GEN_ATOL
    else:
        import demo_autoencoder as jax_demo_autoencoder

        # The root script encodes with the flax model on the bundle's
        # variables (its own set-up stood in for) and its decode records the
        # mixed codes; two frames are decoded afterwards.
        model, variables = JaxAutoencoder(is_variational=False), _npz_variables("autoencoder-128")
        calls = _recording_jit(monkeypatch, {"encode", "decode"}, {
            "encode": lambda x: model.apply(variables, x[None], train=False,
                                            method=JaxAutoencoder.encode)[0],
            "decode": lambda z: jnp.zeros((32,) * 3)})
        monkeypatch.setattr(jax_demo_autoencoder, "create_state",
                            lambda model, key: types.SimpleNamespace(params={}, batch_stats={}))
        monkeypatch.setattr(jax_checkpoints, "load", lambda template, name, base: variables)
        monkeypatch.setattr(jax_demo_autoencoder, "make_viewer", lambda nogui: theirs)
        monkeypatch.setattr(demo_autoencoder, "make_viewer", lambda nogui: ours)
        argv = ["gui", "classic", "synthetic=3", "epochs=1"]  # epochs bounds headless runs only
        monkeypatch.setattr(sys, "argv", ["demo_autoencoder.py"] + argv)
        jax_demo_autoencoder.main()
        demo_autoencoder.main(argv + ["cpu"])
        codes = np.stack([args[0] for args in calls["decode"]])
        frames = 2 * demo_autoencoder.TRANSITION_FRAMES
        checked = [0, frames - 1]
        want = np.asarray(model.apply(variables, jnp.asarray(codes[checked]), train=False,
                                      method=JaxAutoencoder.decode))
        bound = AE_REL * np.abs(want).max()
    assert len(codes) == frames
    assert ([kind for kind, _ in ours.calls] == [kind for kind, _ in theirs.calls]
            == ["voxels"] * frames + ["stop"])
    for i, w in zip(checked, want):
        got = ours.calls[i][1]
        assert got.shape == w.shape == (32, 32, 32)
        assert np.abs(got - w).max() <= bound


def test_bundle_examples_matches_jax(tmp_path, monkeypatch):
    """The bundled networks upcast to float32, with an optimizer key and an
    epoch, bundled by both: the same keys, dtypes and bits."""
    model_dir = tmp_path / "models"
    model_dir.mkdir()
    for name in make_examples.ARTIFACTS:
        with np.load(os.path.join(EXAMPLES, f"{name}.npz")) as data:
            arrays = {k: data[k].astype(np.float32) for k in data.files}
        arrays["opt_state/0/count"] = np.array(7, np.int32)
        arrays["opt_state/0/mu/w"] = np.ones(3, np.float32)
        arrays["epoch"] = np.array(4)
        np.savez(model_dir / f"{name}.npz", **arrays)
    theirs = tmp_path / "jax_examples"
    monkeypatch.setattr(jax_checkpoints, "EXAMPLES_PATH", str(theirs))
    jax_make_examples.bundle_examples(str(model_dir))
    written = make_examples.bundle_examples(str(model_dir), str(tmp_path / "ours"))
    assert [os.path.basename(p) for p in written] == [f"{n}.npz" for n in make_examples.ARTIFACTS]
    for name in make_examples.ARTIFACTS:
        with np.load(tmp_path / "ours" / f"{name}.npz") as ours, \
                np.load(theirs / f"{name}.npz") as want:
            assert sorted(ours.files) == sorted(want.files)
            assert not any(k.startswith("opt_state/") or k == "epoch" for k in ours.files)
            for key in want.files:
                assert ours[key].dtype == want[key].dtype, (name, key)
                assert ours[key].tobytes() == want[key].tobytes(), (name, key)
    with np.load(tmp_path / "ours" / "sdf_net_latent_codes.npz") as codes:
        assert codes["array"].dtype == np.float32
    loaded = checkpoints.load("generator", base=str(tmp_path / "ours"))
    assert all(v.dtype == torch.float32 for v in loaded.values())


_JAX_STAGES = {"voxel GAN": "gan", "voxel WGAN": "wgan", "SDF autodecoder": "sdf_autodecoder",
               "autoencoder": "autoencoder", "classifier": "classifier"}


@pytest.mark.parametrize("quick", [False, True])
def test_make_examples_stage_configs_match_jax(quick, tmp_path, monkeypatch):
    """Both main()s with their trainers recording their configurations and
    no bundle: the same five stages in order, with the same settings."""
    import importlib

    monkeypatch.chdir(tmp_path)
    theirs, ours = [], []
    for name, module in _JAX_STAGES.items():
        jax_module = importlib.import_module(f"shapegan_tpu.train.{module}")
        monkeypatch.setattr(jax_module, "train", lambda c, n=name: theirs.append((n, c)))
        port_module = importlib.import_module(f"shapegan_tpu_torch.train.{module}")
        monkeypatch.setattr(port_module, "train", lambda c, n=name: ours.append((n, c)))
    monkeypatch.setattr(jax_make_examples, "bundle_examples", lambda: None)
    monkeypatch.setattr(make_examples, "bundle_examples", lambda *a: None)
    monkeypatch.setattr(sys, "argv", ["make_examples.py"] + (["quick"] if quick else []))
    jax_make_examples.main()
    seconds = make_examples.main((["quick"] if quick else []) + ["cpu"])
    assert [n for n, _ in ours] == [n for n, _ in theirs] == list(_JAX_STAGES)
    assert list(seconds) == list(_JAX_STAGES) + ["bundle examples"]
    for (_, got), (_, want) in zip(ours, theirs):
        for field in ("synthetic", "epochs", "nogui", "classic", "extras", "batch_size",
                      "model_dir", "seed", "resume"):
            assert getattr(got, field) == getattr(want, field), field
        assert got.cpu and isinstance(got, TrainConfig)


def _jax_demo_gan_codes(monkeypatch, tmp_path, frames, wgan):
    """The codes the root demo_gan.py decodes, frame by frame (its network
    set-up stood in for: the codes do not depend on it)."""
    monkeypatch.chdir(tmp_path)
    calls = _recording_jit(monkeypatch, {"decode"}, {"decode": lambda z: jnp.zeros((32, 32, 32))})
    state = types.SimpleNamespace(params={}, batch_stats={})
    monkeypatch.setattr(jax_demo_gan, "create_states", lambda key: (None, None, state, None))
    monkeypatch.setattr(jax_checkpoints, "load", lambda template, name, base: template)
    monkeypatch.setattr(sys, "argv", ["demo_gan.py", "nogui", f"frames={frames}"]
                        + (["wgan"] if wgan else []))
    jax_demo_gan.main()
    return np.stack([args[0] for args in calls["decode"]])


# The flax generator in eval mode, compiled once for both checkpoints.
_jax_generator = jax.jit(lambda variables, z: JaxGenerator().apply(variables, z, train=False))


@pytest.mark.parametrize("name", ["generator", "wgan-generator"])
def test_demo_gan_codes_and_volumes_match_jax(name, tmp_path, monkeypatch):
    """90 frames (three transitions): the codes bit-equal to the root
    demo's; the eval-mode volumes of every 30th against the flax generator
    on the bundle's variables; the entry point's first frames are those
    volumes."""
    wgan = name == "wgan-generator"
    want_codes = _jax_demo_gan_codes(monkeypatch, tmp_path, 90, wgan)
    codes = demo_gan.code_sequence(90)
    assert codes.dtype == np.float32 and codes.shape == (90, 128)
    np.testing.assert_array_equal(codes, want_codes)
    generator = demo_gan.load_generator(name, "models", "cpu")  # the bundle
    volumes = torch.stack([demo_gan.decode(generator, code) for code in codes[::30]])
    want = np.asarray(_jax_generator(_npz_variables(name), jnp.asarray(want_codes[::30])))
    assert np.abs(volumes.numpy() - want).max() <= GEN_ATOL
    out = demo_gan.main(["cpu", "frames=2"] + (["wgan"] if wgan else []))
    np.testing.assert_array_equal(out["codes"], codes[:2])
    assert out["volumes"].shape == (2, 32, 32, 32) and out["volumes"].device.type == "cpu"
    assert torch.equal(out["volumes"][0], volumes[0])


def test_demo_autoencoder_matches_jax(tmp_path, monkeypatch, capsys):
    """The classic AE of the bundle on 4 synthetic volumes, 2 transitions:
    the order of the root demo, its codes and the last frame of each
    transition against the flax model in eval mode."""
    monkeypatch.chdir(tmp_path)
    out = demo_autoencoder.main(["cpu", "classic", "synthetic=4", "epochs=2", "show_slice"])
    assert capsys.readouterr().out.count("+") >= 4  # two slices printed
    order = np.random.default_rng(0).permutation(4)  # demo_autoencoder.py:50-51
    np.testing.assert_array_equal(out["order"], order)
    dataset = resolve_voxel_dataset(TrainConfig(synthetic=4), resolution=32)
    variables = _npz_variables("autoencoder-128")
    model = JaxAutoencoder(is_variational=False)
    x = jnp.asarray(np.stack([dataset[int(i)] for i in order[:3]]))
    want_codes = np.asarray(model.apply(variables, x, train=False, method=JaxAutoencoder.encode))
    t = (demo_autoencoder.TRANSITION_FRAMES - 1) / demo_autoencoder.TRANSITION_FRAMES
    mixes = jnp.asarray(want_codes[:2] * (1 - t) + want_codes[1:] * t)
    want_frames = np.asarray(model.apply(variables, mixes, train=False, method=JaxAutoencoder.decode))

    def rel(a, b):
        return float(np.abs(a - b).max() / np.abs(b).max())

    assert out["codes"].shape == (3, 128) and out["last_frames"].shape == (2, 32, 32, 32)
    assert rel(out["codes"].numpy(), want_codes) <= AE_REL
    assert rel(out["last_frames"].numpy(), want_frames) <= AE_REL


@pytest.mark.parametrize("show_slice, steps", [(False, 250), (True, 3)])
def test_demo_training_index_batches_match_jax(show_slice, steps, tmp_path, monkeypatch):
    """The root demo's index draws (its steps recorded, its chair sampler a
    stand-in of 1000 points), headless by chunks and with show_slice by
    step, bit-equal to the port's."""
    monkeypatch.chdir(tmp_path)
    count = 1000

    class Mesh:
        def scaled_to_unit_sphere(self):
            return self

    monkeypatch.setattr(jax_demo_training, "example_chair_path", lambda: "chair.obj")
    monkeypatch.setattr(jax_demo_training, "load_mesh", lambda path: Mesh())
    monkeypatch.setattr(jax_demo_training, "sample_sdf_near_surface", lambda mesh, n: (
        np.zeros((count, 3), np.float32), np.zeros(count, np.float32)))
    calls = _recording_jit(monkeypatch, {"step", "step_chunk"}, {
        "step": lambda p, o, idx: (p, o, jnp.float32(0.0)),
        "step_chunk": lambda p, o, idx: (p, o, jnp.float32(0.0))})
    monkeypatch.setattr(sys, "argv", ["demo_training.py", "nogui", f"steps={steps}"]
                        + (["show_slice"] if show_slice else []))
    jax_demo_training.main()
    want = [args[2] for args in calls["step" if show_slice else "step_chunk"]]
    got = list(demo_training.index_batches(count, steps, per_step=show_slice))
    assert len(got) == len(want) == (steps if show_slice else 3)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_demo_training_adam_steps_match_optax():
    """Two steps from JAX's latent-free init, carried across, on 600 given
    points at batch 512: the losses and the parameters against optax's
    Adam over JAX's float32 apply_grid."""
    net_jax = JaxSDFNet(latent_code_size=0)
    params = net_jax.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    points = rng.uniform(-1, 1, (600, 3)).astype(np.float32)
    sdf = np.clip(np.linalg.norm(points, axis=1) - 0.5, -0.1, 0.1).astype(np.float32)
    batches = [rng.integers(0, 600, 512) for _ in range(2)]
    code = jnp.zeros(0)
    tx = optax.adam(1e-4)
    opt_state = tx.init(params)

    def loss_fn(p, idx):
        out = net_jax.apply_grid(p, jnp.asarray(points)[idx], code[None])[0]
        return jnp.mean(jnp.abs(out - jnp.asarray(sdf)[idx]))

    want_losses = []
    for idx in batches:
        loss, grads = jax.value_and_grad(loss_fn)(params, jnp.asarray(idx))
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        want_losses.append(float(loss))

    net = SDFNet(sdf_mlp.params_from_jax({k: np.asarray(v) for k, v in
                                          net_jax.init(jax.random.PRNGKey(0)).items()}))
    optimizer = torch.optim.Adam(net.parameters(), lr=demo_training.LEARNING_RATE)
    step = demo_training.make_step(net, optimizer, torch.tensor(points), torch.tensor(sdf))
    losses = [float(step(torch.as_tensor(idx))) for idx in batches]
    np.testing.assert_allclose(losses, want_losses, rtol=ADAM_RTOL)
    for key, value in net.param_dict().items():
        want = np.asarray(params[key])
        if want.size:
            assert np.abs(value.detach().numpy() - want).max() <= ADAM_RTOL * np.abs(want).max(), key


def test_demo_training_runs_headless_on_the_cpu(capsys, monkeypatch):
    """``steps=3`` end to end: the chair mesh, 2,000 samples from the C++
    engine (the sampler's count cut), one chunk of three steps, one loss
    printed."""
    sampler = demo_training.chair_samples
    monkeypatch.setattr(demo_training, "chair_samples",
                        lambda count, seed, device: sampler(2000, seed, device))
    out = demo_training.main(["cpu", "steps=3"])
    assert len(out["losses"]) == 1 and np.isfinite(out["losses"][0]) and 0 < out["losses"][0] < 1
    assert "step 2: loss" in capsys.readouterr().out
    assert out["net"].device.type == "cpu" and out["sample_s"] > 0
