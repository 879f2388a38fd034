"""Progressive hybrid WGAN-GP — the paper's headline model (counterpart of
:mod:`shapegan_tpu.train.hybrid_progressive_gan`).

    python -m shapegan_tpu_torch.train.hybrid_progressive_gan iteration=N \\
        [epochs=E] [synthetic=S] [batch_size=B] [continue] [show_slice] [cpu]

Semantics of the JAX trainer: four growth iterations (``iteration=0..3``)
at 8^3/16^3/32^3/64^3, each warm-started from the previous iteration's
checkpoints unless ``continue`` resumes the same one (then the RMSprop
sidecar is restored too); the critic updated every batch with a gradient
penalty of weight 10, the generator every ``g_every`` batches (default 5);
RMSprop (optax's rule, ``optim.py``) at 1e-4 for both; batch 16; fade-in
over the first 10 epochs of a grown iteration; saves every ``save_every``
epochs (default 1; the last epoch always) and a snapshot every 10; the CSV
``epoch time fake real gp`` in ``plots/hybrid_gan_training_<iteration>.csv``.

On the GPU the generator's volumes go through the hand-written kernels: the
grid kernel forward for the critic's fakes, and for the generator's loss
and gradients the VJP that :data:`shapegan_tpu_torch.train.hybrid_gan._GRID_STASH`
picks (by default None: the grid kernel and the grid backward kernel; with
a stash set, the stash forward and stash backward kernels). With ``cpu``
their plain versions run on the CPU; without it the trainer needs CUDA. The noise (latents and
the penalty's interpolation coefficients) is drawn on the device from a
``torch.Generator`` seeded per epoch, so it is not the JAX trainer's noise;
the steps take it as arguments, so a test can hand both the same. On one
card each step is dispatched as the replay of a CUDA graph of its whole
body (``make_steps``), so the host issues a batch in a few launches. With
``gui`` the live viewer (``train.common.make_viewer``, rank 0's) shows the
G step's first fake volume every 50th batch.

Data-parallel under ``python -m torch.distributed.run --nproc_per_node=N``
(NCCL, one card a rank; gloo with ``cpu``), as the JAX trainer under its
mesh: ``get_mesh(batch_size=B)`` takes ``gcd(N, B)`` ranks; every rank
draws the global batch's latents and penalty coefficients from the same
seeded generator and takes its rows; the G step evaluates its rows through
:func:`~shapegan_tpu_torch.ops.sdf_mlp_kernels.apply_grid_sharded` (the
grid kernel and the grid backward kernel on each card); the gradients and
the metrics are averaged over the data group; rank 0 writes the files.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from shapegan_tpu_torch import LATENT_CODE_SIZE, SDF_CLIPPING, checkpoints, tracing
from shapegan_tpu_torch.core.config import TrainConfig, parse_cli, resolve_device
from shapegan_tpu_torch.models import progressive_gan
from shapegan_tpu_torch.models.progressive_gan import RESOLUTIONS, ProgressiveDiscriminator
from shapegan_tpu_torch.models.sdf_net import SDFNet
from shapegan_tpu_torch.ops import _build, sdf_mlp
from shapegan_tpu_torch.ops.coords import voxel_coordinates
from shapegan_tpu_torch.ops.losses import gradient_penalty
from shapegan_tpu_torch.optim import RMSprop
from shapegan_tpu_torch.parallel.mesh import (
    Mesh,
    get_mesh,
    init_from_env,
    shard_batch,
    tears_down_launch,
)
from shapegan_tpu_torch.train.common import (
    CSVLogger,
    EpochTimer,
    average_over_data,
    RollingHistory,
    StepProfiler,
    effective_batch_size,
    idle_result,
    load_critic,
    load_generator,
    make_viewer,
    make_voxel_batches,
    maybe_print_slice,
    resolve_voxel_dataset,
)
from shapegan_tpu_torch.train import hybrid_gan
from shapegan_tpu_torch.train.hybrid_gan import generate_volumes, generate_volumes_inference

FADE_IN_EPOCHS = 10
BATCH_SIZE = 16
GRADIENT_PENALTY_WEIGHT = 10.0
DEFAULT_EPOCHS = 250
LEARN_RATE = 1e-4
GENERATOR_UPDATE_EVERY = 5
SNAPSHOT_EVERY = 10

G_NAME = "hybrid_progressive_gan_generator_{:d}"
D_NAME = "hybrid_progressive_gan_discriminator_{:d}"
OPT_NAME = "hybrid_progressive_gan_optimizer_{:d}"

Grads = Dict[str, torch.Tensor]


def create_models(seed: int = 0, device="cpu") -> Tuple[SDFNet, ProgressiveDiscriminator]:
    """Generator and critic with fresh weights from ``seed``; the critic
    holds all four optional layers, so one parameter set serves every
    growth iteration."""
    generator = torch.Generator().manual_seed(seed)
    net = SDFNet(sdf_mlp.init(generator, device=device))
    return net, ProgressiveDiscriminator(generator=generator, device=device)


def generator_grads(net: SDFNet, discriminator: ProgressiveDiscriminator, grid: torch.Tensor,
                    z: torch.Tensor, iteration: int, fade) -> Tuple[Grads, torch.Tensor]:
    """Gradients of the generator loss ``-mean(D(G(z)))`` for the generator's
    parameters, and the fake volumes."""
    params = net.param_dict()
    with tracing.span("sg.g_step.generate"):
        fake = generate_volumes(net, grid, z, RESOLUTIONS[iteration])
    with tracing.span("sg.g_step.critic"):
        loss = -discriminator(fake, iteration, fade).mean()
    with tracing.span("sg.g_step.backward"):
        grads = torch.autograd.grad(loss, list(params.values()))
    return dict(zip(params, grads)), fake.detach()


def critic_grads(discriminator: ProgressiveDiscriminator, fake: torch.Tensor, batch: torch.Tensor,
                 alpha: torch.Tensor, iteration: int, fade) -> Tuple[Grads, Dict[str, torch.Tensor]]:
    """Gradients of the critic loss ``mean(D(fake)) - mean(D(real)) + GP`` for
    the critic's parameters (zero for the layers this iteration does not
    use), and the metrics (mean scores and the penalty)."""
    params = dict(discriminator.named_parameters())

    def critic(x):
        return discriminator(x, iteration, fade)

    with tracing.span("sg.d_step.critic"):
        pred_fake = critic(fake).mean()
        pred_real = critic(batch).mean()
    with tracing.span("sg.d_step.penalty"):
        gp = gradient_penalty(critic, alpha, batch, fake, weight=GRADIENT_PENALTY_WEIGHT)
    with tracing.span("sg.d_step.backward"):
        loss = pred_fake - pred_real + gp
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(params.items(), grads)}
    return grads, {"pred_fake": pred_fake.detach(), "pred_real": pred_real.detach(),
                   "gradient_penalty": gp.detach()}


def make_steps(net: SDFNet, discriminator: ProgressiveDiscriminator, g_opt: RMSprop,
               d_opt: RMSprop, iteration: int, mesh: Optional[Mesh] = None):
    """The G and D steps of one growth iteration:

    * ``g_step(z, fade)`` — one generator update from latents ``z`` [B, L];
      returns the fake volumes;
    * ``d_step(batch, z, alpha, fade)`` — one critic update on real volumes
      ``batch``, fakes generated (forward only) from ``z``, and penalty
      coefficients ``alpha`` [B, 1, 1, 1]; returns the metrics.

    Under a ``mesh`` of several ranks (entered by the caller) ``z`` and
    ``alpha`` are the global batch's and ``batch`` this rank's rows; each
    step averages its gradients, and the D step its metrics, over the data
    group.

    On CUDA with no collective to make (no mesh, or a mesh of one rank),
    each step is dispatched as replays of CUDA graphs (:class:`_Replayed`):
    the same body, its kernels in the same order, one ``cudaGraphLaunch`` a
    call; ``fade`` reaches the critic as a 0-dim float32 device tensor,
    filled before every call. The returned tensors are the caller's own.
    On the CPU and under a mesh of several ranks, the steps run eagerly.

    Each step is the span ``sg.g_step`` / ``sg.d_step``; a replay is the
    span ``.replay`` within it, and an eager call (or a capture) has the
    phases: ``.generate``, ``.critic``, ``.backward``, ``.optimizer`` (G);
    ``.fakes``, ``.critic``, ``.penalty``, ``.backward``, ``.optimizer``
    (D).
    """
    resolution = RESOLUTIONS[iteration]
    grid = voxel_coordinates(resolution, device=net.device)

    def g_body(z: torch.Tensor, fade) -> torch.Tensor:
        grads, fake = generator_grads(net, discriminator, grid, z, iteration, fade)
        with tracing.span("sg.g_step.optimizer"):
            g_opt.step(average_over_data(mesh, grads))
        return fake

    def d_body(batch: torch.Tensor, z: torch.Tensor, alpha: torch.Tensor, fade):
        with tracing.span("sg.d_step.fakes"):
            fake = generate_volumes_inference(net, grid, z, resolution)
        grads, metrics = critic_grads(discriminator, fake, batch, shard_batch(mesh, alpha),
                                      iteration, fade)
        with tracing.span("sg.d_step.optimizer"):
            d_opt.step(average_over_data(mesh, grads))
        return average_over_data(mesh, metrics)

    if net.device.type != "cuda" or (mesh is not None and mesh.size > 1):
        def g_step(z: torch.Tensor, fade) -> torch.Tensor:
            with tracing.span("sg.g_step"):
                return g_body(z, fade)

        def d_step(batch: torch.Tensor, z: torch.Tensor, alpha: torch.Tensor, fade):
            with tracing.span("sg.d_step"):
                return d_body(batch, z, alpha, fade)

        return g_step, d_step

    fade_now = torch.zeros((), dtype=torch.float32, device=net.device)
    g_graphs = _Replayed("sg.g_step", lambda z: g_body(z, fade_now))
    d_graphs = _Replayed("sg.d_step", lambda batch, z, alpha: d_body(batch, z, alpha, fade_now))

    def g_step(z: torch.Tensor, fade) -> torch.Tensor:
        with tracing.span("sg.g_step"):
            fade_now.fill_(fade)
            return g_graphs(z)

    def d_step(batch: torch.Tensor, z: torch.Tensor, alpha: torch.Tensor, fade):
        with tracing.span("sg.d_step"):
            fade_now.fill_(fade)
            return d_graphs(batch, z, alpha)

    return g_step, d_step


class _Replayed:
    """A step body dispatched as replays of CUDA graphs, one graph for each
    key of what the body observes: the inputs' shapes and dtypes, cuDNN's
    and matmuls' TF32 flags, and the grid VJP that ``hybrid_gan._GRID_STASH``
    picks (a graph keeps the kernels and the math it was captured with).

    A key's first call runs the body eagerly: the warm-up a capture needs
    (the kernels' build, cuDNN's algorithm choice, the allocator's blocks).
    Its second call copies the inputs into static tensors and captures the
    body on a side stream into the graph's own memory pool; that call and
    every later one then replay it, the later ones after copying their
    inputs in. A capture that fails raises.

    The body's outputs (a tensor, or a dict of tensors) are returned as
    clones, never as the graph's static tensors, which the next replay
    overwrites. The counters ``train.graph_captures`` and
    ``train.graph_replays`` count captures and replays (a capture's own
    replay is one); a later replay adds to each hand kernel's
    ``launch_count`` the launches that its capture counted."""

    def __init__(self, name: str, body):
        self._name = name
        self._body = body
        self._warm = set()
        self._graphs: Dict[tuple, _Graph] = {}

    def __call__(self, *inputs: torch.Tensor):
        key = (tuple((t.shape, t.dtype, t.device) for t in inputs),
               torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
               hybrid_gan._GRID_STASH)
        graph = self._graphs.get(key)
        if graph is None:
            if key not in self._warm:
                self._warm.add(key)
                return self._body(*inputs)
            graph = self._graphs[key] = _Graph(self._body, inputs)
            tracing.count("train.graph_captures")
        else:
            for static, value in zip(graph.inputs, inputs):
                static.copy_(value)
            _build.add_launches(graph.launches)
        with tracing.span(f"{self._name}.replay"):
            graph.graph.replay()
        tracing.count("train.graph_replays")
        if isinstance(graph.outputs, dict):
            return {k: v.clone() for k, v in graph.outputs.items()}
        return graph.outputs.clone()


class _Graph:
    """``body`` captured from static copies of ``inputs``: the graph, its
    static inputs and outputs, and the hand kernels' launches that the
    capture counted (wrapper -> count)."""

    def __init__(self, body, inputs):
        self.inputs = [t.clone() for t in inputs]
        before = _build.launch_counts()
        self.graph, self.outputs = _record_graph(body, self.inputs)
        self.launches = {w: n - before.get(w, 0) for w, n in _build.launch_counts().items()
                         if n != before.get(w, 0)}


def _record_graph(body, inputs):
    """``body(*inputs)`` captured into a new CUDA graph (on
    ``torch.cuda.graph``'s side stream, into the graph's own memory pool):
    the graph and the body's outputs, its static tensors."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outputs = body(*inputs)
    return graph, outputs


def _optimizer_tree(g_opt: RMSprop, d_opt: RMSprop) -> dict:
    """Both optimizers' state under optax's paths (``g/0/nu/<key>``,
    ``d/0/nu/<layer>/<kernel|bias>``), in the JAX package's layouts."""
    return {"g": ({"nu": g_opt.nu},), "d": ({"nu": progressive_gan.params_to_jax(d_opt.nu)},)}


@tears_down_launch
def train(config: Optional[TrainConfig] = None) -> dict:
    """Train one growth iteration; returns the models and the step times."""
    config = config or parse_cli()
    device = init_from_env(resolve_device(config))
    iteration = config.iteration
    resolution = RESOLUTIONS[iteration]
    epochs_total = config.epochs or DEFAULT_EPOCHS
    base = config.model_dir

    net, discriminator = create_models(config.seed, device)
    # Warm start from the previous iteration, or resume this one.
    source = iteration if config.resume else iteration - 1
    if source >= 0:
        if checkpoints.exists(G_NAME.format(source), base=base):
            load_generator(net, G_NAME.format(source), base)
        if checkpoints.exists(D_NAME.format(source), base=base):
            load_critic(discriminator, D_NAME.format(source), base)

    g_every = int(config.extras.get("g_every", GENERATOR_UPDATE_EVERY))
    learn_rate = float(config.extras.get("learn_rate", LEARN_RATE))
    d_learn_rate = float(config.extras.get("d_learn_rate", learn_rate))
    save_every = int(config.extras.get("save_every", 1))
    g_opt = RMSprop(net.param_dict(), learn_rate)
    d_opt = RMSprop(dict(discriminator.named_parameters()), d_learn_rate)
    # Same-iteration resume restores the RMSprop moments; a new growth
    # iteration starts with fresh ones.
    if config.resume and checkpoints.exists(OPT_NAME.format(iteration), base=base):
        restored = checkpoints.load_tree(_optimizer_tree(g_opt, d_opt), OPT_NAME.format(iteration),
                                         base=base)
        g_opt.load_state({"nu": restored["g"][0]["nu"]})
        d_opt.load_state({"nu": progressive_gan.params_from_jax(restored["d"][0]["nu"],
                                                                device=device)})

    dataset = resolve_voxel_dataset(config, resolution=resolution, rescale_sdf=False)
    batch_size = effective_batch_size(config.batch_size or BATCH_SIZE, len(dataset))
    mesh = get_mesh(batch_size=batch_size)
    if not mesh.member:
        return idle_result(mesh)
    batches = make_voxel_batches(dataset, batch_size, config.seed, config.extras, device, mesh)
    batches_per_epoch = max(1, len(batches))
    g_step, d_step = make_steps(net, discriminator, g_opt, d_opt, iteration, mesh)

    logger = CSVLogger(f"{config.plot_dir}/hybrid_gan_training_{iteration}.csv",
                       resume=config.resume)
    viewer = make_viewer(config.nogui)
    history_fake, history_real, history_gp = RollingHistory(), RollingHistory(), RollingHistory()
    g_profiler, d_profiler = StepProfiler(device), StepProfiler(device)
    noise = torch.Generator(device=device)
    fading = (not config.resume) and iteration > 0

    try:
        with mesh:
            for epoch in range(logger.first_epoch, epochs_total):
                # Epoch-deterministic noise, so a resumed run replays its epochs.
                noise.manual_seed((config.seed + 1) * 1_000_003 + epoch)
                batches.set_epoch(epoch)
                with EpochTimer() as timer:
                    for batch_index, batch in enumerate(batches):
                        fade = ((epoch + batch_index / batches_per_epoch) / FADE_IN_EPOCHS
                                if fading else 1.0)
                        if batch_index % g_every == 0:
                            z = torch.randn((batch_size, LATENT_CODE_SIZE), generator=noise,
                                            device=device)
                            with g_profiler:
                                fake = g_step(z, fade)
                            if batch_index % 50 == 0:
                                if viewer is not None:
                                    viewer.set_voxels(fake[0])
                                maybe_print_slice(fake[0], config.show_slice, scale=SDF_CLIPPING)
                        z = torch.randn((batch_size, LATENT_CODE_SIZE), generator=noise,
                                        device=device)
                        alpha = torch.rand((batch_size, 1, 1, 1), generator=noise, device=device)
                        with d_profiler:
                            metrics = d_step(batch, z, alpha, fade)
                        history_fake.append(metrics["pred_fake"])
                        history_real.append(metrics["pred_real"])
                        history_gp.append(metrics["gradient_penalty"])
                        if config.verbose and batch_index % 50 == 0:
                            print(f"Epoch {epoch}, batch {batch_index}: "
                                  f"D(x'): {history_fake.mean:.4f}, D(x): {history_real.mean:.4f}, "
                                  f"loss: {history_real.mean - history_fake.mean:.4f}, "
                                  f"gradient penalty: {history_gp.mean:.4f}")

                print(f"Epoch {epoch} ({timer.duration:.1f}s, "
                      f"G {g_profiler.mean_step_time * 1000:.1f} ms/step, "
                      f"D {d_profiler.mean_step_time * 1000:.1f} ms/step) [{resolution}^3], "
                      f"D(x'): {history_fake.mean:.4f}, D(x): {history_real.mean:.4f}, "
                      f"loss: {history_real.mean - history_fake.mean:.4f}, "
                      f"gradient penalty: {history_gp.mean:.4f}", flush=True)

                critic = progressive_gan.params_to_jax(dict(discriminator.named_parameters()))
                if (epoch + 1) % save_every == 0 or epoch == epochs_total - 1:
                    checkpoints.save(net.param_dict(), G_NAME.format(iteration), base=base)
                    checkpoints.save(critic, D_NAME.format(iteration), base=base)
                    checkpoints.save(_optimizer_tree(g_opt, d_opt), OPT_NAME.format(iteration),
                                     base=base)
                if epoch % SNAPSHOT_EVERY == 0:
                    checkpoints.save(net.param_dict(), G_NAME.format(iteration), epoch=epoch,
                                     base=base)
                    checkpoints.save(critic, D_NAME.format(iteration), epoch=epoch, base=base)
                logger.write(epoch, timer.duration, history_fake.mean, history_real.mean,
                             history_gp.mean)
    except KeyboardInterrupt:
        pass
    finally:
        logger.close()
        if viewer is not None:
            viewer.stop()
    return {"net": net, "discriminator": discriminator, "viewer": viewer,
            "g_step_s": list(g_profiler.times), "d_step_s": list(d_profiler.times)}


if __name__ == "__main__":
    train()
