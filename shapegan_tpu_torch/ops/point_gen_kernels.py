"""The point-GAN generator's fused forward for the H100 (counterpart of
:mod:`shapegan_tpu.ops.point_gen_pallas`).

One hand-written CUDA kernel (``csrc/point_gen.cu``, replaces ``_kernel`` /
``generate_fused`` of the JAX package): the whole default
:class:`~shapegan_tpu_torch.models.point_sdf_net.SDFGenerator` forward, pos
[B, N, 3] float32 → raw SDF [B, N] float32, with every activation kept on
chip (in registers, on the wgmma trunk of ``csrc/sdf_trunk_sm90.cuh``).
Laid out as :mod:`~shapegan_tpu_torch.ops.sdf_mlp_kernels`: a wrapper
(:func:`generate_cuda`: checks, allocates, launches on the current stream,
counts its launches in ``launch_count``, is the span ``sg.kernel.generate``
in a traced run), a plain PyTorch version
(:func:`generate_plain`) at the Pallas kernel's rounding points, and a
dispatcher (:func:`generate`) that takes the plain version only for CPU
tensors; a CUDA tensor goes to the kernel, which raises if it cannot run.

The Pallas kernel's rounding points, which are not flax's (the module rounds
every Dense output to bf16 and adds biases in bf16): each layer's product is
a float32 sum of bf16 products, the bias and latent adds are float32, the
LayerNorm is two-pass float32 (mean, then the mean of the squared
deviations), gamma/beta are bf16 read as float32, and only the relu output
is rounded to bf16. The head is a float32 row dot plus b7.

Operand layout (shared with the kernel): ``zz1``/``zz2`` [B, 256] bf16, the
latent rows z @ z_lin + bias (a bf16 product rounded to bf16, plus the bf16
bias); ``w0p``/``w4p`` [3, 256] bf16, the position rows of lin0 and lin4;
``w`` [6, 256(out), 256(in)] bf16, lin1, lin2, lin3, lin4's first 256 input
columns, lin5, lin6 (torch's Linear layout); ``b`` [8, 256] bf16, rows
b0 … b6 and b7 broadcast; ``gamma``/``beta`` [8, 256] bf16, rows 0 … 6 and a
zero row; ``w7`` [256] bf16, the head weight.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch.func import functional_call

from shapegan_tpu_torch import tracing
from shapegan_tpu_torch.ops import _build

BF16 = torch.bfloat16
WIDTH = 256
LAYERS = 8
LN_EPS = 1e-6  # flax.linen.LayerNorm's default, as the Pallas kernel
SKIP_LAYER = 4  # lin4: adds pos @ w4p and zz2

# A/B switch of the D step's fake generation: the kernel (True) or the bf16
# module through cuBLAS and element-wise LayerNorm (False). The JAX package
# leaves its TPU kernel off. On the H100 (700 W) the kernel takes 0.35 ms
# at 32 x 4096 points against 8.3 ms for the module, and the D step 14.3 ms
# against 18.7 (chip_smoke.py phases 4 and 10; PERF.md, section 6), so it
# is on here.
_FORCE_FUSED_GENERATE = True

Params = Dict[str, torch.Tensor]


# ---------------------------------------------------------------- operands


def _latent_row(params: Params, name: str, z: torch.Tensor) -> torch.Tensor:
    return (z.to(BF16) @ params[f"{name}.weight"].t().to(BF16)
            + params[f"{name}.bias"].to(BF16)).contiguous()


def generate_operands(params: Params, pos: torch.Tensor, z: torch.Tensor):
    """The kernel's operands (pos, zz1, zz2, w0p, w4p, w, b, gamma, beta,
    w7) from the generator's parameters (keyed like its
    ``named_parameters()``), positions [B, N, 3] and latents [B, L]: what the
    JAX package's ``generate_fused`` computes before its ``pallas_call``."""
    w4 = params["lin4.weight"]  # [256, 256 + 3]: lin4 sees concat(x, pos)
    w = torch.stack([params["lin1.weight"], params["lin2.weight"], params["lin3.weight"],
                     w4[:, :WIDTH], params["lin5.weight"], params["lin6.weight"]])
    b7 = params["lin7.bias"].expand(WIDTH)
    zero = torch.zeros_like(b7)
    b = torch.stack([params[f"lin{i}.bias"] for i in range(LAYERS - 1)] + [b7])
    gamma = torch.stack([params[f"norm{i}.scale"] for i in range(LAYERS - 1)] + [zero])
    beta = torch.stack([params[f"norm{i}.bias"] for i in range(LAYERS - 1)] + [zero])
    return (pos.float().contiguous(), _latent_row(params, "z_lin1", z),
            _latent_row(params, "z_lin2", z),
            params["lin0.weight"].t().to(BF16).contiguous(), w4[:, WIDTH:].t().to(BF16).contiguous(),
            w.to(BF16).contiguous(), b.to(BF16).contiguous(), gamma.to(BF16).contiguous(),
            beta.to(BF16).contiguous(), params["lin7.weight"][0].to(BF16).contiguous())


# ------------------------------------------------------------ plain version


def _ln_relu(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """The Pallas kernel's ``_ln_relu``: two-pass float32 LayerNorm, bf16
    gamma/beta as float32, relu; then the round to bf16."""
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + LN_EPS)
    return torch.relu(y * gamma.float() + beta.float()).to(BF16)


def generate_plain(pos, zz1, zz2, w0p, w4p, w, b, gamma, beta, w7) -> torch.Tensor:
    """Plain PyTorch version of the kernel → [B, N] float32. Products take
    bf16 operands in float32 (``a.float() @ b.float()``, exact per product),
    so the only roundings to bf16 are the kernel's."""
    batch, n, _ = pos.shape
    p = pos.reshape(batch * n, 3).to(BF16).float()
    item = torch.arange(batch * n, device=pos.device) // n
    x = p @ w0p.float() + b[0].float() + zz1.float()[item]
    x = _ln_relu(x, gamma[0], beta[0])
    for layer in range(LAYERS - 2):
        h = x.float() @ w[layer].float().t()
        if layer + 1 == SKIP_LAYER:
            h = h + p @ w4p.float() + b[SKIP_LAYER].float() + zz2.float()[item]
        else:
            h = h + b[layer + 1].float()
        x = _ln_relu(h, gamma[layer + 1], beta[layer + 1])
    head = (x.float() * w7.float()).sum(-1) + b[LAYERS - 1, 0].float()
    return head.reshape(batch, n)


# ------------------------------------------------------------ kernel wrapper


def _check(name: str, device: torch.device, tensor: torch.Tensor, shape, dtype) -> None:
    if tensor.device != device:
        raise ValueError(f"{name}: on {tensor.device}, expected {device}")
    if tensor.dtype != dtype:
        raise ValueError(f"{name}: dtype {tensor.dtype}, expected {dtype}")
    if tuple(tensor.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(tensor.shape)}, expected {tuple(shape)}")
    if not tensor.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


@tracing.kernel
def generate_cuda(pos, zz1, zz2, w0p, w4p, w, b, gamma, beta, w7) -> torch.Tensor:
    """Launch the generator kernel (``csrc/point_gen.cu``) → [B, N] float32."""
    if pos.device.type != "cuda":
        raise ValueError(f"CUDA kernel called with a tensor on {pos.device}")
    device = pos.device
    if pos.ndim != 3:
        raise ValueError(f"pos: shape {tuple(pos.shape)}, expected [B, N, 3]")
    batch, n = pos.shape[:2]
    _check("pos", device, pos, (batch, n, 3), torch.float32)
    for name, t in (("zz1", zz1), ("zz2", zz2)):
        _check(name, device, t, (batch, WIDTH), BF16)
    for name, t in (("w0p", w0p), ("w4p", w4p)):
        _check(name, device, t, (3, WIDTH), BF16)
    _check("w", device, w, (LAYERS - 2, WIDTH, WIDTH), BF16)
    for name, t in (("b", b), ("gamma", gamma), ("beta", beta)):
        _check(name, device, t, (LAYERS, WIDTH), BF16)
    _check("w7", device, w7, (WIDTH,), BF16)
    out = torch.empty((batch, n), dtype=torch.float32, device=device)
    if batch == 0 or n == 0:
        return out
    lib = _build.load()
    code = lib.point_gen_forward(
        pos.data_ptr(), zz1.data_ptr(), zz2.data_ptr(), w0p.data_ptr(), w4p.data_ptr(),
        w.data_ptr(), b.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w7.data_ptr(),
        out.data_ptr(), batch, n, device.index, torch.cuda.current_stream(device).cuda_stream)
    _build.check(lib, "point_gen_forward", code)
    _build.count_launch(generate_cuda)
    return out


generate_cuda.launch_count = 0


def generate(pos, zz1, zz2, w0p, w4p, w, b, gamma, beta, w7) -> torch.Tensor:
    """Generator kernel on CUDA tensors, its plain version on CPU tensors."""
    if pos.device.type == "cpu":
        return generate_plain(pos, zz1, zz2, w0p, w4p, w, b, gamma, beta, w7)
    return generate_cuda(pos, zz1, zz2, w0p, w4p, w, b, gamma, beta, w7)


# ------------------------------------------------------------- entry points


def generate_fused(params: Params, pos: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Fused forward of the default generator (8 layers of 256, LayerNorm,
    no dropout): pos [B, N, 3], z [B, L] → [B, N, 1] float32 raw SDF
    values, the module's output to bf16 tolerance. Any N: the kernel masks
    its own tail, and a tile may span two items."""
    return generate(*generate_operands(params, pos, z))[..., None]


def generate_best(generator, params: Params, pos: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Forward-only fake-cloud generation: :func:`generate_fused` when
    ``_FORCE_FUSED_GENERATE`` is on, the positions lie on a CUDA device and
    the generator is the kernel's model (LayerNorm, 8 layers of 256, no
    dropout, batched positions), else the module on ``params`` in its own
    dtype. CPU tensors take the module, as the JAX package does off a TPU."""
    kernel_ok = (
        _FORCE_FUSED_GENERATE
        and pos.device.type == "cuda"
        and pos.ndim == 3
        and generator.norm
        and generator.num_layers == LAYERS
        and generator.hidden_channels == WIDTH
        and generator.dropout == 0.0
    )
    if kernel_ok:
        return generate_fused(params, pos, z)
    return functional_call(generator, params, (pos, z))
