"""The voxel GAN's convolutions in the window (every forward, data
gradient and weight gradient, each at its own least time from
voxel_counts.py: inputs, weights and outputs read or written once) over
the device time of the kernels that cuDNN runs for them, in percent. The
bias adds and the bias gradients' sums run as aten's generic elementwise
and reduction kernels, which other operations share, and are left out."""

from benchmark import counts

# cuDNN's convolution kernels as the profiler names them on the H100 (the
# first traced run): the implicit-GEMM forward, data-gradient and
# weight-gradient kernels (sm80/sm90 xmma), the generic strided data
# gradient, and its layout transforms (NCDHW to NDHWC and back, the
# generic transform, the fill of a strided data gradient's output).
PATTERNS = ("_xmma_", "convolveNd_", "nchwToNhwcKernel", "nhwcToNchwKernel",
            "tensorTransformGeneric", "setTensor5d_kernel")


def read(reading):
    least = sum(counts.least_seconds(f, b) for k, (f, b) in reading.work.items()
                if k.startswith("conv."))
    if reading.device is None or not least:
        return None
    seconds = reading.device.device_seconds(PATTERNS)
    return 100.0 * least / seconds if seconds > 0 else None
