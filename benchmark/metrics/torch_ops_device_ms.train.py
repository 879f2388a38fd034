"""Device time per batch of every operation that is not one of the
program's hand-written kernels: the critic's cuDNN convolutions, the
gradient penalty, RMSprop and the glue (torch.profiler)."""

from benchmark import readers


def read(reading):
    batches = reading.counts.get("batches")
    if reading.device is None or not batches:
        return None
    return 1e3 * reading.device.device_seconds(exclude=readers.PORT_KERNELS) / batches
