#!/usr/bin/env python3
"""How often ``torch.profiler`` misses a kernel of B6b's call, the call whose
device time ``chip_smoke.py`` splits by pass. On one GPU:

    python -m shapegan_tpu_torch.profiler_probe [trials]

At 20,000 and 65,536 rows (random weights, ``chip_smoke.rowwise_case``)
each trial times the kernel and its plain version as phase 4 does, then
records one call of the kernel in two ways: ``bare``, in the step after a
warm-up step with nothing around it, and ``padded``, by
``chip_smoke.profiled_call`` (idle card on either side of the call, and a
new recording while a pass is missing). It prints, for each, how many
recordings lacked each pass, the new recordings taken, and the kernel
instances seen (each call launches one rows pass, one weight kernel, four
memsets, five finishes, one tail kernel and one transpose).
"""

from __future__ import annotations

import collections
import sys
import time

import torch

from shapegan_tpu_torch.kernel_mutants import _chip_smoke
from shapegan_tpu_torch.ops import _build, sdf_mlp
from shapegan_tpu_torch.ops import sdf_mlp_kernels as K


def bare_call(fn):
    """key_averages() of one call of fn in the step after a warm-up step."""
    fn()
    torch.cuda.synchronize()
    events = []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA],
                                schedule=torch.profiler.schedule(wait=0, warmup=1, active=1),
                                on_trace_ready=lambda prof: events.append(prof.key_averages())) as prof:
        for _ in range(2):
            fn()
            torch.cuda.synchronize()
            prof.step()
    return events[0]


def main(trials: int = 40) -> int:
    cs = _chip_smoke()
    _build.load()
    device = torch.device("cuda", 0)
    print(f"card: {cs.nvidia_smi_line()}", flush=True)
    params = sdf_mlp.init(torch.Generator().manual_seed(1), device=device)
    passes = cs.ROWWISE_BWD_PASSES
    again = [0]
    cs.log = lambda msg: again.__setitem__(0, again[0] + ("recording it again" in msg))
    for n in (20000, 65536):
        ops, g = cs.rowwise_case(params, n, 8, device)
        fn = lambda: K.rowwise_backward_cuda(*ops, g)  # noqa: E731
        for way, record in (("bare", bare_call), ("padded", lambda f: cs.profiled_call(f, tuple(passes.values())))):
            missing, instances = collections.Counter(), collections.Counter()
            again[0] = 0
            t0 = time.perf_counter()
            for _ in range(trials):
                cs.time_ms(fn, iters=20)
                cs.time_ms(lambda: K.rowwise_backward_plain(*ops, g), iters=10)
                events = [e for e in record(fn) if e.device_type == torch.autograd.DeviceType.CUDA]
                for name, part in passes.items():
                    missing[name] += not any(part in e.key for e in events)
                for e in events:
                    instances[next((k for k, part in passes.items() if part in e.key), "other")] += e.count
            print(f"N={n} {way}: {trials} recordings in {time.perf_counter() - t0:.1f} s; lacking a pass "
                  f"{dict(missing)}; recorded again {again[0]}; kernel instances {dict(instances)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(*(int(a) for a in sys.argv[1:])))
