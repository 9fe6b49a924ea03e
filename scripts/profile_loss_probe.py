"""Which kernels a torch.profiler profile loses, and whether
``chip_smoke.profiled`` keeps the traced function's.

    python scripts/profile_loss_probe.py [--traces 12] [--kernels 3000]

Needs one card. A function launches a marker kernel, ``--kernels`` small
adds and a marker again; it is traced ``--traces`` times in one process
each of two ways, a bare ``torch.profiler.profile`` around it and
``chip_smoke.profiled`` (spin kernels first, then the function), with a
profile of 150,000 kernels before traces 0, 2 and the middle one of each
series (the state of the process late in ``chip_smoke.py``, which traces
large steps first). For every trace it prints the kernel launch calls
recorded, the kernels recorded, and the positions in launch order of the
launches whose kernel has no device record (matched by correlation id);
then the least (device start - launch start) over the kernels and the
first launch's distance from the profile's start, which tell a loss by
count from one by the profile's time window.
"""

import argparse
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402


def bare(fn, with_stack=False):
    """A profile around ``fn`` alone."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts,
                                with_stack=with_stack) as prof:
        fn()
        torch.cuda.synchronize()
    return None, prof


def summary(prof):
    """(launch calls, kernels recorded, the positions in launch order of
    the launches without a device record, the least device start - launch
    start in ms, the first launch after the profile's start in ms)."""
    result = prof.profiler.kineto_results
    events = list(result.events())
    calls = {e.correlation_id(): e.start_ns() for e in events
             if e.name() in chip_smoke.LAUNCH_CALLS}
    kernels = [e for e in events
               if e.device_type() == torch.autograd.DeviceType.CUDA
               and e.duration_ns() > 0 and not e.is_user_annotation()]
    skews = [e.start_ns() - calls[e.correlation_id()] for e in kernels
             if e.correlation_id() in calls]
    first = min(calls.values(), default=None)
    return (len(calls), len(kernels), chip_smoke.unrecorded_launches(prof),
            min(skews) / 1e6 if skews else float("nan"),
            (first - result.trace_start_ns()) / 1e6 if first else float("nan"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--traces", type=int, default=12)
    ap.add_argument("--kernels", type=int, default=3000)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_loss_probe: needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"{smi}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    x = torch.zeros(4096, device="cuda")
    marker = torch.zeros(4096, device="cuda")

    def work():
        marker.mul_(2)
        for _ in range(args.kernels):
            x.add_(1)
        marker.mul_(2)

    def heavy():
        for _ in range(150_000):
            x.add_(1)

    for name, trace, prefix in (
            ("bare profile", bare, 0),
            ("chip_smoke.profiled", chip_smoke.profiled,
             chip_smoke.PROFILE_PREFIX)):
        lost = 0
        for i in range(args.traces):
            if i in (0, 2, args.traces // 2):
                t0 = time.perf_counter()
                trace(heavy)
                print(f"{name}: a profile of 150000 kernels, "
                      f"{time.perf_counter() - t0:.1f} s", flush=True)
            try:
                launched, recorded, missing, skew_ms, first_ms = summary(
                    trace(work, with_stack=i % 2 == 0)[1])
            except RuntimeError as err:    # profiled() found a loss
                print(f"{name} trace {i}: {err}", flush=True)
                lost += 1
                continue
            ours = [j - prefix for j in missing if j >= prefix]
            lost += bool(ours)
            print(f"{name} trace {i}: {launched} launches, {recorded} "
                  f"kernels recorded; without a record the launches at "
                  f"{missing[:8]}{' ...' if len(missing) > 8 else ''} ("
                  f"{len(missing)}, {len(ours)} of the function's; "
                  f"{prefix} spin kernels first); device start - launch "
                  f"start at least {skew_ms:.3f} ms; first launch "
                  f"{first_ms:.3f} ms after the profile's start", flush=True)
        print(f"{name}: the function lost kernels in {lost} of "
              f"{args.traces} traces", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
