"""Run one cell of the port's benchmark once, on this machine's card.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``portbench/``
and the port's ``src/``. Each run is a new process: it loads the port's
CUDA extension (built into ``build/`` inside the checkout on a checkout's
first run), makes the cell's weights and traffic on the card from
``--seed``, warms up the cell's own shapes, measures for ``--seconds``,
then checks the port's first steps against the plain reference and prints
one JSON line last on standard output: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's ``end_to_end`` metrics untraced, its
``per_layer`` ones with ``--trace 1``), ``device``, with ``--trace 1``
``breakdown``, and ``checks`` (each compared number beside its limit,
also the last lines on standard error).

Exits non-zero, printing no result, without a CUDA card (or with fewer
than the cell asks for), when a file the cell needs is missing (the port's
``src/`` included), or when the process holds ``jax``, ``jaxlib``,
``flax`` or the JAX package ``repro`` once the window has closed.

For reading the comparison's limits (``PERF.md``): ``--control tf32``
(the reference in TF32 in the port's place) and ``--control half_batch``
(the same reference fed half of each batch) compare and print without a
window; ``--fault unchanged`` or ``--fault half_batch`` plants that fault
in the port's step for a whole run.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def process_age_s() -> float:
    """Seconds since this process started, by the kernel's count (0 where
    it cannot be read)."""
    try:
        ticks = os.sysconf("SC_CLK_TCK")
        start = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1]
                    .split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return max(0.0, uptime - start / ticks)
    except (OSError, ValueError, IndexError):
        return 0.0


T_PROCESS = T_START - process_age_s()


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", choices=("tf32", "fp8", "half_batch"))
    p.add_argument("--fault", choices=("unchanged", "half_batch"))
    return p.parse_args(argv)


def fail(msg: str) -> int:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    return 2


def forbidden_modules() -> list:
    """The modules of ``FORBIDDEN`` this process holds, by whole top-level
    name (``repro_torch`` is not ``repro``)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    args = parse(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        return fail(f"no port under {ROOT / 'src'}: run from a whole "
                    "checkout")
    for path in (str(ROOT), str(ROOT / "src")):
        if path not in sys.path:
            sys.path.insert(0, path)
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(ROOT / "build" / "torch_extensions"))

    from portbench.manifest import Manifest, ManifestError, family

    try:
        manifest = Manifest.load(ROOT)
        cell = manifest.cell(args.workload)
        config = manifest.config(cell)
        traffic = manifest.traffic(cell)
        driver = family(config["family"])
    except (ManifestError, KeyError, ImportError) as e:
        return fail(str(e))

    import torch

    if not torch.cuda.is_available():
        return fail("no CUDA device: the benchmark measures the card and "
                    "never falls back to the CPU")
    if torch.cuda.device_count() < cell["chips"]:
        return fail(f"{cell['name']} asks for {cell['chips']} cards, "
                    f"{torch.cuda.device_count()} found")

    if args.control is not None:
        out = driver.control(cell["name"], config, traffic, seed=args.seed,
                             device="cuda", root=HERE, kind=args.control)
        print(json.dumps({"control": args.control, **out}), flush=True)
        return 0

    from portbench import result

    record = driver.run(cell["name"], config, traffic, seed=args.seed,
                        seconds=args.seconds, trace=bool(args.trace),
                        device="cuda", root=HERE, t_start=T_PROCESS,
                        fault=args.fault)
    held = forbidden_modules()
    if held:
        return fail(f"the process holds {held} after the window")
    line = result.line(manifest, cell, config, traffic, record,
                       bool(args.trace))
    result.emit(line, record)
    return 0


if __name__ == "__main__":
    sys.exit(main())
