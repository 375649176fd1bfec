"""One run of one benchmark cell of rtsdm_tpu_torch, the PyTorch and CUDA
renderer, on the NVIDIA GPU of this machine:

    python3 benchmark/run.py --workload emerald_720p.orbit --seed 7 \
        --seconds 51 --trace 0

from the root of a checkout. It makes the cell's scene from the seed,
builds the renderer and warms it up (set-up), renders the cell's camera
path for --seconds (the window), renders one of the window's frames and
set-up's first frame again through the frozen plain reference
(benchmark/reference/) and compares, then prints one JSON line: the cell's
end-to-end metrics (--trace 0) or its per-layer metrics (--trace 1, with a
device trace of a few frames), whether the outputs were correct, and the
device. It fails, printing no result, without a CUDA device, and when the
JAX package or JAX is loaded.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

T_PROCESS = time.perf_counter()
HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

# every build and kernel cache of the run inside the checkout, at fixed
# paths (the port's nvcc outputs go to build/rtsdm_tpu_torch/ by itself)
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
    os.environ.setdefault(var, str(ROOT / "build" / "benchmark_cache" / sub))
os.environ.setdefault("USE_FLAX", "0")
# The frame is bound by the host's launches, so every run gets the same
# host: the process and every thread it starts on one fixed core (the
# middle one it is allowed), and one thread for the host's tensor and
# array work. The bounds in BENCHMARK.json were measured so (PERF.md).
_CORES = sorted(os.sched_getaffinity(0))
os.sched_setaffinity(0, {_CORES[(len(_CORES) - 1) // 2]})
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"

sys.path.insert(0, str(HERE))
sys.path.insert(1, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    t_import = time.perf_counter()
    import torch
    t_torch = time.perf_counter()

    from harness import cell, discover, guard
    bench = discover.load_benchmark(ROOT / "BENCHMARK.json")
    chips = int(discover.cell(bench, args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.cuda.reset_peak_memory_stats()
    t_cuda = time.perf_counter()
    result = cell.run(args.workload, bench, args.seed, args.seconds,
                      bool(args.trace), T_PROCESS)
    found = guard.forbidden_loaded()
    if found:
        print(f"benchmark: forbidden modules loaded: {', '.join(found)}",
              file=sys.stderr)
        return 3
    print(f"benchmark: {args.workload} seed {args.seed}: "
          f"{result['frames']} frames, reference {result['reference_s']:.1f} s",
          file=sys.stderr)
    result["setup_parts"].update(torch_import_s=t_torch - t_import,
                                 cuda_init_s=t_cuda - t_torch)
    cell.report_checks(result["checks"])
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
