#!/usr/bin/env python3
"""The port's render of a mid-size reference's settings against the
reference, output by output: the MSEs chip_smoke.py's mid-size bounds are
set from (twice the measured MSE, rounded up to one digit).

    python tests/torch_refs/port_mse.py NAME [NAME ...] [--device cpu]

renders each reference NAME of chip_smoke.MID_REFS through the port on
--device (the CPU by default; cuda on the card) and prints each output's
MSE against tests/torch_refs/NAME.*.npz; for a name with a substituted
hold (chip_smoke.MID_SUBSTITUTED_BOUND) once more with the JAX package's
raster channels stored beside the reference in place of the port's.
Imports no JAX. Not run by the tests.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
import chip_smoke as C  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("names", nargs="+", choices=sorted(C.MID_REFS))
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args(argv)
    out = {}
    for name in args.names:
        settings = C.MID_REFS[name][0]
        ref = C.mid_ref(name)
        runs = [("", None)]
        if name in C.MID_SUBSTITUTED_BOUND:
            runs.append((":substituted", C.mid_rasters(name)))
        for tag, substitute in runs:
            t0 = time.perf_counter()
            kept, _ = C.mid_frame(settings, substitute=substitute,
                                  device=args.device)
            for k, v in kept.items():
                out[f"{name}{tag}.{k}"] = float(((v - ref[k]) ** 2).mean())
            print(f"{name}{tag}: "
                  + ", ".join(f"{k} {out[f'{name}{tag}.{k}']:.4g}"
                              for k in kept)
                  + f" ({time.perf_counter() - t0:.1f} s)", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
