#!/usr/bin/env python3
"""Time the GQA decode forms of the checkout this runs in, on one GPU.

Prints one line ``RESULT <tag> {form: device ms}`` for the fused and
post-append GQA decode forms (contiguous and paged, f32 and fp8 tiers) at
``chip_smoke.py``'s timed case (falcon3-1b's heads, b 6, length 80), after
building the kernels from this checkout and checking each form against its
plain version (``chip_smoke.py``'s phases). Two versions are compared in
one machine by running this from each checkout in turn, e.g. parent,
change, parent:

    (cd parent && python3 ../time_decode_forms.py parent)
    python3 time_decode_forms.py change
"""

import subprocess
import sys
from pathlib import Path


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("time_decode_forms: no CUDA device", file=sys.stderr)
        return 2
    root = Path.cwd()
    sys.path[:0] = [str(root / "src"), str(root)]
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    tag = sys.argv[1] if len(sys.argv) > 1 else root.name
    build.build_all()
    theta = get_config("falcon3-1b").rope_theta
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for fused in (True, False):
        out["fused" if fused else "post"] = cs.decode_timing(torch, gen, theta, 80, fused, smi)["ms"]
    for form in ("fused paged", "post paged", "fused", "post"):
        out["fp8 " + form] = cs.fp8_decode_phase(torch, gen, theta, smi, form)["ms"]
    for fused in (True, False):
        out["paged " + ("fused" if fused else "post")] = cs.paged_decode_phase(
            torch, gen, theta, smi, fused)["ms"]
    print("RESULT", tag, {k: round(v, 5) for k, v in out.items()}, "on", smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
