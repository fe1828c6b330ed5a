#!/usr/bin/env python3
"""Time the ternary matmul's act-quant and known-scale forms (kernels 1
and 4) of the checkout this runs in, on one GPU.

Builds ``csrc/ternary_matmul.cu`` from this checkout, prints ``SASS <tag>
{kernel: digest}`` (``time_decode_forms.sass_digests``), then one line
``RESULT <tag> {case: device ms}``: ``ternary_matmul_actq`` (f32
activations) and ``ternary_matmul_fused`` at falcon3-1b's four leaf
shapes (wqkv, wo, wgu, down) and M 1 (the scrub's probe), 6 (a decode
step) and 192 (an admission), each checked bit for bit against its plain
version first. Two versions are compared in one machine by running this
from each checkout in turn, e.g. parent, change, change, parent:

    (cd parent && python3 ../time_ternary_forms.py parent)
    python3 time_ternary_forms.py change
"""

import subprocess
import sys
from pathlib import Path


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("time_ternary_forms: no CUDA device", file=sys.stderr)
        return 2
    root = Path.cwd()
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from time_decode_forms import sass_digests  # this script's, whichever checkout runs

    sys.path[:1] = [str(root / "src"), str(root)]
    import chip_smoke as cs

    from repro_torch.core.ternary import act_quant
    from repro_torch.kernels import build
    from repro_torch.kernels import ternary_matmul as tm

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    tag = sys.argv[1] if len(sys.argv) > 1 else root.name
    libs = build.build_all(["ternary_matmul"])
    print("SASS", tag, sass_digests(build, libs, ("ternary_matmul",)), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for k, n in cs.DECODE_SHAPES:
        for m in (1, 6, 192):
            x, (p,), col = cs.projection_operands(torch, gen, m, k, n)
            q = act_quant(x)
            cs.check(torch.equal(tm.ternary_matmul_actq(x, p, col, k=k),
                                 tm.ternary_matmul_actq_plain(x, p, col, k))
                     and torch.equal(tm.ternary_matmul_fused(q.xq, p, q.scale, col, k=k),
                                     tm.ternary_matmul_fused_plain(q.xq, p, q.scale, col, k)),
                     f"{tag}: a form differs from its plain version at M={m} K={k} N={n}")
            for form, fn in (("actq", lambda: tm.ternary_matmul_actq(x, p, col, k=k)),
                             ("known", lambda: tm.ternary_matmul_fused(q.xq, p, q.scale, col,
                                                                       k=k))):
                ms = cs.device_ms(fn, only=cs.TERNARY)
                out[f"{form} M={m} K={k} N={n}"] = cs.time_ms(fn) if ms is None else ms
    print("RESULT", tag, {c: round(v, 5) for c, v in out.items()}, "on", smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
