#!/usr/bin/env python3
"""Time the GQA decode forms of the checkout this runs in, on one GPU.

Prints one line ``RESULT <tag> {form: device ms}`` for the fused and
post-append GQA decode forms (contiguous and paged, f32 and fp8 tiers) at
``chip_smoke.py``'s timed case (falcon3-1b's heads, b 6, length 80) and
the ring form of the fused decode (A1d, f32 and fp8 tiers) at its ring
case (mixtral-8x22b's heads, b 4, a wrapped 4096-row ring) and, in a
checkout that has it, the fused form at d 112 (zamba2-7b's heads, b 6,
length 111), after building
the kernels from this checkout and checking each form against its plain
version (``chip_smoke.py``'s phases of the checkout it runs in). Before
that it prints ``SASS <tag> {kernel: digest}``, a digest of each decode
kernel's machine code as ``cuobjdump -sass`` shows it, so two checkouts'
kernels can be compared for identical code. Two versions are compared in
one machine by running this from each checkout in turn, e.g. parent,
change, parent:

    (cd parent && python3 ../time_decode_forms.py parent)
    python3 time_decode_forms.py change
"""

import hashlib
import re
import subprocess
import sys
from pathlib import Path

DECODE_SOURCES = ("flash_decode", "flash_decode_paged", "flash_decode_ring", "flash_decode_fp8",
                  "flash_decode_paged_fp8")


def sass_digests(build, libs, sources=DECODE_SOURCES) -> dict:
    """{mangled kernel name: first 12 hex digits of the sha256 of its SASS
    instructions and their encodings} for every kernel of the libraries
    ``sources`` (``libs``: name -> path); names and code without the
    anonymous namespace's tag, which differs between checkouts."""
    tool = Path(build.nvcc_path()).parent / "cuobjdump"
    out = {}
    for name in sources:
        text = subprocess.run([str(tool), "-sass", str(libs[name])], capture_output=True,
                              text=True, check=True).stdout
        # the anonymous namespace's tag follows the source's path: dropped
        text = re.sub(r"_GLOBAL__N__[0-9a-f]+_", "", text)
        for fn, body in re.findall(r"Function : (\S+)\n(.*?)(?=\n\s*Function : |\Z)", text, re.S):
            code = "\n".join(ln.strip() for ln in body.splitlines() if "/*" in ln)
            out[fn] = hashlib.sha256(code.encode()).hexdigest()[:12]
    return out


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
    libs = build.build_all()
    print("SASS", tag, sass_digests(build, libs), flush=True)
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
    swa_theta = get_config("mixtral-8x22b").rope_theta
    out["ring"] = cs.ring_decode_phase(torch, gen, swa_theta, smi)["ms"]
    out["fp8 ring"] = cs.fp8_decode_phase(torch, gen, swa_theta, smi, "ring")["ms"]
    if hasattr(cs, "d112_timing"):  # the fused form at zamba2-7b's heads, where it has one
        out["fused d112"] = cs.d112_timing(torch, gen, get_config("zamba2-7b").rope_theta, 111,
                                           smi)["ms"]
    print("RESULT", tag, {k: round(v, 5) for k, v in out.items()}, "on", smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
