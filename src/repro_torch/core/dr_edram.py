"""Decode-Refresh eDRAM access model (reference: ``repro/core/dr_edram.py``).

Buffering the first ``B`` tokens of a length-``S`` sequence on-die removes
``B(2S - B + 1) / (S(S + 1))`` of the external KV accesses (one write per
token, step t reads tokens 0..t-1). S = 128, B = 32 gives the paper's
43.6 %. ``simulate`` counts the same accesses step by step.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from fractions import Fraction


def closed_form_reduction(seq_len: int, buffered: int, include_writes: bool = True) -> float:
    """Fraction of external DRAM accesses removed by buffering ``buffered`` early tokens."""
    s, b = seq_len, min(buffered, seq_len)
    if s <= 0 or b <= 0:
        return 0.0
    if include_writes:
        return float(Fraction(b * (2 * s - b + 1), s * (s + 1)))
    if s == 1:
        return 1.0
    return float(Fraction(b * (2 * s - b - 1), s * (s - 1)))


@dataclass
class AccessTrace:
    """Exact access counts from simulating one full generation of length S."""

    seq_len: int
    buffered: int
    ext_reads: int = 0
    ext_writes: int = 0
    die_reads: int = 0
    die_writes: int = 0
    reads_per_token: list = field(default_factory=list)
    max_touch_gap: int = 0

    @property
    def total(self) -> int:
        return self.ext_reads + self.ext_writes + self.die_reads + self.die_writes

    @property
    def external(self) -> int:
        return self.ext_reads + self.ext_writes

    @property
    def reduction(self) -> float:
        return 1.0 - self.external / self.total if self.total else 0.0


def simulate(seq_len: int, buffered: int) -> AccessTrace:
    """Step-by-step decode simulation counting every KV read and write."""
    tr = AccessTrace(seq_len=seq_len, buffered=min(buffered, seq_len))
    tr.reads_per_token = [0] * seq_len
    last_touch = {}
    for t in range(seq_len):
        if t < tr.buffered:
            tr.die_writes += 1
            last_touch[t] = t
        else:
            tr.ext_writes += 1
        for i in range(t):
            tr.reads_per_token[i] += 1
            if i < tr.buffered:
                tr.die_reads += 1
                tr.max_touch_gap = max(tr.max_touch_gap, t - last_touch[i])
                last_touch[i] = t
            else:
                tr.ext_reads += 1
    return tr
