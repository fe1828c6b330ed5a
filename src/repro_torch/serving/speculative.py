"""Draft-verify speculative decoding: the accept rule and the draft config
(reference: ``repro/serving/speculative.py``).

``Engine(draft_cfg=..., draft_params=..., spec_k=K)`` (``serving/
engine.py``) decodes up to K tokens per round:

  1. draft: a small ternary model proposes K-1 greedy continuations of
     the slot's pending token (K ``decode_step``s against the slot's
     private draft cache);
  2. verify: the target scores the whole K-token chunk in one
     ``transformer.spec_verify_chunk``, the chunked prefill's form with
     its emit and without the append (kernel 3, A3a / A3b);
  3. accept: ``longest_accepted_prefix`` keeps the longest prefix the
     target itself would have produced; the engine commits the chunk and
     truncates both caches to it.

Every emitted token is a target argmax, so greedy speculation gives the
sequential loop's tokens for every accept / reject mix, provided a verify
row equals the decode step's row bit for bit (both fold absolute 32-key
tiles, and every other op of the target runs per row). Temperature
sampling needs rejection sampling, which is a stub here as in the
reference (``rejection_sample``); the engine refuses the combination.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs import ModelConfig


def longest_accepted_prefix(chunk: torch.Tensor, greedy: torch.Tensor,
                            chunk_valid: torch.Tensor, stop_token: Optional[int] = None,
                            force_reject: bool = False) -> torch.Tensor:
    """Tokens each slot emits this round, (slots,) int32 in ``[1,
    chunk_valid]`` (0 where ``chunk_valid`` is 0).

    ``chunk`` (slots, K) is the pending token then the draft's proposals,
    ``greedy`` (slots, K) the target's argmax after each chunk position.
    ``chunk[:, 0]`` always emits; proposal i >= 1 is accepted iff every
    earlier one was and it equals ``greedy[:, i - 1]``: ``1 +
    sum(cumprod(match))``, with no per-slot branch. The count never passes
    the first position whose target continuation is ``stop_token`` (the
    sequential loop retires the slot there), and rows past
    ``chunk_valid`` never match. ``force_reject`` rejects every proposal
    (the engine's ``spec_force="reject"``)."""
    k = chunk.shape[1]
    n_valid = chunk_valid.to(torch.int32)
    if k > 1 and not force_reject:
        i = torch.arange(1, k, dtype=torch.int32, device=chunk.device)[None]
        match = (chunk[:, 1:] == greedy[:, :-1]) & (i < n_valid[:, None])
        n_acc = torch.cumprod(match.to(torch.int32), dim=1).sum(dim=1, dtype=torch.int32)
    else:
        n_acc = torch.zeros(chunk.shape[:1], dtype=torch.int32, device=chunk.device)
    n_emit = torch.minimum(1 + n_acc, n_valid.clamp(min=1))
    if stop_token is not None:
        j = torch.arange(k, dtype=torch.int32, device=chunk.device)[None]
        is_stop = (greedy == stop_token) & (j < n_valid[:, None])
        first_stop = torch.where(is_stop.any(dim=1),
                                 is_stop.to(torch.int32).argmax(dim=1).to(torch.int32), k)
        n_emit = torch.minimum(n_emit, first_stop + 1)
    return torch.where(n_valid > 0, n_emit, 0).to(torch.int32)


def make_draft_config(target: ModelConfig, n_layers: int = 2, d_model: int = 64) -> ModelConfig:
    """A small dense full-attention draft on the target's vocabulary (the
    one hard coupling: the draft proposes token ids the target scores),
    tied embeddings, no LoRA. For tests on smoke targets; a served
    deployment registers its draft (``falcon3-draft``)."""
    return ModelConfig(
        name=target.name + "-draft",
        family="dense",
        n_layers=n_layers,
        d_model=d_model,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=2 * d_model,
        vocab_size=target.vocab_size,
        rope_theta=target.rope_theta,
        tie_embeddings=True,
        bitnet=dataclasses.replace(target.bitnet, lora_rank=0),
        source="derived draft (speculative decoding)",
    )


def rejection_sample(*args, **kwargs):
    """Temperature-sampled speculation (rejection sampling over the draft's
    and the target's probabilities) is not implemented: the accept rule
    emits target argmax tokens only."""
    raise NotImplementedError(
        "speculative decoding is greedy-only: temperature speculation "
        "needs draft/target rejection sampling (see docs/serving.md, "
        "'Speculative decoding')"
    )
