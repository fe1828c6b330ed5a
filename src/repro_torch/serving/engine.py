"""Continuous-batching serving engine over packed-ternary weights and
per-slot DR-tiered KV caches (reference: ``repro/serving/engine.py``, the
core: grouped admission, the decode step, harvest and ``generate``).

Weights are packed once at construction and stay on the device: no
weight is ever reloaded (``weight_loads`` stays 0). Device state
(``DecodeState``) is a fixed set of slots. One decode step runs entirely
on the device — emit the pending token, decode (ternary kernels +
flash-decode kernel, KV appends gated by ``active = allocated & ~done``),
accumulate the per-slot DR ledger, sample, fold the budget and stop token
into ``done`` — with no host read. The host syncs only every
``sync_every`` steps: it reads the small ``done`` mask, harvests finished
slots with their outputs and ledgers, and admits queued prompts into the
freed slots as same-length groups (one prefill each).

Per sequence the ledger (prompt phase in closed form plus the per-step
decode counts) reconciles exactly with
``dr_edram.closed_form_reduction(seq_len, hot_cap)``.

The same loop serves the dense family (GQA cache) and the MoE family with
MLA attention (latent cache, one stack per layer kind); MLA serves through
grouped admission only, as in the reference.

Not ported: chunked and paged admission, speculation, SDC scrubbing,
sessions and overload control.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import ModelConfig
from repro_torch.core import kv_cache
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.pack import pack_params, tree_to
from repro_torch.serving.scheduler import FinishedRequest, Request, SlotScheduler

TRAFFIC_KEYS = kv_cache.TRAFFIC_KEYS


def _n_attn_layers(cfg: ModelConfig) -> int:
    """Layers that hold a KV cache (reference: ``analysis/roofline.py::
    _n_attn_layers``). Every layer of the ported families (dense, MoE) has
    attention; the reference's hybrid and attention-free branches have no
    ported family yet."""
    return cfg.n_layers
# `generate` pads rows that stopped early with this sentinel (outside every
# vocabulary, so a sampled stop token stays distinguishable from padding)
PAD_TOKEN = -1


@dataclasses.dataclass
class DecodeState:
    """Device state of the decode loop (one row = one slot)."""

    cache: dict  # stacked tiered KV cache, per-slot lengths
    tok: torch.Tensor  # (slots,) int32 — last sampled token
    allocated: torch.Tensor  # (slots,) bool — slot holds a live request
    done: torch.Tensor  # (slots,) bool — request finished
    seq_len: torch.Tensor  # (slots,) int32 — cache length incl. prompt
    n_gen: torch.Tensor  # (slots,) int32 — tokens emitted so far
    max_new: torch.Tensor  # (slots,) int32 — per-slot budget
    out: torch.Tensor  # (slots, out_cap) int32 — emitted tokens
    ledger: Dict[str, torch.Tensor]  # 4 x (slots,) int32 decode token counts


@dataclasses.dataclass
class GenerationResult:
    tokens: torch.Tensor  # (b, max_new) int32 on the CPU, PAD_TOKEN past each row's end
    steps: int
    traffic: dict
    wall_s: float
    finished: Optional[List[FinishedRequest]] = None  # per row, with its own ledger

    @property
    def external_reduction(self) -> float:
        return kv_cache.external_reduction(self.traffic)


class Engine:
    """Weight-reload-free continuous-batching inference engine.

    ``serve(requests)`` serves ``Request``s of any prompt lengths through
    ``slots`` concurrent slots; ``generate(prompts, ...)`` is the
    aligned-batch wrapper (one slot per row)."""

    def __init__(self, cfg: ModelConfig, params, hot_cap: int = 32, max_len: int = 256,
                 pack: bool = True, sample: str = "greedy", temperature: float = 1.0,
                 seed: int = 0, slots: int = 8, sync_every: int = 8, device=None):
        if not pack:
            raise NotImplementedError("QAT (unpacked) serving is not part of this port")
        if sample not in ("greedy", "temperature"):
            raise ValueError(f"unknown sampling mode {sample!r}")
        self.cfg = cfg
        self.device = resolve_device(device)
        # freeze to ROM form once (packed trits, fused wqkv / wgu); never
        # reloaded afterwards. Already-packed leaves pass through.
        self.params = pack_params(tree_to(params, self.device), cfg)
        self.hot_cap = hot_cap
        self.max_len = max_len
        self.sample = sample
        self.temperature = temperature
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self.slots = slots
        self.sync_every = sync_every
        self.weight_loads = 0  # host->device weight transfers after init

    # ------------------------------------------------------------------
    def _kv_token_bytes(self) -> int:
        """Ledger bytes per token, at 2 bytes a value, over the attention
        layers: GQA caches k and v of every kv head; MLA one latent row
        (kv_lora_rank + rope dims)."""
        cfg = self.cfg
        if cfg.attn_type == "mla":
            per_layer = cfg.mla.kv_cache_dim * 2
        else:
            per_layer = 2 * cfg.n_kv_heads * cfg.resolved_head_dim * 2
        return per_layer * _n_attn_layers(cfg)

    def _init_state(self, n_slots: int, out_cap: int) -> DecodeState:
        dev = self.device

        def z():
            return torch.zeros((n_slots,), dtype=torch.int32, device=dev)

        return DecodeState(
            cache=T.init_decode_cache(self.cfg, n_slots, self.max_len, self.hot_cap,
                                      dtype=self.params["final_ln"].dtype, device=dev),
            tok=z(),
            allocated=torch.zeros((n_slots,), dtype=torch.bool, device=dev),
            done=torch.zeros((n_slots,), dtype=torch.bool, device=dev),
            seq_len=z(), n_gen=z(), max_new=z(),
            out=torch.zeros((n_slots, out_cap), dtype=torch.int32, device=dev),
            ledger={k: z() for k in TRAFFIC_KEYS},
        )

    def _sample_fn(self, logits: torch.Tensor) -> torch.Tensor:
        if self.sample == "greedy":
            return logits.argmax(dim=-1).to(torch.int32)
        u = torch.rand(logits.shape, generator=self._gen, device=logits.device)
        gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
        return (logits / self.temperature + gumbel).argmax(dim=-1).to(torch.int32)

    # ------------------------------------------------------------------
    def _step(self, state: DecodeState, out_cap: int, stop_token: Optional[int]) -> None:
        """One decode dispatch: emit -> decode/append -> account -> sample
        -> fold budget and stop into ``done``. Device work only."""
        active = state.allocated & ~state.done
        act32 = active.to(torch.int32)
        cols = torch.arange(out_cap, dtype=torch.int32, device=self.device)
        emit = (cols[None] == state.n_gen[:, None]) & active[:, None]
        state.out = torch.where(emit, state.tok[:, None], state.out)
        n_gen = state.n_gen + act32
        logits, state.cache = T.decode_step(self.params, self.cfg, state.tok, state.cache,
                                            active=active)
        tr = kv_cache.step_traffic_tokens(state.seq_len, self.hot_cap)
        state.ledger = {k: state.ledger[k] + tr[k] * act32 for k in TRAFFIC_KEYS}
        state.seq_len = state.seq_len + act32
        state.tok = torch.where(active, self._sample_fn(logits), state.tok)
        done = state.done | (active & (n_gen >= state.max_new))
        if stop_token is not None:
            done = done | (active & (state.tok == stop_token))
        state.done, state.n_gen = done, n_gen

    def _admit(self, state: DecodeState, slots_idx: List[int], group: List[Request]) -> None:
        """Prefill ``group`` (equal prompt lengths), scatter the fresh cache
        rows into ``slots_idx`` and sample the first tokens."""
        toks = torch.as_tensor(np.stack([np.asarray(r.tokens, np.int32) for r in group]),
                               device=self.device)
        logits, fresh = T.prefill(self.params, self.cfg, toks, hot_cap=self.hot_cap,
                                  max_len=self.max_len)
        idx = torch.as_tensor(slots_idx, dtype=torch.long, device=self.device)
        for name, stack in state.cache.items():
            for live, new in zip(stack, fresh[name]):
                live[:, idx] = new.to(live.dtype)
        max_new = torch.as_tensor([r.max_new_tokens for r in group], dtype=torch.int32,
                                  device=self.device)
        state.tok[idx] = self._sample_fn(logits)
        state.allocated[idx] = True
        state.done[idx] = max_new <= 0
        state.seq_len[idx] = toks.shape[1]
        state.n_gen[idx] = 0
        state.max_new[idx] = max_new
        state.out[idx] = 0
        for k in TRAFFIC_KEYS:
            state.ledger[k][idx] = 0

    def _validate_request(self, r: Request) -> None:
        if r.prompt_len == 0:
            raise ValueError(f"request {r.rid}: empty prompt")
        if r.prompt_len + r.max_new_tokens > self.max_len:
            raise ValueError(f"request {r.rid}: prompt {r.prompt_len} + max_new "
                             f"{r.max_new_tokens} exceeds max_len {self.max_len}")

    def _build_finished(self, req: Request, out_row: np.ndarray, seq_len: int,
                        decode_ledger: Dict[str, int], token_bytes: int) -> FinishedRequest:
        prompt = kv_cache.prompt_traffic_tokens(req.prompt_len, self.hot_cap)
        traffic = {k: (int(decode_ledger[k]) + prompt[k]) * token_bytes for k in TRAFFIC_KEYS}
        return FinishedRequest(rid=req.rid, prompt_len=req.prompt_len, tokens=out_row,
                               seq_len=seq_len, steps=len(out_row), traffic=traffic)

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def serve(self, requests: Sequence[Request], slots: Optional[int] = None,
              stop_token: Optional[int] = None,
              sync_every: Optional[int] = None) -> List[FinishedRequest]:
        """Serve ``requests`` through continuous batching; one
        ``FinishedRequest`` per request, in completion order."""
        n_slots = slots or self.slots
        chunk = sync_every or self.sync_every
        for r in requests:
            self._validate_request(r)
        out_cap = self.max_len  # fixed: any budget fits, no per-batch shapes
        sched = SlotScheduler(n_slots)
        for r in requests:
            sched.submit(r)
        state = self._init_state(n_slots, out_cap)
        token_bytes = self._kv_token_bytes()
        remaining = [0] * n_slots  # host mirror of each slot's budget (no sync)
        finished: List[FinishedRequest] = []
        while not sched.idle():
            while True:
                slots_idx, group = sched.next_group()
                if not group:
                    break
                self._admit(state, slots_idx, group)
                for s, req in zip(slots_idx, group):
                    remaining[s] = req.max_new_tokens
            decoding = sched.active_slots()
            budgets = [remaining[s] for s in decoding if remaining[s] > 0]
            n_steps = min([chunk] + budgets) if budgets else 0
            for _ in range(n_steps):
                self._step(state, out_cap, stop_token)
            for s in decoding:
                remaining[s] = max(remaining[s] - n_steps, 0)
            # sync point: only the small done mask crosses to the host
            done = state.done.cpu().numpy()
            ripe = [s for s in decoding if done[s]]
            if not ripe:
                continue
            n_gen = state.n_gen.cpu().numpy()
            seq_len = state.seq_len.cpu().numpy()
            out = state.out.cpu().numpy()
            ledger = {k: state.ledger[k].cpu().numpy() for k in TRAFFIC_KEYS}
            for s in ripe:
                req = sched.retire(s)
                finished.append(self._build_finished(
                    req, out[s, : n_gen[s]].copy(), int(seq_len[s]),
                    {k: ledger[k][s] for k in TRAFFIC_KEYS}, token_bytes))
                remaining[s] = 0
            state.allocated[torch.as_tensor(ripe, device=self.device)] = False
        return finished

    def generate(self, prompts, max_new_tokens: int = 32,
                 stop_token: Optional[int] = None) -> GenerationResult:
        """Aligned-batch generation: one slot per prompt row, one prefill."""
        t0 = time.perf_counter()
        prompts_np = np.asarray(torch.as_tensor(prompts).cpu(), np.int32)
        reqs = [Request(rid=i, tokens=prompts_np[i], max_new_tokens=max_new_tokens)
                for i in range(prompts_np.shape[0])]
        finished = sorted(self.serve(reqs, slots=len(reqs), stop_token=stop_token),
                          key=lambda f: f.rid)
        rows = [np.concatenate([f.tokens, np.full((max_new_tokens - len(f.tokens),),
                                                  PAD_TOKEN, np.int32)])
                for f in finished]
        traffic = {k: sum(f.traffic[k] for f in finished) for k in TRAFFIC_KEYS}
        return GenerationResult(
            tokens=torch.as_tensor(np.stack(rows), dtype=torch.int32),
            steps=max((f.steps for f in finished), default=0),
            traffic=traffic,
            wall_s=time.perf_counter() - t0,
            finished=finished,
        )
