"""Continuous-batching serving engine over packed-ternary weights and
per-slot DR-tiered KV caches (reference: ``repro/serving/engine.py``, the
core: grouped and chunked admission, the decode step, harvest and
``generate``).

Weights are packed once at construction and stay on the device: no
weight is ever reloaded (``weight_loads`` stays 0). Device state
(``DecodeState``) is a fixed set of slots. One decode step runs entirely
on the device — emit the pending token, decode (ternary kernels +
flash-decode kernel, KV appends gated by ``active = allocated & ~done``),
accumulate the per-slot DR ledger, sample, fold the budget and stop token
into ``done`` — with no host read. The host syncs only every
``sync_every`` steps: it reads the small ``done`` mask, harvests finished
slots with their outputs and ledgers, and admits queued prompts into the
freed slots: as same-length groups (one prefill each), or, with
``prefill_chunk = C``, one request per free slot streamed into the live
cache as fixed-shape (slots, C) chunk waves (``_stream_chunks``), which
interleave with the decode steps.

Per sequence the ledger (prompt phase in closed form plus the per-step
decode counts) reconciles exactly with
``dr_edram.closed_form_reduction(seq_len, hot_cap)``.

The same loop serves the dense family (GQA cache), the MoE family with
MLA attention (latent cache, one stack per layer kind) and the MoE family
with sliding-window attention (mixtral-8x22b: a ring cold tier of the
window's last tokens and no hot tier); MLA serves through grouped
admission only, as in the reference (``_chunked_capable``). Under SWA the
ledger still charges the engine's ``hot_cap`` (``step_traffic_tokens``,
``prompt_traffic_tokens``, ``expected_reduction``), exactly as the
reference's does, although the cache has no hot tier and the ring caps
the reads at the window.

With ``paged=True`` (chunked admission only) the cold tier is a pool of
pages shared by the slots (``kv_cache.PagedKVCache``), accounted on the
host by ``serving/paging.py``: each admission round matches every new
prompt against the prefix tree, adopts the matched cold pages (and a
copy-on-write copy of a partly matched boundary page), restores the
matched hot tier from a pooled snapshot, all in one ``paged_admit`` pass
over the layers, and streams only the prompt past the match. Pages are
allocated for the prompt at admission and for decode growth before each
decode chunk (``_ensure_pages``); a prompt that completes its prefill is
recorded in the tree (``_record_prefix``), and a retired slot drops its
page references. The decode and chunk steps read the pool through the
paged forms of the attention kernels; nothing gathers it back.

``BitNetConfig.kv_fp8`` (the reference's ``launch/serve.py --kv-fp8``)
makes every cache of all three admission paths fp8 (e4m3): the kernels'
fp8-tier forms read it, the prefill forms emit into it, and activations
and queries stay in the params' dtype. The ledger is unchanged.

Not ported: speculation, SDC scrubbing, sessions and overload control
(preempting a slot when the page pool runs dry raises instead).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import ModelConfig
from repro_torch.core import dr_edram, kv_cache
from repro_torch.device import resolve_device
from repro_torch.kernels.flash_decode import TILE
from repro_torch.models import transformer as T
from repro_torch.models.pack import pack_params, tree_to
from repro_torch.serving.paging import PagePool, PrefixCache, PrefixMatch, pages_needed
from repro_torch.serving.scheduler import FinishedRequest, Request, SlotScheduler

TRAFFIC_KEYS = kv_cache.TRAFFIC_KEYS
# One page is one 32-key tile of the attention kernels, so a page never
# splits a tile. The reference keeps its rationale (one page = one kernel
# block) but reads the size from its TPU block table, which does not
# carry over.
DEFAULT_PAGE_SIZE = TILE


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
class _PagedServe:
    """Host side of one ``serve`` call's paged cold tier."""

    pool: PagePool
    ptree: PrefixCache
    host_table: np.ndarray  # (slots, pages_per_slot) int32: the device tables' mirror
    slot_pages: List[List[int]]  # pool pages each slot's table maps, in order
    prefix_used: List[int]  # prompt tokens each slot took from the prefix tree
    seq_mirror: List[int]  # upper bound of each slot's cache length


@dataclasses.dataclass
class GenerationResult:
    tokens: torch.Tensor  # (b, max_new) int32 on the CPU, PAD_TOKEN past each row's end
    steps: int
    traffic: dict
    wall_s: float
    finished: Optional[List[FinishedRequest]] = None  # per row, with its own ledger
    steps_per_row: Optional[List[int]] = None  # decode steps each row was active for

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
                 seed: int = 0, slots: int = 8, sync_every: int = 8, device=None,
                 prefill_chunk: int = 0, paged: bool = False, page_size: Optional[int] = None,
                 n_pages: Optional[int] = None, prefix_sharing: bool = True):
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
        # chunked-prefill admission (0: grouped admission); archs that
        # cannot chunk keep grouped admission, as in the reference
        self.prefill_chunk = prefill_chunk
        self.weight_loads = 0  # host->device weight transfers after init
        # (slots, C) of every chunk wave dispatched: one shape per slot
        # count, whatever the prompt lengths
        self.chunk_shapes: set = set()
        # paged cold tier + refcounted prefix sharing (serving/paging.py)
        self.paged = paged
        self.prefix_sharing = bool(prefix_sharing) and paged
        if paged:
            if not (prefill_chunk > 0 and self._chunked_capable()):
                raise ValueError(
                    "paged serving needs chunked prefill (prefill_chunk > 0) on a "
                    "full-attention cache family: grouped whole-prompt admission bypasses "
                    "the page table")
            if max_len <= hot_cap:
                raise ValueError(f"paged serving needs a non-empty cold tier (max_len "
                                 f"{max_len} <= hot_cap {hot_cap})")
            self._page_size = int(page_size or DEFAULT_PAGE_SIZE)
            self._pps = -(-(max_len - hot_cap) // self._page_size)
            self._n_hot_pages = -(-hot_cap // self._page_size) if hot_cap else 0
            self._n_pages_cfg = n_pages
        # the refcount ledger and prefix tree of the last paged serve()
        self._last_pool: Optional[PagePool] = None
        self._last_ptree: Optional[PrefixCache] = None

    def _chunked_capable(self) -> bool:
        """Chunked prefill needs a pure attention-token path: a dense / MoE
        family with full or sliding-window GQA attention and no frontend
        (reference: ``_chunked_capable``). The port builds only dense and
        MoE models and no frontend, so of those clauses only the attention
        type can fail here (MLA)."""
        return self.cfg.attn_type in ("full", "swa")

    # ------------------------------------------------------------------
    def _kv_token_bytes(self) -> int:
        """Ledger bytes per token, at 2 bytes a value, over the attention
        layers: GQA caches k and v of every kv head; MLA one latent row
        (kv_lora_rank + rope dims). The reference's rule charges 2 bytes a
        value whatever ``kv_fp8`` says (``Engine._kv_token_bytes``), so
        fp8 tiers leave the ledger as it is."""
        cfg = self.cfg
        if cfg.attn_type == "mla":
            per_layer = cfg.mla.kv_cache_dim * 2
        else:
            per_layer = 2 * cfg.n_kv_heads * cfg.resolved_head_dim * 2
        return per_layer * _n_attn_layers(cfg)

    def _pool_pages(self, n_slots: int) -> int:
        """Pool size for a serve() call (reference: ``_pool_pages``): a
        full private page set per slot, headroom for the pages one
        admission round pins (per fill the matched hot snapshot and the
        copy-on-write source) and one spare page set so insertion can
        snapshot a hot node."""
        if self._n_pages_cfg is not None:
            return self._n_pages_cfg
        return (n_slots * self._pps + self._pps + n_slots * (self._n_hot_pages + 1)
                + self._n_hot_pages)

    def _init_state(self, n_slots: int, out_cap: int) -> DecodeState:
        dev = self.device
        paged_kw = (dict(paged=True, page_size=self._page_size,
                         n_pages=self._pool_pages(n_slots)) if self.paged else {})

        def z():
            return torch.zeros((n_slots,), dtype=torch.int32, device=dev)

        return DecodeState(
            cache=T.init_decode_cache(self.cfg, n_slots, self.max_len, self.hot_cap,
                                      dtype=self.params["final_ln"].dtype, device=dev,
                                      **paged_kw),
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
        # the lm_head at the slot count, as in the chunk and decode steps
        logits, fresh = T.prefill(self.params, self.cfg, toks, hot_cap=self.hot_cap,
                                  max_len=self.max_len, logit_rows=state.tok.shape[0])
        idx = torch.as_tensor(slots_idx, dtype=torch.long, device=self.device)
        for name, stack in state.cache.items():
            for live, new in zip(stack, fresh[name]):
                kv_cache.raw(live)[:, idx] = kv_cache.raw(new)  # one tier dtype
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

    def _chunk_step(self, state: DecodeState, tokens: torch.Tensor, n_valid: torch.Tensor,
                    is_first: torch.Tensor, is_last: torch.Tensor,
                    max_new: torch.Tensor) -> None:
        """One chunk wave over every slot, in place (reference:
        ``_get_chunk_step``): a slot's first chunk starts from a clean cache
        row and ledger; each slot appends its ``n_valid`` rows (idle and
        decoding slots ride along with 0 and touch nothing); where
        ``is_last`` the slot samples its first token and joins the decode
        steps as a group-admitted one would. Device work only."""
        self.chunk_shapes.add(tuple(tokens.shape))
        for stack in state.cache.values():  # every layer, before the first reads it
            stack.lengths.masked_fill_(is_first[None, :], 0)
        logits, _ = T.prefill_chunk_step(self.params, self.cfg, tokens, state.cache, n_valid)
        first_tok = self._sample_fn(logits)
        state.tok = torch.where(is_last, first_tok, state.tok)
        state.allocated = state.allocated | is_last
        state.done = torch.where(is_last, max_new <= 0, state.done & ~is_first)
        state.seq_len = torch.where(is_first, 0, state.seq_len) + n_valid
        state.n_gen = torch.where(is_first, 0, state.n_gen)
        state.max_new = torch.where(is_last, max_new, state.max_new)
        state.out = torch.where(is_first[:, None], 0, state.out)
        state.ledger = {k: torch.where(is_first, 0, v) for k, v in state.ledger.items()}

    def _stream_chunks(self, state: DecodeState, n_slots: int, prefilling: Dict[int, list],
                       max_waves: int, on_last=None) -> None:
        """Stream pending prompt chunks (reference: ``_stream_chunks``, no
        draft branch): one dispatch per wave, one C-token chunk per
        prefilling slot. ``prefilling`` maps slot -> [request, offset]; after
        ``max_waves`` waves it carries the remaining offsets into the next
        serving-loop iteration, so a long prompt interleaves with decode
        steps instead of stalling every active slot. ``on_last(slot, req)``
        runs after the wave that completes a slot's prompt (paged serving
        records the prefix there)."""
        c = self.prefill_chunk
        waves = 0
        while prefilling and waves < max_waves:
            toks = np.zeros((n_slots, c), np.int32)
            n_valid = np.zeros((n_slots,), np.int32)
            is_first = np.zeros((n_slots,), bool)
            is_last = np.zeros((n_slots,), bool)
            max_new = np.zeros((n_slots,), np.int32)
            done_slots = []
            for s, (req, off) in list(prefilling.items()):
                part = np.asarray(req.tokens, np.int32)[off: off + c]
                toks[s, : len(part)] = part
                n_valid[s] = len(part)
                # paged slots were reset by the paged admission and may
                # resume mid-prompt at a matched offset: no reset here
                is_first[s] = off == 0 and not self.paged
                max_new[s] = req.max_new_tokens
                if off + len(part) >= req.prompt_len:
                    is_last[s] = True
                    done_slots.append((s, req))
                    del prefilling[s]
                else:
                    prefilling[s] = [req, off + len(part)]
            dev = self.device
            self._chunk_step(state, torch.as_tensor(toks, device=dev),
                             torch.as_tensor(n_valid, device=dev),
                             torch.as_tensor(is_first, device=dev),
                             torch.as_tensor(is_last, device=dev),
                             torch.as_tensor(max_new, device=dev))
            waves += 1
            if on_last is not None:
                for s, req in done_slots:
                    on_last(s, req)

    # ------------------------------------------------------------------
    # paged admission: page-table install + hot restore + copy-on-write
    # ------------------------------------------------------------------
    def _layers(self, state: DecodeState):
        """Every layer's cache view, over all the stacks."""
        for stack in state.cache.values():
            for i in range(stack.lengths.shape[0]):
                yield kv_cache.layer(stack, i)

    def _paged_alloc(self, pg: _PagedServe, n: int) -> List[int]:
        """``n`` free pages, evicting cached prefixes (leaf-only LRU) first
        (reference: ``_paged_alloc``). Where the reference would then
        preempt a weaker slot, the port raises: its overload control is
        not ported, and the default pool never runs dry."""
        pg.ptree.evict_for(n)
        pages = pg.pool.alloc(n)
        if pages is None:
            raise NotImplementedError(
                f"page pool exhausted: {n} pages needed, {pg.pool.available()} of "
                f"{pg.pool.n_pages} free after eviction; preempting a slot to fund them "
                "(the reference's overload control) is not ported; raise n_pages")
        return pages

    def _set_tables(self, state: DecodeState, table: np.ndarray) -> None:
        """Install the host mirror as every stack's page table (reference:
        ``_get_set_table``)."""
        t = torch.as_tensor(table, device=self.device)
        for stack in state.cache.values():
            stack.page_table.copy_(t.expand_as(stack.page_table))

    def _admit_paged(self, state: DecodeState, pg: _PagedServe, fills,
                     prefilling: Dict[int, list]) -> None:
        """Page bookkeeping for every slot paired this round, then one
        ``paged_admit`` pass over the layers (reference: ``_admit_paged``).
        A fill adopts its matched cold pages, gets fresh pages for the rest
        of its prompt (decode growth comes later, ``_ensure_pages``) and
        streams from the matched offset. Matched pages are increfed for
        the round, so the eviction that funds the fresh pages cannot free
        them before the admission reads them."""
        n_slots = pg.host_table.shape[0]
        ps, hc, pps = self._page_size, self.hot_cap, self._pps
        reset = np.zeros((n_slots,), bool)
        new_len = np.zeros((n_slots,), np.int32)
        new_table = pg.host_table.copy()
        hot_src = np.full((n_slots, max(self._n_hot_pages, 1)), -1, np.int32)
        cow_src = np.full((n_slots,), -1, np.int32)
        cow_dst = np.full((n_slots,), -1, np.int32)
        transient: List[int] = []
        for s, req in fills:
            m = pg.ptree.match(req.tokens) if self.prefix_sharing else PrefixMatch()
            if m.length:
                pg.pool.incref(m.hot_pages)
                transient.extend(m.hot_pages)
                if m.cow_src >= 0:
                    pg.pool.incref([m.cow_src])
                    transient.append(m.cow_src)
                pg.pool.incref(m.shared_pages)  # the slot's own reader refs
            shared = list(m.shared_pages)
            fresh = self._paged_alloc(pg, min(pages_needed(req.prompt_len, hc, ps), pps)
                                      - len(shared))
            row = shared + fresh
            if m.cow_src >= 0 and fresh:
                cow_src[s] = m.cow_src
                cow_dst[s] = fresh[0]  # the boundary page: the first one not shared
            reset[s] = True
            new_len[s] = m.length
            hot_src[s, : len(m.hot_pages)] = m.hot_pages
            new_table[s] = row + [0] * (pps - len(row))
            pg.slot_pages[s] = row
            pg.prefix_used[s] = m.length
            pg.seq_mirror[s] = req.prompt_len
            prefilling[s] = [req, m.length]  # only the prompt past the match streams
        dev = self.device
        args = [torch.as_tensor(a, device=dev)
                for a in (reset, new_len, new_table, hot_src, cow_src, cow_dst)]
        for cache in self._layers(state):
            kv_cache.paged_admit(cache, *args)
        r = args[0]
        state.tok = torch.where(r, 0, state.tok)
        state.allocated = state.allocated & ~r  # decodes after its last chunk
        state.done = state.done & ~r
        state.seq_len = torch.where(r, args[1], state.seq_len)
        state.n_gen = torch.where(r, 0, state.n_gen)
        state.out = torch.where(r[:, None], 0, state.out)
        state.ledger = {k: torch.where(r, 0, v) for k, v in state.ledger.items()}
        pg.host_table[:] = new_table
        if transient:
            pg.pool.decref(transient)

    def _ensure_pages(self, state: DecodeState, pg: _PagedServe, sched: SlotScheduler,
                      decoding: List[int], remaining: List[int], chunk: int) -> None:
        """Fund each decoding slot's cold growth for the next decode chunk
        (reference: ``_ensure_pages``): its pages must cover the furthest
        position the chunk can append, bounded by the host budget mirror
        (no device read). Oldest requests first."""
        hc, ps = self.hot_cap, self._page_size
        dirty = False
        for s in sorted(decoding, key=lambda i: sched.slot_req[i].arrival):
            target = min(pg.seq_mirror[s] + min(chunk, remaining[s]), self.max_len)
            need = pages_needed(target, hc, ps) - len(pg.slot_pages[s])
            if need <= 0:
                continue
            pages = self._paged_alloc(pg, need)
            k0 = len(pg.slot_pages[s])
            pg.slot_pages[s].extend(pages)
            pg.host_table[s, k0: k0 + len(pages)] = pages
            dirty = True
        if dirty:
            self._set_tables(state, pg.host_table)

    def _record_prefix(self, state: DecodeState, pg: _PagedServe, s: int, req: Request) -> None:
        """Insert a fully prefilled prompt into the prefix tree (reference:
        ``_record_prefix``); its cold pages are adopted by reference, and
        ``save_hot`` snapshots the slot's hot tier only when the tree needs
        a new hot node."""
        def save(ids):
            arr = np.full((max(pg.ptree.n_hot_pages, 1),), -1, np.int32)
            arr[: len(ids)] = ids
            page_ids = torch.as_tensor(arr, device=self.device)
            for cache in self._layers(state):
                kv_cache.save_hot(cache, s, page_ids)

        pg.ptree.insert(np.asarray(req.tokens, np.int32), pg.host_table[s], save)

    def _validate_request(self, r: Request, n_slots: int) -> None:
        if r.prompt_len == 0:
            raise ValueError(f"request {r.rid}: empty prompt")
        if r.prompt_len + r.max_new_tokens > self.max_len:
            raise ValueError(f"request {r.rid}: prompt {r.prompt_len} + max_new "
                             f"{r.max_new_tokens} exceeds max_len {self.max_len}")
        if self.paged:
            # a request whose peak page set cannot fit the pool alone can
            # never be served
            peak = pages_needed(min(r.prompt_len + r.max_new_tokens, self.max_len),
                                self.hot_cap, self._page_size)
            if peak > self._pool_pages(n_slots):
                raise ValueError(f"request {r.rid}: needs {peak} cold pages at its peak but "
                                 f"the pool holds {self._pool_pages(n_slots)}; raise n_pages")

    def _build_finished(self, req: Request, out_row: np.ndarray, seq_len: int,
                        decode_ledger: Dict[str, int], token_bytes: int,
                        prefix_used: int = 0) -> FinishedRequest:
        """The request's record; its prompt ledger leaves out the
        ``prefix_used`` tokens restored from the prefix tree (and charges
        the reload of their hot part)."""
        prompt = kv_cache.prompt_traffic_tokens_resumed(
            req.prompt_len, min(prefix_used, req.prompt_len), self.hot_cap)
        traffic = {k: (int(decode_ledger[k]) + prompt[k]) * token_bytes for k in TRAFFIC_KEYS}
        return FinishedRequest(rid=req.rid, prompt_len=req.prompt_len, tokens=out_row,
                               seq_len=seq_len, steps=len(out_row), traffic=traffic,
                               prefix_tokens_reused=prefix_used)

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
            self._validate_request(r, n_slots)
        out_cap = self.max_len  # fixed: any budget fits, no per-batch shapes
        sched = SlotScheduler(n_slots)
        for r in requests:
            sched.submit(r)
        state = self._init_state(n_slots, out_cap)
        token_bytes = self._kv_token_bytes()
        remaining = [0] * n_slots  # host mirror of each slot's budget (no sync)
        finished: List[FinishedRequest] = []
        chunked = self.prefill_chunk > 0 and self._chunked_capable()
        prefilling: Dict[int, list] = {}  # slot -> [request, next prompt offset]
        pg = None
        if self.paged:
            pool = PagePool(self._pool_pages(n_slots))
            pg = _PagedServe(pool=pool, ptree=PrefixCache(pool, self.hot_cap, self._page_size),
                             host_table=np.zeros((n_slots, self._pps), np.int32),
                             slot_pages=[[] for _ in range(n_slots)],
                             prefix_used=[0] * n_slots, seq_mirror=[0] * n_slots)
            self._last_pool, self._last_ptree = pg.pool, pg.ptree
        on_last = None
        if self.prefix_sharing:
            on_last = lambda s, req: self._record_prefix(state, pg, s, req)  # noqa: E731
        while not sched.idle():
            if chunked:
                fills = sched.next_fills()
                for s, req in fills:
                    remaining[s] = req.max_new_tokens
                if pg is not None and fills:
                    self._admit_paged(state, pg, fills, prefilling)
                else:
                    for s, req in fills:
                        prefilling[s] = [req, 0]
                self._stream_chunks(state, n_slots, prefilling, max_waves=chunk,
                                    on_last=on_last)
            else:
                while True:
                    slots_idx, group = sched.next_group()
                    if not group:
                        break
                    self._admit(state, slots_idx, group)
                    for s, req in zip(slots_idx, group):
                        remaining[s] = req.max_new_tokens
            # slots still mid-prefill ride through the decode steps inactive:
            # they neither bound the step count nor burn budget
            decoding = [s for s in sched.active_slots() if s not in prefilling]
            if pg is not None:
                self._ensure_pages(state, pg, sched, decoding, remaining, chunk)
            budgets = [remaining[s] for s in decoding if remaining[s] > 0]
            n_steps = min([chunk] + budgets) if budgets else 0
            for _ in range(n_steps):
                self._step(state, out_cap, stop_token)
            for s in decoding:
                remaining[s] = max(remaining[s] - n_steps, 0)
                if pg is not None:
                    pg.seq_mirror[s] = min(pg.seq_mirror[s] + n_steps, self.max_len)
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
                    {k: ledger[k][s] for k in TRAFFIC_KEYS}, token_bytes,
                    pg.prefix_used[s] if pg is not None else 0))
                remaining[s] = 0
                if pg is not None:  # pages free when their last reader leaves
                    pg.pool.decref(pg.slot_pages[s])
                    pg.slot_pages[s] = []
                    pg.prefix_used[s] = pg.seq_mirror[s] = 0
            state.allocated[torch.as_tensor(ripe, device=self.device)] = False
        return finished

    def generate(self, prompts, max_new_tokens: int = 32,
                 stop_token: Optional[int] = None) -> GenerationResult:
        """Aligned-batch generation: one slot per prompt row, admitted by one
        prefill (or, with ``prefill_chunk``, by chunk waves)."""
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
            steps_per_row=[f.steps for f in finished],
        )

    def expected_reduction(self, seq_len: int) -> float:
        """Closed-form DR-eDRAM prediction for a full generation to seq_len."""
        return dr_edram.closed_form_reduction(seq_len, self.hot_cap)
