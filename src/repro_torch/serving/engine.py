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

The SSM family (mamba2-130m) and the hybrid family (zamba2-7b) keep
recurrent state in their cache stacks (``models/transformer.py``):
admission scatters a fresh SSM and conv state into the slot along each
stack's batch axis (``T.batch_axis``), and a decode step leaves an
inactive slot's state as it was. They admit grouped only, as in the
reference: ``prefill_chunk > 0`` keeps grouped admission, ``paged=True``
raises and speculation falls back with a ``RuntimeWarning``. An
attention-free model keeps a token ledger at 0 bytes a token.

A vision model (llava-next-34b) serves like a dense one, grouped: a
request's ``patches`` are projected and concatenated ahead of its text at
admission (requests group by prompt length and patch shape), so its
cache, ``seq_len`` and prompt ledger count ``n_patches`` + text tokens.
A frontend rules out chunked admission, as in the reference, so paged
serving raises and speculation falls back. The encoder-only audio
family (hubert-xlarge) has no decode: ``start_session`` refuses it with
the reference's ``ValueError`` naming the family (from
``init_decode_cache``).

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

Overload control (reference: "Graceful degradation"). The page pool is a
fixed KV budget, and overload degrades against it: admission funds only
the prompt's pages and decode growth is funded chunk by chunk; when the
pool cannot fund a claim the engine evicts cached prefixes (leaf-only
LRU), then preempts strictly weaker slots one at a time
(``SlotScheduler.preempt_victims``). A preempted request's emitted tokens
fold into its prompt and it requeues with its claim; re-admission rides
the prefix match and the chunked prefill, and since a decoded row equals
the prefill's row at its position bit for bit (both fold absolute 32-key
tiles), greedy tokens stay those of an unpressured run. Requests carry a
``deadline`` (on the engine's ``clock``) and a ``priority``;
``Engine.cancel(rid)`` retires a slot or drops a queued request at the
next sync point; ``max_queue`` sheds overflow as ``rejected``. Every end
is a ``FinishedRequest.outcome``, and ``ServeStats`` (``last_stats``)
counts them. ``serve`` composes ``start_session``, a ``run_iteration``
loop and ``finish_session``; ``on_iteration(ctx)`` runs after every
iteration (``serving/chaos.py``: the invariant checker and the fault
injector).

Speculative decoding (reference: "Speculative decoding";
``serving/speculative.py``). ``Engine(draft_cfg=..., draft_params=...,
spec_k=K)`` replaces the one-token decode step by a draft-verify round
(``_spec_step``): K greedy draft ``decode_step``s against a per-slot
contiguous draft cache propose a K-token chunk, one
``transformer.spec_verify_chunk`` (kernel 3's chunked or paged chunked
form with its emit and without the append) scores it against the target's
cache, the accept rule keeps the longest prefix the target itself would
have emitted, and the round commits the whole chunk and truncates both
caches to it; over a sliding-window ring, whose wrapped append is
destructive, it commits only the accepted rows and truncates the draft's
cache alone, as the reference does. The draft prefills from offset 0 in
its own chunk waves beside the target's (``draft_prefilling``), never
sharing a prefix; the target's last chunk waits for the draft. A round emits a data-dependent
1..K tokens, so the host mirrors are read back once per iteration, where
a paged slot also returns the pages its rollback stranded. Greedy tokens
equal the non-speculative serve's for every accept / reject mix, on the
ring too: the ring decode (A1d) folds the ring's positions in absolute
32-key tiles, so a verify chunk's row is the decoded row bit for bit.

Sessions and handoff (reference: the session evacuation API, the
primitives ``serving/replica.py`` and ``serving/router.py`` build on).
``drain_session`` evacuates a live session: every active slot is
preempted through the fold above and the queue emptied, so a resubmitted
request continues bit for bit; with ``with_handoffs`` a paged engine first
serializes each decoding slot's rows (``export_slot``, the
``kv_cache.pack_slot_state`` wire format). ``import_handoff`` seeds a
receiving session's prefix tree from such a payload (the full cold pages
through ``write_pool_pages`` into fresh pages, the hot rows in the
``save_hot`` page layout), so the resubmitted request re-prefills only
past the match. ``abandon_session`` tears down a dead session on the host
alone. ``Engine(guard=PreemptionGuard())`` drains ``serve`` when the flag
is raised and leaves the evacuated requests in ``last_drained``.

SDC resilience (reference: "Fault model & SDC ladder"; ``serving/sdc.py``).
``Engine(integrity=IntegrityConfig(...))`` stamps every packed leaf with
its ABFT checksum and crc32, refuses weights that fail their crc at load
(``WeightFaultError``) and keeps a host golden copy of the packed words.
Every step that emits logits latches non-finite ones per slot into the
device bool ``numerics_bad`` (read on the host only at a scrub). Every
``scrub_every`` iterations, and whenever a decoding slot is ripe for
harvest, ``_scrub`` runs before the harvest: the weights' crcs and the
ABFT probe (one kernel-4 launch per layer slice), whose faults reload the
leaf from the golden copy, flush the prefix tree and roll every slot back
to its last verified token count (``_preempt_slot(n_fold=)``), counting a
strike (``max_weight_strikes`` make the engine ``unhealthy``, which the
``Router`` retires); then the crc stamps of the full cold pages, whose
mismatches quarantine the page and roll its readers back; then the
sentinel, whose slots end ``"numerics"`` (or raise ``NumericsError``).
Since a rollback re-prefills only verified tokens and recompute is bit
exact, every request that finishes gives a faultless serve's tokens.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Callable, Dict, List, Optional, Sequence, Set

import numpy as np
import torch

from repro_torch.configs import ModelConfig
from repro_torch.core import dr_edram, kv_cache
from repro_torch.device import resolve_device
from repro_torch.distributed.fault import PreemptionGuard, StragglerMonitor
from repro_torch.kernels.flash_decode import TILE
from repro_torch.models import pack as pack_lib
from repro_torch.models import transformer as T
from repro_torch.models.pack import pack_params, tree_to
from repro_torch.serving import sdc as sdc_lib
from repro_torch.serving import speculative as spec_lib
from repro_torch.serving.paging import (PagePool, PagePoolError, PrefixCache, PrefixMatch,
                                        pages_needed)
from repro_torch.serving.scheduler import (FinishedRequest, Request, SlotScheduler,
                                           terminal_record)

TRAFFIC_KEYS = kv_cache.TRAFFIC_KEYS
# One page is one 32-key tile of the attention kernels, so a page never
# splits a tile. The reference keeps its rationale (one page = one kernel
# block) but reads the size from its TPU block table, which does not
# carry over.
DEFAULT_PAGE_SIZE = TILE


def _n_attn_layers(cfg: ModelConfig) -> int:
    """Layers that hold a KV cache (reference: ``analysis/roofline.py::
    _n_attn_layers``): the shared block's invocations of a hybrid model,
    none without attention, else every layer."""
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.hybrid_attn_every
    if cfg.attn_type == "none":
        return 0
    return cfg.n_layers
# `generate` pads rows that stopped early with this sentinel (outside every
# vocabulary, so a sampled stop token stays distinguishable from padding)
PAD_TOKEN = -1
# consecutive serving-loop iterations without progress before the engine
# declares the pool unreclaimable (PagePoolError); a transient hold (the
# chaos injector pinning pages for a few iterations) rides through
_STALL_LIMIT = 32


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
    # speculative decoding: the draft model's per-slot cache (None on a
    # non-speculative engine), the proposals scored and those accepted
    draft_cache: Optional[dict] = None
    drafted: Optional[torch.Tensor] = None  # (slots,) int32
    accepted: Optional[torch.Tensor] = None  # (slots,) int32
    # the SDC sentinel: a slot's logits were non-finite since its
    # admission (read on the host only at a scrub, serving/sdc.py); None
    # on an engine without ``integrity``, which never reads it
    numerics_bad: Optional[torch.Tensor] = None  # (slots,) bool


@dataclasses.dataclass
class ServeStats:
    """Control-plane counters of one session (``Engine.last_stats``).
    ``recompute_tokens`` counts the prompt tokens a re-admission prefilled
    again (its prompt minus the prefix match): the price of preemption.
    ``iter_p50`` / ``iter_max`` (seconds) and ``straggler_flags`` summarize
    the iterations' wall times through a ``StragglerMonitor``.
    ``drafted_tokens`` / ``accepted_tokens`` sum the requests' speculation
    ledgers. The SDC ladder's counters (0 without ``Engine(integrity=)``):
    faults the scrub detected, full pages crc-verified, packed leaves
    reloaded from the golden copy, slots contained for non-finite logits
    (outcome ``"numerics"``)."""

    preemptions: int = 0
    rejected: int = 0
    cancelled: int = 0
    expired: int = 0
    recompute_tokens: int = 0
    grown_pages: int = 0
    iterations: int = 0
    iter_p50: float = 0.0
    iter_max: float = 0.0
    straggler_flags: int = 0
    drafted_tokens: int = 0
    accepted_tokens: int = 0
    sdc_detected: int = 0
    pages_scrubbed: int = 0
    weight_reloads: int = 0
    slots_quarantined: int = 0

    def record_spec(self, fin: FinishedRequest) -> None:
        self.drafted_tokens += fin.drafted_tokens
        self.accepted_tokens += fin.accepted_tokens


@dataclasses.dataclass
class _ServeCtx:
    """Mutable state of one session, threaded through admission, growth,
    preemption and harvest, and handed to the ``on_iteration`` hook after
    every iteration (``serving/chaos.py`` reads ``pool`` / ``ptree`` /
    ``host_table`` / ``slot_pages`` / ``sched`` through it; a hook may
    take free pages from the pool or call ``Engine.cancel``, nothing
    else)."""

    state: DecodeState
    sched: SlotScheduler
    finished: List[FinishedRequest]
    stats: ServeStats
    token_bytes: int
    chunked: bool
    remaining: List[int]  # each slot's budget, mirrored on the host (no sync)
    seq_mirror: List[int]  # upper bound of each slot's cache length
    prefix_used: List[int]  # prompt tokens each slot took from the prefix tree
    prefilling: Dict[int, list]  # slot -> [request, next prompt offset]
    slot_pages: List[List[int]]  # pool pages each slot's table maps, in order
    out_cap: int
    stop_token: Optional[int]
    chunk: int  # decode steps between sync points
    pool: Optional[PagePool] = None
    ptree: Optional[PrefixCache] = None
    host_table: Optional[np.ndarray] = None  # (slots, pps) int32: the device tables' mirror
    iteration: int = 0
    on_iteration: Optional[Callable[["_ServeCtx"], None]] = None
    monitor: Optional[StragglerMonitor] = None
    stall: int = 0  # consecutive iterations without progress
    # speculative decoding: slot -> [request, offset] of the draft cache's
    # own prefill (a slot decodes once both caches hold its prompt), and
    # the geometry the invariant checker's check 7 reads
    draft_prefilling: Dict[int, list] = dataclasses.field(default_factory=dict)
    spec: bool = False
    hot_cap: int = 0
    page_size: int = 0
    # after drain_session: the folded requests evacuated instead of finished
    drained: Optional[List[Request]] = None
    # the SDC scrub (Engine(integrity=)): page -> (born, crc) stamps over
    # FULL cold pages, each slot's emitted count at its last clean scrub
    # (the rollback target) and the iteration of the last scrub
    page_crc: Dict[int, tuple] = dataclasses.field(default_factory=dict)
    verified_len: Optional[List[int]] = None
    last_scrub: int = -1


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
                 n_pages: Optional[int] = None, prefix_sharing: bool = True,
                 max_queue: Optional[int] = None, clock: Optional[Callable[[], float]] = None,
                 draft_cfg: Optional[ModelConfig] = None, draft_params=None, spec_k: int = 0,
                 spec_force: Optional[str] = None, guard: Optional[PreemptionGuard] = None,
                 integrity: Optional[sdc_lib.IntegrityConfig] = None):
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
        # bound of the admission queue (None: unbounded); overflow is shed
        # as "rejected". serve(max_queue=...) overrides it per call
        self.max_queue = max_queue
        # the clock of Request.deadline (tests inject a fake one)
        self._clock = clock or time.monotonic
        self._cancel_requested: Set[int] = set()
        self.last_stats: Optional[ServeStats] = None
        self._last_ctx: Optional[_ServeCtx] = None
        # cooperative preemption: when the guard's flag is raised mid-serve,
        # the loop finishes its iteration, folds every active slot's
        # emitted tokens into its request and returns; the evacuated
        # requests are left in last_drained
        self.guard = guard
        self.last_drained: Optional[List[Request]] = None
        # speculative decoding: a draft model and a chunk width K turn the
        # decode step into a draft-verify round (reference gates, in order)
        self.draft_cfg = draft_cfg
        self.spec_k = int(spec_k)
        if spec_force not in (None, "reject"):
            raise ValueError(f"spec_force must be None or 'reject': {spec_force!r}")
        self.spec_force = spec_force
        spec = draft_params is not None and self.spec_k > 0
        if spec:
            if draft_cfg is None:
                raise ValueError("draft_params requires draft_cfg")
            if sample != "greedy":
                spec_lib.rejection_sample()
            if draft_cfg.vocab_size != cfg.vocab_size:
                raise ValueError(
                    f"draft vocab {draft_cfg.vocab_size} != target vocab {cfg.vocab_size}: "
                    "draft proposals are token ids scored by the target — the vocabularies "
                    "must match")
            if not (prefill_chunk > 0 and self._chunked_capable()):
                warnings.warn(
                    f"speculative decoding needs chunked prefill on an attention-cache "
                    f"family without a frontend; {cfg.name} (family={cfg.family}, "
                    f"attn={cfg.attn_type}, frontend={cfg.frontend}, "
                    f"prefill_chunk={prefill_chunk}) falls back to non-speculative decode",
                    RuntimeWarning, stacklevel=2)
                spec = False
        self.spec = spec
        self.draft_params = (pack_params(tree_to(draft_params, self.device), draft_cfg)
                             if spec else None)
        # the SDC plane: stamp every packed leaf, refuse a corrupt image at
        # load and keep a host golden copy of the packed words (the repair
        # source, one list of layers per path); the session loop scrubs on
        # the cadence of `integrity` (_scrub)
        self.integrity = integrity
        self._golden: Optional[Dict[str, List[torch.Tensor]]] = None
        self.weight_fault_strikes = 0  # distinct scrubs that found weight faults
        self.unhealthy = False  # strikes >= max_weight_strikes
        if integrity is not None:
            self.params = pack_lib.add_integrity(self.params)
            bad = pack_lib.verify_packed(self.params)
            if bad:
                raise sdc_lib.WeightFaultError(f"packed weights failed crc32 at load: {bad}")
            self._golden = {path: [pw.packed.cpu().clone() for pw in stack.layers]
                            for path, stack in pack_lib.iter_packed_leaves(self.params)}

    def _chunked_capable(self) -> bool:
        """Chunked prefill needs a pure attention-token path: a dense / MoE
        family (no recurrent SSM state to stream) with full or
        sliding-window GQA attention and no frontend features spliced
        ahead of the text (reference: ``_chunked_capable``). Elsewhere
        ``prefill_chunk > 0`` admits grouped."""
        return (self.cfg.family in ("dense", "moe") and self.cfg.attn_type in ("full", "swa")
                and self.cfg.frontend == "none")

    # ------------------------------------------------------------------
    def _kv_token_bytes(self) -> int:
        """Ledger bytes per token, at 2 bytes a value, over the attention
        layers: GQA caches k and v of every kv head; MLA one latent row
        (kv_lora_rank + rope dims); an attention-free model nothing. The
        reference's rule charges 2 bytes a value whatever ``kv_fp8`` says
        (``Engine._kv_token_bytes``), so fp8 tiers leave the ledger as it
        is."""
        cfg = self.cfg
        if cfg.attn_type == "mla":
            per_layer = cfg.mla.kv_cache_dim * 2
        elif cfg.attn_type == "none":
            per_layer = 0
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

        # the draft's cache is always contiguous: private scratch, never
        # paged or shared, its lengths kept equal to the target's by truncate
        draft_cache = (T.init_decode_cache(self.draft_cfg, n_slots, self.max_len, self.hot_cap,
                                           dtype=self.draft_params["final_ln"].dtype,
                                           device=dev) if self.spec else None)
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
            draft_cache=draft_cache, drafted=z(), accepted=z(),
            numerics_bad=(torch.zeros((n_slots,), dtype=torch.bool, device=dev)
                          if self.integrity is not None else None),
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
        # the SDC sentinel: latch non-finite logits per active slot
        if state.numerics_bad is not None:
            state.numerics_bad |= active & ~torch.isfinite(logits).all(dim=-1)

    def _admit(self, state: DecodeState, slots_idx: List[int], group: List[Request]) -> None:
        """Prefill ``group`` (equal prompt lengths and patch shapes; a vision
        model's patches stacked ahead of the text), scatter the fresh cache
        rows into ``slots_idx`` along every tensor's batch axis (reference:
        ``_scatter_cache``; a recurrent family's SSM and conv states too, so
        a slot's next tenant starts from its own prompt's state) and sample
        the first tokens."""
        toks = torch.as_tensor(np.stack([np.asarray(r.tokens, np.int32) for r in group]),
                               device=self.device)
        patches = None
        if group[0].patches is not None:
            patches = torch.as_tensor(np.stack([np.asarray(r.patches) for r in group]),
                                      device=self.device)
        # the lm_head at the slot count, as in the chunk and decode steps
        logits, fresh = T.prefill(self.params, self.cfg, toks, hot_cap=self.hot_cap,
                                  max_len=self.max_len, logit_rows=state.tok.shape[0],
                                  patches=patches)
        idx = torch.as_tensor(slots_idx, dtype=torch.long, device=self.device)
        for name, stack in state.cache.items():
            ax = T.batch_axis(name)
            for live, new in zip(stack, fresh[name]):
                # one tier dtype; a conv state shorter than the slot's (a
                # prompt under d_conv - 1 tokens) broadcasts over its rows,
                # as the reference's scatter does
                kv_cache.raw(live).movedim(ax, 0)[idx] = kv_cache.raw(new).movedim(ax, 0)
        max_new = torch.as_tensor([r.max_new_tokens for r in group], dtype=torch.int32,
                                  device=self.device)
        state.tok[idx] = self._sample_fn(logits)
        state.allocated[idx] = True
        state.done[idx] = max_new <= 0
        state.seq_len[idx] = self._attempt_prompt_len(group[0])
        state.n_gen[idx] = 0
        state.max_new[idx] = max_new
        state.out[idx] = 0
        state.drafted[idx] = 0
        state.accepted[idx] = 0
        if state.numerics_bad is not None:
            state.numerics_bad[idx] = False
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
        state.drafted = torch.where(is_first, 0, state.drafted)
        state.accepted = torch.where(is_first, 0, state.accepted)
        if state.numerics_bad is not None:
            state.numerics_bad.masked_fill_(is_first, False)

    def _draft_chunk_step(self, state: DecodeState, tokens: torch.Tensor,
                          n_valid: torch.Tensor, is_first: torch.Tensor) -> None:
        """One chunk wave of the draft cache's prefill (reference:
        ``_get_draft_chunk``): the target's wave protocol, idle slots
        riding along with 0 rows; only the cache matters, since the target
        samples every emitted token."""
        for stack in state.draft_cache.values():
            stack.lengths.masked_fill_(is_first[None, :], 0)
        T.prefill_chunk_step(self.draft_params, self.draft_cfg, tokens, state.draft_cache,
                             n_valid)

    def _spec_step(self, state: DecodeState, out_cap: int, stop_token: Optional[int]) -> None:
        """One draft-verify round over every slot, in place (reference:
        ``_get_spec_step``): K gated draft decode steps propose a chunk
        (the pending token, then K - 1 proposals; the K-th step only
        appends row K - 1 to the draft cache), ``spec_verify_chunk``
        scores it without appending, the accept rule picks ``n_emit``, the
        whole chunk is committed and both caches are truncated to ``seq0
        + n_emit``; a ring (SWA) commits only the ``n_emit`` accepted rows,
        since a wrapped ring append overwrites rows a rollback could not
        restore, and only the draft's cache is truncated. Every emitted
        token is a target argmax. The ledger charges
        ``spec_traffic_tokens`` for the rows committed. Device work only."""
        k_spec = self.spec_k
        active = state.allocated & ~state.done
        act32 = active.to(torch.int32)
        seq0 = state.seq_len
        chunk_valid = torch.where(active, (state.max_new - state.n_gen).clamp(0, k_spec), 0)
        cols, tok_i = [state.tok], state.tok
        for i in range(k_spec):
            gate = active & (i < chunk_valid)
            dlogits, _ = T.decode_step(self.draft_params, self.draft_cfg, tok_i,
                                       state.draft_cache, active=gate)
            tok_i = torch.where(gate, dlogits.argmax(dim=-1).to(torch.int32), tok_i)
            if i + 1 < k_spec:
                cols.append(tok_i)
        chunk = torch.stack(cols, dim=1)  # (slots, K)
        logits, kvs = T.spec_verify_chunk(self.params, self.cfg, chunk, state.cache, chunk_valid)
        greedy = logits.argmax(dim=-1).to(torch.int32)
        n_emit = spec_lib.longest_accepted_prefix(chunk, greedy, chunk_valid, stop_token,
                                                  force_reject=self.spec_force == "reject")
        ring = self.cfg.attn_type == "swa"
        commit_n = n_emit if ring else chunk_valid
        T.spec_commit_chunk(self.cfg, state.cache, kvs, commit_n)
        for caches in (state.draft_cache,) if ring else (state.cache, state.draft_cache):
            for stack in caches.values():
                kv_cache.truncate(stack, seq0 + n_emit)
        pos = (torch.arange(out_cap, dtype=torch.int32, device=self.device)[None]
               - state.n_gen[:, None])
        emit = (pos >= 0) & (pos < n_emit[:, None])
        vals = torch.gather(chunk, 1, pos.clamp(0, k_spec - 1).long())
        state.out = torch.where(emit, vals, state.out)
        state.n_gen = state.n_gen + n_emit
        state.seq_len = seq0 + n_emit
        # the pending token of the next round: the target's own
        # continuation after the last emitted token
        new_tok = torch.gather(greedy, 1, (n_emit - 1).clamp(0, k_spec - 1).long()[:, None])[:, 0]
        state.tok = torch.where(active, new_tok, state.tok)
        done = state.done | (active & (state.n_gen >= state.max_new))
        if stop_token is not None:
            done = done | (active & (state.tok == stop_token))
        state.done = done
        tr = kv_cache.spec_traffic_tokens(seq0, chunk_valid, commit_n, self.hot_cap)
        state.ledger = {k: state.ledger[k] + tr[k] * act32 for k in TRAFFIC_KEYS}
        state.drafted = state.drafted + (chunk_valid - 1).clamp(min=0)
        state.accepted = state.accepted + (n_emit - 1).clamp(min=0)
        # the SDC sentinel over the verify logits (slots, K, vocab)
        if state.numerics_bad is not None:
            state.numerics_bad |= active & ~torch.isfinite(logits).all(dim=-1).all(dim=-1)

    def _stream_chunks(self, state: DecodeState, n_slots: int, prefilling: Dict[int, list],
                       max_waves: int, on_last=None,
                       draft_prefilling: Optional[Dict[int, list]] = None) -> None:
        """Stream pending prompt chunks (reference: ``_stream_chunks``): one
        dispatch per wave, one C-token chunk per prefilling slot.
        ``prefilling`` maps slot -> [request, offset]; after ``max_waves``
        waves it carries the remaining offsets into the next serving-loop
        iteration, so a long prompt interleaves with decode steps instead of
        stalling every active slot. ``on_last(slot, req)`` runs after the
        wave that completes a slot's prompt (paged serving records the
        prefix there).

        A speculative engine streams the draft cache's prefill beside it
        (``draft_prefilling``, one more dispatch per wave), always from
        offset 0, so it can lag a target that resumed at a prefix match;
        the target's last chunk waits until the draft catches up, since the
        slot enters the rounds as soon as its target prefill completes."""
        c = self.prefill_chunk
        dp = draft_prefilling if draft_prefilling is not None else {}
        dev = self.device
        waves = 0
        while (prefilling or dp) and waves < max_waves:
            toks = np.zeros((n_slots, c), np.int32)
            n_valid = np.zeros((n_slots,), np.int32)
            is_first = np.zeros((n_slots,), bool)
            is_last = np.zeros((n_slots,), bool)
            max_new = np.zeros((n_slots,), np.int32)
            done_slots = []
            for s, (req, off) in list(prefilling.items()):
                part = np.asarray(req.tokens, np.int32)[off: off + c]
                if (s in dp and off + len(part) >= req.prompt_len
                        and dp[s][1] + c < req.prompt_len):
                    continue  # the last chunk waits: the draft still lags
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
            if dp:
                dtoks = np.zeros((n_slots, c), np.int32)
                dn_valid = np.zeros((n_slots,), np.int32)
                d_first = np.zeros((n_slots,), bool)
                for s, (req, doff) in list(dp.items()):
                    part = np.asarray(req.tokens, np.int32)[doff: doff + c]
                    dtoks[s, : len(part)] = part
                    dn_valid[s] = len(part)
                    d_first[s] = doff == 0
                    if doff + len(part) >= req.prompt_len:
                        del dp[s]
                    else:
                        dp[s] = [req, doff + len(part)]
                self._draft_chunk_step(state, torch.as_tensor(dtoks, device=dev),
                                       torch.as_tensor(dn_valid, device=dev),
                                       torch.as_tensor(d_first, device=dev))
            if n_valid.any():  # every target chunk may be waiting for its draft
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

    # ------------------------------------------------------------------
    # page pressure: reclaim, preemption, release
    # ------------------------------------------------------------------
    def _release_slot_state(self, state: DecodeState, s: int, truncate: bool = True) -> None:
        """Release slot ``s``'s device row mid-flight (preemption or
        cancellation): clear its allocated / done flags and, when
        ``truncate``, its cache length in every stack
        (``kv_cache.release_slots``), so the slot is inert until
        re-admitted; the draft cache's row too. Grouped admission skips the
        truncation: it writes a whole fresh row, lengths included."""
        state.allocated[s] = False
        state.done[s] = False
        if state.numerics_bad is not None:
            state.numerics_bad[s] = False
        if truncate:
            mask = torch.zeros(state.allocated.shape, dtype=torch.bool, device=self.device)
            mask[s] = True
            for stack in list(state.cache.values()) + list((state.draft_cache or {}).values()):
                kv_cache.release_slots(stack, mask)

    def _preempt_slot(self, ctx: _ServeCtx, s: int, n_fold: Optional[int] = None) -> None:
        """Evict slot ``s`` mid-flight to reclaim its pages (reference:
        ``_preempt_slot``): fold the tokens it emitted into its request's
        prompt, carry this attempt's ledger, release its pages and device
        row, and requeue it with its claim. The pending token t_k is sampled
        but neither emitted nor cached, so re-prefilling prompt ‖ t_0 ..
        t_{k-1} samples t_k again from the same last row, bit for bit: the
        decode and the chunked prefill fold the same absolute tiles. A
        speculative slot's drafted / accepted counts fold into the request
        as its ledger does. ``n_fold`` caps the tokens folded: the SDC
        ladder passes the slot's last verified count, so tokens emitted
        after a detected corruption are discarded and generated again from
        the clean prefix (the ledger still charges the whole attempt)."""
        req = ctx.sched.slot_req[s]
        tb = ctx.token_bytes
        carry = dict(req.carry_traffic) if req.carry_traffic else {k: 0 for k in TRAFFIC_KEYS}
        if s in ctx.prefilling:
            off = ctx.prefilling.pop(s)[1]
            if off:  # the partial prefill the device already did
                prompt = kv_cache.prompt_traffic_tokens_resumed(
                    off, min(ctx.prefix_used[s], off), self.hot_cap)
                for k in TRAFFIC_KEYS:
                    carry[k] += prompt[k] * tb
        else:
            st = ctx.state
            p_attempt = req.prompt_len
            n_gen = int(st.n_gen[s])
            if n_fold is not None:
                n_gen = min(n_fold, n_gen)
            if n_gen:
                out_row = st.out[s, :n_gen].cpu().numpy().astype(np.int32)
                if req.orig_prompt_len is None:
                    req.orig_prompt_len = req.prompt_len
                req.tokens = np.concatenate([np.asarray(req.tokens, np.int32), out_row])
                req.max_new_tokens -= n_gen
            prompt = kv_cache.prompt_traffic_tokens_resumed(p_attempt, ctx.prefix_used[s],
                                                            self.hot_cap)
            for k in TRAFFIC_KEYS:
                carry[k] += (prompt[k] + int(st.ledger[k][s])) * tb
            req.carry_drafted += int(st.drafted[s])
            req.carry_accepted += int(st.accepted[s])
        ctx.draft_prefilling.pop(s, None)
        req.carry_traffic = carry
        req.carry_reused += ctx.prefix_used[s]
        req.n_preemptions += 1
        ctx.stats.preemptions += 1
        if ctx.slot_pages[s]:
            ctx.pool.decref(ctx.slot_pages[s])
            ctx.slot_pages[s] = []
        ctx.prefix_used[s] = ctx.remaining[s] = ctx.seq_mirror[s] = 0
        if ctx.verified_len is not None:
            ctx.verified_len[s] = 0
        ctx.sched.requeue(s)
        self._release_slot_state(ctx.state, s, truncate=ctx.chunked)

    def _paged_alloc(self, ctx: _ServeCtx, n: int, beneficiary: Request,
                     exclude: Sequence[int] = ()) -> Optional[List[int]]:
        """``n`` pages for ``beneficiary`` (reference: ``_paged_alloc``):
        leaf-only LRU eviction of cached prefixes first, then preemption of
        strictly weaker slots, one victim at a time (a victim's pages may be
        shared with the tree, so each preemption may unlock more eviction).
        None when the claim cannot be funded: the caller requeues
        (admission) or preempts itself (growth)."""
        ctx.ptree.evict_for(n)
        pages = ctx.pool.alloc(n)
        while pages is None:
            emitted = {s: ctx.sched.slot_req[s].max_new_tokens - ctx.remaining[s]
                       for s in ctx.sched.active_slots() if s not in ctx.prefilling}
            victims = [v for v in ctx.sched.preempt_victims(beneficiary, emitted, exclude)
                       if ctx.slot_pages[v]]  # a pageless victim funds nothing
            if not victims:
                return None
            self._preempt_slot(ctx, victims[0])
            ctx.ptree.evict_for(n)
            pages = ctx.pool.alloc(n)
        return pages

    def _set_tables(self, state: DecodeState, table: np.ndarray) -> None:
        """Install the host mirror as every stack's page table (reference:
        ``_get_set_table``)."""
        t = torch.as_tensor(table, device=self.device)
        for stack in state.cache.values():
            stack.page_table.copy_(t.expand_as(stack.page_table))

    def _admit_paged(self, ctx: _ServeCtx, fills) -> bool:
        """Page bookkeeping for every slot paired this round, then one
        ``paged_admit`` pass over the layers (reference: ``_admit_paged``).
        A fill adopts its matched cold pages, gets fresh pages for the rest
        of its prompt (decode growth comes later, ``_ensure_pages``) and
        streams from the matched offset. Matched pages are increfed for the
        round, so the eviction or preemption that funds the fresh pages
        cannot free them before the admission reads them. A fill the pool
        cannot fund unwinds its own increfs and requeues. True when a fill
        was admitted."""
        state = ctx.state
        n_slots = ctx.host_table.shape[0]
        ps, hc, pps = self._page_size, self.hot_cap, self._pps
        reset = np.zeros((n_slots,), bool)
        new_len = np.zeros((n_slots,), np.int32)
        new_table = ctx.host_table.copy()
        hot_src = np.full((n_slots, max(self._n_hot_pages, 1)), -1, np.int32)
        cow_src = np.full((n_slots,), -1, np.int32)
        cow_dst = np.full((n_slots,), -1, np.int32)
        transient: List[int] = []
        # this round's fills are never victims: a processed one has its
        # bookkeeping in flight, a pending one has no pages yet
        fill_slots = [s for s, _ in fills]
        for s, req in fills:
            m = ctx.ptree.match(req.tokens) if self.prefix_sharing else PrefixMatch()
            mine: List[int] = []  # this fill's transient increfs
            if m.length:
                ctx.pool.incref(m.hot_pages)
                mine.extend(m.hot_pages)
                if m.cow_src >= 0:
                    ctx.pool.incref([m.cow_src])
                    mine.append(m.cow_src)
                ctx.pool.incref(m.shared_pages)  # the slot's own reader refs
            shared = list(m.shared_pages)
            fresh = self._paged_alloc(ctx, min(pages_needed(req.prompt_len, hc, ps), pps)
                                      - len(shared), req, exclude=fill_slots)
            if fresh is None:  # unwind this fill, retry at a later sync point
                if mine:
                    ctx.pool.decref(mine)
                if m.length:
                    ctx.pool.decref(shared)
                ctx.sched.requeue(s)
                ctx.remaining[s] = ctx.seq_mirror[s] = 0
                continue
            transient.extend(mine)
            row = shared + fresh
            if m.cow_src >= 0 and fresh:
                cow_src[s] = m.cow_src
                cow_dst[s] = fresh[0]  # the boundary page: the first one not shared
            reset[s] = True
            new_len[s] = m.length
            hot_src[s, : len(m.hot_pages)] = m.hot_pages
            new_table[s] = row + [0] * (pps - len(row))
            ctx.slot_pages[s] = row
            ctx.prefix_used[s] = m.length
            ctx.seq_mirror[s] = req.prompt_len
            if req.orig_prompt_len is not None:
                # a re-admission prefills again what an earlier attempt
                # computed, less what the prefix tree kept
                ctx.stats.recompute_tokens += req.prompt_len - m.length
            ctx.prefilling[s] = [req, m.length]  # only the prompt past the match streams
        admitted = bool(reset.any())
        if admitted:
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
            state.drafted = torch.where(r, 0, state.drafted)
            state.accepted = torch.where(r, 0, state.accepted)
            if state.numerics_bad is not None:
                state.numerics_bad.masked_fill_(r, False)
            ctx.host_table[:] = new_table
        if transient:
            ctx.pool.decref(transient)
        return admitted

    def _ensure_pages(self, ctx: _ServeCtx, chunk: int) -> None:
        """Fund each decoding slot's cold growth for the next decode chunk
        (reference: ``_ensure_pages``): its pages must cover the furthest
        position the chunk can append, bounded by the host budget mirror
        (no device read). Strongest claims first, so under pressure the
        weak are preempted before they ask; a slot whose own growth cannot
        be funded preempts itself rather than stall the batch."""
        hc, ps = self.hot_cap, self._page_size
        decoding = [s for s in ctx.sched.active_slots() if s not in ctx.prefilling]
        dirty = False
        for s in sorted(decoding, key=lambda i: ctx.sched.slot_req[i].claim):
            req = ctx.sched.slot_req[s]
            if req is None:  # preempted by a stronger claim this round
                continue
            target = min(ctx.seq_mirror[s] + min(chunk, ctx.remaining[s]), self.max_len)
            need = pages_needed(target, hc, ps) - len(ctx.slot_pages[s])
            if need <= 0:
                continue
            pages = self._paged_alloc(ctx, need, req, exclude=(s,))
            if pages is None:
                self._preempt_slot(ctx, s)
                continue
            k0 = len(ctx.slot_pages[s])
            ctx.slot_pages[s].extend(pages)
            ctx.host_table[s, k0: k0 + len(pages)] = pages
            ctx.stats.grown_pages += len(pages)
            dirty = True
        if dirty:
            self._set_tables(ctx.state, ctx.host_table)

    def _record_prefix(self, ctx: _ServeCtx, s: int, req: Request) -> None:
        """Insert a fully prefilled prompt into the prefix tree (reference:
        ``_record_prefix``); its cold pages are adopted by reference, and
        ``save_hot`` snapshots the slot's hot tier only when the tree needs
        a new hot node."""
        def save(ids):
            arr = np.full((max(ctx.ptree.n_hot_pages, 1),), -1, np.int32)
            arr[: len(ids)] = ids
            page_ids = torch.as_tensor(arr, device=self.device)
            for cache in self._layers(ctx.state):
                kv_cache.save_hot(cache, s, page_ids)

        ctx.ptree.insert(np.asarray(req.tokens, np.int32), ctx.host_table[s], save)

    # ------------------------------------------------------------------
    # outcomes: finish / cancel / expire / reject
    # ------------------------------------------------------------------
    def cancel(self, rid: int) -> None:
        """Cancel request ``rid`` at the next sync point of the running
        session: an active slot retires (its tokens so far surface with
        outcome ``cancelled``), its pages return and its device row is
        released; a queued request is dropped without running. Unknown or
        finished rids are no-ops."""
        self._cancel_requested.add(rid)

    def _terminal_outcome(self, req: Request, now: float) -> Optional[str]:
        if req.rid in self._cancel_requested:
            self._cancel_requested.discard(req.rid)
            return "cancelled"
        if req.deadline is not None and now >= req.deadline:
            return "expired"
        return None

    def _build_finished(self, req: Request, out_row: np.ndarray, seq_len: int,
                        decode_ledger: Dict[str, int], prefilled_len: int, prefix_used: int,
                        outcome: str, token_bytes: int, drafted: int = 0,
                        accepted: int = 0) -> FinishedRequest:
        """The request's record from one slot's harvest (reference:
        ``_build_finished``). The prompt ledger leaves out the
        ``prefix_used`` tokens restored from the prefix tree (and charges
        the reload of their hot part). A preempted request's earlier
        tokens are stitched back in front of this attempt's, the ORIGINAL
        prompt length is reported, and the ledger adds every earlier
        attempt's work (``carry_traffic``), its speculation counts too."""
        traffic = {k: int(decode_ledger[k]) * token_bytes for k in TRAFFIC_KEYS}
        if prefilled_len:
            prompt = kv_cache.prompt_traffic_tokens_resumed(
                prefilled_len, min(prefix_used, prefilled_len), self.hot_cap)
            for k in TRAFFIC_KEYS:
                traffic[k] += prompt[k] * token_bytes
        if req.carry_traffic:
            for k in TRAFFIC_KEYS:
                traffic[k] += req.carry_traffic[k]
        if req.orig_prompt_len is not None:
            prior = np.asarray(req.tokens, np.int32)[req.orig_prompt_len:]
            tokens, prompt_len = np.concatenate([prior, out_row]), req.orig_prompt_len
        else:
            tokens, prompt_len = out_row, req.prompt_len
        return FinishedRequest(rid=req.rid, prompt_len=prompt_len, tokens=tokens,
                               seq_len=seq_len, steps=len(tokens), traffic=traffic,
                               prefix_tokens_reused=prefix_used + req.carry_reused,
                               outcome=outcome, n_preemptions=req.n_preemptions,
                               drafted_tokens=drafted + req.carry_drafted,
                               accepted_tokens=accepted + req.carry_accepted)

    def _finish_queued(self, req: Request, outcome: str) -> FinishedRequest:
        """Terminal record of a request that holds no slot at its end."""
        return terminal_record(req, outcome)

    def _cancel_slot(self, ctx: _ServeCtx, s: int, outcome: str) -> None:
        """End an active slot mid-flight (cancel / deadline): harvest what
        it emitted, retire it, return its pages, release its device row."""
        req = ctx.sched.retire(s)
        st = ctx.state
        ctx.draft_prefilling.pop(s, None)
        if s in ctx.prefilling:
            off = ctx.prefilling.pop(s)[1]
            fin = self._build_finished(req, np.zeros((0,), np.int32), off,
                                       {k: 0 for k in TRAFFIC_KEYS}, off, ctx.prefix_used[s],
                                       outcome, ctx.token_bytes)
        else:
            n_gen = int(st.n_gen[s])
            fin = self._build_finished(
                req, st.out[s, :n_gen].cpu().numpy().astype(np.int32), int(st.seq_len[s]),
                {k: int(st.ledger[k][s]) for k in TRAFFIC_KEYS},
                self._attempt_prompt_len(req), ctx.prefix_used[s], outcome, ctx.token_bytes,
                drafted=int(st.drafted[s]), accepted=int(st.accepted[s]))
        ctx.finished.append(fin)
        ctx.stats.record_spec(fin)
        if ctx.slot_pages[s]:
            ctx.pool.decref(ctx.slot_pages[s])
            ctx.slot_pages[s] = []
        ctx.prefix_used[s] = ctx.remaining[s] = ctx.seq_mirror[s] = 0
        if ctx.verified_len is not None:
            ctx.verified_len[s] = 0
        self._release_slot_state(st, s, truncate=ctx.chunked)

    def _sweep_cancel_expire(self, ctx: _ServeCtx) -> int:
        """Apply cancellations and deadlines at a sync point, to queued and
        active requests alike; returns how many ended (progress, for the
        stall guard)."""
        now = self._clock()
        events = 0
        for req in list(ctx.sched.queue):
            outcome = self._terminal_outcome(req, now)
            if outcome:
                ctx.sched.drop(req)
                fin = self._finish_queued(req, outcome)
                ctx.finished.append(fin)
                ctx.stats.record_spec(fin)
                setattr(ctx.stats, outcome, getattr(ctx.stats, outcome) + 1)
                events += 1
        for s, req in enumerate(ctx.sched.slot_req):
            if req is None:
                continue
            outcome = self._terminal_outcome(req, now)
            if outcome:
                self._cancel_slot(ctx, s, outcome)
                setattr(ctx.stats, outcome, getattr(ctx.stats, outcome) + 1)
                events += 1
        return events

    def _attempt_prompt_len(self, req: Request) -> int:
        """The rows an admission of ``req`` prefills: its prompt, and a
        vision model's patches ahead of it (reference:
        ``_attempt_prompt_len``)."""
        return req.prompt_len + (self.cfg.n_patches if req.patches is not None else 0)

    def _validate_request(self, r: Request, n_slots: int) -> None:
        need = self._attempt_prompt_len(r)
        if need == 0:
            raise ValueError(f"request {r.rid}: empty prompt")
        if need + r.max_new_tokens > self.max_len:
            raise ValueError(f"request {r.rid}: prompt {need} + max_new "
                             f"{r.max_new_tokens} exceeds max_len {self.max_len}")
        if self.paged:
            # feasibility, not headroom: with lazy growth and preemption a
            # request whose peak page set fits the pool completes (the
            # strongest claim can reclaim every other page); one that
            # cannot fit alone never can
            peak = pages_needed(min(need + r.max_new_tokens, self.max_len),
                                self.hot_cap, self._page_size)
            if peak > self._pool_pages(n_slots):
                raise ValueError(f"request {r.rid}: needs {peak} cold pages at its peak but "
                                 f"the pool holds {self._pool_pages(n_slots)}: unservable "
                                 "even with every other slot preempted; raise n_pages")

    # ------------------------------------------------------------------
    # the serving loop, as a resumable session
    # ------------------------------------------------------------------
    @torch.inference_mode()
    def start_session(self, requests: Sequence[Request], slots: Optional[int] = None,
                      stop_token: Optional[int] = None, sync_every: Optional[int] = None,
                      max_queue: Optional[int] = None,
                      on_iteration: Optional[Callable[[_ServeCtx], None]] = None) -> _ServeCtx:
        """Validate ``requests`` and build the session that ``run_iteration``
        advances (reference: ``start_session``); a request the bounded queue
        sheds ends at once as ``rejected``."""
        n_slots = slots or self.slots
        for r in requests:
            self._validate_request(r, n_slots)
        # a new session owes nothing to the rids of earlier ones
        self._cancel_requested.clear()
        sched = SlotScheduler(n_slots, max_queue=self.max_queue if max_queue is None
                              else max_queue)
        stats = ServeStats()
        finished: List[FinishedRequest] = []
        for r in requests:
            if not sched.submit(r):
                stats.rejected += 1
                finished.append(self._finish_queued(r, "rejected"))
        out_cap = self.max_len  # fixed: any budget fits, no per-batch shapes
        ctx = _ServeCtx(
            state=self._init_state(n_slots, out_cap), sched=sched, finished=finished,
            stats=stats, token_bytes=self._kv_token_bytes(),
            chunked=self.prefill_chunk > 0 and self._chunked_capable(),
            remaining=[0] * n_slots, seq_mirror=[0] * n_slots, prefix_used=[0] * n_slots,
            prefilling={}, slot_pages=[[] for _ in range(n_slots)], out_cap=out_cap,
            stop_token=stop_token, chunk=sync_every or self.sync_every,
            on_iteration=on_iteration, monitor=StragglerMonitor(window=16, factor=4.0),
            spec=self.spec, hot_cap=self.hot_cap,
            page_size=self._page_size if self.paged else 0, verified_len=[0] * n_slots,
        )
        if self.paged:
            ctx.pool = PagePool(self._pool_pages(n_slots))
            ctx.ptree = PrefixCache(ctx.pool, self.hot_cap, self._page_size)
            ctx.host_table = np.zeros((n_slots, self._pps), np.int32)
            self._last_pool, self._last_ptree = ctx.pool, ctx.ptree
        self._last_ctx = ctx
        return ctx

    def submit_to_session(self, ctx: _ServeCtx, req: Request) -> bool:
        """Admit ``req`` into a live session: the same validation, and
        False when the bounded queue sheds it (the caller owns its end)."""
        self._validate_request(req, len(ctx.sched.slot_req))
        return ctx.sched.submit(req)

    @torch.inference_mode()
    def run_iteration(self, ctx: _ServeCtx) -> bool:
        """One serving-loop iteration (reference: ``run_iteration``): sweep
        cancellations and deadlines, admit into free slots, fund page
        growth (which may preempt), run one decode chunk, harvest finished
        slots, run the hook, count the stall guard. True when it made
        progress. Call only while ``not ctx.sched.idle()``."""
        t0 = time.perf_counter()
        sched, chunk, state = ctx.sched, ctx.chunk, ctx.state
        n_slots = len(sched.slot_req)
        progress = self._sweep_cancel_expire(ctx) > 0
        if ctx.chunked:
            fills = sched.next_fills()
            for s, req in fills:
                ctx.remaining[s] = req.max_new_tokens
            if self.paged and fills:
                progress |= self._admit_paged(ctx, fills)
            elif fills:
                for s, req in fills:
                    ctx.prefilling[s] = [req, 0]
                    ctx.seq_mirror[s] = req.prompt_len
                progress = True
            on_last = None
            if self.prefix_sharing:
                on_last = lambda s, req: self._record_prefix(ctx, s, req)  # noqa: E731
            if self.spec:
                # every fresh slot prefills the draft cache too, from offset
                # 0 (the draft never shares a prefix)
                for s, (req, _) in ctx.prefilling.items():
                    ctx.draft_prefilling.setdefault(s, [req, 0])
            progress |= bool(ctx.prefilling) or bool(ctx.draft_prefilling)
            self._stream_chunks(state, n_slots, ctx.prefilling, max_waves=chunk,
                                on_last=on_last, draft_prefilling=ctx.draft_prefilling)
        else:
            while True:
                slots_idx, group = sched.next_group()
                if not group:
                    break
                self._admit(state, slots_idx, group)
                for s, req in zip(slots_idx, group):
                    ctx.remaining[s] = req.max_new_tokens
                    ctx.seq_mirror[s] = self._attempt_prompt_len(req)
                progress = True
        if self.paged:
            # a speculative round appends up to K rows before its rollback:
            # fund the worst case, the decref below returns what it strands
            self._ensure_pages(ctx, chunk * self.spec_k if self.spec else chunk)
        # slots still mid-prefill ride through the decode steps inactive:
        # they neither bound the step count nor burn budget
        decoding = [s for s in sched.active_slots()
                    if s not in ctx.prefilling and s not in ctx.draft_prefilling]
        budgets = [ctx.remaining[s] for s in decoding if ctx.remaining[s] > 0]
        n_steps = min([chunk] + budgets) if budgets else 0
        step = self._spec_step if self.spec else self._step
        for _ in range(n_steps):
            step(state, ctx.out_cap, ctx.stop_token)
        if self.spec and n_steps:
            self._refresh_mirrors(ctx, decoding)
        else:
            for s in decoding:
                ctx.remaining[s] = max(ctx.remaining[s] - n_steps, 0)
                ctx.seq_mirror[s] = min(ctx.seq_mirror[s] + n_steps, self.max_len)
        progress |= n_steps > 0
        # the SDC scrub, BEFORE harvest: a ripe slot forces one, so no
        # request retires with an unverified tail (harvest gating)
        if self.integrity is not None:
            self._scrub(ctx)
        # sync point: only the small done mask crosses to the host
        done = state.done.cpu().numpy()
        ripe = [s for s in decoding if done[s]]
        if ripe:
            progress = True
            n_gen = state.n_gen.cpu().numpy()
            seq_len = state.seq_len.cpu().numpy()
            out = state.out.cpu().numpy()
            ledger = {k: state.ledger[k].cpu().numpy() for k in TRAFFIC_KEYS}
            drafted, accepted = state.drafted.cpu().numpy(), state.accepted.cpu().numpy()
            for s in ripe:
                req = sched.retire(s)
                fin = self._build_finished(
                    req, out[s, : n_gen[s]].copy(), int(seq_len[s]),
                    {k: ledger[k][s] for k in TRAFFIC_KEYS},
                    self._attempt_prompt_len(req),
                    ctx.prefix_used[s], "finished", ctx.token_bytes,
                    drafted=int(drafted[s]), accepted=int(accepted[s]))
                ctx.finished.append(fin)
                ctx.stats.record_spec(fin)
                self._cancel_requested.discard(req.rid)
                ctx.prefix_used[s] = ctx.remaining[s] = ctx.seq_mirror[s] = 0
                # the slot's next tenant starts unverified (fault 5: the
                # reference keeps this count, so a rollback before the next
                # tenant's first scrub folds its unverified tokens)
                ctx.verified_len[s] = 0
                if self.paged:  # pages free when their last reader leaves
                    ctx.pool.decref(ctx.slot_pages[s])
                    ctx.slot_pages[s] = []
            state.allocated[torch.as_tensor(ripe, device=self.device)] = False
        # the hook sees the 0-based index of the iteration just completed
        if ctx.on_iteration is not None:
            ctx.on_iteration(ctx)
        ctx.stats.iterations += 1
        ctx.iteration += 1
        # time a hook spends (a chaos straggler's sleep) counts on purpose
        ctx.monitor.record(ctx.iteration - 1, time.perf_counter() - t0)
        ctx.stall = 0 if progress else ctx.stall + 1
        if ctx.stall >= _STALL_LIMIT and not sched.idle():
            head = min(sched.queue, key=lambda r: r.claim) if sched.queue else None
            raise PagePoolError(
                f"page pool exhausted and unreclaimable: {len(sched.queue)} queued (head "
                f"rid={getattr(head, 'rid', None)}), {ctx.pool.available() if ctx.pool else 0} "
                f"pages free of {ctx.pool.n_pages if ctx.pool else 0}; raise n_pages")
        return progress

    # ------------------------------------------------------------------
    # the SDC scrub: detect -> contain -> repair (serving/sdc.py)
    # ------------------------------------------------------------------
    def _scrub(self, ctx: _ServeCtx) -> None:
        """One scrub pass before harvest (reference: ``_scrub``):

        1. weights: the crc of every packed leaf (exact) and, with
           ``abft_probe``, the ABFT probe; a fault reloads the leaf from
           the golden copy, flushes the prefix tree, rolls every live slot
           back to its verified count and counts a strike
           (``max_weight_strikes`` make the engine ``unhealthy``);
        2. KV pages (when no weight fault was found): stamp newly full
           cold pages and verify the stamped ones; a mismatch quarantines
           the page for good, evicts it from the prefix tree and rolls its
           readers back;
        3. numerics: read the sentinel; a latched slot is contained
           (outcome ``"numerics"``) or raises ``NumericsError``.

        It runs every ``scrub_every`` iterations and whenever a decoding
        slot is ripe for harvest. Slots that come through clean advance
        ``verified_len`` to their emitted count, so a rollback target
        always comes from a scrub before any later fault."""
        ic = self.integrity
        done = ctx.state.done.cpu().numpy()
        ripe = any(done[s] for s in ctx.sched.active_slots() if s not in ctx.prefilling)
        if not (ripe or ctx.iteration - ctx.last_scrub >= ic.scrub_every):
            return
        ctx.last_scrub = ctx.iteration
        weight_hit = self._scrub_weights(ctx)
        if not weight_hit and self.paged:
            self._scrub_pages(ctx)
        self._check_numerics(ctx)
        # the surviving decoding slots advance their verified count
        n_gen = ctx.state.n_gen.cpu().numpy()
        for s in ctx.sched.active_slots():
            if s in ctx.prefilling or s in ctx.draft_prefilling:
                continue
            ctx.verified_len[s] = int(n_gen[s])

    def _scrub_weights(self, ctx: _ServeCtx) -> bool:
        """Detect and repair packed-weight corruption; True when a fault
        was found (the page scrub is then skipped: every page stamp was
        just dropped)."""
        bad = set(pack_lib.verify_packed(self.params))
        if self.integrity.abft_probe:
            bad |= set(sdc_lib.abft_verify_tree(self.params))
        if not bad:
            return False
        ctx.stats.sdc_detected += len(bad)
        for path in sorted(bad):
            gold = (self._golden or {}).get(path)
            if gold is None:
                continue  # an unrepairable leaf: the strike below still counts
            stack = sdc_lib.get_leaf(self.params, path)
            self.params = sdc_lib.set_leaf(self.params, path, pack_lib.LeafStack(tuple(
                dataclasses.replace(pw, packed=g.to(self.device))
                for pw, g in zip(stack.layers, gold))))
            self.weight_loads += 1
            ctx.stats.weight_reloads += 1
        self.weight_fault_strikes += 1
        if self.weight_fault_strikes >= self.integrity.max_weight_strikes:
            # repeated faults: a bad ROM bank, not a particle strike; the
            # router's health sweep drains and retires the replica
            self.unhealthy = True
        # containment: everything computed since the fault window opened
        # is suspect: cached prefixes, page stamps, unverified tails
        if ctx.ptree is not None:
            ctx.ptree.flush()
        ctx.page_crc.clear()
        for s in list(ctx.sched.active_slots()):
            self._preempt_slot(ctx, s, n_fold=ctx.verified_len[s])
        return True

    def _scrub_pages(self, ctx: _ServeCtx) -> None:
        """Detect and contain KV-page corruption: stamp newly full pages,
        verify the stamped ones, quarantine mismatches and roll their
        readers back. Only FULL cold pages behind each slot's frontier and
        the tree's pages are covered: they are append-frozen; the hot tier
        and the partial frontier page change legitimately and are covered
        by the numerics sentinel only."""
        pool, ptree = ctx.pool, ctx.ptree
        hc, ps = self.hot_cap, self._page_size
        seq_dev = ctx.state.seq_len.cpu().numpy()
        want = set(ptree.tree_pages()) if ptree is not None else set()
        for s in ctx.sched.active_slots():
            nf = max(0, int(seq_dev[s]) - hc) // ps
            want.update(ctx.slot_pages[s][:nf])
        # drop stamps whose page left the set or began a new life since
        for p in list(ctx.page_crc):
            if p not in want or ctx.page_crc[p][0] != int(pool.born[p]):
                del ctx.page_crc[p]
        check = sorted(ctx.page_crc)
        fresh = sorted(want - set(check))
        crcs = kv_cache.pool_page_crcs(ctx.state.cache, check + fresh)
        bad = [p for p in check if crcs[p] != ctx.page_crc[p][1]]
        for p in fresh:
            ctx.page_crc[p] = (int(pool.born[p]), crcs[p])
        ctx.stats.pages_scrubbed += len(check)
        if not bad:
            return
        ctx.stats.sdc_detected += len(bad)
        # quarantine FIRST, so the eviction's and the preemptions' decrefs
        # park the damaged pages instead of freeing them
        for p in bad:
            pool.quarantine(p)
            del ctx.page_crc[p]
        if ptree is not None:
            ptree.evict_pages(bad)
        bad_set = set(bad)
        for s in list(ctx.sched.active_slots()):
            if bad_set & set(ctx.slot_pages[s]):
                self._preempt_slot(ctx, s, n_fold=ctx.verified_len[s])

    def _check_numerics(self, ctx: _ServeCtx) -> None:
        """Read the sentinel and contain (or raise on) every latched slot:
        it ends with outcome ``"numerics"``, its partial output surfaced
        and never retried."""
        flagged = ctx.state.numerics_bad.cpu().numpy()
        for s in list(ctx.sched.active_slots()):
            if not flagged[s]:
                continue
            ctx.stats.sdc_detected += 1
            if self.integrity.on_numerics == "raise":
                req = ctx.sched.slot_req[s]
                raise sdc_lib.NumericsError(f"non-finite logits in slot {s} "
                                            f"(rid={getattr(req, 'rid', None)})", slot=s)
            # repair the transient plane before the slot's next tenant
            sdc_lib.clear_hot_slot(ctx, s)
            self._cancel_slot(ctx, s, "numerics")
            ctx.stats.slots_quarantined += 1

    def _refresh_mirrors(self, ctx: _ServeCtx, decoding: List[int]) -> None:
        """After speculative rounds (which emit a data-dependent 1..K tokens
        each), read each decoding slot's budget and length back from the
        device (one sync per iteration) and return the pages its rollback
        stranded past its length (reference: run_iteration's spec branch).
        A returned page's table entry goes back to 0 on the host; the
        device may keep the stale entry, which is safe: a later round
        writes there only after ``_ensure_pages`` funds the page again and
        installs the table."""
        n_gen = ctx.state.n_gen.cpu().numpy()
        seq = ctx.state.seq_len.cpu().numpy()
        for s in decoding:
            req = ctx.sched.slot_req[s]
            if req is None:
                continue
            ctx.remaining[s] = max(int(req.max_new_tokens) - int(n_gen[s]), 0)
            ctx.seq_mirror[s] = int(seq[s])
            if not self.paged or not ctx.slot_pages[s]:
                continue
            keep = pages_needed(ctx.seq_mirror[s], self.hot_cap, self._page_size)
            extra = ctx.slot_pages[s][keep:]
            if extra:
                ctx.pool.decref(extra)
                del ctx.slot_pages[s][keep:]
                ctx.host_table[s, keep:] = 0

    def finish_session(self, ctx: _ServeCtx) -> List[FinishedRequest]:
        """Seal a session: summarize its iteration times into its
        ``ServeStats``, publish them as ``last_stats`` and return its
        terminal records."""
        if ctx.monitor.times:
            ctx.stats.iter_p50 = float(np.median(ctx.monitor.times))
            ctx.stats.iter_max = float(max(ctx.monitor.times))
            ctx.stats.straggler_flags = len(ctx.monitor.flagged)
        self.last_stats = ctx.stats
        return ctx.finished

    def serve(self, requests: Sequence[Request], slots: Optional[int] = None,
              stop_token: Optional[int] = None, sync_every: Optional[int] = None,
              max_queue: Optional[int] = None,
              on_iteration: Optional[Callable[[_ServeCtx], None]] = None
              ) -> List[FinishedRequest]:
        """Serve ``requests`` through continuous batching: one terminal
        ``FinishedRequest`` per request, in completion order, its
        ``outcome`` telling completion from cancellation, expiry and
        shedding. Under paged serving page pressure degrades (eviction,
        then preemption with recompute-from-prefix) instead of failing;
        ``max_queue`` bounds the admission queue and ``on_iteration(ctx)``
        runs after every loop iteration. With a ``PreemptionGuard``
        attached, a raised flag drains the session after the current
        iteration: the evacuated requests go to ``last_drained`` and get no
        terminal record from this call."""
        ctx = self.start_session(requests, slots=slots, stop_token=stop_token,
                                 sync_every=sync_every, max_queue=max_queue,
                                 on_iteration=on_iteration)
        self.last_drained = None
        while not ctx.sched.idle():
            self.run_iteration(ctx)
            if self.guard is not None and self.guard.requested:
                self.last_drained, _ = self.drain_session(ctx)
                self.guard.requested = False  # consumed: drained once
                break
        return self.finish_session(ctx)

    # ------------------------------------------------------------------
    # session evacuation: drain (cooperative) / abandon (after a crash),
    # and the warm-migration handoff
    # ------------------------------------------------------------------
    @torch.inference_mode()
    def drain_session(self, ctx: _ServeCtx, with_handoffs: bool = False):
        """Evacuate a live session (reference: ``drain_session``): every
        active slot is preempted through the fold (emitted tokens join the
        prompt, ``orig_prompt_len`` marks the seam, pages decref), then the
        queue is emptied. Returns ``(drained, handoffs)``: the evacuated
        requests in claim order, which continue bit for bit wherever they
        are resubmitted, and, with ``with_handoffs`` on a paged engine,
        each decoding slot's rows serialized BEFORE the fold, by rid. A
        slot still prefilling (its target or draft cache) ships none and
        migrates cold."""
        handoffs: Dict[int, bytes] = {}
        for s in list(ctx.sched.active_slots()):
            req = ctx.sched.slot_req[s]
            if (with_handoffs and self.paged and s not in ctx.prefilling
                    and s not in ctx.draft_prefilling):
                handoffs[req.rid] = self.export_slot(ctx, s)
            self._preempt_slot(ctx, s)
        drained = sorted(ctx.sched.queue, key=lambda r: r.claim)
        ctx.sched.queue.clear()
        ctx.drained = drained
        return drained, handoffs

    def abandon_session(self, ctx: _ServeCtx) -> List[Request]:
        """Tear down a DEAD session on the host (reference:
        ``abandon_session``): release every slot's pages and the queue and
        return the orphaned requests in claim order, active slots first.
        No device work and no fold: a dead device has no tokens to give,
        so the emitted ones come from the router's journal. The pool then
        holds the tree's references only, and the scheduler is idle."""
        orphans: List[Request] = []
        for s in list(ctx.sched.active_slots()):
            req = ctx.sched.retire(s)
            ctx.prefilling.pop(s, None)
            ctx.draft_prefilling.pop(s, None)
            if ctx.slot_pages[s]:
                ctx.pool.decref(ctx.slot_pages[s])
                ctx.slot_pages[s] = []
            ctx.prefix_used[s] = ctx.remaining[s] = ctx.seq_mirror[s] = 0
            orphans.append(req)
        orphans.sort(key=lambda r: r.claim)
        orphans += sorted(ctx.sched.queue, key=lambda r: r.claim)
        ctx.sched.queue.clear()
        return orphans

    def export_slot(self, ctx: _ServeCtx, s: int) -> bytes:
        """Slot ``s``'s rows across every cache stack as one checksummed
        payload (reference: ``export_slot``), in the tier storage dtype."""
        states = {k: kv_cache.export_slot_state(c, s) for k, c in ctx.state.cache.items()}
        return kv_cache.pack_slot_state(states, self._page_size if self.paged
                                        else DEFAULT_PAGE_SIZE)

    @torch.inference_mode()
    def import_handoff(self, ctx: _ServeCtx, tokens, blob: bytes) -> int:
        """The receiving side of warm migration (reference:
        ``import_handoff``): verify and unpack a payload and seed this
        session's prefix tree with it, so the resubmitted request's prefix
        match skips the seeded rows. Returns the prompt tokens seeded (0:
        nothing usable; the request then runs cold, which is always right).

        The hot tier and every FULL cold page are adopted: the cold rows
        are written into freshly allocated pool pages, which the tree's
        ``insert`` adopts by id, and the hot rows into the tree's snapshot
        pages in the ``save_hot`` layout. The partial last page is not
        seeded: the match is capped at ``len(tokens) - 1`` anyway, and the
        chunked prefill recomputes the tail bit for bit. Raises
        ``HandoffError`` on a payload that fails verification; the caller
        falls back to cold."""
        if not (self.paged and self.prefix_sharing and ctx.ptree):
            return 0
        states = kv_cache.unpack_slot_state(blob)
        if set(states) != set(ctx.state.cache):
            raise kv_cache.HandoffError(f"handoff cache keys {sorted(states)} do not match this "
                                        f"engine's {sorted(ctx.state.cache)}")
        toks = np.asarray(tokens, np.int32)
        hc, ps = self.hot_cap, self._page_size
        length = min(st["length"] for st in states.values())
        if length < len(toks):
            raise kv_cache.HandoffError(f"handoff covers {length} tokens but the folded request "
                                        f"carries {len(toks)}: torn capture")
        if len(toks) <= hc:
            return 0  # nothing past the hot tier: a cold re-prefill is cheap
        kf = (len(toks) - hc) // ps  # full cold pages only
        ctx.ptree.evict_for(kf)
        pages = ctx.pool.alloc(kf) if kf else []
        if pages is None:
            return 0  # the pool cannot host the handoff: go cold

        def as_pages(rows, n):
            """Host rows (layers, r <= n * ps, ...) as n zero-padded pages."""
            return kv_cache.pad_rows(rows, n * ps).reshape((rows.shape[0], n, ps)
                                                           + tuple(rows.shape[2:]))

        for key, st in states.items():
            if kf:
                kv_cache.write_pool_pages(ctx.state.cache[key], pages,
                                          *(as_pages(st[n][:, : kf * ps], kf)
                                            for n in ("cold_k", "cold_v")))

        def save(ids):
            # hot row i -> row i % ps of page ids[i // ps], the save_hot
            # layout, so an admission restores it as a local snapshot
            for key, st in states.items():
                kv_cache.write_pool_pages(ctx.state.cache[key], ids,
                                          *(as_pages(st[n], len(ids)) for n in ("hot_k", "hot_v")))

        ok = ctx.ptree.insert(toks, np.asarray(pages, np.int32), save)
        # the tree holds its own references on what it adopted; the
        # allocation's retire either way (a refused or duplicate insert
        # frees the pages here)
        if pages:
            ctx.pool.decref(pages)
        return hc + kf * ps if ok else 0

    def generate(self, prompts, max_new_tokens: int = 32, patches=None,
                 stop_token: Optional[int] = None) -> GenerationResult:
        """Aligned-batch generation: one slot per prompt row, admitted by one
        prefill (or, with ``prefill_chunk``, by chunk waves); ``patches``
        (b, n_patches, frontend_dim): each row's image features, for a
        vision model."""
        t0 = time.perf_counter()
        prompts_np = np.asarray(torch.as_tensor(prompts).cpu(), np.int32)
        patches_np = None if patches is None else np.asarray(torch.as_tensor(patches).cpu())
        reqs = [Request(rid=i, tokens=prompts_np[i], max_new_tokens=max_new_tokens,
                        patches=None if patches_np is None else patches_np[i])
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
