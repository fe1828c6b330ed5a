"""Refcounted page pool + radix prefix tree for paged KV serving
(reference: ``repro/serving/paging.py``; numpy only, the port's own copy).

Host-side control plane of the paged cold tier
(``core/kv_cache.PagedKVCache``): the pool tracks which physical pages
are free and how many readers each live page has; the tree maps token
prefixes to the pages that already hold their KV rows, so admission can
skip prefilling a shared prefix.

Layout of a cached prefix (page_size = ps, hot_cap = hc):

  * the root's children are keyed by the FULL first ``hc`` tokens of a
    prompt; such a *hot node* owns ``ceil(hc / ps)`` snapshot pages that
    hold a copy of a slot's hot tier (the hot tier is per-slot memory, so
    sharing it means snapshotting it into the pool and copying it back at
    admission: ``kv_cache.save_hot`` / ``kv_cache.paged_admit``);
  * deeper nodes are keyed by ``ps``-token runs and own one cold page
    each; a slot that matches maps those pages in its page table (no
    copy: this is the sharing);
  * a partially matched boundary page is adopted copy-on-write: the
    engine allocates a fresh page, ``paged_admit`` copies the source page
    into it, and the slot appends its own tokens after the matched rows.

Refcounts (``PagePool``): a page's count is its number of readers, the
tree counting as one and every slot whose page table maps the page as
one. ``insert`` increfs the pages it adopts from a slot; the engine
increfs shared pages when a slot adopts them and decrefs the slot's page
list when it retires. Counts never go negative (``PagePoolError``) and a
page returns to the free list exactly when its last reader drops it.
Eviction is leaf-only LRU over pages only the tree holds (refcount 1), so
it never frees a page a slot still reads.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


def pages_needed(length: int, hot_cap: int, page_size: int) -> int:
    """Cold pages a slot of ``length`` tokens occupies: the hot tier
    absorbs the first ``hot_cap`` rows, the rest rounds up to whole
    pages. Admission, decode growth and request validation all size
    with this one definition."""
    return -(-max(length - hot_cap, 0) // page_size)


class PagePoolError(RuntimeError):
    """Refcount-protocol violation (or an unservable allocation): carries
    the page id and its count so the report survives ``python -O`` and
    points at the page, not just the call site."""

    def __init__(self, msg: str, page: Optional[int] = None,
                 refcount: Optional[int] = None):
        if page is not None:
            msg = f"{msg} (page={page}, refcount={refcount})"
        super().__init__(msg)
        self.page = page
        self.refcount = refcount


class PagePool:
    """Free list + per-page reader counts for the physical page pool.

    Quarantine: a page retired for good (the SDC scrub retires pages
    whose bytes were found corrupted, ``Engine._scrub_pages``) —
    ``quarantine`` pulls it off the free list (or marks
    it so the next ``decref`` to zero doesn't return it), and ``alloc``
    never hands it out again. The pool is then free ∪ referenced ∪
    quarantined, pairwise disjoint."""

    def __init__(self, n_pages: int):
        self.n_pages = n_pages
        self.refs = np.zeros(n_pages, np.int32)
        self._free: List[int] = list(range(n_pages - 1, -1, -1))
        self.quarantined: set = set()
        # per-page birth counter, bumped on every alloc: a (page, born)
        # pair names one life of a physical page (the reference's scrub
        # keys its page stamps on it)
        self.born = np.zeros(n_pages, np.int64)
        self._alloc_seq = 0

    def available(self) -> int:
        return len(self._free)

    def used(self) -> int:
        return self.n_pages - len(self._free) - len(self.quarantined)

    def quarantine(self, page: int) -> None:
        """Retire ``page`` for good. Legal on a free page (removed from
        the free list immediately) or a referenced one (readers drain
        normally; the final decref parks it instead of freeing it)."""
        p = int(page)
        if p in self.quarantined:
            return
        self.quarantined.add(p)
        if self.refs[p] == 0:
            self._free.remove(p)

    def alloc(self, n: int) -> Optional[List[int]]:
        """Take ``n`` free pages (each born with one reader); None if the
        free list is short — the caller evicts (PrefixCache) and retries."""
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self.refs[p] = 1
            self._alloc_seq += 1
            self.born[p] = self._alloc_seq
        return pages

    def incref(self, pages: Sequence[int]) -> None:
        for p in pages:
            if self.refs[p] <= 0:
                raise PagePoolError(
                    "incref on free page", page=int(p),
                    refcount=int(self.refs[p]))
            self.refs[p] += 1

    def decref(self, pages: Sequence[int]) -> None:
        """Drop one reader per page; a page frees exactly when its count
        hits zero — unless it is quarantined, in which case it parks
        (never reallocated). Counts never go negative (PagePoolError)."""
        for p in pages:
            if self.refs[p] <= 0:
                raise PagePoolError(
                    "decref on free page", page=int(p),
                    refcount=int(self.refs[p]))
            self.refs[p] -= 1
            if self.refs[p] == 0 and int(p) not in self.quarantined:
                self._free.append(int(p))


@dataclasses.dataclass
class PrefixMatch:
    """Result of matching a prompt against the tree (all page ids are
    pool indices; ``length`` counts matched *tokens*, capped at
    prompt_len - 1 so at least one novel token remains to produce the
    first-sample logits)."""

    length: int = 0  # matched tokens M (0 = miss)
    hot_pages: Tuple[int, ...] = ()  # snapshot pages for the hot restore
    shared_pages: Tuple[int, ...] = ()  # fully matched cold pages, in order
    cow_src: int = -1  # partially matched boundary page (-1 = none)
    cow_len: int = 0  # matched rows r within the boundary page


class _Node:
    __slots__ = ("key", "pages", "children", "parent", "last_use")

    def __init__(self, key, pages, parent):
        self.key = key  # token tuple (hot node: hc tokens; else ps)
        self.pages = list(pages)
        self.children: Dict[tuple, "_Node"] = {}
        self.parent = parent
        self.last_use = 0


class PrefixCache:
    """Radix tree over prompt prefixes at page granularity."""

    def __init__(self, pool: PagePool, hot_cap: int, page_size: int):
        self.pool = pool
        self.hot_cap = hot_cap
        self.page_size = page_size
        self.n_hot_pages = -(-hot_cap // page_size) if hot_cap else 0
        self._root = _Node((), (), None)
        self._clock = 0

    # -- bookkeeping ----------------------------------------------------
    def _touch(self, node: _Node) -> None:
        self._clock += 1
        node.last_use = self._clock

    def _nodes(self) -> List[_Node]:
        out, stack = [], [self._root]
        while stack:
            n = stack.pop()
            out.extend(n.children.values())
            stack.extend(n.children.values())
        return out

    def tree_pages(self) -> List[int]:
        """All pages currently held by the tree (refcount view helper)."""
        return [p for n in self._nodes() for p in n.pages]

    # -- matching -------------------------------------------------------
    def match(self, tokens: np.ndarray) -> PrefixMatch:
        """Longest cached prefix of ``tokens``. Never matches the whole
        prompt (cap at len - 1): the last token must be prefilled so its
        logits exist to sample the first generated token from."""
        toks = np.asarray(tokens).reshape(-1)
        lim = len(toks) - 1
        hc, ps = self.hot_cap, self.page_size
        if lim < 1 or len(toks) < hc or hc == 0:
            return PrefixMatch()
        node = self._root.children.get(tuple(int(t) for t in toks[:hc]))
        if node is None:
            return PrefixMatch()
        self._touch(node)
        m = PrefixMatch(length=min(hc, lim), hot_pages=tuple(node.pages))
        shared: List[int] = []
        k = 0
        while m.length < lim:
            page_toks = tuple(
                int(t) for t in toks[hc + k * ps : hc + (k + 1) * ps])
            child = (node.children.get(page_toks)
                     if len(page_toks) == ps else None)
            if child is not None and hc + (k + 1) * ps <= lim:
                shared.append(child.pages[0])
                node = child
                self._touch(node)
                m = dataclasses.replace(
                    m, length=hc + (k + 1) * ps,
                    shared_pages=tuple(shared))
                k += 1
                continue
            # boundary: the longest common prefix of any child's page
            best_r, best = 0, None
            for key, c in node.children.items():
                r = 0
                for a, b in zip(key, page_toks):
                    if a != b:
                        break
                    r += 1
                if r > best_r:
                    best_r, best = r, c
            r = min(best_r, lim - m.length)
            if r > 0 and best is not None:
                self._touch(best)
                m = dataclasses.replace(
                    m, length=m.length + r, cow_src=best.pages[0],
                    cow_len=r)
            break
        return m

    # -- insertion ------------------------------------------------------
    def insert(
        self,
        tokens: np.ndarray,
        slot_pages: Sequence[int],
        save_hot: Callable[[Sequence[int]], None],
    ) -> bool:
        """Record a fully prefilled prompt. ``slot_pages[k]`` is the pool
        page holding the slot's cold positions [hc + k*ps, hc + (k+1)*ps);
        only pages the prompt covers COMPLETELY are inserted (the tail
        partial page stays slot-private). Adopted slot pages are increfed
        (the tree becomes a second reader — the "one physical copy");
        runs already present are deduped, keeping the tree's copy. A
        missing hot node is created by snapshotting the slot's hot tier
        into freshly allocated pages via the ``save_hot`` callback (the
        engine's jitted ``kv_cache.save_hot`` dispatch). Best-effort:
        returns False without modifying anything when the pool cannot
        fund the snapshot."""
        toks = np.asarray(tokens).reshape(-1)
        hc, ps = self.hot_cap, self.page_size
        if hc == 0 or len(toks) < hc:
            return False
        hot_key = tuple(int(t) for t in toks[:hc])
        node = self._root.children.get(hot_key)
        if node is None:
            ids = self._alloc(self.n_hot_pages)
            if ids is None:
                return False
            save_hot(ids)
            node = _Node(hot_key, ids, self._root)
            self._root.children[hot_key] = node
        self._touch(node)
        k_full = (len(toks) - hc) // ps
        for k in range(k_full):
            key = tuple(int(t) for t in toks[hc + k * ps : hc + (k + 1) * ps])
            child = node.children.get(key)
            if child is None:
                child = _Node(key, (slot_pages[k],), node)
                self.pool.incref(child.pages)
                node.children[key] = child
            node = child
            self._touch(node)
        return True

    # -- allocation / eviction -----------------------------------------
    def _alloc(self, n: int) -> Optional[List[int]]:
        if not self.evict_for(n):
            return None
        return self.pool.alloc(n)

    def evict_pages(self, pages: Sequence[int]) -> int:
        """Force-evict every node referencing any of ``pages`` AND its
        whole subtree (descendants extend a prefix that ran through the
        damaged page — their cached rows are downstream of the fault and
        must not be served). The tree's reader refs drop; the caller
        quarantines the damaged pages themselves. Returns the number of
        nodes removed."""
        bad = {int(p) for p in pages}
        victims = []
        stack = list(self._root.children.values())
        while stack:
            node = stack.pop()
            if any(int(p) in bad for p in node.pages):
                victims.append(node)  # highest damaged node wins the cut
            else:
                stack.extend(node.children.values())
        removed = 0
        for v in victims:
            sub = [v]
            while sub:
                node = sub.pop()
                self.pool.decref(node.pages)
                removed += 1
                sub.extend(node.children.values())
            v.parent.children.pop(v.key, None)
        return removed

    def flush(self) -> int:
        """Drop the ENTIRE tree, decrefing every tree-held page: the
        weight-fault response — every cached row was computed by a
        possibly-corrupted matmul, so nothing in the tree can be trusted
        after a weight reload. Returns the number of nodes removed."""
        removed = 0
        for node in self._nodes():
            self.pool.decref(node.pages)
            removed += 1
        self._root.children.clear()
        return removed

    def evict_for(self, n: int) -> bool:
        """Peel LRU childless nodes whose pages have no reader but the
        tree until ``n`` pages are free. Pages a live slot still maps
        (refcount >= 2) are never touched."""
        while self.pool.available() < n:
            victim = None
            for cand in self._nodes():
                if cand.children:
                    continue
                if any(self.pool.refs[p] != 1 for p in cand.pages):
                    continue
                if victim is None or cand.last_use < victim.last_use:
                    victim = cand
            if victim is None:
                return False
            self.pool.decref(victim.pages)
            victim.parent.children.pop(victim.key)
        return True
