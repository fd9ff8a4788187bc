"""Serving engine: calibration, prefill/decode, continuous batching.

The torch port of the single-device path of ``repro/serving/engine.py``:

  1. CALIBRATE - a short prefill with the uncompressed policy collects raw
     K/V and picks static TierSpecs (``core.cache.calibrate_specs``).
  2. SERVE - ``SlotServer`` runs a continuous-batching scheduler over a
     fixed table of ``max_batch`` slots. Each request owns one row of the
     decode cache (per-row ``n_comp``/``n_resid``), is admitted at its
     true prompt length, and its row is recycled the moment it finishes
     while the other rows keep decoding.

Admission is CHUNK-INTERLEAVED by default (``prefill_chunk_pages = 1``):
each scheduler step advances the pending admission by at most
``prefill_chunk_pages`` pages' worth of prompt and runs a decode launch
in the same step, so no occupied slot waits longer than one bounded
chunk; 0 is the monolithic prefill-insert. PAGED engines
(``EngineConfig.paged``) keep the compressed region in a shared page pool
and admit on free pages: each request reserves its worst-case page count
and admission blocks, in FIFO order, while reservations plus the
watermark would overflow the pool, so the device's free stack never
over-pops.

Invariants the scheduler keeps (as the reference's):
  * the host-side token counts (``_Active.cached_tokens``) upper-bound
    the device counters, so buckets and reservations need no device read;
  * paged: reserved pages never exceed ``pool_pages - page_watermark``;
  * a retired slot's pages are back in the pool before the next admission.

PREFIX-CACHE engines (``EngineConfig.prefix_cache``, paged only) keep a
host-side index of the full compressed pages of admitted prompts
(``PrefixIndex``): an admission whose prompt starts with indexed pages
maps them into its slot by reference, reserves and computes only its
suffix, and gives the same bytes and tokens as a cold admission. Cold
index pages are evicted (LRU leaves) before admission would block.

SPECULATIVE engines (``EngineConfig.spec_decode``) draft up to
``spec_k`` tokens a row from the row's own sequence (``NGramDrafter``) and
verify them in one pass over a window of ``spec_k + 1`` positions
(``models.transformer.verify_steps``); the accepted prefix plus the
model's next token are emitted, so outputs equal plain decode's bit for
bit. Every engine, speculative or not, runs its decode GEMMs at the
window's height (``decode_step``'s ``rows``): on the GPU a product's row
sums in another order at another row count, so the two paths must issue
the same shapes.

Preemption, sessions, fault plans and meshes are not ported yet
(ROADMAP.md); where the reference consults them, this engine takes the
branch the reference takes when they are off.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..core.cache import (
    PackKVConfig,
    acquire_pages,
    bucket_length,
    calibrate_specs,
    release_pages,
)
from ..distributed.fault import StragglerMonitor
from ..models import get_model
from ..utils import cdiv


@dataclasses.dataclass
class EngineConfig:
    capacity: int = 4096  # compressed-region token capacity
    max_batch: int = 8  # slot-table size
    backend: str = "fused"  # fused (the CUDA kernels; plain versions on CPU) | ref
    calibrate: bool = True
    calib_tokens: int = 192  # multiple of the 64-token block
    bucketed: bool = True  # read only a live-length bucket of the cache
    bucket_unit: int = 256  # smallest bucket; power-of-two multiples
    decode_chunk: int = 8  # decode steps per multi-step launch (1 = per token)
    prefill_chunk_pages: int = 1  # admission chunk budget in pages of
    #   ``page_size`` tokens per scheduler step (dense engines use the same
    #   token unit); 0 = monolithic prefill-insert
    # speculative decode:
    spec_decode: bool = False  # n-gram drafts verified in one pass a launch
    spec_k: int = 4  # most drafts a verify pass (window spec_k + 1); every
    #   engine's decode GEMMs run at the window's height, spec on or off
    spec_backoff: int = 32  # most scheduler steps a slot waits to draft
    #   again after fully rejected passes (doubling 1, 2, ...; 0 = never)
    paged: bool = False  # page-pool storage + page-reservation admission
    page_size: int = 256  # tokens per page (power of two, >= block)
    pool_pages: int | None = None  # pages in the pool; None = max_batch *
    #   capacity / page_size (no oversubscription)
    page_watermark: int = 0  # spare pages admission always holds back
    # shared-prefix page cache (paged storage only):
    prefix_cache: bool = False  # reuse indexed prompt pages across requests
    prefix_cache_pages: int | None = None  # most pages the index may pin
    debug_invariants: bool = False  # check refcount conservation after every
    #   admit/retire (a device read per check: tests and bring-up only)
    device: str = "cuda"


class Engine:
    def __init__(self, cfg: ArchConfig, params: dict, pack_cfg: PackKVConfig,
                 ecfg: EngineConfig):
        if ecfg.backend not in ("fused", "ref"):
            raise ValueError(f"backend {ecfg.backend!r}: 'fused' or 'ref'")
        # full-precision f32 matmuls and convolutions (no TF32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.cfg = cfg
        self.params = params
        self.ecfg = ecfg
        self.device = torch.device(ecfg.device)
        self.api = get_model(cfg)
        if ecfg.prefix_cache:
            if self.api.prefill_prefix is None:
                raise ValueError(f"family {cfg.family!r} cannot serve "
                                 "--prefix-cache: it has no KV pages to share")
            if not ecfg.paged:
                raise ValueError("--prefix-cache requires --paged: shared "
                                 "prefixes live in the refcounted page pool")
            if cfg.window:
                raise ValueError(
                    "--prefix-cache does not support sliding-window attention "
                    f"(window={cfg.window}): evicted window tokens break "
                    "page-aligned prefix identity")
        if ecfg.spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {ecfg.spec_k}")
        if ecfg.spec_decode:
            if self.api.decode_verify is None:
                raise ValueError(f"family {cfg.family!r} cannot serve "
                                 "--spec-decode: it has no verify pass")
            if ecfg.spec_k < 1:
                raise ValueError(f"spec_k must be >= 1, got {ecfg.spec_k}")
        if ecfg.paged:
            if not self.api.supports_paged:
                raise ValueError(f"family {cfg.family!r} cannot serve paged: "
                                 "its decode state is not page-addressable")
            if ecfg.capacity % ecfg.page_size:
                raise ValueError(f"capacity {ecfg.capacity} not a multiple of "
                                 f"page_size {ecfg.page_size}")
            pool_pages = (ecfg.pool_pages if ecfg.pool_pages is not None
                          else ecfg.max_batch * ecfg.capacity // ecfg.page_size)
            pack_cfg = dataclasses.replace(pack_cfg, paged=True,
                                           page_size=ecfg.page_size,
                                           pool_pages=pool_pages)
        self.pack_cfg = (self._calibrate(pack_cfg)
                         if ecfg.calibrate and pack_cfg.policy == "packkv"
                         else pack_cfg)

    # -- calibration --------------------------------------------------------
    def _calibrate(self, pack_cfg: PackKVConfig) -> PackKVConfig:
        S = self.ecfg.calib_tokens
        rng = np.random.default_rng(0)
        tokens = torch.as_tensor(rng.integers(0, self.cfg.vocab, (1, S)),
                                 dtype=torch.int32, device=self.device)
        # calibration reads raw K/V from a dense layout
        none_cfg = dataclasses.replace(pack_cfg, policy="none", paged=False)
        blk = pack_cfg.block
        cap = -(-max(S, blk) // blk) * blk
        _, cache = self.api.prefill(self.params, self.cfg, none_cfg, cap,
                                    {"tokens": tokens})
        n = int(min(int(c.n_comp.min()) for c in cache))
        n = (n // blk) * blk
        if n == 0:
            return pack_cfg
        k = torch.cat([c.raw_k[:, :, :n] for c in cache])  # [L*B, H, n, D]
        v = torch.cat([c.raw_v[:, :, :n] for c in cache])
        return calibrate_specs(k, v, pack_cfg)

    # -- serving ------------------------------------------------------------
    def _tokens(self, tokens) -> torch.Tensor:
        if not isinstance(tokens, torch.Tensor):
            tokens = torch.from_numpy(np.asarray(tokens))
        return tokens.to(device=self.device, dtype=torch.int32)

    def prefill(self, batch: dict):
        return self.api.prefill(self.params, self.cfg, self.pack_cfg,
                                self.ecfg.capacity,
                                {"tokens": self._tokens(batch["tokens"])})

    @property
    def rows(self) -> int:
        """Positions a batch row of every decode GEMM: the verify window."""
        return self.ecfg.spec_k + 1

    def decode(self, cache, token, n_bucket: int | None = None):
        return self.api.decode_step(self.params, self.cfg, cache,
                                    self._tokens(token),
                                    backend=self.ecfg.backend, n_bucket=n_bucket,
                                    rows=self.rows)

    def decode_chunk(self, cache, token, active, n_steps: int,
                     eos_id: int | None, n_bucket: int | None = None):
        """Multi-step decode (``models.transformer.decode_steps``); the
        cache is updated in place. Returns (tokens np [t_max, B], n_exec,
        cache)."""
        toks, n_exec, cache = self.api.decode_multi(
            self.params, self.cfg, cache, self._tokens(token),
            torch.as_tensor(np.asarray(active, bool), device=self.device),
            n_steps, -1 if eos_id is None else eos_id,
            t_max=self.ecfg.decode_chunk, backend=self.ecfg.backend,
            n_bucket=n_bucket, rows=self.rows)
        return toks.cpu().numpy(), n_exec, cache

    def decode_verify(self, cache, tokens, lens, active,
                      n_bucket: int | None = None):
        """One speculative verify pass (``models.transformer.verify_steps``).
        tokens: [B, w] seed + drafts, junk-padded; lens: [B] valid window
        lengths; active: bool [B] occupied rows. The cache comes back with
        the accepted prefixes committed and free rows re-zeroed. Returns
        (hat np [B, w], n_accept np [B], cache): one host read."""
        hat, n_accept, cache = self.api.decode_verify(
            self.params, self.cfg, cache, self._tokens(tokens),
            self._tokens(lens),
            torch.as_tensor(np.asarray(active, bool), device=self.device),
            backend=self.ecfg.backend, n_bucket=n_bucket)
        both = torch.cat([hat, n_accept[:, None]], dim=1).cpu().numpy()
        return both[:, :-1], both[:, -1], cache

    def bucket_for(self, n_max: int) -> int | None:
        """Launch bucket covering ``n_max`` compressed tokens (None = full).
        Paged engines raise the unit to the page size, so every bucket is
        a whole number of pages."""
        if not self.ecfg.bucketed:
            return None
        unit = self.ecfg.bucket_unit
        if self.ecfg.paged:
            unit = max(unit, self.ecfg.page_size)
        return bucket_length(n_max, self.ecfg.capacity, unit)

    def alloc_slot_cache(self):
        """Slot-table decode cache: max_batch rows, per-row counters."""
        return self.api.alloc_cache(self.cfg, self.pack_cfg, self.ecfg.max_batch,
                                    self.ecfg.capacity, self.device)

    def insert_request(self, cache, slot: int, tokens):
        """Single-slot prefill-insert; returns (last logits [V], cache)."""
        logits, cache = self.api.prefill_into_slot(
            self.params, self.cfg, self.pack_cfg, self.ecfg.capacity, cache,
            slot, {"tokens": self._tokens(tokens)[None]})
        return logits[0], cache

    # -- chunked admission --------------------------------------------------
    def chunk_tokens(self) -> int:
        """Admission chunk budget in tokens (page-aligned)."""
        return self.ecfg.prefill_chunk_pages * self.ecfg.page_size

    def chunk_init(self, prompt_len: int) -> dict:
        """Fresh admission scratch for a ``prompt_len``-token prompt."""
        return self.api.prefill_chunk_init(self.cfg, self.pack_cfg,
                                           self.ecfg.capacity,
                                           prompt_len=prompt_len,
                                           device=self.device)

    def chunk_step(self, scratch: dict, tokens, n_ctx: int):
        """One bounded prefill chunk at absolute offset ``n_ctx``, its
        GEMMs over a full chunk's height (``prefill_chunk``'s ``rows``).
        Returns (last-token logits [V], scratch); only the final chunk's
        logits are meaningful."""
        logits, scratch = self.api.prefill_chunk(
            self.params, self.cfg, self.pack_cfg, scratch,
            self._tokens(tokens)[None], n_ctx=n_ctx,
            rows=max(1, self.ecfg.prefill_chunk_pages) * self.ecfg.page_size)
        return logits[0], scratch

    def chunk_insert(self, cache, slot: int, scratch: dict):
        """Finish a chunked admission: compress the prompt and write row
        ``slot``."""
        return self.api.prefill_chunk_insert(self.cfg, self.pack_cfg,
                                             self.ecfg.capacity, cache, slot,
                                             scratch)

    def chunk_final(self, cache, slot: int, scratch: dict, tokens, n_ctx: int):
        """The last chunk and the row insert. Returns (last-token logits
        [V], cache)."""
        logits, scratch = self.chunk_step(scratch, tokens, n_ctx)
        return logits, self.chunk_insert(cache, slot, scratch)

    # -- prefix-cache admission ---------------------------------------------
    def _page_ids(self, pages) -> torch.Tensor:
        """Host page ids as an int32 device tensor."""
        return torch.as_tensor(np.asarray(pages, np.int64), dtype=torch.int32,
                               device=self.device)

    def insert_request_prefix(self, cache, slot: int, tokens, pages, perms):
        """Prefix-cache admission in one call: ``pages`` are the physical
        ids of the matched page-aligned prompt prefix (empty for a cold
        admission), ``perms`` the index entry's (k_perm, v_perm) or None.
        Returns (last logits [V], cache)."""
        logits, cache = self.api.prefill_prefix(
            self.params, self.cfg, self.pack_cfg, self.ecfg.capacity, cache,
            slot, {"tokens": self._tokens(tokens)[None]}, self._page_ids(pages),
            *(perms or (None, None)), n_prefix=len(pages) * self.ecfg.page_size)
        return logits[0], cache

    def prefix_chunk_bounds(self, prompt_len: int, n_matched_pages: int):
        """Segment bounds of an interleaved prefix-cache admission."""
        return self.api.prefix_chunk_bounds(
            self.pack_cfg, prompt_len, n_matched_pages * self.ecfg.page_size)

    def prefix_chunk_start(self, cache, prompt_len: int, pages, perms):
        """The admission's mini-cache, seeded with the matched pages."""
        return self.api.prefix_chunk_init(
            self.cfg, self.pack_cfg, self.ecfg.capacity, cache, self._page_ids(pages),
            *(perms or (None, None)), n_prefix=len(pages) * self.ecfg.page_size,
            prompt_len=prompt_len, device=self.device)

    def prefix_chunk_step(self, mini, tokens, n_ctx: int):
        """One page-aligned segment. Returns (last-token logits [V], mini)."""
        logits, mini = self.api.prefix_chunk(
            self.params, self.cfg, self.pack_cfg, mini,
            self._tokens(tokens)[None], n_ctx=n_ctx)
        return logits[0], mini

    def prefix_chunk_finish(self, cache, slot: int, mini, pages, prompt_len: int):
        """Write the finished mini-cache into row ``slot``: matched pages by
        reference, the rest into fresh pages."""
        return self.api.prefix_chunk_insert(
            self.pack_cfg, cache, slot, mini, self._page_ids(pages),
            n_prefix=len(pages) * self.ecfg.page_size, prompt_len=prompt_len)

    def index_acquire(self, cache, ids):
        """Pin pages for the prefix index (+1 reference each)."""
        return acquire_pages(cache, self._page_ids(ids))

    def index_release(self, cache, ids):
        """Unpin evicted index pages (-1 reference; freed at zero)."""
        return release_pages(cache, self._page_ids(ids))

    def free_slot(self, cache, slot: int):
        return self.api.reset_slot(cache, slot)

    def mask_free(self, cache, active):
        return self.api.mask_free(cache, torch.as_tensor(
            np.asarray(active, bool), device=self.device))

    def generate(self, batch: dict, max_new: int, eos_id: int | None = None):
        """Greedy wave decode over the full capacity. Returns (tokens np
        [B, max_new], cache); stops early only when every row has emitted
        ``eos_id``."""
        logits, cache = self.prefill(batch)
        B = logits.shape[0]
        tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
        done = torch.zeros((B,), dtype=torch.bool, device=self.device)
        outs = []
        for _ in range(max_new):
            outs.append(tok[:, 0].cpu().numpy())
            if eos_id is not None:
                done = done | (tok[:, 0] == eos_id)
                if bool(done.all()):
                    break
            logits, cache = self.decode(cache, tok)
            tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
        return np.stack(outs, axis=1), cache


@dataclasses.dataclass
class Request:
    rid: int
    tokens: np.ndarray  # [S] prompt at its true length
    max_new: int
    output: np.ndarray | None = None
    status: str = "queued"  # queued -> active -> done


@dataclasses.dataclass
class SlotStats:
    """Scheduler telemetry (the subset of the reference's this port has)."""

    n_slots: int = 0
    decode_steps: int = 0  # decode steps executed
    chunk_launches: int = 0  # decode launches (== steps when decode_chunk=1)
    occupied_slot_steps: int = 0  # sum over steps of occupied slots
    tokens_out: int = 0  # tokens delivered to requests
    admitted: int = 0
    completed: int = 0
    slot_reuses: int = 0  # admissions into a previously used slot
    wall_s: float = 0.0
    decode_s: float = 0.0  # wall time of the decode launches (tokens copied
    #   to the host at their end, so the device work is done)
    # paged admission (zeros for dense engines):
    admission_blocks: int = 0  # admissions deferred for lack of free pages
    pages_reserved_peak: int = 0  # max simultaneously reserved pool pages
    # chunked admission (zero when prefill_chunk_pages == 0):
    prefill_chunks: int = 0  # bounded prefill dispatches (a prompt within
    #   one chunk budget takes the monolithic insert and counts zero)
    # prefix cache (zeros when it is off):
    prefix_lookups: int = 0  # admissions that consulted the prefix index
    prefix_hits: int = 0  # admissions that matched at least one full page
    prefix_pages_shared: int = 0  # pages mapped by reference (cumulative)
    prefix_evictions: int = 0  # index entries dropped (pressure or cap)
    # speculative decode (zeros when it is off); ``decode_steps`` then
    # counts model passes, verify passes included, and ``tokens_out``
    # stays the token count:
    spec_launches: int = 0  # verify passes (window spec_k + 1)
    spec_drafted: int = 0  # drafts submitted for verification
    spec_accepted: int = 0  # drafts accepted (emitted without a pass of their own)
    degraded_steps: int = 0  # launches run plain after the watchdog turned
    #   speculation off

    @property
    def acceptance_rate(self) -> float:
        return self.spec_accepted / self.spec_drafted if self.spec_drafted else 0.0

    @property
    def prefix_hit_rate(self) -> float:
        return self.prefix_hits / self.prefix_lookups if self.prefix_lookups else 0.0

    @property
    def occupancy(self) -> float:
        """Fraction of slot-steps that decoded a live request."""
        total = self.decode_steps * max(self.n_slots, 1)
        return self.occupied_slot_steps / total if total else 0.0

    @property
    def decode_tok_s(self) -> float:
        """Tokens per second over the whole run, admissions included."""
        return self.tokens_out / self.wall_s if self.wall_s else 0.0


class _PrefixNode:
    """One full compressed page of a cached prompt prefix (a trie node)."""

    __slots__ = ("chunk", "page", "parent", "children", "last_used", "perms")

    def __init__(self, chunk: bytes, page: int, parent):
        self.chunk = chunk  # the raw token ids of this page's span (the key)
        self.page = page  # physical pool page id (one index reference held)
        self.parent = parent  # None at depth 0
        self.children: dict[bytes, "_PrefixNode"] = {}
        self.last_used = 0
        self.perms = None  # depth 0 only: (k_perm, v_perm) [n_layers, H_kv, D]


class PrefixIndex:
    """Host-side content-addressed index over FULL compressed prompt pages.

    A trie keyed by page-aligned chunks of raw prompt token ids; each node
    owns one physical pool page and holds ONE device reference on it
    (``core.cache.acquire_pages``), so indexed pages outlive their slot and
    are never handed out by the allocator. Lookup walks the longest
    matching chain; eviction removes LRU LEAVES only, skipping pages
    mapped into a live slot (a shared page is reserved by no slot).
    Depth-0 nodes carry the donor's page-0 channel calibration. Pure host
    state: every device change is the ``SlotServer``'s, through
    ``Engine.index_acquire`` / ``index_release``."""

    def __init__(self, page_size: int):
        self.page_size = page_size
        self.roots: dict[bytes, _PrefixNode] = {}
        self.n_held = 0  # pages the index holds a reference on
        self.pages: set[int] = set()  # their ids (each in exactly one node)
        self._clock = 0

    def chunks(self, tokens) -> list[bytes]:
        """Page-aligned raw-token-id chunks (the trie keys)."""
        t = np.ascontiguousarray(np.asarray(tokens, np.int64))
        p = self.page_size
        return [t[i * p:(i + 1) * p].tobytes() for i in range(len(t) // p)]

    def touch(self, node: _PrefixNode) -> None:
        self._clock += 1
        node.last_used = self._clock

    def descend(self, parent, chunk: bytes):
        return (self.roots if parent is None else parent.children).get(chunk)

    def lookup(self, tokens, max_pages: int):
        """Longest-prefix match, LRU-bumping the path. Returns (page ids,
        (k_perm, v_perm) or None)."""
        pages: list[int] = []
        perms = None
        node = None
        for chunk in self.chunks(tokens)[:max_pages]:
            node = self.descend(node, chunk)
            if node is None:
                break
            self.touch(node)
            if node.perms is not None:
                perms = node.perms
            pages.append(node.page)
        return pages, perms

    def insert(self, parent, chunk: bytes, page: int, perms=None):
        node = _PrefixNode(chunk, page, parent)
        self.touch(node)
        node.perms = perms if parent is None else None
        (self.roots if parent is None else parent.children)[chunk] = node
        self.n_held += 1
        self.pages.add(page)
        return node

    def evict_lru(self, protected: set[int]):
        """Drop the least recently used unprotected LEAF; returns its page
        id (the caller releases the device reference) or None."""
        best = None
        stack = list(self.roots.values())
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            if n.children or n.page in protected:
                continue
            if best is None or n.last_used < best.last_used:
                best = n
        if best is None:
            return None
        owner = self.roots if best.parent is None else best.parent.children
        del owner[best.chunk]
        self.n_held -= 1
        self.pages.discard(best.page)
        return best.page


class NGramDrafter:
    """Host-side per-slot suffix n-gram drafter (self-speculation, "prompt
    lookup").

    No draft model: per slot it keeps prompt + emitted tokens and proposes
    what followed the most recent earlier occurrence of the sequence's
    current suffix n-gram. Draft quality moves only the acceptance rate;
    the verify pass keeps outputs exact for any drafts, so a drafter can be
    swapped (``SlotServer(drafter=...)``)."""

    def __init__(self, max_ngram: int = 3):
        self.max_ngram = max_ngram
        self._seq: dict[int, list[int]] = {}

    def seed(self, slot: int, tokens) -> None:
        """Start tracking ``slot``: prompt + first generated token."""
        self._seq[slot] = [int(t) for t in tokens]

    def extend(self, slot: int, tokens) -> None:
        """Append the tokens a launch just emitted for ``slot``."""
        self._seq[slot].extend(int(t) for t in tokens)

    def drop(self, slot: int) -> None:
        self._seq.pop(slot, None)

    def draft(self, slot: int, k: int) -> list[int]:
        """Up to ``k`` proposed continuations of ``slot``'s sequence: for n
        = max_ngram..1, what followed the most recent prior occurrence of
        the last n tokens. Empty when nothing matches (the scheduler then
        runs a plain launch)."""
        seq = self._seq.get(slot)
        if not seq or k <= 0:
            return []
        L = len(seq)
        for n in range(min(self.max_ngram, L - 1), 0, -1):
            key = seq[L - n:]
            for s in range(L - n - 1, -1, -1):
                if seq[s:s + n] == key:
                    # s + n <= L - 1, so the continuation is never empty
                    return seq[s + n:s + n + k]
        return []


class _Active:
    """One occupied slot: the request plus its generation state."""

    __slots__ = ("req", "out", "done")

    def __init__(self, req: Request, first_tok: int, eos_id: int | None):
        self.req = req
        self.out = [first_tok]
        self.done = (eos_id is not None and first_tok == eos_id) or req.max_new <= 1

    @property
    def remaining(self) -> int:
        return self.req.max_new - len(self.out)

    @property
    def cached_tokens(self) -> int:
        """Host mirror of the row's cache occupancy (n_comp + n_resid): the
        prompt plus every generated token but the last (not yet appended)."""
        return len(self.req.tokens) + len(self.out) - 1


class _PrefillTask:
    """An in-flight chunked admission: one request advancing through its
    prefill segments. The slot (and its pages) is claimed at the start but
    stays ``None`` in the slot table until the last segment inserts the
    row; decode launches in between treat it as a free row."""

    __slots__ = ("req", "slot", "kind", "scratch", "bounds", "idx", "logits",
                 "match_pages")

    def __init__(self, req: Request, slot: int, kind: str, scratch,
                 bounds: list[int], match_pages: tuple[int, ...] = ()):
        self.req = req
        self.slot = slot
        self.kind = kind  # "plain" | "prefix"
        # plain: raw prompt K/V (models.prefill_chunk_init); prefix: the
        # dense mini-cache (models.prefix_chunk_init)
        self.scratch = scratch
        self.bounds = bounds  # segment offsets; [i, i+1) is one dispatch
        self.idx = 0  # next segment
        self.logits = None  # the last segment's logits seed decode
        self.match_pages = match_pages  # prefix: pages shared by reference

    @property
    def done(self) -> bool:
        return self.idx >= len(self.bounds) - 1


class SlotServer:
    """Continuous-batching scheduler over a fixed slot table.

    Each step: (1) ADMIT - advance the pending admission by one bounded
    prefill chunk, the last inserting the finished row into its claimed
    slot (``prefill_chunk_pages = 0``: seat queue heads by one monolithic
    prefill-insert each); (2) DECODE - one batched greedy launch of up to
    ``decode_chunk`` steps over the whole table (free rows ride along,
    masked); (3) RETIRE - rows that hit EOS or ``max_new`` record their
    output and their slot is reset for the next admission. Per-request
    greedy outputs equal a batch-size-1 ``Engine.generate`` run
    (per-row state, per-row positions, row-independent attention; chunk
    boundaries are exact resume points, ``models.layers.resume_attention``).

    PAGED engines admit on FREE PAGES: each admitted request reserves its
    worst-case page count (``ceil(min(capacity, prompt + max_new) /
    page_size)``) and admission blocks, FIFO order kept, while
    reservations plus the watermark would overflow the pool.

    PREFIX-CACHE engines look up the longest page-aligned prompt prefix
    already in the index; its pages are mapped by reference (a hit
    reserves only its suffix pages) and every full page of the admitted
    prompt is registered. Under page pressure, cold index prefixes (LRU
    leaves mapped into no live slot) are evicted before admission blocks.

    SPECULATIVE engines replace the decode launch with a verify pass when
    some row has a draft (``drafter``, default ``NGramDrafter``): each
    row's drafts are capped by its residual headroom after the seed
    append and by its remaining tokens; a slot whose drafts all die waits
    a doubling number of steps before drafting again
    (``EngineConfig.spec_backoff``). ``straggler`` (default
    ``StragglerMonitor()``) watches each decode launch's wall time; its
    'exclude' verdict turns speculation off for the rest of the run.
    """

    def __init__(self, engine: Engine, eos_id: int | None = None,
                 drafter: NGramDrafter | None = None,
                 straggler: StragglerMonitor | None = None):
        if engine.cfg.input_mode != "tokens":
            raise ValueError(f"input_mode {engine.cfg.input_mode!r} is not "
                             "servable per slot")
        self.engine = engine
        self.eos_id = eos_id
        spec = engine.ecfg.spec_decode
        self._drafter = (drafter or NGramDrafter()) if spec else None
        self._watchdog = (straggler or StragglerMonitor()) if spec else None
        self._spec_degraded = False  # set once the watchdog says exclude
        self._spec_backoff = [0] * engine.ecfg.max_batch
        self._spec_cooldown = [0] * engine.ecfg.max_batch
        self.n_slots = engine.ecfg.max_batch
        self.cache = None  # allocated on first admission
        self.slots: list[_Active | None] = [None] * self.n_slots
        self._ever_used = [False] * self.n_slots
        self._last_tok = np.zeros((self.n_slots,), np.int32)
        self.queue: deque[Request] = deque()
        self.done: dict[int, Request] = {}
        self.stats = SlotStats(n_slots=self.n_slots)
        self._reserved: dict[int, int] = {}  # slot -> pages it may NEWLY pop
        self._index = (PrefixIndex(engine.ecfg.page_size)
                       if engine.ecfg.prefix_cache else None)
        self._slot_shared: dict[int, tuple[int, ...]] = {}  # slot -> mapped pages
        self._task: _PrefillTask | None = None  # in-flight chunked admission

    # -- paged admission accounting ----------------------------------------
    @property
    def _pages_avail(self) -> int:
        """Pool pages not spoken for: total minus the watermark, minus every
        slot's reservation of pages it may newly pop, minus the pages the
        prefix index pins (reclaimable on demand, ``_evict_to_fit``)."""
        total = self.engine.pack_cfg.pool_pages
        held = self._index.n_held if self._index is not None else 0
        return (total - self.engine.ecfg.page_watermark
                - sum(self._reserved.values()) - held)

    def _pages_needed(self, req: Request) -> int:
        """Worst-case resident pages over the request's lifetime: its
        compressed tokens never exceed min(capacity, prompt + max_new)."""
        ecfg = self.engine.ecfg
        return cdiv(min(ecfg.capacity, len(req.tokens) + req.max_new),
                    ecfg.page_size)

    def _fit_pages(self, need_new: int, protected: set[int]) -> bool:
        """Whether ``need_new`` pages are reservable now, after evicting
        cold index prefixes; a miss is one admission block (FIFO order is
        kept: the head waits for a retirement)."""
        if self._evict_to_fit(need_new, protected):
            return True
        self.stats.admission_blocks += 1
        return False

    def _reserve(self, slot: int, req: Request, n_shared: int) -> None:
        """Reserve the pages ``req`` may newly pop: a hit's shared pages
        reserve none."""
        if self.engine.ecfg.paged:
            self._reserved[slot] = self._pages_needed(req) - n_shared
            self.stats.pages_reserved_peak = max(self.stats.pages_reserved_peak,
                                                 sum(self._reserved.values()))

    # -- prefix cache --------------------------------------------------------
    def _match(self, req: Request):
        """Longest page-aligned prefix the index serves for ``req``, one
        token short of the prompt at most (admission needs a suffix for
        its last-token logits). Returns (page ids, perms or None)."""
        max_m = (len(req.tokens) - 1) // self.engine.ecfg.page_size
        return self._index.lookup(req.tokens, max_m)

    def _live_shared(self) -> set[int]:
        """Shared pages a live slot maps by reference."""
        return {p for t in self._slot_shared.values() for p in t}

    def _evict_to_fit(self, need_new: int, protected: set[int]) -> bool:
        """Evict index pages (LRU leaves first) until ``need_new`` pages
        fit; never pages mapped into a live slot (no reservation covers
        them) or ``protected`` (the pending admission's match)."""
        if self._index is None:
            return need_new <= self._pages_avail
        protected = protected | self._live_shared()
        while need_new > self._pages_avail:
            page = self._index.evict_lru(protected)
            if page is None:
                return False
            self.cache = self.engine.index_release(self.cache, [page])
            self.stats.prefix_evictions += 1
        return True

    def _register(self, req: Request, slot: int) -> None:
        """Index every full compressed page of the freshly admitted prompt:
        matched pages are bumped, new ones get nodes and one device
        reference each. Within ``prefix_cache_pages`` by evicting LRU
        leaves first; registration stops when nothing is evictable (a
        shorter chain is still a correct trie)."""
        pack = self.engine.pack_cfg
        page = self.engine.ecfg.page_size
        k = (len(req.tokens) // pack.block) * pack.block // page
        if not k:
            return
        cap = self.engine.ecfg.prefix_cache_pages
        row = self.cache[0].pages.page_table[slot, :k].tolist()
        perms = None
        if pack.policy != "none":  # a copy: the slot's rows are reused
            perms = (torch.stack([c.k.chan_perm[slot] for c in self.cache]),
                     torch.stack([c.v.chan_perm[slot] for c in self.cache]))
        protected = self._live_shared() | set(row)
        acquired: list[int] = []
        parent = None
        for d, chunk in enumerate(self._index.chunks(req.tokens)[:k]):
            node = self._index.descend(parent, chunk)
            if node is None:
                if cap is not None and self._index.n_held >= cap:
                    ev = self._index.evict_lru(protected)
                    if ev is None:
                        break
                    self.cache = self.engine.index_release(self.cache, [ev])
                    self.stats.prefix_evictions += 1
                node = self._index.insert(parent, chunk, row[d],
                                          perms if d == 0 else None)
                acquired.append(row[d])
            else:
                self._index.touch(node)
            parent = node
        if acquired:
            self.cache = self.engine.index_acquire(self.cache, acquired)

    def _count_lookup(self, pages: list[int]) -> None:
        self.stats.prefix_lookups += 1
        if pages:
            self.stats.prefix_hits += 1
            self.stats.prefix_pages_shared += len(pages)

    def _counters(self, act: _Active) -> tuple[int, int]:
        """Host mirror of an occupied row's (n_comp, n_resid), exact with
        no device read: prefill compresses every full block, then each
        cached token appends one residual slot, flushing a block whenever
        the residual is full at the append (a paged row stops flushing at
        capacity, as ``core.cache.append_token`` does)."""
        pack = self.engine.pack_cfg
        S = len(act.req.tokens)
        lb = (S // pack.block) * pack.block
        r = S - lb + len(act.out) - 1  # as if no flush had fired
        f = -(-(r - pack.residual) // pack.block) if r > pack.residual else 0
        if self.engine.ecfg.paged:
            f = min(f, (self.engine.ecfg.capacity - lb) // pack.block)
        return lb + f * pack.block, r - f * pack.block

    def _check_invariants(self) -> None:
        """Debug mode (``EngineConfig.debug_invariants``): every layer's
        page ledger conserves references (free iff ref == 0, both ways).
        Reads the device."""
        if not (self.engine.ecfg.debug_invariants and self.engine.ecfg.paged
                and self.cache is not None):
            return
        for layer in self.cache:
            ref = layer.pages.ref.cpu().numpy()
            nf = int(layer.pages.n_free)
            free = layer.pages.free.cpu().numpy()
            assert int((ref > 0).sum()) + nf == ref.shape[0], (ref, nf)
            assert int((ref == 0).sum()) == nf, (ref, nf)
            assert (ref[free[:nf]] == 0).all(), (ref, free[:nf])
            if self._index is not None:
                assert all(ref[p] >= 1 for p in self._index.pages), self._index.pages

    # -- queue --------------------------------------------------------------
    def submit(self, req: Request) -> None:
        if req.max_new < 1:
            raise ValueError(f"request {req.rid}: max_new must be >= 1")
        ecfg, pack = self.engine.ecfg, self.engine.pack_cfg
        # Paged engines only, as the reference: a dense row past capacity
        # overwrites its last block (``append_block`` clamps its start),
        # and a dense prompt whose whole blocks exceed capacity is refused
        # by ``prefill_cache`` at its admission step.
        if ecfg.paged:
            lb = (len(req.tokens) // pack.block) * pack.block
            if lb > ecfg.capacity:
                raise ValueError(f"request {req.rid}: block-aligned prompt "
                                 f"length {lb} exceeds compressed capacity "
                                 f"{ecfg.capacity}")
            hi = len(req.tokens) + req.max_new
            if hi > ecfg.capacity + pack.residual:
                # past it, a paged row stops flushing and degrades its own
                # residual
                raise ValueError(
                    f"request {req.rid}: prompt + max_new = {hi} exceeds "
                    f"capacity + residual = {ecfg.capacity + pack.residual}")
            most = pack.pool_pages - ecfg.page_watermark
            if self._pages_needed(req) > most:
                raise ValueError(f"request {req.rid} needs "
                                 f"{self._pages_needed(req)} pages but the "
                                 f"pool admits at most {most}")
        self.queue.append(req)

    @property
    def n_occupied(self) -> int:
        return sum(s is not None for s in self.slots)

    # -- retirement (the one path out of a slot) ----------------------------
    def _release_slot(self, i: int) -> None:
        """Free slot ``i``: the device row (paged: its pages) and its
        page reservation."""
        self.slots[i] = None
        if self._drafter is not None:
            self._drafter.drop(i)
        self.cache = self.engine.free_slot(self.cache, i)
        self._reserved.pop(i, None)
        self._slot_shared.pop(i, None)  # its shared pages' refs went with it
        self._check_invariants()

    def _retire_slot(self, i: int) -> Request:
        act = self.slots[i]
        act.req.output = np.asarray(act.out, np.int32)
        act.req.status = "done"
        self.done[act.req.rid] = act.req
        self._release_slot(i)
        self.stats.completed += 1
        return act.req

    # -- admission ------------------------------------------------------------
    def _claim(self):
        """A free slot for the queue head, its prefix match (page ids,
        perms; empty without a prefix cache) and, paged, room for its
        page reservation; None while admission is blocked."""
        if not self.queue or None not in self.slots:
            return None
        head = self.queue[0]
        pages, perms = [], None
        if self._index is not None and self.cache is not None:
            pages, perms = self._match(head)
        if self.engine.ecfg.paged and not self._fit_pages(
                self._pages_needed(head) - len(pages), set(pages)):
            return None
        if self.cache is None:
            self.cache = self.engine.alloc_slot_cache()
        return self.slots.index(None), pages, perms

    def _insert(self, req: Request, i: int, finished: list[Request],
                pages=(), perms=None) -> None:
        """Monolithic prefill-insert of ``req`` into slot ``i`` (prefix
        cache: its one-call prefix admission, then its registration)."""
        if self._index is not None:
            self._count_lookup(pages)
            logits, self.cache = self.engine.insert_request_prefix(
                self.cache, i, req.tokens, pages, perms)
            self._slot_shared[i] = tuple(pages)
            self._register(req, i)
        else:
            logits, self.cache = self.engine.insert_request(self.cache, i,
                                                            req.tokens)
        self._seated(req, i, logits, finished)

    def _seated(self, req: Request, i: int, logits, finished: list[Request]):
        self._activate(req, i, int(torch.argmax(logits)))
        self._check_invariants()
        if self.slots[i].done:  # max_new == 1 or instant EOS
            finished.append(self._retire_slot(i))

    def _admit(self) -> list[Request]:
        """Monolithic admission sweep (``prefill_chunk_pages == 0``): seat
        queue heads until the queue drains or admission blocks."""
        finished: list[Request] = []
        while (claim := self._claim()) is not None:
            i, pages, perms = claim
            req = self.queue.popleft()
            self._reserve(i, req, len(pages))
            self._insert(req, i, finished, pages, perms)
        return finished

    def _activate(self, req: Request, i: int, tok: int) -> None:
        req.status = "active"
        self.slots[i] = _Active(req, tok, self.eos_id)
        self._last_tok[i] = tok
        self._spec_backoff[i] = self._spec_cooldown[i] = 0
        if self._drafter is not None:
            # prompt + the first token (the next launch's seed)
            self._drafter.seed(i, list(np.asarray(req.tokens)) + [tok])
        self.stats.admitted += 1
        self.stats.tokens_out += 1
        if self._ever_used[i]:
            self.stats.slot_reuses += 1
        self._ever_used[i] = True

    def _start_task(self, finished: list[Request]) -> _PrefillTask | None:
        """Claim a slot (and pages) for the queue head and build its
        chunked admission; None while blocked. Without a prefix cache, a
        prompt within one chunk budget is admitted here by the monolithic
        insert (one dispatch either way) and leaves no task; with one,
        every admission runs its page segments (a cold one calibrates on
        its first page, which is what makes a later hit exact)."""
        claim = self._claim()
        if claim is None:
            return None
        slot, pages, perms = claim
        req = self.queue.popleft()
        self._reserve(slot, req, len(pages))
        S = len(req.tokens)
        if self._index is not None:
            self._count_lookup(pages)
            return _PrefillTask(req, slot, "prefix",
                                self.engine.prefix_chunk_start(self.cache, S,
                                                               pages, perms),
                                self.engine.prefix_chunk_bounds(S, len(pages)),
                                tuple(pages))
        c = self.engine.chunk_tokens()
        if S <= c:
            self._insert(req, slot, finished)
            return None
        return _PrefillTask(req, slot, "plain", self.engine.chunk_init(S),
                            sorted(set(range(0, S, c)) | {S}))

    def _advance_task(self, finished: list[Request]) -> None:
        """One scheduler step's admission progress: one plain segment (the
        last one also inserts the row), or up to ``prefill_chunk_pages``
        one-page prefix segments; a finished task's row is activated."""
        if self._task is None:
            self._task = self._start_task(finished)
        t = self._task
        if t is None:
            return
        budget = 1 if t.kind == "plain" else max(1, self.engine.ecfg.prefill_chunk_pages)
        for _ in range(budget):
            if t.done:
                break
            s0, s1 = t.bounds[t.idx], t.bounds[t.idx + 1]
            seg = t.req.tokens[s0:s1]
            if t.kind == "prefix":
                t.logits, t.scratch = self.engine.prefix_chunk_step(t.scratch, seg, s0)
            elif t.idx == len(t.bounds) - 2:  # last segment: chunk + insert
                t.logits, self.cache = self.engine.chunk_final(
                    self.cache, t.slot, t.scratch, seg, s0)
                t.scratch = None
            else:
                t.logits, t.scratch = self.engine.chunk_step(t.scratch, seg, s0)
            t.idx += 1
            self.stats.prefill_chunks += 1
        if t.done:
            self._task = None
            self._finish_task(t, finished)

    def _finish_task(self, t: _PrefillTask, finished: list[Request]) -> None:
        """Activate a finished admission; a prefix task first writes its
        row (shared pages by reference) and registers its pages (a plain
        task's last segment already inserted the row)."""
        if t.kind == "prefix":
            self.cache = self.engine.prefix_chunk_finish(
                self.cache, t.slot, t.scratch, t.match_pages, len(t.req.tokens))
            self._slot_shared[t.slot] = t.match_pages
            self._register(t.req, t.slot)
        self._seated(t.req, t.slot, t.logits, finished)

    def _chunk_plan(self) -> tuple[int, int | None]:
        """(n_steps, n_bucket) for the next decode launch: no row may
        overshoot its ``max_new`` inside a chunk, and the bucket bounds
        every row's n_comp through the whole chunk."""
        occupied = [a for a in self.slots if a is not None]
        n_steps = max(1, min(self.engine.ecfg.decode_chunk,
                             min(a.remaining for a in occupied)))
        n_max = max(a.cached_tokens for a in occupied) + n_steps
        return n_steps, self.engine.bucket_for(n_max)

    def step(self) -> list[Request]:
        """Admit (one chunk, or a monolithic sweep), then one decode
        launch, then retire. Returns the requests finished now."""
        t0 = time.perf_counter()
        finished: list[Request] = []
        if self.engine.ecfg.prefill_chunk_pages > 0:
            self._advance_task(finished)
        else:
            finished.extend(self._admit())
        if self.n_occupied:
            t_dec = time.perf_counter()
            if self.engine.ecfg.spec_decode and not self._spec_degraded:
                self._decode_spec(finished)
            else:
                if self.engine.ecfg.spec_decode:
                    self.stats.degraded_steps += 1
                self._decode_plain(finished)
            dt = time.perf_counter() - t_dec
            self.stats.decode_s += dt
            self._observe_launch(dt)
        self.stats.wall_s += time.perf_counter() - t0
        return finished

    def _observe_launch(self, dt: float) -> None:
        """Feed one decode launch's wall time to the straggler watchdog; an
        'exclude' verdict turns speculation off for good (outputs do not
        change: speculation moves only the speed)."""
        if self._watchdog is None or self._spec_degraded:
            return
        if self._watchdog.observe(dt) == "exclude":
            self._spec_degraded = True

    def _decode_plain(self, finished: list[Request]) -> None:
        """The plain launch: a multi-step chunk or a single step."""
        n_steps, n_bucket = self._chunk_plan()
        if self.engine.ecfg.decode_chunk > 1:
            self._decode_chunk(n_steps, n_bucket, finished)
        else:
            self._decode_single(n_bucket, finished)

    def _emit(self, i: int, t: int) -> bool:
        """Record token ``t`` for slot ``i``; True once the row is done."""
        act = self.slots[i]
        act.out.append(t)
        self._last_tok[i] = t
        self.stats.tokens_out += 1
        if self._drafter is not None:
            self._drafter.extend(i, (t,))
        act.done = (self.eos_id is not None and t == self.eos_id) or \
            len(act.out) >= act.req.max_new
        return act.done

    def _decode_single(self, n_bucket: int | None, finished: list[Request]):
        """Per-token launch (decode_chunk = 1)."""
        logits, self.cache = self.engine.decode(self.cache, self._last_tok[:, None],
                                                n_bucket)
        nxt = torch.argmax(logits, -1).cpu().numpy()
        self.stats.decode_steps += 1
        self.stats.chunk_launches += 1
        for i, act in enumerate(self.slots):
            if act is None:
                continue
            self.stats.occupied_slot_steps += 1
            if self._emit(i, int(nxt[i])):
                finished.append(self._retire_slot(i))
        if self.n_occupied < self.n_slots:
            # free rows got a junk append this step: re-zero their counters
            self.cache = self.engine.mask_free(
                self.cache, [s is not None for s in self.slots])

    def _decode_chunk(self, n_steps: int, n_bucket: int | None,
                      finished: list[Request]):
        """Multi-step launch: up to ``n_steps`` tokens per row. Tokens a
        row produces past its own EOS are discarded (rows are independent);
        ``decode_steps`` re-zeroes free rows after every step."""
        active = [a is not None for a in self.slots]
        toks, n_exec, self.cache = self.engine.decode_chunk(
            self.cache, self._last_tok[:, None], active, n_steps, self.eos_id,
            n_bucket)
        self.stats.chunk_launches += 1
        self.stats.decode_steps += n_exec
        self.stats.occupied_slot_steps += n_exec * self.n_occupied
        for i, act in enumerate(self.slots):
            if act is None:
                continue
            for s in range(n_exec):
                if self._emit(i, int(toks[s, i])):
                    break
            if act.done:
                finished.append(self._retire_slot(i))

    # -- speculative decode --------------------------------------------------
    def _post_seed(self, act: _Active) -> tuple[int, int]:
        """The row's (n_comp, n_resid) after the next seed append, from the
        host mirror: the seed flushes a block when the residual is full (a
        paged row at capacity does not)."""
        pack, ecfg = self.engine.pack_cfg, self.engine.ecfg
        c, r = self._counters(act)
        if r >= pack.residual and (not ecfg.paged
                                   or c + pack.block <= ecfg.capacity):
            c, r = c + pack.block, r - pack.block
        return c, r + 1

    def _plan_spec(self):
        """Per-row drafts of one verify pass: (tokens [B, w], lens [B]),
        or None when no row has a draft (a verify window would be pure
        overhead; the caller runs a plain launch instead).

        The window is always ``spec_k + 1`` wide; shorter drafts ride
        through ``lens``. A row's drafts are capped by its residual
        headroom after the seed append (a window never crosses a flush or
        a page pop, ``core.cache.append_window``) and by ``remaining - 1``
        (emission never overshoots ``max_new``). A row in backoff sits the
        pass out, seed only, and its cooldown ticks down."""
        ecfg = self.engine.ecfg
        w = ecfg.spec_k + 1
        toks = np.zeros((self.n_slots, w), np.int32)
        lens = np.ones((self.n_slots,), np.int32)
        any_draft = False
        for i, act in enumerate(self.slots):
            if act is None:
                continue
            toks[i, 0] = self._last_tok[i]
            if self._spec_cooldown[i] > 0:
                self._spec_cooldown[i] -= 1
                continue
            _, r = self._post_seed(act)
            kb = min(ecfg.spec_k, self.engine.pack_cfg.residual - r,
                     act.remaining - 1)
            if kb <= 0:
                continue
            d = self._drafter.draft(i, kb)
            if not d:
                continue
            toks[i, 1:1 + len(d)] = d
            lens[i] = 1 + len(d)
            any_draft = True
        return (toks, lens) if any_draft else None

    def _decode_spec(self, finished: list[Request]) -> None:
        """Speculative launch: every row's drafts verified by one pass; the
        accepted prefix commits by a counter advance and rejected drafts
        die past ``n_resid``. A row emits its accepted drafts and the
        model's own next token, each what plain decode would emit."""
        plan = self._plan_spec()
        if plan is None:
            self._decode_plain(finished)
            return
        toks, lens = plan
        # a window never flushes after its seed, so the post-seed n_comp
        # is exact on the host and bounds the pass's bucket tightly
        n_comp = max(self._post_seed(a)[0] for a in self.slots if a is not None)
        n_bucket = self.engine.bucket_for(max(1, n_comp))
        active = [s is not None for s in self.slots]
        hat, n_accept, self.cache = self.engine.decode_verify(
            self.cache, toks, lens, active, n_bucket)
        ecfg = self.engine.ecfg
        self.stats.decode_steps += 1
        self.stats.chunk_launches += 1
        self.stats.spec_launches += 1
        for i, act in enumerate(self.slots):
            if act is None:
                continue
            self.stats.occupied_slot_steps += 1
            m, kb = int(n_accept[i]), int(lens[i]) - 1
            self.stats.spec_drafted += kb
            self.stats.spec_accepted += m
            if kb > 0 and ecfg.spec_backoff > 0:
                if m == 0:  # every draft died: a doubling cooldown
                    self._spec_backoff[i] = min(max(1, 2 * self._spec_backoff[i]),
                                                ecfg.spec_backoff)
                    self._spec_cooldown[i] = self._spec_backoff[i]
                else:
                    self._spec_backoff[i] = 0
            for j in range(m + 1):
                if self._emit(i, int(hat[i, j])):
                    break  # tokens past EOS or max_new are junk
        for i, act in enumerate(self.slots):
            if act is not None and act.done:
                finished.append(self._retire_slot(i))

    def run(self) -> list[Request]:
        """Drain the queue, the pending admission and all slots; returns
        every finished request."""
        finished: list[Request] = []
        while self.queue or self.n_occupied or self._task is not None:
            finished.extend(self.step())
        return finished
