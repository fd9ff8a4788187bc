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

The prefix cache, speculative decode, preemption, sessions and meshes are
not ported yet (ROADMAP.md); where the reference consults them, this
engine takes the branch the reference takes when they are off.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..core.cache import PackKVConfig, bucket_length, calibrate_specs
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
    paged: bool = False  # page-pool storage + page-reservation admission
    page_size: int = 256  # tokens per page (power of two, >= block)
    pool_pages: int | None = None  # pages in the pool; None = max_batch *
    #   capacity / page_size (no oversubscription)
    page_watermark: int = 0  # spare pages admission always holds back
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

    def decode(self, cache, token, n_bucket: int | None = None):
        return self.api.decode_step(self.params, self.cfg, cache,
                                    self._tokens(token),
                                    backend=self.ecfg.backend, n_bucket=n_bucket)

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
            n_bucket=n_bucket)
        return toks.cpu().numpy(), n_exec, cache

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
        """One bounded prefill chunk at absolute offset ``n_ctx``. Returns
        (last-token logits [V], scratch); only the final chunk's logits
        are meaningful."""
        logits, scratch = self.api.prefill_chunk(
            self.params, self.cfg, self.pack_cfg, scratch,
            self._tokens(tokens)[None], n_ctx=n_ctx)
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

    @property
    def occupancy(self) -> float:
        """Fraction of slot-steps that decoded a live request."""
        total = self.decode_steps * max(self.n_slots, 1)
        return self.occupied_slot_steps / total if total else 0.0

    @property
    def decode_tok_s(self) -> float:
        """Tokens per second over the whole run, admissions included."""
        return self.tokens_out / self.wall_s if self.wall_s else 0.0


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
    prefill segments, one per scheduler step. The slot (and its pages) is
    claimed at the start but stays ``None`` in the slot table until the
    last segment inserts the row; decode launches in between treat it as
    a free row."""

    __slots__ = ("req", "slot", "scratch", "bounds", "idx", "logits")

    def __init__(self, req: Request, slot: int, scratch: dict,
                 bounds: list[int]):
        self.req = req
        self.slot = slot
        self.scratch = scratch  # raw prompt K/V (models.prefill_chunk_init)
        self.bounds = bounds  # segment offsets; [i, i+1) is one dispatch
        self.idx = 0  # next segment
        self.logits = None  # the last segment's logits seed decode

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
    """

    def __init__(self, engine: Engine, eos_id: int | None = None):
        if engine.cfg.input_mode != "tokens":
            raise ValueError(f"input_mode {engine.cfg.input_mode!r} is not "
                             "servable per slot")
        self.engine = engine
        self.eos_id = eos_id
        self.n_slots = engine.ecfg.max_batch
        self.cache = None  # allocated on first admission
        self.slots: list[_Active | None] = [None] * self.n_slots
        self._ever_used = [False] * self.n_slots
        self._last_tok = np.zeros((self.n_slots,), np.int32)
        self.queue: deque[Request] = deque()
        self.done: dict[int, Request] = {}
        self.stats = SlotStats(n_slots=self.n_slots)
        self._reserved: dict[int, int] = {}  # slot -> pages it may pop
        self._task: _PrefillTask | None = None  # in-flight chunked admission

    # -- paged admission accounting ----------------------------------------
    @property
    def _pages_avail(self) -> int:
        """Pool pages not spoken for: total minus the watermark minus every
        slot's reservation."""
        total = self.engine.pack_cfg.pool_pages
        return total - self.engine.ecfg.page_watermark - sum(self._reserved.values())

    def _pages_needed(self, req: Request) -> int:
        """Worst-case resident pages over the request's lifetime: its
        compressed tokens never exceed min(capacity, prompt + max_new)."""
        ecfg = self.engine.ecfg
        return cdiv(min(ecfg.capacity, len(req.tokens) + req.max_new),
                    ecfg.page_size)

    def _fit_pages(self, need: int) -> bool:
        """Whether ``need`` pages are reservable now; a miss is one
        admission block (FIFO order is kept: the head waits for a
        retirement)."""
        if need <= self._pages_avail:
            return True
        self.stats.admission_blocks += 1
        return False

    def _reserve(self, slot: int, req: Request) -> None:
        if self.engine.ecfg.paged:
            self._reserved[slot] = self._pages_needed(req)
            self.stats.pages_reserved_peak = max(self.stats.pages_reserved_peak,
                                                 sum(self._reserved.values()))

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
        self.cache = self.engine.free_slot(self.cache, i)
        self._reserved.pop(i, None)
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
    def _claim(self) -> int | None:
        """A free slot (and, paged, its page reservation) for the queue
        head, or None while admission is blocked."""
        if not self.queue or None not in self.slots:
            return None
        if self.engine.ecfg.paged and not self._fit_pages(
                self._pages_needed(self.queue[0])):
            return None
        if self.cache is None:
            self.cache = self.engine.alloc_slot_cache()
        return self.slots.index(None)

    def _insert(self, req: Request, i: int, finished: list[Request]) -> None:
        """Monolithic prefill-insert of ``req`` into slot ``i``."""
        logits, self.cache = self.engine.insert_request(self.cache, i, req.tokens)
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
        while (i := self._claim()) is not None:
            req = self.queue.popleft()
            self._reserve(i, req)
            self._insert(req, i, finished)
        return finished

    def _activate(self, req: Request, i: int, tok: int) -> None:
        req.status = "active"
        self.slots[i] = _Active(req, tok, self.eos_id)
        self._last_tok[i] = tok
        self.stats.admitted += 1
        self.stats.tokens_out += 1
        if self._ever_used[i]:
            self.stats.slot_reuses += 1
        self._ever_used[i] = True

    def _start_task(self, finished: list[Request]) -> _PrefillTask | None:
        """Claim a slot (and pages) for the queue head and build its
        chunked admission; None while blocked. A prompt within one chunk
        budget is admitted here by the monolithic insert (one dispatch
        either way) and leaves no task."""
        slot = self._claim()
        if slot is None:
            return None
        req = self.queue.popleft()
        self._reserve(slot, req)
        S, c = len(req.tokens), self.engine.chunk_tokens()
        if S <= c:
            self._insert(req, slot, finished)
            return None
        return _PrefillTask(req, slot, self.engine.chunk_init(S),
                            sorted(set(range(0, S, c)) | {S}))

    def _advance_task(self, finished: list[Request]) -> None:
        """One scheduler step's admission progress: one prefill segment;
        the last one also inserts the row and activates it."""
        if self._task is None:
            self._task = self._start_task(finished)
        t = self._task
        if t is None:
            return
        s0, s1 = t.bounds[t.idx], t.bounds[t.idx + 1]
        seg = t.req.tokens[s0:s1]
        if t.idx == len(t.bounds) - 2:  # last segment: chunk + insert
            t.logits, self.cache = self.engine.chunk_final(
                self.cache, t.slot, t.scratch, seg, s0)
            t.scratch = None
        else:
            t.logits, t.scratch = self.engine.chunk_step(t.scratch, seg, s0)
        t.idx += 1
        self.stats.prefill_chunks += 1
        if t.done:
            self._task = None
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
            n_steps, n_bucket = self._chunk_plan()
            if self.engine.ecfg.decode_chunk > 1:
                self._decode_chunk(n_steps, n_bucket, finished)
            else:
                self._decode_single(n_bucket, finished)
            self.stats.decode_s += time.perf_counter() - t_dec
        self.stats.wall_s += time.perf_counter() - t0
        return finished

    def _emit(self, i: int, t: int) -> bool:
        """Record token ``t`` for slot ``i``; True once the row is done."""
        act = self.slots[i]
        act.out.append(t)
        self._last_tok[i] = t
        self.stats.tokens_out += 1
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

    def run(self) -> list[Request]:
        """Drain the queue, the pending admission and all slots; returns
        every finished request."""
        finished: list[Request] = []
        while self.queue or self.n_occupied or self._task is not None:
            finished.extend(self.step())
        return finished
