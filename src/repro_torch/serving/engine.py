"""Serving engine: calibration, prefill/decode, continuous batching.

The torch port of the dense, single-device path of
``repro/serving/engine.py``:

  1. CALIBRATE - a short prefill with the uncompressed policy collects raw
     K/V and picks static TierSpecs (``core.cache.calibrate_specs``).
  2. SERVE - ``SlotServer`` runs a continuous-batching scheduler over a
     fixed table of ``max_batch`` slots. Each request owns one row of the
     decode cache (per-row ``n_comp``/``n_resid``), is admitted at its
     true prompt length by one monolithic prefill, and its row is recycled
     the moment it finishes while the other rows keep decoding.

Admission is monolithic (``prefill_chunk_pages=0``). Chunked admission,
paged storage, prefix cache, speculative decode, preemption, sessions and
meshes are not ported yet (ROADMAP.md).
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


@dataclasses.dataclass
class EngineConfig:
    capacity: int = 4096  # compressed-region token capacity
    max_batch: int = 8  # slot-table size
    backend: str = "fused"  # fused (the CUDA kernel; plain version on CPU) | ref
    calibrate: bool = True
    calib_tokens: int = 192  # multiple of the 64-token block
    bucketed: bool = True  # read only a live-length bucket of the cache
    bucket_unit: int = 256  # smallest bucket; power-of-two multiples
    decode_chunk: int = 8  # decode steps per multi-step launch (1 = per token)
    prefill_chunk_pages: int = 0  # 0 = monolithic admission (the only mode)
    device: str = "cuda"


class Engine:
    def __init__(self, cfg: ArchConfig, params: dict, pack_cfg: PackKVConfig,
                 ecfg: EngineConfig):
        if ecfg.prefill_chunk_pages:
            raise NotImplementedError(
                "chunked admission (prefill_chunk_pages > 0) is not ported "
                "yet: it is the next item of ROADMAP.md Queue 1; use 0")
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
        self.pack_cfg = (self._calibrate(pack_cfg)
                         if ecfg.calibrate and pack_cfg.policy == "packkv"
                         else pack_cfg)

    # -- calibration --------------------------------------------------------
    def _calibrate(self, pack_cfg: PackKVConfig) -> PackKVConfig:
        S = self.ecfg.calib_tokens
        rng = np.random.default_rng(0)
        tokens = torch.as_tensor(rng.integers(0, self.cfg.vocab, (1, S)),
                                 dtype=torch.int32, device=self.device)
        none_cfg = dataclasses.replace(pack_cfg, policy="none")
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
        """Launch bucket covering ``n_max`` compressed tokens (None = full)."""
        if not self.ecfg.bucketed:
            return None
        return bucket_length(n_max, self.ecfg.capacity, self.ecfg.bucket_unit)

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
    """Scheduler telemetry (the subset of the reference's this slice has)."""

    n_slots: int = 0
    decode_steps: int = 0  # decode steps executed
    occupied_slot_steps: int = 0  # sum over steps of occupied slots
    tokens_out: int = 0  # tokens delivered to requests
    admitted: int = 0
    completed: int = 0
    slot_reuses: int = 0  # admissions into a previously used slot
    wall_s: float = 0.0
    decode_s: float = 0.0  # wall time of the decode launches (tokens copied
    #   to the host at their end, so the device work is done)

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


class SlotServer:
    """Continuous-batching scheduler over a fixed slot table.

    Each step: (1) ADMIT - seat FIFO queue heads into free slots, each by
    one monolithic prefill-insert; (2) DECODE - one batched greedy launch
    of up to ``decode_chunk`` steps over the whole table (free rows ride
    along, masked); (3) RETIRE - rows that hit EOS or ``max_new`` record
    their output and their slot is reset for the next admission.
    Per-request greedy outputs equal a batch-size-1 ``Engine.generate``
    run (per-row state, per-row positions, row-independent attention).
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

    def submit(self, req: Request) -> None:
        if req.max_new < 1:
            raise ValueError(f"request {req.rid}: max_new must be >= 1")
        pack = self.engine.pack_cfg
        lb = (len(req.tokens) // pack.block) * pack.block
        if lb > self.engine.ecfg.capacity:
            raise ValueError(f"request {req.rid}: block-aligned prompt length "
                             f"{lb} exceeds capacity {self.engine.ecfg.capacity}")
        self.queue.append(req)

    @property
    def n_occupied(self) -> int:
        return sum(s is not None for s in self.slots)

    def _retire_slot(self, i: int) -> Request:
        act = self.slots[i]
        act.req.output = np.asarray(act.out, np.int32)
        act.req.status = "done"
        self.done[act.req.rid] = act.req
        self.slots[i] = None
        self.cache = self.engine.free_slot(self.cache, i)
        self.stats.completed += 1
        return act.req

    def _admit(self) -> list[Request]:
        """Monolithic admission sweep: seat queue heads until the queue
        drains or no slot is free."""
        finished: list[Request] = []
        while self.queue and None in self.slots:
            i = self.slots.index(None)
            req = self.queue.popleft()
            if self.cache is None:
                self.cache = self.engine.alloc_slot_cache()
            logits, self.cache = self.engine.insert_request(self.cache, i,
                                                            req.tokens)
            self._activate(req, i, int(torch.argmax(logits)))
            if self.slots[i].done:  # max_new == 1 or instant EOS
                finished.append(self._retire_slot(i))
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
        """Admit, then one decode launch, then retire. Returns the
        requests finished now."""
        t0 = time.perf_counter()
        finished = self._admit()
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
        """Drain the queue and all slots; returns every finished request."""
        finished: list[Request] = []
        while self.queue or self.n_occupied:
            finished.extend(self.step())
        return finished
