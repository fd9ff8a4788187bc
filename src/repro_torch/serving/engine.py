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

PREEMPTIVE engines (``EngineConfig.preempt``) give requests a priority
class: a head that cannot seat swaps a lower-class victim's compressed
row out to host memory (``core.cache.evacuate_row`` into a
``SwapStore``) and the victim later resumes from it bitwise
(``restore_row``, no forward pass). SESSION-CACHE engines
(``EngineConfig.session_cache``) park a retiring row in a
``SessionStore`` keyed by its token trace (host RAM, LRU by bytes,
optional disk spill and TTL); a returning turn restores it and ingests
only its new suffix, teacher-forced through the decode launches.
Cancellation, deadlines and a deterministic ``FaultPlan`` retire work
through the same paths.

MESH engines (``EngineConfig.mesh_shape`` other than (1, 1)) serve on a
``(dp, kv)`` grid of devices under this one controller
(``kernels/sharded.py``): pool payloads, residual buffers and channel
permutations split by whole KV heads over ``kv``, the page ledger and
the row counters replicated in every lane, attention rows partitioned
over ``dp``. Tokens equal the (1, 1) engine's bitwise.

Every family serves through this one engine: the recurrent ones (rwkv6,
hybrid_rglru) admit each request by a B=1 prefill (or its chunks) written
into the slot's state row and decode a step a launch; their O(1) state has
no pages, no verify pass and no evacuate / restore ops, so paged storage,
the prefix cache, speculative decode, preemption and the session cache
refuse them at build, with the reference's messages.
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
    SessionStore,
    SwapStore,
    acquire_pages,
    bucket_length,
    calibrate_specs,
    release_pages,
)
from ..distributed.fault import FaultPlan, StragglerMonitor
from ..kernels.sharded import Mesh, lane_lists, ledgers_agree
from ..models import get_model
from ..utils import cdiv, to_device


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
    # preemption:
    preempt: bool = False  # swap a lower class's compressed row out to host
    #   memory when a higher-class head cannot seat; it resumes bitwise
    aging_steps: int = 32  # scheduler steps per one class promotion of a
    #   waiting head (no starvation); 0 = strict priority
    # multi-turn session cache:
    session_cache: bool = False  # park retiring rows host-side by their
    #   token trace; a returning turn restores and ingests only its suffix
    session_cache_mb: int = 256  # host budget of parked rows (LRU by bytes)
    session_ttl_s: float | None = None  # idle expiry (None = never)
    session_disk_dir: str | None = None  # spill LRU victims here through
    #   ``checkpoint.sharded.save_mini`` (None = drop them)
    debug_invariants: bool = False  # check refcount conservation after every
    #   admit/retire, and on a mesh that every lane's ledger is lane
    #   (0, 0)'s (a device read per check: tests and bring-up only)
    device: str = "cuda"  # the controller's device
    # multi-device serving (kernels/sharded.py):
    mesh_shape: tuple = (1, 1)  # (dp, kv): data-parallel row lanes x
    #   KV-head lanes. (1, 1) = off (the single-device engine). Otherwise
    #   every cache-touching op runs in each lane on its head block, and
    #   tokens stay bitwise equal to (1, 1); recurrent families refuse it
    mesh_devices: tuple | None = None  # the lanes' devices, dp-major; may
    #   repeat one ("cuda:0",) * n. None: every lane on "cpu" for a cpu
    #   engine, cuda:0 .. cuda:n-1 for a cuda one


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
        self.mesh = self._build_mesh(cfg, ecfg)
        if ecfg.prefix_cache:
            if self.api.prefill_prefix is None:
                raise ValueError(
                    f"family {cfg.family!r} cannot serve --prefix-cache: its "
                    "recurrent decode state has no page-addressable KV pages "
                    "to share — drop --prefix-cache (plain chunked admission "
                    "still applies)")
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
                raise ValueError(
                    f"family {cfg.family!r} cannot serve --spec-decode: its "
                    "recurrent state update is sequential per token, so "
                    "there is no batched q_len=k verify pass to amortize "
                    "the weights-read over — drop --spec-decode")
            if ecfg.spec_k < 1:
                raise ValueError(f"spec_k must be >= 1, got {ecfg.spec_k}")
        if ecfg.session_cache and cfg.window:
            raise ValueError(
                "--session-cache does not support sliding-window attention "
                f"(window={cfg.window}): evicted window tokens break the "
                "parked-trace identity the session key relies on")
        if (ecfg.preempt or ecfg.session_cache) and self.api.evacuate_slot is None:
            feature = "--preempt" if ecfg.preempt else "--session-cache"
            raise ValueError(
                f"family {cfg.family!r} cannot serve {feature}: its "
                "recurrent slot state has no evacuate/restore ops to "
                f"swap through — drop {feature}")
        if ecfg.paged:
            if not self.api.supports_paged:
                raise ValueError(f"family {cfg.family!r} cannot serve paged: "
                                 "its recurrent decode state is not "
                                 "page-addressable")
            if ecfg.capacity % ecfg.page_size:
                raise ValueError(f"capacity {ecfg.capacity} not a multiple of "
                                 f"page_size {ecfg.page_size}")
            pool_pages = (ecfg.pool_pages if ecfg.pool_pages is not None
                          else ecfg.max_batch * ecfg.capacity // ecfg.page_size)
            pack_cfg = dataclasses.replace(pack_cfg, paged=True,
                                           page_size=ecfg.page_size,
                                           pool_pages=pool_pages)
        # a multi-step launch, where the family has one (the recurrent
        # families decode a step a launch)
        self._decode_multi = self.api.decode_multi
        # rwkv6 keeps no KV cache: nothing to calibrate
        self.pack_cfg = (self._calibrate(pack_cfg)
                         if ecfg.calibrate and pack_cfg.policy == "packkv"
                         and cfg.family != "rwkv6" else pack_cfg)

    def _build_mesh(self, cfg: ArchConfig, ecfg: EngineConfig) -> Mesh | None:
        """The serving mesh, or None at (1, 1); refuses what cannot shard."""
        mesh_shape = tuple(ecfg.mesh_shape)
        if mesh_shape == (1, 1):
            return None
        n_dp, n_kv = mesh_shape
        if n_dp < 1 or n_kv < 1:
            raise ValueError(f"mesh_shape must be positive, got {mesh_shape}")
        if cfg.family in ("rwkv6", "hybrid_rglru"):
            raise ValueError(
                f"family {cfg.family!r} cannot serve --mesh: its "
                "recurrent slot state has no KV-head axis to shard "
                "over the 'kv' mesh axis — drop --mesh (single-device "
                "serving still applies)")
        if cfg.n_kv_heads % n_kv:
            raise ValueError(
                f"n_kv_heads {cfg.n_kv_heads} not divisible by "
                f"kv_shards {n_kv} — pool payloads shard by whole KV heads")
        n = n_dp * n_kv
        devices = ecfg.mesh_devices
        if devices is None and self.device.type == "cpu":
            devices = ("cpu",) * n
        elif devices is None:
            n_dev = torch.cuda.device_count()
            if n_dev < n:
                raise ValueError(
                    f"mesh {n_dp}x{n_kv} needs {n} devices, have {n_dev} "
                    "(one card: name it more than once in "
                    f"EngineConfig.mesh_devices, e.g. ('cuda:0',) * {n})")
            devices = tuple(f"cuda:{i}" for i in range(n))
        return Mesh(n_dp, n_kv, tuple(devices))

    def _checked(self, cache):
        """``cache``, after checking (debug mode, on a mesh) that every
        lane's ledger is lane (0, 0)'s and every dp twin's bytes its own."""
        if self.mesh is not None and self.ecfg.debug_invariants:
            assert ledgers_agree(cache), "mesh lanes diverged"
        return cache

    # -- calibration --------------------------------------------------------
    def _calibrate(self, pack_cfg: PackKVConfig) -> PackKVConfig:
        S = self.ecfg.calib_tokens
        rng = np.random.default_rng(0)
        batch = {"tokens": torch.as_tensor(rng.integers(0, self.cfg.vocab, (1, S)),
                                           dtype=torch.int32, device=self.device)}
        patches = self.cfg.input_mode == "tokens_patches"
        if patches:  # drawn after the tokens, from the same generator
            batch["patches"] = self._patches(
                rng.normal(size=(1, self.cfg.n_patches, self.cfg.d_model)))
        # calibration reads raw K/V from a dense layout
        none_cfg = dataclasses.replace(pack_cfg, policy="none", paged=False)
        blk = pack_cfg.block
        cap = max(S + self.cfg.n_patches * patches, blk)
        cap = -(-cap // blk) * blk
        _, cache = self.api.prefill(self.params, self.cfg, none_cfg, cap, batch)
        if self.cfg.family == "hybrid_rglru":
            # the window caches hold the prompt's last min(S, window) tokens
            cache = cache.cache
            n = min(int(min(int(c.n_comp.min()) for c in cache)), self.cfg.window)
        else:
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

    def _patches(self, patches) -> torch.Tensor:
        """Patch embeddings as f32 on the device (the model casts them to
        bf16; from float64 numpy that is the reference's two roundings)."""
        if not isinstance(patches, torch.Tensor):
            patches = torch.from_numpy(np.asarray(patches))
        return patches.to(device=self.device, dtype=torch.float32)

    def prefill(self, batch: dict):
        """Prefill a batch of equal-length prompts (a VLM's with its
        ``patches``). Returns (last-token logits [B, V], cache)."""
        inputs = {"tokens": self._tokens(batch["tokens"])}
        if "patches" in batch:
            inputs["patches"] = self._patches(batch["patches"])
        mesh = {} if self.mesh is None else {"mesh": self.mesh}
        return self.api.prefill(self.params, self.cfg, self.pack_cfg,
                                self.ecfg.capacity, inputs, **mesh)

    @property
    def rows(self) -> int:
        """Positions a batch row of every decode GEMM: the verify window."""
        return self.ecfg.spec_k + 1

    def decode(self, cache, token, n_bucket: int | None = None):
        logits, cache = self.api.decode_step(
            self.params, self.cfg, cache, self._tokens(token),
            backend=self.ecfg.backend, n_bucket=n_bucket, rows=self.rows)
        return logits, self._checked(cache)

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
        return toks.cpu().numpy(), n_exec, self._checked(cache)

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
        return both[:, :-1], both[:, -1], self._checked(cache)

    def bucket_for(self, n_max: int) -> int | None:
        """Launch bucket covering ``n_max`` compressed tokens (None = full).
        Paged engines raise the unit to the page size, so every bucket is
        a whole number of pages. The recurrent families take None: their
        state is O(1) or bounded by the window, with no capacity to cut."""
        if not self.ecfg.bucketed or not self.api.supports_paged:
            return None
        unit = self.ecfg.bucket_unit
        if self.ecfg.paged:
            unit = max(unit, self.ecfg.page_size)
        return bucket_length(n_max, self.ecfg.capacity, unit)

    def alloc_slot_cache(self):
        """Slot-table decode cache: max_batch rows, per-row counters (on a
        mesh, a ``MeshCache``: each lane's head block on its device)."""
        mesh = {} if self.mesh is None else {"mesh": self.mesh}
        return self.api.alloc_cache(self.cfg, self.pack_cfg, self.ecfg.max_batch,
                                    self.ecfg.capacity, self.device, **mesh)

    def insert_request(self, cache, slot: int, tokens):
        """Single-slot prefill-insert; returns (last logits [V], cache)."""
        logits, cache = self.api.prefill_into_slot(
            self.params, self.cfg, self.pack_cfg, self.ecfg.capacity, cache,
            slot, {"tokens": self._tokens(tokens)[None]})
        return logits[0], self._checked(cache)

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
        return self._checked(self.api.prefill_chunk_insert(
            self.cfg, self.pack_cfg, self.ecfg.capacity, cache, slot, scratch))

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
        return logits[0], self._checked(cache)

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
        return self._checked(self.api.prefix_chunk_insert(
            self.pack_cfg, cache, slot, mini, self._page_ids(pages),
            n_prefix=len(pages) * self.ecfg.page_size, prompt_len=prompt_len))

    def _per_lane(self, cache, op, ids):
        """``op(layers, ids)`` in every lane, ``ids`` on the lane's device."""
        ids = self._page_ids(ids)
        for _, layers in lane_lists(cache):
            op(layers, ids.to(layers[0].n_comp.device))
        return self._checked(cache)

    def index_acquire(self, cache, ids):
        """Pin pages for the prefix index (+1 reference each)."""
        return self._per_lane(cache, acquire_pages, ids)

    def index_release(self, cache, ids):
        """Unpin evicted index pages (-1 reference; freed at zero)."""
        return self._per_lane(cache, release_pages, ids)

    def free_slot(self, cache, slot: int):
        return self._checked(self.api.reset_slot(cache, slot))

    def evacuate(self, cache, slot: int, n_pages: int, n_shared: int = 0):
        """Swap row ``slot`` out: (cache with the row freed, per-layer
        dense B=1 minis holding its owned bytes, on the device).
        ``n_pages``: the row's live pages (host-mirrored); ``n_shared``:
        its shared prefix pages, released by reference, not copied."""
        cache, mini = self.api.evacuate_slot(cache, slot, n_pages, n_shared)
        return self._checked(cache), mini

    def restore(self, cache, slot: int, mini, shared_phys=(), n_pages: int = 0,
                n_shared: int = 0):
        """Stream evacuated minis (host or device) back into ``slot``; no
        forward pass."""
        return self._checked(self.api.restore_slot(
            cache, slot, to_device(mini, self.device), self._page_ids(shared_phys),
            n_pages, n_shared))

    def mask_free(self, cache, active):
        return self._checked(self.api.mask_free(cache, torch.as_tensor(
            np.asarray(active, bool), device=self.device)))

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
    # admission class, 0 the most urgent: FIFO within a class, lower
    # classes delayed but never starved (EngineConfig.aging_steps)
    priority: int = 0
    # wall-clock budget in ms from submit: past it the request retires as
    # 'expired' at the next scheduler step, partial output kept
    deadline_ms: float | None = None
    # queued -> active -> done | cancelled | expired | parked (a preempted
    # request goes back to queued in its place; 'parked' is a forced end of
    # turn, partial output kept, the cache parked when sessions are on)
    status: str = "queued"
    # latency (wall-clock seconds, filled by SlotServer):
    t_submit: float = 0.0  # stamped by submit()
    t_first: float | None = None  # first token (TTFT = t_first - t_submit)
    token_times: list = dataclasses.field(default_factory=list)  # one per
    #   token; the tokens of one multi-step launch share a time
    n_preempts: int = 0  # times swapped out mid-decode
    _seq: int = dataclasses.field(default=0, repr=False)  # global submit order
    _enq_step: int = dataclasses.field(default=0, repr=False)  # step when
    #   (re)queued: the aging clock

    def cancel(self) -> None:
        """Ask for cancellation: honoured at the next scheduler step,
        whether the request is queued, mid-prefill, swapped out or
        decoding (partial output kept)."""
        self._cancelled = True

    @property
    def cancelled(self) -> bool:
        return getattr(self, "_cancelled", False)


@dataclasses.dataclass
class SlotStats:
    """Scheduler telemetry (the reference's counters; the per-launch log
    is not kept)."""

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
    # preemption (zeros when it is off):
    preemptions: int = 0  # slots swapped out for a higher class
    swapped_pages: int = 0  # pool pages evacuated to the SwapStore
    restored_pages: int = 0  # pool pages streamed back on resume
    cancelled: int = 0  # requests retired by Request.cancel()
    expired: int = 0  # requests retired past their deadline_ms
    degraded_steps: int = 0  # launches run plain after the watchdog turned
    #   speculation off
    # session cache (zeros when it is off):
    session_lookups: int = 0  # admissions that consulted the session store
    session_parks: int = 0  # retiring slots parked host-side
    session_hits: int = 0  # admissions served from a parked session
    session_evictions: int = 0  # parked entries lost (capacity, TTL, invalid)
    session_restored_pages: int = 0  # pool pages streamed back on hits

    @property
    def acceptance_rate(self) -> float:
        return self.spec_accepted / self.spec_drafted if self.spec_drafted else 0.0

    @property
    def session_hit_rate(self) -> float:
        return self.session_hits / self.session_lookups if self.session_lookups else 0.0

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

    def to_json(self) -> dict:
        """Every counter and the derived rates, JSON-serializable."""
        d = dataclasses.asdict(self)
        d.update(occupancy=self.occupancy, decode_tok_s=self.decode_tok_s,
                 prefix_hit_rate=self.prefix_hit_rate,
                 acceptance_rate=self.acceptance_rate,
                 session_hit_rate=self.session_hit_rate)
        return d


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
    """One occupied slot: the request plus its generation state.

    ``forced`` is a session resume's teacher-forced queue (the returning
    turn's uncached suffix): while it is not empty the decode launches
    still append to the row's cache, but each launch's argmax is replaced
    on the host by the next forced token, and nothing is emitted. ``base``
    re-anchors the host counter mirror (``SlotServer._counters``) of a row
    whose cache did not come from prefilling its own prompt (a session
    resume, or a preemption of one): ``(n_comp0, n_resid0, cached0,
    out0)`` at the anchor."""

    __slots__ = ("req", "out", "done", "forced", "k0", "base")

    def __init__(self, req: Request, first_tok: int | None, eos_id: int | None,
                 forced=None, base=None):
        self.req = req
        self.forced: list[int] = list(forced) if forced else []
        self.k0 = len(self.forced)  # forced tokens at the anchor
        self.base = base
        if first_tok is None:  # a resume: nothing emitted yet
            self.out: list[int] = []
            self.done = False
        else:
            self.out = [first_tok]
            self.done = (eos_id is not None and first_tok == eos_id) or req.max_new <= 1

    @property
    def remaining(self) -> int:
        return self.req.max_new - len(self.out)

    @property
    def cached_tokens(self) -> int:
        """Host mirror of the row's cache occupancy (n_comp + n_resid): the
        prompt plus every generated token but the last (not yet appended).
        A re-anchored row counts from its anchor: every drained forced
        token and every emitted token is one append."""
        if self.base is not None:
            _, _, cached0, out0 = self.base
            return cached0 + (self.k0 - len(self.forced)) + (len(self.out) - out0)
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

    Each step: (1) FAULTS and REAP - fire the fault plan's events for this
    step, then retire cancelled and expired work wherever it is; (2) ADMIT
    - advance the pending admission by one bounded prefill chunk, the last
    inserting the finished row into its claimed slot
    (``prefill_chunk_pages = 0``: seat queue heads by one monolithic
    prefill-insert each); (3) DECODE - one batched greedy launch of up to
    ``decode_chunk`` steps over the whole table (free rows ride along,
    masked), retiring rows that hit EOS or ``max_new``. Per-request greedy
    outputs equal a batch-size-1 ``Engine.generate`` run (per-row state,
    per-row positions, row-independent attention; chunk boundaries are
    exact resume points, ``models.layers.resume_attention``).

    Requests carry a priority class: admission takes the per-class FIFO
    head with the smallest (class lowered by aging, submit order).

    PAGED engines admit on FREE PAGES: each admitted request reserves its
    worst-case page count (``ceil(min(capacity, prompt + max_new) /
    page_size)``) and admission blocks, class and FIFO order kept, while
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
    ``StragglerMonitor()`` when speculating) watches each decode launch's
    wall time; its 'exclude' verdict turns speculation off for the rest
    of the run.

    PREEMPTIVE engines (``EngineConfig.preempt``): when a head cannot seat
    (no free slot, or too few pages after index eviction) a strictly
    lower-class victim is swapped OUT: its compressed pages, residual and
    counters go to a host ``SwapStore`` (``Engine.evacuate``; shared
    prefix pages release their reference instead), and it requeues in its
    original order with its tokens so far. On re-admission the row
    streams back (``Engine.restore``, no forward pass) and decoding
    resumes bitwise as if never interrupted. ``Request.cancel()`` and
    ``deadline_ms`` retire work at the next step through the same paths,
    and a ``distributed.fault.FaultPlan`` (``fault_plan``) drives all of
    it deterministically.

    SESSION-CACHE engines (``EngineConfig.session_cache``): a retiring row
    is evacuated into a host ``SessionStore`` (``session_store``, default
    one from the engine config) keyed by its token trace. A returning turn
    whose prompt extends a parked trace restores the row with no forward
    pass over it and ingests only its new suffix, teacher-forced through
    the ordinary decode launches, so a hit is bitwise equal to never
    having parked.
    """

    def __init__(self, engine: Engine, eos_id: int | None = None,
                 drafter: NGramDrafter | None = None,
                 fault_plan: FaultPlan | None = None,
                 straggler: StragglerMonitor | None = None,
                 session_store: SessionStore | None = None):
        if engine.cfg.input_mode != "tokens":
            raise ValueError(f"input_mode {engine.cfg.input_mode!r} is not "
                             "servable per slot")
        self.engine = engine
        self.eos_id = eos_id
        ecfg = engine.ecfg
        self._drafter = (drafter or NGramDrafter()) if ecfg.spec_decode else None
        self._watchdog = straggler if straggler is not None else (
            StragglerMonitor() if ecfg.spec_decode else None)
        self._spec_degraded = False  # set once the watchdog says exclude
        self._spec_backoff = [0] * ecfg.max_batch
        self._spec_cooldown = [0] * ecfg.max_batch
        self.n_slots = ecfg.max_batch
        self.cache = None  # allocated on first admission
        self.slots: list[_Active | None] = [None] * self.n_slots
        self._ever_used = [False] * self.n_slots
        self._last_tok = np.zeros((self.n_slots,), np.int32)
        self.queues: dict[int, deque[Request]] = {}  # class -> FIFO
        self.done: dict[int, Request] = {}
        self.stats = SlotStats(n_slots=self.n_slots)
        self._reserved: dict[int, int] = {}  # slot -> pages it may NEWLY pop
        self._index = PrefixIndex(ecfg.page_size) if ecfg.prefix_cache else None
        self._slot_shared: dict[int, tuple[int, ...]] = {}  # slot -> mapped pages
        self._task: _PrefillTask | None = None  # in-flight chunked admission
        self._swap = SwapStore() if ecfg.preempt else None
        self._sessions: SessionStore | None = None
        if ecfg.session_cache:
            self._sessions = session_store if session_store is not None else SessionStore(
                capacity_bytes=ecfg.session_cache_mb << 20, ttl_s=ecfg.session_ttl_s,
                disk_dir=ecfg.session_disk_dir)
        self._fault_rid = 1_000_000_000  # request ids of fault-made sessions
        self._seq = 0  # global submit stamp (FIFO order within a class)
        self._step_no = 0  # scheduler steps (the aging and fault clock)
        self._faults = fault_plan
        self._squeeze = 0  # pool pages a pool_squeeze fault holds back

    @property
    def queue(self) -> list[Request]:
        """Every queued request: classes ascending, FIFO within each (a
        view; submit through ``submit``)."""
        return [r for p in sorted(self.queues) for r in self.queues[p]]

    # -- paged admission accounting ----------------------------------------
    @property
    def _pages_avail(self) -> int:
        """Pool pages not spoken for: total minus the watermark and a
        squeeze fault's hold-back, minus every slot's reservation of pages
        it may newly pop, minus the pages the prefix index pins
        (reclaimable on demand, ``_evict_to_fit``)."""
        total = self.engine.pack_cfg.pool_pages
        held = self._index.n_held if self._index is not None else 0
        return (total - self.engine.ecfg.page_watermark - self._squeeze
                - sum(self._reserved.values()) - held)

    def _pages_needed(self, req: Request) -> int:
        """Worst-case resident pages over the request's lifetime: its
        compressed tokens never exceed min(capacity, prompt + max_new)."""
        ecfg = self.engine.ecfg
        return cdiv(min(ecfg.capacity, len(req.tokens) + req.max_new),
                    ecfg.page_size)

    def _fit_pages(self, head: Request, need_new: int, protected: set[int]) -> bool:
        """Make ``need_new`` pages reservable for ``head``: evict cold index
        prefixes first, then swap lower-class victims out; a miss is one
        admission block (class and FIFO order kept: the head waits)."""
        while not self._evict_to_fit(need_new, protected):
            if not self._swap_out_one(head):
                self.stats.admission_blocks += 1
                return False
        return True

    def _reserve(self, slot: int, req: Request, n_shared: int) -> None:
        """Reserve the pages ``req`` may newly pop: shared pages reserve
        none."""
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
        """Shared pages a live slot maps by reference, and those a
        swapped-out request will map back on resume (its slot released its
        references, so only the index pins them until it resumes or dies)."""
        live = {p for t in self._slot_shared.values() for p in t}
        if self._swap is not None:
            for meta in self._swap.metas():
                live.update(meta["shared"])
        return live

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
        if req.priority < 0:
            raise ValueError(f"request {req.rid}: priority must be >= 0")
        if req.deadline_ms is not None and req.deadline_ms <= 0:
            # a deadline already past is a caller's bug, not traffic
            raise ValueError(f"request {req.rid}: deadline_ms must be > 0")
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
        req.t_submit = time.perf_counter()
        req._seq = self._seq
        self._seq += 1
        req._enq_step = self._step_no
        self.queues.setdefault(req.priority, deque()).append(req)

    def _head(self) -> Request | None:
        """The next request to admit: among the per-class FIFO heads, the
        one with the smallest (effective class, submit order). Aging lowers
        a waiting head's class by one every ``aging_steps`` steps, so a
        flood of a higher class delays lower ones but never starves them;
        0 is strict priority."""
        ag = self.engine.ecfg.aging_steps
        best, best_key = None, None
        for p, q in self.queues.items():
            if not q:
                continue
            h = q[0]
            eff = max(0, p - (self._step_no - h._enq_step) // ag) if ag > 0 else p
            key = (eff, h._seq)
            if best_key is None or key < best_key:
                best, best_key = h, key
        return best

    def _pop_head(self, head: Request) -> Request:
        got = self.queues[head.priority].popleft()
        assert got is head
        return got

    def _requeue(self, req: Request) -> None:
        """Put a preempted or aborted request back in its class at its
        ORIGINAL submit order."""
        req.status = "queued"
        req._enq_step = self._step_no
        q = self.queues.setdefault(req.priority, deque())
        pos = 0
        while pos < len(q) and q[pos]._seq < req._seq:
            pos += 1
        q.insert(pos, req)

    @property
    def n_occupied(self) -> int:
        return sum(s is not None for s in self.slots)

    # -- retirement (the one path out of a slot) ----------------------------
    def _release_slot(self, i: int, free_pages: bool = True) -> None:
        """Free slot ``i``: its drafter row, page reservation and shared
        prefix mapping, and, unless an evacuation already returned its
        pages, the device row. Every way out of a slot (EOS, max_new,
        cancel, deadline, preemption, park) comes through here."""
        self.slots[i] = None
        if self._drafter is not None:
            self._drafter.drop(i)
        if free_pages:
            self.cache = self.engine.free_slot(self.cache, i)
        self._reserved.pop(i, None)
        self._slot_shared.pop(i, None)  # its shared pages' refs went with it
        self._check_invariants()

    def _retire_slot(self, i: int, reason: str = "done") -> Request:
        """Finish slot ``i``'s request (reason: done | cancelled | expired
        | parked) and free the slot. A natural or forced end of turn
        (done, parked) parks the row in the session store when it is on;
        cancelled and expired work is dropped."""
        act = self.slots[i]
        act.req.output = np.asarray(act.out, np.int32)
        act.req.status = reason
        self.done[act.req.rid] = act.req
        parked = reason in ("done", "parked") and self._park_row(i)
        # a parked row was evacuated: its pages are back in the pool
        self._release_slot(i, free_pages=not parked)
        if reason == "done":
            self.stats.completed += 1
        elif reason == "cancelled":
            self.stats.cancelled += 1
        elif reason == "expired":
            self.stats.expired += 1
        return act.req

    def _evacuate(self, i: int, act: _Active):
        """Evacuate slot ``i``'s row: (mini, n_pages, n_shared, shared
        pages, (n_comp, n_resid)) from the host counter mirror."""
        c, r = self._counters(act)
        shared = tuple(self._slot_shared.get(i, ()))
        n_pages = n_shared = 0
        if self.engine.ecfg.paged:
            n_pages = cdiv(c, self.engine.ecfg.page_size)
            n_shared = len(shared)
        self.cache, mini = self.engine.evacuate(self.cache, i, n_pages, n_shared)
        return mini, n_pages, n_shared, shared, (c, r)

    # -- session cache: park and resume --------------------------------------
    def _park_row(self, i: int) -> bool:
        """Park slot ``i``'s row in the session store at retirement, keyed
        by its cached token trace: the first ``cached_tokens + 1`` tokens
        of prompt + output (the +1 is the pending seed, not yet appended),
        exact for a finished, a force-parked or a still-ingesting row.
        Shared prefix pages release their references; their trie nodes are
        kept so a resume can prove the index still holds the same pages.
        True when the row was evacuated (release it without freeing)."""
        if self._sessions is None or self.cache is None:
            return False
        act = self.slots[i]
        trace = np.concatenate([np.asarray(act.req.tokens, np.int64),
                                np.asarray(act.out, np.int64)])[:act.cached_tokens + 1]
        nodes: list = []
        if self._slot_shared.get(i) and self._index is not None:
            parent = None
            for chunk in self._index.chunks(trace)[:len(self._slot_shared[i])]:
                parent = self._index.descend(parent, chunk)
                assert parent is not None  # live shared pages are not evicted
                nodes.append(parent)
        mini, n_pages, n_shared, shared, counters = self._evacuate(i, act)
        self._sessions.put(trace, mini, dict(
            last_tok=int(self._last_tok[i]), n_pages=n_pages, n_shared=n_shared,
            shared=shared, nodes=tuple(nodes), counters=counters))
        self.stats.session_parks += 1
        return True

    def _session_valid(self, meta: dict) -> bool:
        """A parked entry's shared prefix is servable iff the SAME trie
        nodes still hold the SAME pages (parking holds no device
        reference, so the index may have evicted the chain meanwhile;
        evicted nodes never come back)."""
        if self._index is None:
            return False
        node = None
        for want, page in zip(meta["nodes"], meta["shared"]):
            node = self._index.descend(node, want.chunk)
            if node is not want or node.page != page:
                return False
        for n in meta["nodes"]:
            self._index.touch(n)
        return True

    def _session_try(self, head: Request, slot: int) -> str:
        """Serve ``head`` from a parked session: "hit" (popped and
        restored into ``slot``), "blocked" (an entry matches but its pages
        do not fit yet; it is kept and admission retries) or "miss"."""
        if self._sessions is None or self.cache is None:
            return "miss"
        while True:
            key = self._sessions.match(head.tokens)
            if key is None:
                return "miss"
            meta = self._sessions.meta(key)
            if meta["n_shared"] and not self._session_valid(meta):
                self._sessions.drop(key)
                continue
            if self.engine.ecfg.paged and not self._fit_pages(
                    head, self._pages_needed(head) - meta["n_shared"],
                    set(meta["shared"])):
                return "blocked"
            req = self._pop_head(head)
            mini, meta = self._sessions.take(key)
            self.stats.session_lookups += 1
            self._session_resume(req, slot, len(key) // 8, mini, meta)
            return "hit"

    def _session_resume(self, req: Request, i: int, trace_len: int, mini,
                        meta: dict) -> None:
        """Restore a parked row into slot ``i`` (its shared prefix mapped
        back by reference; no forward pass) and queue the prompt's
        uncached suffix for teacher-forced ingestion. The counter anchor
        pins ``_counters`` to the parked row's exact (n_comp, n_resid)."""
        self._reserve(i, req, meta["n_shared"])
        self.cache = self.engine.restore(self.cache, i, mini, meta["shared"],
                                         meta["n_pages"], meta["n_shared"])
        if meta["shared"]:
            self._slot_shared[i] = tuple(meta["shared"])
        c0, r0 = meta["counters"]
        forced = [int(t) for t in np.asarray(req.tokens)[trace_len:]]
        self.slots[i] = _Active(req, None, self.eos_id, forced=forced,
                                base=(c0, r0, trace_len - 1, 0))
        req.status = "active"
        self._last_tok[i] = meta["last_tok"]
        self._spec_backoff[i] = self._spec_cooldown[i] = 0
        if self._drafter is not None:
            self._drafter.seed(i, [int(t) for t in np.asarray(req.tokens)[:trace_len]])
        if self._ever_used[i]:
            self.stats.slot_reuses += 1
        self._ever_used[i] = True
        self.stats.admitted += 1
        self.stats.session_hits += 1
        self.stats.session_restored_pages += meta["n_pages"] - meta["n_shared"]
        self._check_invariants()

    def _fault_resume(self, n: int) -> None:
        """Submit up to ``n`` returning sessions built from the oldest
        parked traces (a fixed 3-token suffix, request ids far above real
        traffic); one that admission would refuse is skipped."""
        if self._sessions is None:
            return
        for trace in self._sessions.traces(n):
            toks = np.concatenate([trace, np.zeros((3,), np.int64)])
            req = Request(rid=self._fault_rid, max_new=2, tokens=toks)
            self._fault_rid += 1
            try:
                self.submit(req)
            except ValueError:
                continue

    # -- preemption: swap out and resume --------------------------------------
    def _swap_out_one(self, head: Request) -> bool:
        """Swap ONE victim out to make room for ``head``. Victims are of a
        strictly lower class (the raw priority: aging moves a head's turn,
        not its right to preempt, so a victim never bounces back into its
        preemptor); among them the lowest class with the most work left,
        the lowest slot on ties. Its owned bytes go to the SwapStore, its
        shared prefix pages release their references, and it requeues at
        its original submit order."""
        if self._swap is None:
            return False
        cand = [i for i in range(self.n_slots) if self.slots[i] is not None
                and self.slots[i].req.priority > head.priority]
        if not cand:
            return False
        i = max(cand, key=lambda j: (self.slots[j].req.priority,
                                     self.slots[j].remaining, -j))
        act = self.slots[i]
        req = act.req
        mini, n_pages, n_shared, shared, (c, r) = self._evacuate(i, act)
        # the re-anchor and the forced queue make the swap exact for any
        # row, a session resume preempted mid-ingestion included
        self._swap.put(req.rid, mini, dict(
            out=list(act.out), last_tok=int(self._last_tok[i]), n_pages=n_pages,
            n_shared=n_shared, shared=shared, forced=list(act.forced),
            base=(c, r, act.cached_tokens, len(act.out))))
        req.n_preempts += 1
        self._requeue(req)
        self._release_slot(i, free_pages=False)  # the evacuation freed the row
        self.stats.preemptions += 1
        self.stats.swapped_pages += n_pages - n_shared
        return True

    def _resume(self, req: Request, i: int) -> None:
        """Re-admit a swapped-out request into slot ``i``: its pages stream
        back (shared prefix mapped by reference) and it continues from its
        saved seed token. No forward pass runs: the seed was never cached,
        as if the preemption had not happened."""
        mini, meta = self._swap.pop(req.rid)
        self._reserve(i, req, meta["n_shared"])
        self.cache = self.engine.restore(self.cache, i, mini, meta["shared"],
                                         meta["n_pages"], meta["n_shared"])
        if meta["shared"]:
            self._slot_shared[i] = tuple(meta["shared"])
        act = _Active(req, None, self.eos_id, forced=meta["forced"], base=meta["base"])
        act.out = list(meta["out"])
        self.slots[i] = act
        req.status = "active"
        self._last_tok[i] = meta["last_tok"]
        self._spec_backoff[i] = self._spec_cooldown[i] = 0
        self._ever_used[i] = True
        if self._drafter is not None:
            # the drafter mirrors the CACHED sequence and the pending seed:
            # a row preempted mid-ingestion has seen a prompt prefix
            n_seen = act.cached_tokens + 1 - len(act.out)
            self._drafter.seed(i, [int(t) for t in np.asarray(req.tokens)[:n_seen]]
                               + list(act.out))
        self.stats.restored_pages += meta["n_pages"] - meta["n_shared"]
        self._check_invariants()

    def _seat(self, head: Request) -> int | None:
        """A free slot for ``head``, swapping lower-class victims out one
        at a time when preemption is on and the table is full."""
        while None not in self.slots:
            if not self._swap_out_one(head):
                return None
        return self.slots.index(None)

    def _try_resume(self, head: Request, slot: int) -> bool | None:
        """Resume ``head`` into ``slot`` if it is swapped out: True when
        resumed, False when its pages do not fit yet, None when it is not
        swapped out."""
        if self._swap is None or head.rid not in self._swap:
            return None
        meta = self._swap.meta(head.rid)
        if self.engine.ecfg.paged and not self._fit_pages(
                head, self._pages_needed(head) - meta["n_shared"], set(meta["shared"])):
            return False
        self._resume(self._pop_head(head), slot)
        return True

    # -- admission ------------------------------------------------------------
    def _claim(self, head: Request, slot: int):
        """Cold admission of ``head`` into ``slot``: its prefix match and,
        paged, room for its page reservation. Returns (request, pages,
        perms), the request popped and reserved, or None while blocked."""
        pages, perms = [], None
        if self._index is not None and self.cache is not None:
            pages, perms = self._match(head)
        if self.engine.ecfg.paged and not self._fit_pages(
                head, self._pages_needed(head) - len(pages), set(pages)):
            return None
        req = self._pop_head(head)
        if self._sessions is not None:
            self.stats.session_lookups += 1  # a cold admission is a miss
        if self.cache is None:
            self.cache = self.engine.alloc_slot_cache()
        self._reserve(slot, req, len(pages))
        return req, pages, perms

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
            logits, self.cache = self.engine.insert_request(self.cache, i, req.tokens)
        self._seated(req, i, logits, finished)

    def _seated(self, req: Request, i: int, logits, finished: list[Request]):
        self._activate(req, i, int(torch.argmax(logits)))
        self._check_invariants()
        if self.slots[i].done:  # max_new == 1 or instant EOS
            finished.append(self._retire_slot(i))

    def _admit(self) -> list[Request]:
        """Monolithic admission sweep (``prefill_chunk_pages == 0``): seat
        queue heads (swapped-out ones resume, parked sessions restore,
        fresh ones prefill in one dispatch) until the queue drains or
        admission blocks."""
        finished: list[Request] = []
        while (head := self._head()) is not None:
            i = self._seat(head)
            if i is None:
                break
            resumed = self._try_resume(head, i)
            if resumed is not None:
                if not resumed:
                    break
                continue
            hit = self._session_try(head, i)
            if hit == "hit":
                continue
            if hit == "blocked":
                break
            claim = self._claim(head, i)
            if claim is None:
                break
            req, pages, perms = claim
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
        now = time.perf_counter()
        req.t_first = now
        req.token_times.append(now)
        self.stats.admitted += 1
        self.stats.tokens_out += 1
        if self._ever_used[i]:
            self.stats.slot_reuses += 1
        self._ever_used[i] = True

    def _start_task(self, finished: list[Request]) -> _PrefillTask | None:
        """Seat the queue head and build its chunked admission; None while
        blocked, or when it completed here: a swapped-out head resumes and
        a parked session restores (one scatter each, no prefill), and,
        without a prefix cache, a prompt within one chunk budget takes the
        monolithic insert (one dispatch either way). With a prefix cache
        every admission runs its page segments (a cold one calibrates on
        its first page, which is what makes a later hit exact)."""
        head = self._head()
        if head is None:
            return None
        slot = self._seat(head)
        if slot is None:
            return None
        if self._try_resume(head, slot) is not None:
            return None
        if self._session_try(head, slot) != "miss":
            return None  # a hit restored; a blocked entry waits for pages
        claim = self._claim(head, slot)
        if claim is None:
            return None
        req, pages, perms = claim
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
        every row's n_comp through the whole chunk. While a row ingests
        forced tokens the launch takes one step (its token is replaced on
        the host after each)."""
        occupied = [a for a in self.slots if a is not None]
        n_steps = max(1, min(self.engine.ecfg.decode_chunk,
                             min(a.remaining for a in occupied)))
        if any(a.forced for a in occupied):
            n_steps = 1
        n_max = max(a.cached_tokens for a in occupied) + n_steps
        return n_steps, self.engine.bucket_for(n_max)

    # -- cancellation, deadlines, faults --------------------------------------
    def _finish_dead(self, req: Request, why: str, finished: list[Request]) -> None:
        """Retire a request that is not in a slot (queued, swapped out or
        mid-prefill): its output is what it had generated before a swap-out
        (empty otherwise)."""
        out: list[int] = []
        if self._swap is not None and req.rid in self._swap:
            out = self._swap.meta(req.rid)["out"]
            self._swap.drop(req.rid)
        req.output = np.asarray(out, np.int32)
        req.status = why
        self.done[req.rid] = req
        if why == "cancelled":
            self.stats.cancelled += 1
        else:
            self.stats.expired += 1
        finished.append(req)

    def _abort_task(self) -> None:
        """Drop the in-flight chunked admission at its chunk boundary. It
        holds no device pages (a plain task until its final chunk, a prefix
        task until ``prefix_chunk_finish``), so only its reservation goes
        back."""
        t, self._task = self._task, None
        self._reserved.pop(t.slot, None)
        self._check_invariants()

    def _reap(self, finished: list[Request]) -> None:
        """Honour ``cancel()`` and ``deadline_ms`` at the top of the step,
        before any new work launches, for queued, swapped-out,
        mid-prefill and decoding requests alike."""
        now = time.perf_counter()

        def dead(req: Request) -> str | None:
            if req.cancelled:
                return "cancelled"
            if req.deadline_ms is not None and (now - req.t_submit) * 1e3 > req.deadline_ms:
                return "expired"
            return None

        for q in self.queues.values():
            for req in [r for r in q if dead(r)]:
                q.remove(req)
                self._finish_dead(req, dead(req), finished)
        if self._task is not None and dead(self._task.req):
            req = self._task.req
            self._abort_task()
            self._finish_dead(req, dead(req), finished)
        for i in range(self.n_slots):
            act = self.slots[i]
            if act is not None and (why := dead(act.req)) is not None:
                finished.append(self._retire_slot(i, why))

    def _fault_victims(self, n: int) -> list[Request]:
        """The cancel and deadline storms' victims: occupied slots
        ascending, then queued requests in submit order, then the in-flight
        prefill."""
        out = [a.req for a in self.slots if a is not None][:n]
        queued = sorted((r for q in self.queues.values() for r in q), key=lambda r: r._seq)
        out += queued[:n - len(out)]
        if len(out) < n and self._task is not None:
            out.append(self._task.req)
        return out

    def _apply_faults(self, finished: list[Request]) -> None:
        """Fire this step's scheduled faults (``distributed.fault.
        FaultPlan``). They act through the seams real traffic uses (cancel
        flags, deadlines, requeues, parks), so every invariant the
        scheduler keeps must survive them."""
        if self._faults is None:
            return
        for ev in self._faults.at(self._step_no):
            self._faults.fired.append(ev)
            n = max(1, int(ev.arg))
            if ev.kind == "pool_squeeze":
                self._squeeze = max(0, int(ev.arg))
            elif ev.kind in ("cancel", "deadline"):
                for req in self._fault_victims(n):
                    if ev.kind == "cancel":
                        req.cancel()
                    else:
                        req.deadline_ms = 1e-9  # expired at the next reap
            elif ev.kind == "chunk_abort":
                if self._task is not None:
                    req = self._task.req
                    self._abort_task()
                    self._requeue(req)  # its prefill restarts
            elif ev.kind == "straggler":
                self._observe_launch(float(ev.arg))
            elif ev.kind == "park":
                # a voluntary end of turn mid-generation
                for i in [i for i, a in enumerate(self.slots) if a is not None][:n]:
                    finished.append(self._retire_slot(i, "parked"))
            elif ev.kind == "resume":
                self._fault_resume(n)
            elif ev.kind == "session_expire":
                if self._sessions is not None:
                    self._sessions.expire_now(n)

    def step(self) -> list[Request]:
        """Fire faults and reap, admit (one chunk, or a monolithic sweep),
        then one decode launch, retiring finished rows. Returns the
        requests finished now."""
        t0 = time.perf_counter()
        self._step_no += 1
        finished: list[Request] = []
        self._apply_faults(finished)
        self._reap(finished)
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
        if self._sessions is not None:  # the store's own eviction counts
            self.stats.session_evictions = self._sessions.evictions + self._sessions.expired
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
        """The plain launch: a multi-step chunk or a single step (always a
        single step where the family has no multi-step launch)."""
        n_steps, n_bucket = self._chunk_plan()
        if self.engine.ecfg.decode_chunk > 1 and self.engine._decode_multi is not None:
            self._decode_chunk(n_steps, n_bucket, finished)
        else:
            self._decode_single(n_bucket, finished)

    def _emit(self, i: int, t: int, now: float) -> bool:
        """Record token ``t`` for slot ``i``; True once the row is done."""
        act = self.slots[i]
        act.out.append(t)
        if act.req.t_first is None:  # a session hit's first real token
            act.req.t_first = now
        act.req.token_times.append(now)
        self._last_tok[i] = t
        self.stats.tokens_out += 1
        if self._drafter is not None:
            self._drafter.extend(i, (t,))
        act.done = (self.eos_id is not None and t == self.eos_id) or \
            len(act.out) >= act.req.max_new
        return act.done

    def _ingest(self, i: int) -> None:
        """Teacher-forced ingestion (a session resume): the launch appended
        the previous token; the next one is the known prompt token, not
        the argmax, and nothing is emitted."""
        t = self.slots[i].forced.pop(0)
        self._last_tok[i] = t
        if self._drafter is not None:
            self._drafter.extend(i, (t,))

    def _decode_single(self, n_bucket: int | None, finished: list[Request]):
        """Per-token launch (decode_chunk = 1)."""
        logits, self.cache = self.engine.decode(self.cache, self._last_tok[:, None],
                                                n_bucket)
        nxt = torch.argmax(logits, -1).cpu().numpy()
        now = time.perf_counter()
        self.stats.decode_steps += 1
        self.stats.chunk_launches += 1
        for i, act in enumerate(self.slots):
            if act is None:
                continue
            self.stats.occupied_slot_steps += 1
            if act.forced:
                self._ingest(i)
            elif self._emit(i, int(nxt[i]), now):
                finished.append(self._retire_slot(i))
        if self.n_occupied < self.n_slots:
            # free rows got a junk append this step: re-zero their counters
            self.cache = self.engine.mask_free(
                self.cache, [s is not None for s in self.slots])

    def _decode_chunk(self, n_steps: int, n_bucket: int | None,
                      finished: list[Request]):
        """Multi-step launch: up to ``n_steps`` tokens per row. Tokens a
        row produces past its own EOS are discarded (rows are independent);
        ``decode_steps`` re-zeroes free rows after every step. A row that
        ingests forced tokens takes one (the plan's n_steps is 1 then)."""
        active = [a is not None for a in self.slots]
        toks, n_exec, self.cache = self.engine.decode_chunk(
            self.cache, self._last_tok[:, None], active, n_steps, self.eos_id,
            n_bucket)
        now = time.perf_counter()
        self.stats.chunk_launches += 1
        self.stats.decode_steps += n_exec
        self.stats.occupied_slot_steps += n_exec * self.n_occupied
        for i, act in enumerate(self.slots):
            if act is None:
                continue
            if act.forced:
                if n_exec:
                    self._ingest(i)
                continue
            for s in range(n_exec):
                if self._emit(i, int(toks[s, i]), now):
                    break
            if act.done:
                finished.append(self._retire_slot(i))

    # -- speculative decode --------------------------------------------------
    def _counters(self, act: _Active) -> tuple[int, int]:
        """Host mirror of an occupied row's (n_comp, n_resid), exact with
        no device read: prefill compresses every full block, then each
        cached token appends one residual slot, flushing a block whenever
        the residual is full at the append (a paged row stops flushing at
        capacity, as ``core.cache.append_token`` does). A re-anchored row
        (a session resume, or a preemption of one) starts from its
        anchor's exact counters; the flush count is anchor-independent."""
        pack = self.engine.pack_cfg
        if act.base is not None:
            lb, r0, cached0, _ = act.base
            r = r0 + (act.cached_tokens - cached0)
        else:
            S = len(act.req.tokens)
            lb = (S // pack.block) * pack.block
            r = S - lb + len(act.out) - 1  # as if no flush had fired
        f = -(-(r - pack.residual) // pack.block) if r > pack.residual else 0
        if self.engine.ecfg.paged:
            f = min(f, (self.engine.ecfg.capacity - lb) // pack.block)
        return lb + f * pack.block, r - f * pack.block

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
        (emission never overshoots ``max_new``). A row that ingests forced
        tokens rides seed-only (its next token is known); a row in backoff
        sits the pass out, seed only, and its cooldown ticks down."""
        ecfg = self.engine.ecfg
        w = ecfg.spec_k + 1
        toks = np.zeros((self.n_slots, w), np.int32)
        lens = np.ones((self.n_slots,), np.int32)
        any_draft = False
        for i, act in enumerate(self.slots):
            if act is None:
                continue
            toks[i, 0] = self._last_tok[i]
            if act.forced:
                continue
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
        model's own next token, each what plain decode would emit; a row
        that ingests forced tokens takes its next one instead."""
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
        now = time.perf_counter()
        ecfg = self.engine.ecfg
        self.stats.decode_steps += 1
        self.stats.chunk_launches += 1
        self.stats.spec_launches += 1
        for i, act in enumerate(self.slots):
            if act is None:
                continue
            self.stats.occupied_slot_steps += 1
            if act.forced:
                self._ingest(i)
                continue
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
                if self._emit(i, int(hat[i, j]), now):
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
