"""Serving engine: continuous batching over the paged compressed KV pool.

The port of `repro.serve.engine`'s main path, with the JAX engine's
``async_host=False`` semantics: a synchronous loop that admits, dispatches
one fused-sampling decode step, reads the (B,) tokens back and retires.

  * `prefill_compressed_paged` — raw prefill of one admission bucket, then
    ONE `fused_compress` call per plan segment (K and V of every layer of
    the segment) into the per-segment update tree the pool splices in.
  * `decode_step_compressed` — per layer each slot writes its token into
    its raw 8-token tail; slots whose tail filled flush it through ONE
    `fused_compress` call into the page the engine reserved; attention is
    ONE `fused_attend_paged` call streaming int8 pages through the block
    table.  Whether any row flushes is decided once per step, so steps
    without a flush launch no compress kernel.
  * `Engine` — host free list of pages (worst-case horizon reserved at
    admission, so a live slot never stalls), packed admission, decode-bucket
    pick and flush-page vector per step, greedy sampling on device.

Only the dct codec, greedy sampling and the paged pool are in this slice;
other settings raise.
"""
from __future__ import annotations

import collections
import time
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.codec import plan as plan_lib
from repro_torch.core import kv_cache as kvc
from repro_torch.kernels.fused_attend import ops as fa_ops
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.serve import pipeline as pl


# ---------------------------------------------------------------------------
# Step functions
# ---------------------------------------------------------------------------

def prefill_compressed_paged(params, tokens: torch.Tensor, cfg, *, plan=None,
                             keep: int = 4, lengths=None,
                             dtype=torch.bfloat16):
    """Prefill one admission bucket into paged slot-update form.

    tokens (R, bucket) right-padded, bucket % 8 == 0; `lengths[r]` is row
    r's prompt length.  Returns (logits at each row's last prompt position
    (R, V) f32 — what admission samples from; the (R, bucket, V) tensor is
    never built — and the per-segment update tree for `paged_write_rows`:
    block planes (Lseg, R, bucket/8, Hkv, ...), tails (Lseg, R, 8, Hkv, hd)
    in `dtype`).
    """
    assert cfg.attn_type == "gqa"
    plan = plan_lib.as_plan(plan, keep=keep)
    b, s = tokens.shape
    assert s % kvc.BLOCK == 0, s
    lengths = kvc.as_pos_vec(s if lengths is None else lengths, b, tokens.device)
    x, k, v = T.prefill_hidden(params, tokens, cfg)
    rows = torch.arange(b, device=tokens.device)
    logits = T.unembed(params, x[rows, lengths.long() - 1][:, None], cfg)[:, 0]
    update = []
    for start, stop, pol in plan.segments(cfg.n_layers):
        comp = kvc.prefill_compress(k[start:stop], v[start:stop], pol.kv_keep,
                                    pos=lengths, codec=pol.codec)
        comp["tail_k"] = comp["tail_k"].to(dtype)
        comp["tail_v"] = comp["tail_v"].to(dtype)
        update.append(comp)
    return logits, tuple(update)


def decode_step_compressed(params, token: torch.Tensor, cache: kvc.PagedKVCache,
                           pos, cfg, *, flush_page, attend_blocks=None):
    """One-token decode against the paged compressed pool, in place.

    token, pos (B,) on the cache's device; `flush_page[b]` names the page
    the engine reserved for row b's flush THIS step (an id >= P means no
    flush).  The block-table row update happens once here (every layer of
    a slot flushes the same block index).  `attend_blocks` is the decode
    bucket's table-slice width.  Returns (logits (B, V) f32, cache).
    """
    assert cfg.attn_type == "gqa", "compressed cache is for GQA families"
    b = token.shape[0]
    dev = token.device
    pos = kvc.as_pos_vec(pos, b, dev)
    table = cache.block_table
    nblocks = table.shape[1]
    fp = torch.as_tensor(flush_page).to(device=dev, dtype=torch.int64)
    rows = torch.arange(b, device=dev)
    blk = (pos // kvc.BLOCK).long()
    on_table = (pos % kvc.BLOCK == kvc.BLOCK - 1) & (blk < nblocks)
    blk_c = torch.where(on_table, blk, 0)
    table[rows, blk_c] = torch.where(on_table, fp.to(table.dtype),
                                     table[rows, blk_c])
    flush = kvc.flush_targets(pos, fp, cache.n_pages)
    att_table = kvc.table_view(table, attend_blocks)

    x = T.embed_tokens(params, token)[:, None, :]
    positions = pos[:, None]
    hd = cfg.resolved_head_dim
    for seg in cache.segments:
        for li in range(seg.start, seg.stop):
            p = T.layer_params(params, li)
            lc = seg.layer(li - seg.start)
            hn = L.rmsnorm(p["ln1"], x)
            q = L.dense(p["attn"]["wq"], hn).reshape(b, 1, cfg.n_heads, hd)
            q = L.apply_rope(q, positions, cfg.rope_theta)
            k_new, v_new = L.gqa_project_kv(p["attn"], hn, positions, cfg)
            kvc.update_layer(lc, k_new, v_new, pos, seg.keep, flush=flush,
                             codec=seg.codec)
            attn = fa_ops.attend_with_tail(q, lc, pos, block_table=att_table)
            x = x + L.dense(p["attn"]["wo"], attn.reshape(b, 1, cfg.n_heads * hd))
            x = x + L.mlp(p["mlp"], L.rmsnorm(p["ln2"], x), cfg)
    return T.unembed(params, x, cfg)[:, 0], cache


# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ServeConfig:
    """The settings this slice honours.  The paged pool is required (set
    `pool_pages` or `page_budget_mb`); sampling is greedy; the plan's
    layers must use the dct codec."""

    max_seq: int = 2048
    kv_compress: bool = True
    kv_keep: int = 4              # legacy scalar shim => CompressionPlan.uniform
    plan: Any = None              # CompressionPlan | spec string | int keep
    temperature: float = 0.0      # only greedy (0) in this slice
    eos_id: int = -1              # -1 => never stops early
    pool_pages: int | None = None
    page_budget_mb: float | None = None
    prefill_buckets: Any = None
    decode_buckets: Any = None

    def __post_init__(self):
        if not self.kv_compress:
            raise NotImplementedError("raw (uncompressed) KV serving: later slice")
        if self.temperature > 0.0:
            raise NotImplementedError("temperature sampling: later slice")
        if not self.paged:
            raise NotImplementedError(
                "dense non-paged KV pool: later slice (set pool_pages or "
                "page_budget_mb)")
        self.resolved_plan()  # non-dct codecs raise here

    def resolved_plan(self) -> plan_lib.CompressionPlan:
        return plan_lib.as_plan(self.plan, keep=self.kv_keep)

    @property
    def paged(self) -> bool:
        return self.pool_pages is not None or self.page_budget_mb is not None

    def resolved_pool_pages(self, cfg) -> int:
        if self.pool_pages is not None:
            return int(self.pool_pages)
        page_b = self.resolved_plan().page_bytes(cfg)
        pages = int(self.page_budget_mb * 1e6 // page_b)
        if pages < 1:
            raise ValueError(
                f"page_budget_mb={self.page_budget_mb} holds no page "
                f"(one page = {page_b} B across {cfg.n_layers} layers)")
        return pages


def make_steps(api, sc: ServeConfig):
    """(prefill_fn, decode_fn, cache_init) of the paged branch.

    prefill_fn(params, tokens, lengths=None)           -> (logits, update)
    decode_fn(params, token, cache, pos, flush_page,
              attend_blocks=None)                      -> (logits, cache)
    cache_init(batch, device)                          -> PagedKVCache
    """
    cfg = api.cfg
    if cfg.attn_type != "gqa" or cfg.resolved_head_dim % kvc.BLOCK \
            or not cfg.vec_pos_decode:
        raise NotImplementedError(
            f"arch {cfg.name}: the paged compressed pool needs a GQA family "
            "with per-slot positions")
    plan = sc.resolved_plan()
    n_pages = sc.resolved_pool_pages(cfg)

    def prefill_fn(params, tokens, lengths=None):
        return prefill_compressed_paged(params, tokens, cfg, plan=plan,
                                        lengths=lengths)

    def decode_fn(params, token, cache, pos, flush_page, attend_blocks=None):
        return decode_step_compressed(params, token, cache, pos, cfg,
                                      flush_page=flush_page,
                                      attend_blocks=attend_blocks)

    def cache_init(batch, device):
        return kvc.init_paged_cache(cfg, batch, sc.max_seq, n_pages, plan=plan,
                                    device=device)

    return prefill_fn, decode_fn, cache_init


@dataclass
class Request:
    uid: int
    prompt: np.ndarray            # (S,) int32
    max_new: int
    out_tokens: list[int] = field(default_factory=list)
    done: bool = False


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


# ---------------------------------------------------------------------------
# Continuous-batching engine
# ---------------------------------------------------------------------------

class Engine:
    """Continuous-batching request server over the paged compressed pool.

    Slots are independent: a retired slot re-admits from the queue while
    its neighbours keep decoding.  Admission is gated on free PAGES (each
    request's worst-case horizon is reserved up front) and packs every
    admissible request into one bucketed prefill.  `stats` splits wall
    time into prefill_s / decode_s / host_s; `latency_stats()` reports
    p50/p99 TTFT and inter-token latency.  Runs on the card unless
    ``device="cpu"``.
    """

    def __init__(self, api, params, sc: ServeConfig, batch: int, *, device=None):
        self.device = resolve_device(device)
        cfg = api.cfg
        self._prefill_fn, self._decode_fn, self._cache_init = make_steps(api, sc)
        self.api, self.sc, self.batch = api, sc, batch
        self.plan = sc.resolved_plan()
        self.params = _to_device(params, self.device)
        self.ladder = pl.PrefillLadder.build(sc.max_seq, sc.prefill_buckets)
        self.decode_ladder = pl.DecodeLadder.build(sc.max_seq, sc.decode_buckets)
        # host-side page allocator: the free list IS the allocation policy;
        # the device only ever sees page ids it was handed
        self._n_pages = sc.resolved_pool_pages(cfg)
        self._free_pages = list(range(self._n_pages))
        self._slot_pages: list[list[int]] = [[] for _ in range(batch)]
        self._page_refs = np.zeros(self._n_pages, np.int64)
        self.stats = {"requests": 0, "tokens_out": 0, "steps": 0,
                      "prefill_s": 0.0, "decode_s": 0.0, "host_s": 0.0,
                      "slot_steps_live": 0, "slot_steps_total": 0,
                      "peak_live_slots": 0, "admit_blocked_on_pages": 0,
                      "peak_pages_in_use": 0, "decode_bucket_tokens": 0}
        self._lat = {"ttft_s": [], "itl_s": []}
        self._staged = []
        self._t_gen0 = 0.0

    def _new_cache(self, device=None) -> kvc.PagedKVCache:
        return self._cache_init(self.batch, device or self.device)

    # ------------------------------------------------------------- reports
    def slot_utilization(self) -> float:
        return self.stats["slot_steps_live"] / max(self.stats["slot_steps_total"], 1)

    def latency_stats(self) -> dict:
        """p50/p99 TTFT (generate() entry to the first token on the host)
        and inter-token latency, in seconds; zeros when nothing was served."""
        out = {}
        for key, name in (("ttft_s", "ttft"), ("itl_s", "itl")):
            vals = self._lat[key]
            for q in (50, 99):
                out[f"{name}_p{q}_s"] = float(np.percentile(vals, q)) if vals else 0.0
        return out

    def kv_pool_stats(self) -> dict:
        """Analytic pool footprint (sized on the meta device, no
        allocation) plus the allocator's view; checks the page ledger."""
        total = self._new_cache(device="meta").nbytes()
        out = {"kv_pool_bytes": int(total),
               "kv_bytes_per_device": float(total),
               "slots_per_gb": self.batch / max(total / 1e9, 1e-12)}
        if "measured_kv_bytes" in self.stats:
            out["measured_kv_bytes"] = float(self.stats["measured_kv_bytes"])
        out.update(
            pool_pages=self._n_pages,
            page_bytes=self.plan.page_bytes(self.api.cfg),
            pages_in_use=self._n_pages - len(self._free_pages),
            pages_device_free=len(self._free_pages),
            peak_pages_in_use=self.stats["peak_pages_in_use"],
        )
        self.check_page_invariants()
        return out

    def check_page_invariants(self) -> None:
        """Allocator conservation: every free page has refcount 0, every
        held page's refcount equals its (slot, block) references, and free
        + held == pool pages."""
        free = self._free_pages
        assert len(free) == len(set(free)), "free list has duplicates"
        held = collections.Counter()
        for pages in self._slot_pages:
            held.update(pages)
        refs = self._page_refs
        for p in free:
            assert refs[p] == 0, f"free page {p} has refcount {int(refs[p])}"
        overlap = set(free) & set(held)
        assert not overlap, f"pages both free and held: {sorted(overlap)}"
        for p, n in held.items():
            assert refs[p] == n, f"page {p}: refcount {int(refs[p])} != {n} references"
        assert int((refs > 0).sum()) == len(held)
        assert len(free) + len(held) == self._n_pages, \
            (len(free), len(held), self._n_pages)

    # ----------------------------------------------------------------- API
    def generate(self, requests: list[Request]) -> list[Request]:
        """Serve every request to completion; returns them in input order."""
        queue = list(requests)
        self._t_gen0 = time.perf_counter()
        d0, p0 = self.stats["decode_s"], self.stats["prefill_s"]
        self._run_continuous(queue)
        wall = time.perf_counter() - self._t_gen0
        self.stats["host_s"] += wall - (self.stats["decode_s"] - d0) \
            - (self.stats["prefill_s"] - p0)
        self.stats["requests"] += len(queue)
        return queue

    # ----------------------------------------------------------- allocator
    def _pages_needed(self, r: Request) -> int:
        """Worst-case pages `r` can flush: positions written span
        [0, min(plen + max_new - 1, max_seq))."""
        horizon = min(len(r.prompt) + r.max_new - 1, self.sc.max_seq)
        return horizon // kvc.BLOCK

    def _release_page_list(self, pages) -> None:
        for p in pages:
            n = self._page_refs[p] = self._page_refs[p] - 1
            assert n >= 0, f"page {p} over-released"
            if n == 0:
                self._free_pages.append(p)

    def _release_pages(self, slot: int) -> None:
        pages, self._slot_pages[slot] = self._slot_pages[slot], []
        self._release_page_list(pages)

    def _reserve_pages(self, r: Request, slot: int) -> bool:
        """Reserve `slot`'s worst-case page horizon for `r`; False = blocked
        on free pages (the request stays queued, FCFS)."""
        horizon = self._pages_needed(r)
        if horizon > self._n_pages:
            raise ValueError(
                f"request {r.uid} needs {horizon} pages > pool of "
                f"{self._n_pages} (raise pool_pages/page_budget_mb or lower max_new)")
        if horizon > len(self._free_pages):
            return False
        own = [self._free_pages.pop() for _ in range(horizon)]
        for p in own:
            assert self._page_refs[p] == 0, f"free page {p} had references"
            self._page_refs[p] = 1
        self._slot_pages[slot] = own
        used = self._n_pages - len(self._free_pages)
        self.stats["peak_pages_in_use"] = max(self.stats["peak_pages_in_use"], used)
        return True

    # ----------------------------------------------------------- admission
    def _admit_free_slots(self, queue, cache):
        """Fill free slots from the queue, gated on free pages (FCFS), and
        flush the staged group through one packed prefill."""
        for i in range(self.batch):
            if self._slots[i] is not None or self._qi >= len(queue):
                continue
            r = queue[self._qi]
            if not self._reserve_pages(r, i):
                # blocked on pages, not slots: keep decoding; a retirement
                # frees pages and the next round retries (FCFS)
                self.stats["admit_blocked_on_pages"] += 1
                break
            self._qi += 1
            try:
                plen = len(r.prompt)
                self._staged.append((r, i, plen, self.ladder.bucket_for(plen)))
            except ValueError:
                # off-ladder prompt: no staged reservation may leak
                self._release_pages(i)
                for (_, s, _, _) in self._staged:
                    self._release_pages(s)
                self._staged = []
                raise
        return self._flush_admissions(cache)

    def _flush_admissions(self, cache):
        """ONE prefill at the group's widest bucket, one splice of every
        row's full prompt blocks into its reserved pages, first tokens
        sampled on device at each row's last prompt position."""
        if not self._staged:
            return cache
        staged, self._staged = self._staged, []
        t0 = time.perf_counter()
        bucket = max(b for (_, _, _, b) in staged)
        rows = len(staged)
        tokens = np.zeros((rows, bucket), np.int32)
        lengths = np.zeros(rows, np.int32)
        slot_ids = np.zeros(rows, np.int32)
        page_ids = np.full((rows, bucket // kvc.BLOCK), self._n_pages, np.int32)
        table = np.zeros((rows, self.sc.max_seq // kvc.BLOCK), np.int32)
        for j, (r, slot, plen, _) in enumerate(staged):
            tokens[j, :plen] = r.prompt
            lengths[j] = plen
            slot_ids[j] = slot
            pb = plen // kvc.BLOCK
            page_ids[j, :pb] = self._slot_pages[slot][:pb]
            table[j, :pb] = self._slot_pages[slot][:pb]
        dev = self.device
        logits, rows_cache = self._prefill_fn(
            self.params, torch.from_numpy(tokens).to(dev),
            lengths=torch.from_numpy(lengths).to(dev))
        first = torch.argmax(logits, dim=-1)
        cache = kvc.paged_write_rows(cache, rows_cache, slot_ids, page_ids, table)
        firsts = first.cpu().numpy()
        self.stats["prefill_s"] += time.perf_counter() - t0
        t_emit = time.perf_counter()
        fix_i, fix_t, fix_p = [], [], []
        for j, (r, slot, plen, _) in enumerate(staged):
            tok = int(firsts[j])
            self.stats["tokens_out"] += 1
            r.out_tokens.append(tok)
            self._lat["ttft_s"].append(t_emit - self._t_gen0)
            self._last_emit[slot] = t_emit
            if tok == self.sc.eos_id or r.max_new <= 1 or plen >= self.sc.max_seq:
                cache = kvc.paged_reset_slot(cache, slot)  # done at admission
                r.done = True
                self._release_pages(slot)
            else:
                self._slots[slot] = r
                self._pos[slot] = plen
                self._nout[slot] = 1
                fix_i.append(slot)
                fix_t.append(tok)
                fix_p.append(plen)
        if fix_i:
            self._apply_fix(fix_i, fix_t, fix_p)
        return cache

    def _apply_fix(self, idx, tok_vals, pos_vals):
        """Write admission/retirement corrections into the device-resident
        (B,) token/pos vectors."""
        dev = self.device
        ii = torch.tensor(idx, dtype=torch.int64, device=dev)
        self._tok_dev[ii] = torch.tensor(tok_vals, dtype=torch.int32, device=dev)
        self._pos_dev[ii] = torch.tensor(pos_vals, dtype=torch.int32, device=dev)
        self._devpos[np.asarray(idx, np.int64)] = pos_vals

    # -------------------------------------------------------------- decode
    def _decode_args(self, live):
        """(flush-page vector, decode bucket) for the next step.

        The bucket covers the deepest live slot's flushed watermark; each
        flushing row (its tail fills this step) gets its reserved page,
        every other row the out-of-range id P."""
        need = max(((int(self._devpos[i]) // kvc.BLOCK) * kvc.BLOCK
                    for i in live), default=0)
        bucket = self.decode_ladder.bucket_for(need)
        fp = np.full(self.batch, self._n_pages, np.int32)
        for i in live:
            p = int(self._devpos[i])
            blk = p // kvc.BLOCK
            if p % kvc.BLOCK == kvc.BLOCK - 1 and blk < len(self._slot_pages[i]):
                fp[i] = self._slot_pages[i][blk]
        return fp, bucket

    def _dispatch(self, cache, live):
        """One decode step with greedy sampling on device."""
        t0 = time.perf_counter()
        fp, bucket = self._decode_args(live)
        self.stats["decode_bucket_tokens"] += bucket
        logits, cache = self._decode_fn(
            self.params, self._tok_dev, cache, self._pos_dev,
            torch.from_numpy(fp), attend_blocks=bucket // kvc.BLOCK)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        self._tok_dev, self._pos_dev = tok, self._pos_dev + 1
        self._devpos += 1
        self.stats["steps"] += 1
        self.stats["slot_steps_total"] += self.batch
        self.stats["slot_steps_live"] += len(live)
        self.stats["decode_s"] += time.perf_counter() - t0
        return cache, tok

    def _process(self, tok, plive, cache):
        """Read the step's tokens (the loop's device->host sync), append
        them, and retire finished slots (pages return in slot order)."""
        t0 = time.perf_counter()
        toks = tok.cpu().numpy()
        self.stats["decode_s"] += time.perf_counter() - t0
        t_emit = time.perf_counter()
        retired, fix_i = [], []
        for i, r in plive:
            t = int(toks[i])
            self._nout[i] += 1
            self._pos[i] += 1
            self.stats["tokens_out"] += 1
            r.out_tokens.append(t)
            self._lat["itl_s"].append(t_emit - self._last_emit[i])
            self._last_emit[i] = t_emit
            if t == self.sc.eos_id or self._nout[i] >= r.max_new \
                    or self._pos[i] >= self.sc.max_seq:
                self._slots[i] = None
                self._pos[i] = 0
                self._nout[i] = 0
                cache = kvc.paged_reset_slot(cache, i)
                pages, self._slot_pages[i] = self._slot_pages[i], []
                retired.append((r, pages))
                fix_i.append(i)
        for r, pages in retired:
            r.done = True
            self._release_page_list(pages)
        if fix_i:
            self._apply_fix(fix_i, [0] * len(fix_i), [0] * len(fix_i))
        return cache

    def _run_continuous(self, queue: list[Request]) -> None:
        b = self.batch
        self._slots: list[Request | None] = [None] * b
        self._pos = np.zeros(b, np.int64)      # logical per-slot position
        self._nout = np.zeros(b, np.int64)     # tokens emitted per slot
        self._devpos = np.zeros(b, np.int64)   # device position mirror
        self._last_emit = np.zeros(b)
        self._tok_dev = torch.zeros(b, dtype=torch.int32, device=self.device)
        self._pos_dev = torch.zeros(b, dtype=torch.int32, device=self.device)
        self._staged = []
        self._qi = 0
        cache = self._new_cache()
        idle_spins, last_state = 0, None
        while True:
            cache = self._admit_free_slots(queue, cache)
            live = [(i, r) for i, r in enumerate(self._slots) if r is not None]
            if not live:
                if self._qi >= len(queue):
                    break
                # everything retired at admission; admit more.  Guard the
                # spin: a request the pool can never admit would loop here
                state = (self._qi, len(self._free_pages))
                idle_spins = idle_spins + 1 if state == last_state else 0
                last_state = state
                if idle_spins > 2 * b + 4:
                    raise RuntimeError(
                        f"serve loop wedged: no live slots and no progress "
                        f"(qi={self._qi}/{len(queue)})")
                continue
            idle_spins, last_state = 0, None
            self.stats["peak_live_slots"] = max(self.stats["peak_live_slots"],
                                                len(live))
            cache, tok = self._dispatch(cache, [i for i, _ in live])
            cache = self._process(tok, live, cache)
        self.stats["measured_kv_bytes"] = kvc.measured_cache_bytes(cache)
