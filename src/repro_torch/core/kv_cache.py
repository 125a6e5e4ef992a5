"""Paged DCT-truncated int8 KV cache: the port of `repro.core.kv_cache`'s
paged pool.

Per plan segment (a run of layers with one policy) the pool holds

  packed_k/v : (Lseg, P, Hkv, hd/8, k, k) int8   page pool
  scale_k/v  : (Lseg, P, Hkv, hd/8)       f32
  tail_k/v   : (Lseg, B, 8, Hkv, hd)      raw ring, cache dtype

and one block table (B, max_seq/8) int32 maps slot b's j-th 8-token block
to its page; a page is one block group across every layer.  The engine's
host free list assigns pages; the device only scatters through the ids it
is handed and gathers through the table.  Unmapped entries are 0 (a valid
page) and never read: attention stops at each slot's flushed watermark.

Unlike the JAX package, which returns new arrays, the port updates the pool
IN PLACE (`update_layer`, `paged_write_rows`, `paged_reset_slot`) so a
decode step never copies the pool; callers that need the old state clone
it first (`PagedKVCache.clone`).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.codec import api as codec_api
from repro_torch.codec import families as families_lib
from repro_torch.codec import plan as plan_lib

BLOCK = 8
TAIL_NAMES = families_lib.TAIL_NAMES
ATTEND_KV_BLOCK = 1024  # the plain scan's chunk, as the JAX engine's kv_block


def block_group_bytes(keep: int, n_kv_heads: int, head_dim: int,
                      codec: str = "dct") -> int:
    """Analytic bytes of one flushed 8-token block group for ONE layer, K
    and V: the paged pool's page-size unit per layer."""
    assert head_dim % BLOCK == 0, head_dim
    fam = families_lib.get_family(codec)
    return 2 * n_kv_heads * (head_dim // BLOCK) * fam.analytic_tile_bytes(keep)


def as_pos_vec(pos, batch: int, device=None) -> torch.Tensor:
    """Normalize a position argument to a per-slot (B,) int32 vector
    (scalars broadcast)."""
    pos = torch.as_tensor(pos, dtype=torch.int32, device=device)
    if pos.ndim == 0:
        return pos.expand(batch).contiguous()
    assert pos.shape == (batch,), (tuple(pos.shape), batch)
    return pos


# ---------------------------------------------------------------------------
# Containers
# ---------------------------------------------------------------------------

@dataclass
class KVSegment:
    """Pool planes of one contiguous run of layers sharing a policy:
    ``{name}_k/v`` per the codec family's plane tree plus the raw tail
    ring ``tail_k/v``."""

    planes: dict[str, torch.Tensor]
    keep: int
    start: int
    stop: int
    codec: str = "dct"

    packed_k = property(lambda self: self.planes["packed_k"])
    scale_k = property(lambda self: self.planes["scale_k"])
    packed_v = property(lambda self: self.planes["packed_v"])
    scale_v = property(lambda self: self.planes["scale_v"])
    tail_k = property(lambda self: self.planes["tail_k"])
    tail_v = property(lambda self: self.planes["tail_v"])

    @property
    def family(self):
        return families_lib.get_family(self.codec)

    @property
    def page_keys(self) -> tuple[str, ...]:
        """Block planes that live in the page pool (tails stay per slot)."""
        return tuple(sorted(n for n in self.planes if n not in TAIL_NAMES))

    def layer(self, i: int) -> dict[str, torch.Tensor]:
        """Views of layer `start + i`'s planes (writes go to the pool)."""
        return {n: a[i] for n, a in self.planes.items()}

    def nbytes(self) -> int:
        return sum(a.numel() * a.element_size() for a in self.planes.values())


@dataclass
class PagedKVCache:
    """Shared page pool (per-segment planes) + per-slot block table."""

    segments: tuple[KVSegment, ...]
    block_table: torch.Tensor  # (B, S/8) int32

    @property
    def n_layers(self) -> int:
        return self.segments[-1].stop

    @property
    def n_pages(self) -> int:
        return self.segments[0].packed_k.shape[1]

    @property
    def max_seq(self) -> int:
        return self.block_table.shape[1] * BLOCK

    @property
    def keeps(self) -> tuple[int, ...]:
        return tuple(s.keep for s in self.segments for _ in range(s.stop - s.start))

    def page_bytes(self) -> int:
        total = 0
        for s in self.segments:
            _, _, hkv, nhd, k, _ = s.packed_k.shape
            total += (s.stop - s.start) * block_group_bytes(k, hkv, nhd * BLOCK, s.codec)
        return total

    def nbytes(self) -> int:
        return sum(s.nbytes() for s in self.segments) + \
            self.block_table.numel() * self.block_table.element_size()

    def clone(self) -> "PagedKVCache":
        return PagedKVCache(
            tuple(KVSegment({n: a.clone() for n, a in s.planes.items()},
                            s.keep, s.start, s.stop, s.codec)
                  for s in self.segments),
            self.block_table.clone())


def init_paged_cache(cfg, batch: int, max_seq: int, n_pages: int,
                     keep: int = 4, dtype=torch.bfloat16, plan=None,
                     device=None) -> PagedKVCache:
    """Zero pool of `n_pages` pages + block tables per `plan` (legacy scalar
    `keep` => uniform plan).  ``device="meta"`` sizes it without
    allocating."""
    assert max_seq % BLOCK == 0
    assert n_pages >= 1, n_pages
    hd = cfg.resolved_head_dim
    assert hd % BLOCK == 0, f"head_dim {hd} not 8-tileable"
    plan = plan_lib.as_plan(plan, keep=keep)
    hkv = cfg.n_kv_heads
    segments = []
    for start, stop, pol in plan.segments(cfg.n_layers):
        fam = families_lib.get_family(pol.codec)
        n = stop - start
        planes = {}
        for spec in fam.plane_specs(pol.kv_keep, hd):
            shape = (n, n_pages, hkv) + spec.block_shape
            for sfx in ("_k", "_v"):
                planes[spec.name + sfx] = torch.zeros(shape, dtype=spec.dtype,
                                                      device=device)
        for name in TAIL_NAMES:
            planes[name] = torch.zeros((n, batch, BLOCK, hkv, hd), dtype=dtype,
                                       device=device)
        segments.append(KVSegment(planes, keep=pol.kv_keep, start=start,
                                  stop=stop, codec=pol.codec))
    table = torch.zeros((batch, max_seq // BLOCK), dtype=torch.int32,
                        device=device)
    return PagedKVCache(tuple(segments), table)


def measured_cache_bytes(cache: PagedKVCache) -> float:
    """Measured compressed bytes resident in the pool: raw tails at full
    size plus the analytic tile bytes of every LIVE tile (nonzero carrier or
    scale).  Syncs the device; call from stats paths only."""
    total = 0.0
    for seg in cache.segments:
        planes = seg.planes
        for name in TAIL_NAMES:
            total += planes[name].numel() * planes[name].element_size()
        for sfx in ("_k", "_v"):
            live = (planes["packed" + sfx] != 0).any(dim=-1).any(dim=-1)
            live = live | (planes["scale" + sfx] != 0)
            total += float(live.sum().item()) * \
                seg.family.analytic_tile_bytes(seg.keep)
    return total


# ---------------------------------------------------------------------------
# Per-layer decode update (one layer's views, B slots)
# ---------------------------------------------------------------------------

def flush_targets(pos: torch.Tensor, flush_page: torch.Tensor, n_pages: int):
    """(rows, pages) of this step's block flushes, as index tensors.

    Row b flushes when its tail just filled (pos % 8 == 7) AND its page id
    lies in the pool; every other row is dropped (the JAX package's
    drop-mode scatter).  Computed once per decode step and shared by every
    layer: the one host sync here also tells the caller whether any
    compress kernel needs to run at all.
    """
    fp = flush_page.to(device=pos.device, dtype=torch.int64)
    write = (pos % BLOCK == BLOCK - 1) & (fp >= 0) & (fp < n_pages)
    rows = torch.nonzero(write).flatten()
    return rows, fp[rows]


def update_layer(layer_cache: dict[str, torch.Tensor], k_new, v_new, pos,
                 keep: int, *, flush=None,
                 codec: str = "dct") -> dict[str, torch.Tensor]:
    """Write each row's new token into its own tail slot; flush the rows in
    `flush` (see `flush_targets`) into their pages.  In place.

    layer_cache: pool views ``{name}_k/v (P, Hkv) + block_shape`` and
    ``tail_k/v (B, 8, Hkv, hd)``; k_new/v_new (B, 1, Hkv, hd).  The tail is
    written BEFORE the flush compresses it, and before the caller attends
    at `pos` (the prefill tail invariant).  K and V of all flushing rows go
    through ONE compress call.
    """
    fam = families_lib.get_family(codec)
    b = k_new.shape[0]
    pos = as_pos_vec(pos, b, k_new.device)
    rows = torch.arange(b, device=k_new.device)
    slot = (pos % BLOCK).long()
    tk, tv = layer_cache["tail_k"], layer_cache["tail_v"]
    tk[rows, slot] = k_new[:, 0].to(tk.dtype)
    tv[rows, slot] = v_new[:, 0].to(tv.dtype)
    if flush is None or flush[0].numel() == 0:
        return layer_cache
    fr, pages = flush
    # (2, n, 8, Hkv, hd) -> (2, n, Hkv, 8, hd) planes: one block per head
    tails = torch.stack([tk[fr], tv[fr]]).transpose(2, 3)
    q, sc = codec_api.compress_blocks(tails, keep)
    for i, sfx in enumerate(("_k", "_v")):
        for name, plane in fam.pack(q[i][:, :, 0], sc[i][:, :, 0], keep).items():
            dst = layer_cache[name + sfx]
            dst[pages] = plane.to(dst.dtype)
    return layer_cache


# ---------------------------------------------------------------------------
# Plain decode attention over the paged pool
# ---------------------------------------------------------------------------

def attend_scan(q, layer_cache, pos, keep: int, *, block_table,
                kv_block: int = ATTEND_KV_BLOCK, scale: float | None = None,
                codec: str = "dct") -> torch.Tensor:
    """Online-softmax decode attention over the paged pool, decompressing
    per chunk of `kv_block` positions gathered through `block_table`; each
    row attends to packed blocks below its flushed watermark plus its raw
    tail (positions pos - pos % 8 .. pos).  q (B, 1, H, hd) -> (B, H, hd)
    f32.  Chunking and masking follow the JAX package's scan."""
    fam = families_lib.get_family(codec)
    bases = tuple(sorted({n[:-2] for n in layer_cache if n not in TAIL_NAMES}))
    b, _, h, hd = q.shape
    dev = q.device
    pos = as_pos_vec(pos, b, dev).long()
    _, hkv, _, _, _ = layer_cache["packed_k"].shape
    n_pages = layer_cache["packed_k"].shape[0]
    n_rep = h // hkv
    nblocks_total = block_table.shape[1]
    max_seq = nblocks_total * BLOCK
    scale = scale if scale is not None else 1.0 / np.sqrt(hd)
    kv_block = min(kv_block, max_seq)
    while max_seq % kv_block:  # shrink to a divisor (max_seq is a mult of 8)
        kv_block -= BLOCK
    bpc = kv_block // BLOCK
    nchunks = max_seq // kv_block

    qf = (q.float() * scale)[:, 0].reshape(b, hkv, n_rep, hd)
    flushed = (pos // BLOCK) * BLOCK
    m = torch.full((b, hkv, n_rep), -torch.inf, device=dev)
    l = torch.zeros((b, hkv, n_rep), device=dev)
    acc = torch.zeros((b, hkv, n_rep, hd), device=dev)

    def merge(s, valid, v, m, l, acc):
        s = torch.where(valid, s, -torch.inf)
        m_new = torch.maximum(m, s.amax(dim=-1))
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.where(valid, torch.exp(s - m_safe[..., None]), 0.0)
        alpha = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bgrk,bgkd->bgrd", p, v)
        return m_new, l, acc

    for c in range(nchunks):
        start = c * bpc
        # unmapped entries point at page 0 — valid, and masked below
        pages = block_table[:, start:start + bpc].long().clamp(0, n_pages - 1)

        def chunk_planes(sfx):
            # (B, bpc, Hkv, ...) -> (B, Hkv, bpc, ...)
            return {base: layer_cache[base + sfx][pages].transpose(1, 2)
                    for base in bases}

        kq, ksc = fam.unpack(chunk_planes("_k"), keep)
        vq, vsc = fam.unpack(chunk_planes("_v"), keep)
        kc = codec_api.decompress_blocks(kq, ksc)  # (B, Hkv, kv_block, hd) f32
        vc = codec_api.decompress_blocks(vq, vsc)
        kv_pos = start * BLOCK + torch.arange(kv_block, device=dev)
        valid = (kv_pos[None] < flushed[:, None])[:, None, None]
        s = torch.einsum("bgrd,bgkd->bgrk", qf, kc)
        m, l, acc = merge(s, valid, vc, m, l, acc)

    # raw tail: positions flushed .. pos (inclusive)
    tk = layer_cache["tail_k"].transpose(1, 2).float()  # (B, Hkv, 8, hd)
    tv = layer_cache["tail_v"].transpose(1, 2).float()
    tail_pos = flushed[:, None] + torch.arange(BLOCK, device=dev)
    tvalid = (tail_pos <= pos[:, None])[:, None, None]
    st = torch.einsum("bgrd,bgkd->bgrk", qf, tk)
    m, l, acc = merge(st, tvalid, tv, m, l, acc)
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.reshape(b, h, hd)


def attend_compressed(q, layer_cache, pos, keep: int, *, block_table,
                      kv_block: int = ATTEND_KV_BLOCK, scale=None,
                      codec: str = "dct") -> torch.Tensor:
    """`attend_scan` in the JAX package's signature: (B, 1, H, hd) in q's
    dtype."""
    out = attend_scan(q, layer_cache, pos, keep, block_table=block_table,
                      kv_block=kv_block, scale=scale, codec=codec)
    return out[:, None].to(q.dtype)


def table_view(block_table: torch.Tensor, attend_blocks: int | None = None):
    """Decode-bucket slice of a block table: its first `attend_blocks`
    entries (None / >= width => the whole table).  Exact: dropped entries
    can only name blocks past every row's watermark."""
    nb = block_table.shape[1]
    if attend_blocks is None or attend_blocks >= nb:
        return block_table
    assert attend_blocks >= 1, attend_blocks
    return block_table[:, :attend_blocks]


# ---------------------------------------------------------------------------
# Bulk prefill compression
# ---------------------------------------------------------------------------

def prefill_compress(k, v, keep: int, pos=None,
                     codec: str = "dct") -> dict[str, torch.Tensor]:
    """Compress a full prompt's K/V into cache layout.

    k, v: (..., B, S, Hkv, hd), S % 8 == 0 — any leading dims (the engine
    passes a whole segment's layer stack, so one compress call covers it;
    K and V share that call).  `pos[b]` is row b's prompt length.  Blocks at
    or above a row's watermark hold padding garbage that attention masks and
    decode overwrites.  The trailing partial block of each row (positions
    flushed .. flushed+7, clamped) is returned raw as tail_k/tail_v.

    Invariant: tail entries at indices >= pos%8 are clamped-gather garbage
    that `tail_pos <= pos` treats as valid at position pos itself, so decode
    must WRITE position pos before attending at it.
    """
    fam = families_lib.get_family(codec)
    *lead, b, s, hkv, hd = k.shape
    pos = as_pos_vec(s if pos is None else pos, b, k.device).long()
    # one call for K and V: (2, ..., B, Hkv, S, hd) planes
    q, sc = codec_api.compress_blocks(torch.stack([k, v]).transpose(-3, -2), keep)
    idx = (pos[:, None] // BLOCK) * BLOCK + torch.arange(BLOCK, device=k.device)
    idx = torch.clamp(idx, max=s - 1)  # (B, 8)
    gather = lambda x: x[..., torch.arange(b, device=k.device)[:, None], idx, :, :]
    out = dict(tail_k=gather(k), tail_v=gather(v))
    hkv_axis = len(lead) + 1  # planes are (..., B, Hkv, S/8) + block_shape
    for i, sfx in enumerate(("_k", "_v")):
        for name, plane in fam.pack(q[i], sc[i], keep).items():
            # -> cache layout (..., B, S/8, Hkv) + block_shape
            out[name + sfx] = plane.transpose(hkv_axis, hkv_axis + 1)
    return out


# ---------------------------------------------------------------------------
# Slot lifecycle (continuous batching), in place
# ---------------------------------------------------------------------------

def paged_write_rows(cache: PagedKVCache, rows_update, slots, page_ids,
                     table_rows) -> PagedKVCache:
    """Splice a packed admission (R prefilled rows) into the pool, in place.

    `rows_update`: per-segment dicts from a paged prefill — block planes
    (Lseg, R, nb, Hkv, ...), tails (Lseg, R, 8, Hkv, hd).  `slots` (R,)
    assigns row r to slot slots[r]; `page_ids` (R, nb) names each prompt
    block's page; `table_rows` (R, S/8) are the new table rows.  Slot ids
    >= B and page ids >= P are dropped (admission padding), so a padding
    entry lands nowhere.
    """
    dev = cache.block_table.device
    b, n_pages = cache.block_table.shape[0], cache.n_pages
    slots = torch.as_tensor(slots, dtype=torch.int64)
    page_ids = torch.as_tensor(page_ids, dtype=torch.int64)
    srow = torch.nonzero((slots >= 0) & (slots < b)).flatten()
    pr, pj = torch.nonzero((page_ids >= 0) & (page_ids < n_pages), as_tuple=True)
    pages = page_ids[pr, pj].to(dev)
    pr, pj, srow = pr.to(dev), pj.to(dev), srow.to(dev)
    sidx = slots.to(dev)[srow]
    for seg, upd in zip(cache.segments, rows_update):
        for key in seg.page_keys:
            dst = seg.planes[key]
            dst[:, pages] = upd[key][:, pr, pj].to(dst.dtype)
        for key in TAIL_NAMES:
            dst = seg.planes[key]
            dst[:, sidx] = upd[key][:, srow].to(dst.dtype)
    table_rows = torch.as_tensor(table_rows, dtype=torch.int32).to(dev)
    cache.block_table[sidx] = table_rows[srow]
    return cache


def paged_reset_slot(cache: PagedKVCache, slot: int) -> PagedKVCache:
    """Retire one slot, in place: zero its tails and block-table row.  Page
    contents stay; the engine's free list reclaims the ids."""
    for seg in cache.segments:
        for key in TAIL_NAMES:
            seg.planes[key][:, slot] = 0
    cache.block_table[slot] = 0
    return cache
