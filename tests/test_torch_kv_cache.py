"""Parity of the port's paged KV pool with the JAX package, plane by plane
(CPU, f32, reference codec backend).

Covers the pool's whole device-side life: `init_paged_cache`, the per-layer
decode `update_layer` (flushing and non-flushing rows, out-of-range and
stray page ids), `prefill_compress` with per-row prompt lengths and a
leading layer axis, the packed-admission splice `paged_write_rows` with
padding rows, `paged_reset_slot`, and the byte reports.  The port updates
in place where the JAX package returns new arrays; both end states must be
equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.core import kv_cache as JKV
from repro_torch.configs import get_config as tget_config
from repro_torch.core import kv_cache as TKV

PYRAMID = "0-1:keep=8,2-:keep=4"


def _assert_int8_equal(got: np.ndarray, want: np.ndarray):
    """Equal up to rounding-tie flips (|delta| == 1, share < 1e-3)."""
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert d.max(initial=0) <= 1, d.max()
    assert (d != 0).sum() <= 1e-3 * d.size, ((d != 0).sum(), d.size)


def _assert_planes_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for name in want:
        g, w = got[name].numpy(), np.asarray(want[name])
        assert g.shape == w.shape and g.dtype == w.dtype, (name, g.shape, w.shape)
        if w.dtype == np.int8:
            _assert_int8_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7, err_msg=name)


def _assert_cache_equal(tc, jc):
    assert len(tc.segments) == len(jc.segments)
    for ts, js in zip(tc.segments, jc.segments):
        assert (ts.keep, ts.start, ts.stop, ts.codec) == (js.keep, js.start, js.stop, js.codec)
        _assert_planes_equal(ts.planes, js.as_tree())
    np.testing.assert_array_equal(tc.block_table.numpy(), np.asarray(jc.block_table))


def _random_planes(shapes_dtypes: dict, rng) -> dict:
    out = {}
    for name, (shape, dtype) in sorted(shapes_dtypes.items()):
        if dtype == np.int8:
            out[name] = rng.integers(-127, 128, shape).astype(np.int8)
        else:
            out[name] = rng.uniform(0.01, 1.0, shape).astype(dtype)
    return out


def _layer_pool(keep, n_pages=9, b=6, hkv=2, hd=16, seed=0):
    nh = hd // 8
    rng = np.random.default_rng(seed)
    return _random_planes({
        "packed_k": ((n_pages, hkv, nh, keep, keep), np.int8),
        "scale_k": ((n_pages, hkv, nh), np.float32),
        "packed_v": ((n_pages, hkv, nh, keep, keep), np.int8),
        "scale_v": ((n_pages, hkv, nh), np.float32),
        "tail_k": ((b, 8, hkv, hd), np.float32),
        "tail_v": ((b, 8, hkv, hd), np.float32),
    }, rng)


# rows: flush into page 3 | flush, id out of range (dropped) | no flush with a
# stray in-range id | no flush | flush into page 0 | depth 0, no flush
UPDATE_POS = np.array([7, 15, 12, 0, 23, 0], np.int32)
UPDATE_FP = np.array([3, 9, 5, 9, 0, 9], np.int32)


@pytest.mark.parametrize("keep", [2, 4, 8])
@pytest.mark.parametrize("flushing", [True, False])
def test_update_layer_matches_jax(keep, flushing):
    pool = _layer_pool(keep, seed=keep)
    rng = np.random.default_rng(100 + keep)
    k_new = rng.standard_normal((6, 1, 2, 16)).astype(np.float32)
    v_new = rng.standard_normal((6, 1, 2, 16)).astype(np.float32)
    pos = UPDATE_POS if flushing else UPDATE_POS - UPDATE_POS % 8 + 2
    want = JKV.update_layer({n: jnp.asarray(a) for n, a in pool.items()},
                            jnp.asarray(k_new), jnp.asarray(v_new), jnp.asarray(pos),
                            keep, backend="reference", flush_page=jnp.asarray(UPDATE_FP))
    tpool = {n: torch.from_numpy(a.copy()) for n, a in pool.items()}
    tpos = torch.from_numpy(pos)
    flush = TKV.flush_targets(tpos, torch.from_numpy(UPDATE_FP), 9)
    assert flush[0].tolist() == ([0, 4] if flushing else [])
    got = TKV.update_layer(tpool, torch.from_numpy(k_new), torch.from_numpy(v_new),
                           tpos, keep, flush=flush)
    assert got is tpool  # in place
    _assert_planes_equal(got, want)
    if flushing:  # the flushed pages really changed
        assert not np.array_equal(got["packed_k"][3].numpy(), pool["packed_k"][3])
    else:
        np.testing.assert_array_equal(got["packed_k"].numpy(), pool["packed_k"])


@pytest.mark.parametrize("keep", [2, 4, 8])
def test_prefill_compress_matches_jax_per_row_lengths(keep):
    n_layers, b, s, hkv, hd = 3, 4, 24, 2, 16
    rng = np.random.default_rng(keep)
    k = rng.standard_normal((n_layers, b, s, hkv, hd)).astype(np.float32)
    v = rng.standard_normal((n_layers, b, s, hkv, hd)).astype(np.float32)
    lengths = np.array([24, 5, 17, 8], np.int32)
    want = jax.vmap(lambda kk, vv: JKV.prefill_compress(
        kk, vv, keep, pos=jnp.asarray(lengths), backend="reference"))(
        jnp.asarray(k), jnp.asarray(v))
    got = TKV.prefill_compress(torch.from_numpy(k), torch.from_numpy(v), keep,
                               pos=torch.from_numpy(lengths))
    _assert_planes_equal(got, want)
    # one layer without the leading axis, default pos = S
    want1 = JKV.prefill_compress(jnp.asarray(k[1]), jnp.asarray(v[1]), keep,
                                 backend="reference")
    got1 = TKV.prefill_compress(torch.from_numpy(k[1]), torch.from_numpy(v[1]), keep)
    _assert_planes_equal(got1, want1)


def _twin_caches(plan, batch=3, max_seq=32, n_pages=7, seed=0):
    """A JAX and a port paged pool for yi_6b reduced holding the same random
    contents and block table."""
    jcfg, tcfg = jget_config("yi_6b").reduced(), tget_config("yi_6b").reduced()
    jc = JKV.init_paged_cache(jcfg, batch, max_seq, n_pages, plan=plan, dtype=jnp.float32)
    tc = TKV.init_paged_cache(tcfg, batch, max_seq, n_pages, plan=plan,
                              dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(seed)
    segs = []
    for js, ts in zip(jc.segments, tc.segments):
        tree = js.as_tree()
        filled = _random_planes({n: (a.shape, np.dtype(a.dtype)) for n, a in tree.items()}, rng)
        segs.append(js.replace_arrays({n: jnp.asarray(a) for n, a in filled.items()}))
        for n, a in filled.items():
            ts.planes[n].copy_(torch.from_numpy(a))
    table = rng.integers(0, n_pages, (batch, max_seq // 8)).astype(np.int32)
    tc.block_table.copy_(torch.from_numpy(table))
    return JKV.PagedKVCache(tuple(segs), jnp.asarray(table)), tc


@pytest.mark.parametrize("plan", [4, PYRAMID])
def test_init_paged_cache_matches_jax(plan):
    jc, tc = _twin_caches(plan)
    assert tc.n_pages == jc.n_pages and tc.max_seq == jc.max_seq
    assert tc.keeps == jc.keeps and tc.n_layers == jc.n_layers
    assert tc.page_bytes() == jc.page_bytes()
    assert sum(s.nbytes() for s in tc.segments) == sum(s.nbytes() for s in jc.segments)
    _assert_cache_equal(tc, jc)
    assert TKV.measured_cache_bytes(tc) == JKV.measured_cache_bytes(jc)
    for keep in range(1, 9):
        assert TKV.block_group_bytes(keep, 4, 128) == JKV.block_group_bytes(keep, 4, 128)


@pytest.mark.parametrize("plan", [4, PYRAMID])
def test_paged_write_rows_and_reset_slot_match_jax(plan):
    jc, tc = _twin_caches(plan)
    rng = np.random.default_rng(1)
    n_rows, nb = 3, 2
    update = []
    for js in jc.segments:
        tree = js.as_tree()
        shapes = {}
        for n, a in tree.items():
            if n.startswith("tail"):
                shapes[n] = ((a.shape[0], n_rows) + a.shape[2:], np.dtype(a.dtype))
            else:  # (Lseg, P, Hkv, ...) -> (Lseg, R, nb, Hkv, ...)
                shapes[n] = ((a.shape[0], n_rows, nb) + a.shape[2:], np.dtype(a.dtype))
        update.append(_random_planes(shapes, rng))
    # row 2 is admission padding: slot id >= B and every page id >= P
    slots = np.array([2, 0, 3], np.int32)
    page_ids = np.array([[5, 1], [6, 7], [7, 7]], np.int32)
    table_rows = np.zeros((n_rows, 4), np.int32)
    table_rows[0, :2] = [5, 1]
    table_rows[1, :1] = [6]
    jc = JKV.paged_write_rows(jc, tuple({n: jnp.asarray(a) for n, a in u.items()}
                                        for u in update),
                              jnp.asarray(slots), jnp.asarray(page_ids),
                              jnp.asarray(table_rows))
    TKV.paged_write_rows(tc, tuple({n: torch.from_numpy(a) for n, a in u.items()}
                                   for u in update), slots, page_ids, table_rows)
    _assert_cache_equal(tc, jc)
    np.testing.assert_array_equal(tc.block_table[2].numpy(), table_rows[0])
    jc = JKV.paged_reset_slot(jc, 2)
    TKV.paged_reset_slot(tc, 2)
    _assert_cache_equal(tc, jc)
    assert int(tc.block_table[2].abs().sum()) == 0
    assert TKV.measured_cache_bytes(tc) == JKV.measured_cache_bytes(jc)


def test_as_pos_vec_broadcasts_and_checks():
    assert TKV.as_pos_vec(5, 3).tolist() == [5, 5, 5]
    assert TKV.as_pos_vec(torch.tensor([1, 2]), 2).dtype == torch.int32
    with pytest.raises(AssertionError):
        TKV.as_pos_vec([1, 2, 3], 2)
