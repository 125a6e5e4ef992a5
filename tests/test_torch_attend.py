"""Parity of the port's paged decode attention with the JAX package (CPU).

The port's plain paths — `core.kv_cache.attend_compressed` with a block
table, and `kernels.fused_attend.ops.attend_with_tail` taking the kernel
wrapper's plain version on CPU tensors — are held against the JAX
package's reference scan (`repro.core.kv_cache.attend_compressed`) and its
fused paged Pallas kernel in interpret mode (`repro.kernels.fused_attend.
ops.attend_with_tail`), at atol 1e-4.

The pool is the scrambled 13-page pool of tests/test_decode_ladder.py,
with two more rows: depth 0 (nothing flushed, one valid tail entry) and
depth 7 (a full tail, no page yet).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kv_cache as JKV
from repro.kernels.fused_attend import ops as jops
from repro_torch.core import kv_cache as TKV
from repro_torch.kernels.fused_attend import kernel as tkernel
from repro_torch.kernels.fused_attend import ops as tops
from repro_torch.kernels.fused_attend import ref as tref

ATOL = 1e-4
N_PAGES, WIDTH = 13, 8  # 13-page pool, 64-token table capacity


def _case(keep, hkv=2, n_rep=2, hd=16, seed=3):
    """Pool planes, q, per-row positions and a scrambled block table."""
    rng = np.random.default_rng(seed)
    nh = hd // 8
    pos = np.array([28, 14, 0, 7], np.int32)
    b = len(pos)
    cache = {
        "packed_k": rng.integers(-8, 8, (N_PAGES, hkv, nh, keep, keep), np.int8),
        "scale_k": rng.uniform(0.5, 2, (N_PAGES, hkv, nh)).astype(np.float32),
        "packed_v": rng.integers(-8, 8, (N_PAGES, hkv, nh, keep, keep), np.int8),
        "scale_v": rng.uniform(0.5, 2, (N_PAGES, hkv, nh)).astype(np.float32),
        "tail_k": rng.standard_normal((b, 8, hkv, hd)).astype(np.float32),
        "tail_v": rng.standard_normal((b, 8, hkv, hd)).astype(np.float32),
    }
    q = rng.standard_normal((b, 1, hkv * n_rep, hd)).astype(np.float32)
    table = np.zeros((b, WIDTH), np.int32)
    perm = rng.permutation(N_PAGES)
    for i in range(b):
        for j in range(int(pos[i]) // 8):
            table[i, j] = int(perm[(i * 4 + j) % N_PAGES])
    return cache, q, pos, table


def _jax(cache, q, pos, table):
    return ({k: jnp.asarray(v) for k, v in cache.items()}, jnp.asarray(q),
            jnp.asarray(pos), jnp.asarray(table))


def _torch(cache, q, pos, table):
    return ({k: torch.from_numpy(v.copy()) for k, v in cache.items()},
            torch.from_numpy(q.copy()), torch.from_numpy(pos.copy()),
            torch.from_numpy(table.copy()))


@pytest.mark.parametrize("keep", [2, 4, 8])
def test_paged_attend_matches_jax_reference_and_pallas(keep):
    case = _case(keep)
    jc, jq, jpos, jtab = _jax(*case)
    tc, tq, tpos, ttab = _torch(*case)
    want_ref = np.asarray(JKV.attend_compressed(jq, jc, jpos, keep, kv_block=16,
                                                block_table=jtab))
    want_pallas = np.asarray(jops.attend_with_tail(jq, jc, jpos, block_table=jtab,
                                                   pages_per_tile=2))
    got_scan = TKV.attend_compressed(tq, tc, tpos, keep, kv_block=16,
                                     block_table=ttab).numpy()
    got_ops = tops.attend_with_tail(tq, tc, tpos, block_table=ttab).numpy()
    assert got_ops.shape == want_ref.shape == (4, 1, 4, 16)
    for got in (got_scan, got_ops):
        np.testing.assert_allclose(got, want_ref, atol=ATOL)
        np.testing.assert_allclose(got, want_pallas, atol=ATOL)
    # the depth-0 row sees exactly one position: its own tail entry 0
    np.testing.assert_allclose(got_ops[2, 0].reshape(2, 2, 16),
                               np.broadcast_to(case[0]["tail_v"][2, 0][:, None],
                                               (2, 2, 16)), atol=1e-6)


@pytest.mark.parametrize("kv_block", [8, 16, 64])
def test_paged_attend_chunking_is_invisible(kv_block):
    """The plain scan's chunk width changes its schedule, not its answer."""
    case = _case(4, seed=11)
    jc, jq, jpos, jtab = _jax(*case)
    tc, tq, tpos, ttab = _torch(*case)
    want = np.asarray(JKV.attend_compressed(jq, jc, jpos, 4, kv_block=kv_block,
                                            block_table=jtab))
    got = TKV.attend_compressed(tq, tc, tpos, 4, kv_block=kv_block,
                                block_table=ttab).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_table_view_slice_is_exact():
    """A decode-bucket slice of the table (entries past every watermark
    dropped) gives bitwise the full-table answer, as in the JAX package."""
    case = _case(4)
    tc, tq, tpos, ttab = _torch(*case)
    full = tops.attend_with_tail(tq, tc, tpos, block_table=ttab)
    sliced = tops.attend_with_tail(tq, tc, tpos, block_table=TKV.table_view(ttab, 4))
    assert TKV.table_view(ttab, 4).shape == (4, 4)
    assert TKV.table_view(ttab, None) is ttab
    torch.testing.assert_close(sliced, full, rtol=0, atol=0)
    jc, jq, jpos, jtab = _jax(*case)
    want = np.asarray(jops.attend_with_tail(jq, jc, jpos,
                                            block_table=JKV.table_view(jtab, 4),
                                            pages_per_tile=1))
    np.testing.assert_allclose(sliced.numpy(), want, atol=ATOL)


def test_kernel_layout_plain_version_matches_jax_pallas():
    """The wrapper's (B, Hkv, n_rep, hd) f32 layout, with GQA groups of 4
    and bf16 q / tails on the port side (upcast exactly to f32 for JAX)."""
    cache, q, pos, table = _case(4, hkv=2, n_rep=4, hd=32, seed=5)
    b, hkv, n_rep, hd = 4, 2, 4, 32
    q_bf = torch.from_numpy(q).to(torch.bfloat16)
    tails = {n: torch.from_numpy(cache[n]).to(torch.bfloat16) for n in ("tail_k", "tail_v")}
    jcache = dict(cache, **{n: t.float().numpy() for n, t in tails.items()})
    jc, jq, jpos, jtab = _jax(jcache, q_bf.float().numpy(), pos, table)
    want = np.asarray(jops.attend_with_tail(jq, jc, jpos, block_table=jtab))
    tc = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    args = (tc["packed_k"], tc["scale_k"], tc["packed_v"], tc["scale_v"],
            q_bf[:, 0].reshape(b, hkv, n_rep, hd).contiguous(),
            torch.from_numpy(pos), torch.from_numpy(table),
            tails["tail_k"], tails["tail_v"])
    got = tkernel.attend_paged(*args)
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, hkv, n_rep, hd)
    np.testing.assert_allclose(got.reshape(b, 1, hkv * n_rep, hd).numpy(), want,
                               atol=ATOL)
    torch.testing.assert_close(got, tref.attend_paged(*args), rtol=0, atol=0)


@pytest.mark.parametrize("backend", ["reference", "pallas"])
def test_fused_op_matches_jax_attend_auto(backend):
    """The op the decode step calls for the dct family, against the JAX
    package's backend-dispatched `attend_auto` over the same paged pool."""
    case = _case(4, seed=7)
    jc, jq, jpos, jtab = _jax(*case)
    tc, tq, tpos, ttab = _torch(*case)
    want = np.asarray(JKV.attend_auto(jq, jc, jpos, 4, backend=backend,
                                      block_table=jtab, pages_per_tile=2))
    got = tops.attend_with_tail(tq, tc, tpos, block_table=ttab).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
