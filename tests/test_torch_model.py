"""Parity of the port's dense GQA model with the JAX package (CPU, f32).

Weights are drawn by the JAX package, carried across with
`models.convert.params_from_numpy`, and perturbed (biases and norm gains)
so the qkv-bias and norm paths do real work.  Prefill logits and K/V, the
paged compressed prefill, and three teacher-forced
`decode_step_compressed` steps (rows flushing at different steps, one row
starting on a block boundary) must agree at atol 1e-4, rtol 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kv_cache as JKV
from repro.models import api as japi
from repro.models import transformer as JT
from repro.serve import engine as JE
from repro_torch.core import kv_cache as TKV
from repro_torch.models import api as tapi
from repro_torch.models import convert
from repro_torch.models import transformer as TT
from repro_torch.serve import engine as TE

TOL = dict(atol=1e-4, rtol=1e-4)
ARCHS = ["yi_6b", "qwen2_0_5b"]
LENGTHS = np.array([6, 13, 16], np.int32)   # flush at steps 2, 3 and never
BUCKET, MAX_SEQ, N_PAGES = 16, 32, 8
# slot b's pages by block index; prompt blocks first, then decode flushes
SLOT_PAGES = [[4], [0, 6], [2, 5]]


@pytest.fixture(scope="module", params=ARCHS)
def twin(request):
    """(arch, JAX api, JAX params, port api, port params) with equal weights."""
    arch = request.param
    ja = japi.build_reduced(arch)
    tree = jax.tree.map(np.asarray, ja.init(jax.random.PRNGKey(0), dtype=jnp.float32))
    rng = np.random.default_rng(1)

    def perturb(path, a):
        name = jax.tree_util.keystr(path)
        if name.endswith("['b']"):
            return (0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        if name.endswith("['g']"):
            return (1 + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    tree = jax.tree_util.tree_map_with_path(perturb, tree)
    return (arch, ja, jax.tree.map(jnp.asarray, tree), tapi.build_reduced(arch),
            convert.params_from_numpy(tree))


def _tokens(seed=0):
    rng = np.random.default_rng(seed)
    toks = np.zeros((len(LENGTHS), BUCKET), np.int32)
    for i, n in enumerate(LENGTHS):
        toks[i, :n] = rng.integers(0, 256, n)
    return toks


def test_init_lm_tree_matches_jax(twin):
    arch, ja, jparams, ta, _ = twin
    tparams = ta.init(torch.Generator().manual_seed(0), dtype=torch.float32, device="cpu")
    jshapes = jax.tree.map(lambda a: tuple(a.shape), jparams)
    tshapes = jax.tree.map(lambda t: tuple(t.shape), tparams)
    assert tshapes == jshapes
    # the same distributions: N(0, 1/d_in) dense weights, N(0, 0.02) embed
    w = tparams["layers"]["mlp"]["wg"]["w"]
    assert abs(float(w.std()) * np.sqrt(w.shape[1]) - 1) < 0.05
    assert abs(float(tparams["embed"].std()) / 0.02 - 1) < 0.05
    if ta.cfg.qkv_bias:
        assert float(tparams["layers"]["attn"]["wq"]["b"].abs().max()) == 0.0
    assert ("lm_head" in tparams) == (not ta.cfg.tie_embeddings)


def test_prefill_logits_and_kv_match_jax(twin):
    arch, ja, jparams, ta, tparams = twin
    if ta.cfg.qkv_bias:  # the bias path is live
        assert float(tparams["layers"]["attn"]["wk"]["b"].abs().min()) > 0
    toks = _tokens()
    jl, jcache = JT.prefill(jparams, jnp.asarray(toks), ja.cfg, MAX_SEQ,
                            cache_dtype=jnp.float32)
    tl, tcache = TT.prefill(tparams, torch.from_numpy(toks), ta.cfg, MAX_SEQ,
                            cache_dtype=torch.float32)
    assert tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(tcache[key].numpy(), np.asarray(jcache[key]), **TOL)


def _admit(twin):
    """Paged prefill of the three rows and their splice, on both sides."""
    arch, ja, jparams, ta, tparams = twin
    toks = _tokens()
    jl, jupd = JE.prefill_compressed_paged(jparams, jnp.asarray(toks), ja.cfg, plan=4,
                                           lengths=jnp.asarray(LENGTHS), dtype=jnp.float32)
    tl, tupd = TE.prefill_compressed_paged(tparams, torch.from_numpy(toks), ta.cfg, plan=4,
                                           lengths=torch.from_numpy(LENGTHS),
                                           dtype=torch.float32)
    page_ids = np.full((3, BUCKET // 8), N_PAGES, np.int32)
    table = np.zeros((3, MAX_SEQ // 8), np.int32)
    for i, n in enumerate(LENGTHS):
        nb = int(n) // 8
        page_ids[i, :nb] = SLOT_PAGES[i][:nb]
        table[i, :nb] = SLOT_PAGES[i][:nb]
    slots = np.arange(3, dtype=np.int32)
    jc = JKV.init_paged_cache(ja.cfg, 3, MAX_SEQ, N_PAGES, plan=4, dtype=jnp.float32)
    jc = JKV.paged_write_rows(jc, jupd, jnp.asarray(slots), jnp.asarray(page_ids),
                              jnp.asarray(table))
    tc = TKV.init_paged_cache(ta.cfg, 3, MAX_SEQ, N_PAGES, plan=4, dtype=torch.float32,
                              device="cpu")
    TKV.paged_write_rows(tc, tupd, slots, page_ids, table)
    return jl, tl, jc, tc


def test_paged_prefill_matches_jax(twin):
    jl, tl, jc, tc = _admit(twin)
    last = np.asarray(jl)[np.arange(3), LENGTHS - 1]
    np.testing.assert_allclose(tl.numpy(), last, **TOL)
    for ts, js in zip(tc.segments, jc.segments):
        for name, a in js.as_tree().items():
            got, want = ts.planes[name].numpy(), np.asarray(a)
            if want.dtype == np.int8:
                d = np.abs(got.astype(np.int32) - want.astype(np.int32))
                assert d.max() <= 1 and (d != 0).sum() <= 1e-3 * d.size, name
            else:
                np.testing.assert_allclose(got, want, **TOL, err_msg=name)
    np.testing.assert_array_equal(tc.block_table.numpy(), np.asarray(jc.block_table))


def test_teacher_forced_decode_matches_jax(twin):
    arch, ja, jparams, ta, tparams = twin
    _, _, jc, tc = _admit(twin)
    forced = np.random.default_rng(5).integers(0, 256, (3, len(LENGTHS))).astype(np.int32)
    flushes = 0
    for step in range(3):
        pos = LENGTHS + step
        fp = np.full(3, N_PAGES, np.int32)
        for i, p in enumerate(pos):
            if p % 8 == 7:
                fp[i] = SLOT_PAGES[i][p // 8]
                flushes += 1
        tok = forced[step]
        jl, jc = JE.decode_step_compressed(jparams, jnp.asarray(tok), jc, jnp.asarray(pos),
                                           ja.cfg, codec_backend="reference",
                                           flush_page=jnp.asarray(fp), attend_blocks=2)
        tl, tc = TE.decode_step_compressed(tparams, torch.from_numpy(tok), tc,
                                           torch.from_numpy(pos), ta.cfg,
                                           flush_page=torch.from_numpy(fp), attend_blocks=2)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL,
                                   err_msg=f"{arch} step {step}")
        np.testing.assert_array_equal(tc.block_table.numpy(), np.asarray(jc.block_table))
    assert flushes == 2
    for ts, js in zip(tc.segments, jc.segments):
        for name in ("scale_k", "scale_v", "tail_k", "tail_v"):
            np.testing.assert_allclose(ts.planes[name].numpy(),
                                       np.asarray(js.as_tree()[name]), **TOL)
