"""The whole slice on the CPU: the port's `Engine` against a live JAX
`Engine` (reference codec backend, synchronous host loop), same weights,
same traffic.

yi_6b reduced in f32, max_seq 64, 4 slots, uniform keep 4 and the pyramid
plan, with a roomy pool (32 pages) and a starved one (6 pages, admission
blocks on pages).  Greedy tokens, the page accounting
(`peak_pages_in_use`, `admit_blocked_on_pages`, final free pages) and the
pool byte reports must be equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import api as japi
from repro.serve import engine as JE
from repro_torch.core import kv_cache as TKV
from repro_torch.kernels.fused_attend import kernel as fa_kernel
from repro_torch.kernels.fused_compress import kernel as fc_kernel
from repro_torch.models import api as tapi
from repro_torch.models import convert
from repro_torch.serve import engine as TE

# the request mix of tests/test_codec_families.py::_requests
PLENS = [5, 9, 12, 16, 3, 21, 8, 14]
MAX_NEWS = [3, 7, 5, 9, 4, 6, 8, 5]
CELLS = [(4, 32), (4, 6), ("0-1:keep=8,2-:keep=4", 32), ("0-1:keep=8,2-:keep=4", 6)]


def _requests(Request, n=8, seed=42):
    rng = np.random.default_rng(seed)
    return [Request(uid=i, prompt=rng.integers(0, 200, PLENS[i]).astype(np.int32),
                    max_new=MAX_NEWS[i]) for i in range(n)]


@pytest.fixture(scope="module")
def lm():
    ja = japi.build_reduced("yi_6b")
    jparams = ja.init(jax.random.PRNGKey(0), dtype=jnp.float32)
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, jparams))
    return ja, jparams, tapi.build_reduced("yi_6b"), tparams


@pytest.fixture(scope="module", params=CELLS, ids=lambda c: f"plan={c[0]}-pages={c[1]}")
def served(request, lm):
    plan, pages = request.param
    ja, jparams, ta, tparams = lm
    jeng = JE.Engine(ja, jparams, JE.ServeConfig(
        max_seq=64, kv_compress=True, plan=plan, codec_backend="reference",
        pool_pages=pages, async_host=False), batch=4)
    jdone = jeng.generate(_requests(JE.Request))
    fc_kernel.counter.reset()
    fa_kernel.counter.reset()
    teng = TE.Engine(ta, tparams, TE.ServeConfig(max_seq=64, plan=plan, pool_pages=pages),
                     batch=4, device="cpu")
    tdone = teng.generate(_requests(TE.Request))
    launches = (fc_kernel.counter.count, fa_kernel.counter.count)
    return jeng, jdone, teng, tdone, launches


def test_greedy_tokens_equal(served):
    jeng, jdone, teng, tdone, _ = served
    assert all(r.done for r in tdone)
    assert [r.out_tokens for r in tdone] == [list(map(int, r.out_tokens)) for r in jdone]
    assert [len(r.out_tokens) for r in tdone] == MAX_NEWS


def test_page_accounting_equal(served):
    jeng, _, teng, _, _ = served
    for key in ("peak_pages_in_use", "admit_blocked_on_pages", "tokens_out", "requests"):
        assert teng.stats[key] == jeng.stats[key], key
    js, ts = jeng.kv_pool_stats(), teng.kv_pool_stats()
    for key in ("pool_pages", "page_bytes", "pages_in_use", "pages_device_free",
                "peak_pages_in_use", "kv_pool_bytes", "measured_kv_bytes"):
        assert ts[key] == js[key], key
    assert ts["pages_in_use"] == 0
    teng.check_page_invariants()
    if ts["pool_pages"] == 6:  # the starved pool really starved admission
        assert teng.stats["admit_blocked_on_pages"] > 0


def test_cpu_run_launched_no_kernel_and_reported_latency(served):
    _, _, teng, tdone, launches = served
    assert launches == (0, 0)
    lat = teng.latency_stats()
    assert set(lat) == {"ttft_p50_s", "ttft_p99_s", "itl_p50_s", "itl_p99_s"}
    assert 0 < lat["ttft_p50_s"] <= lat["ttft_p99_s"]
    assert len(teng._lat["ttft_s"]) == len(tdone)
    assert len(teng._lat["itl_s"]) == sum(MAX_NEWS) - len(tdone)
    assert 0 < teng.slot_utilization() <= 1


def test_make_steps_serves_one_request_by_hand(lm):
    """The step factory the engine is built on: prefill, splice, decode."""
    _, _, ta, tparams = lm
    sc = TE.ServeConfig(max_seq=32, plan=4, pool_pages=4)
    prefill_fn, decode_fn, cache_init = TE.make_steps(ta, sc)
    cache = cache_init(1, "cpu")
    toks = torch.arange(16, dtype=torch.int32)[None] % 200
    logits, upd = prefill_fn(tparams, toks, lengths=torch.tensor([12], dtype=torch.int32))
    assert tuple(logits.shape) == (1, ta.cfg.vocab_size)
    TKV.paged_write_rows(cache, upd, [0], [[1, 4]], [[1, 0, 0, 0]])
    tok = torch.argmax(logits, -1).to(torch.int32)
    for p in range(12, 16):
        fp = torch.tensor([2 if p == 15 else 4], dtype=torch.int32)
        logits, cache = decode_fn(tparams, tok, cache, torch.tensor([p], dtype=torch.int32),
                                  fp, attend_blocks=2)
        tok = torch.argmax(logits, -1).to(torch.int32)
        assert torch.isfinite(logits).all()
    assert cache.block_table[0, :2].tolist() == [1, 2]


@pytest.mark.parametrize("plan", [4, "0-1:keep=8,2-:keep=4"])
@pytest.mark.parametrize("budget_mb", [0.05, 1.0])
def test_page_budget_solves_the_pool_like_jax(lm, plan, budget_mb):
    ja, _, ta, _ = lm
    jsc = JE.ServeConfig(max_seq=64, kv_compress=True, plan=plan, page_budget_mb=budget_mb)
    tsc = TE.ServeConfig(max_seq=64, plan=plan, page_budget_mb=budget_mb)
    assert tsc.resolved_pool_pages(ta.cfg) == jsc.resolved_pool_pages(ja.cfg) > 0
    with pytest.raises(ValueError, match="holds no page"):
        TE.ServeConfig(max_seq=64, plan=plan, page_budget_mb=1e-6).resolved_pool_pages(ta.cfg)


@pytest.mark.parametrize("bad", [dict(temperature=0.7), dict(kv_compress=False),
                                 dict(pool_pages=None), dict(plan="0-:keep=4+codec=asc")])
def test_serve_config_rejects_unported_settings(bad):
    kw = dict(max_seq=64, plan=4, pool_pages=8)
    kw.update(bad)
    with pytest.raises(NotImplementedError):
        TE.ServeConfig(**kw)
