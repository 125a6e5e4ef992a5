"""Drive the PyTorch/CUDA port on one Hopper card and check it end to end.

    python3 chip_smoke.py

Phases (any failure raises, so the exit code is nonzero and no result line
is printed):

  gpu        card name and power limit (nvidia-smi), kernel build seconds
  kernels    each hand-written kernel against its plain PyTorch version on
             the card, at yi_6b shapes: max |delta|, int8 mismatches,
             median kernel / plain / library time, and the bound
  small      yi_6b reduced in f32 served on the card (kernels) and on the
             CPU (plain versions): greedy tokens must agree
  serve      yi_6b at full width and depth in bf16 (random weights from a
             seeded torch.Generator), 8 slots, max_seq 4096, uniform keep 4,
             24 requests: decode tokens/s, TTFT/ITL p50/p99, pool stats and
             the kernels' launches on this path (both must be > 0)
  crosscheck one decode step from a mid-run engine state through the
             kernels and through the plain versions, with the bf16 weights
             and with them cast to f32: logit |delta|, greedy agreement
  profile    the same step's host-clock time, its device kernels by class
             (torch.profiler) and the device's idle share

The line before the last is a JSON object listing every ported kernel; the
last line is {"ok": true, "device": {...}}.  Details land in
chiprun_out/chip_smoke.json.
"""
from __future__ import annotations

import contextlib
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.codec import api as codec_api, reference  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.fused_attend import kernel as fa, ref as fa_ref  # noqa: E402
from repro_torch.kernels.fused_compress import kernel as fc  # noqa: E402
from repro_torch.models import api as model_api  # noqa: E402
from repro_torch.serve import engine as E  # noqa: E402

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOPS = 67e12             # H100 SXM f32 outside the tensor cores
L2_FLUSH_BYTES = 128 << 20    # > the 50 MB L2: launches see a cold cache

RESULTS: dict = {}


def log(line: str) -> None:
    print(line, flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median device time of one fn() in ms, L2 flushed before every call.

    A spin kernel queued ahead of the start event keeps the card busy while
    the host enqueues fn's launches, so the events bracket device work and
    not Python or launch overhead (unless fn itself waits on the device).
    """
    scratch = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    spin_cycles = int(2e9 * (2 * (time.perf_counter() - t0) + 2e-4))  # <= 2 GHz SM clock
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        scratch.zero_()
        torch.cuda._sleep(spin_cycles)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return float(np.median(times))


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_gpu() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    lib = build.library()
    log(f"gpu: {smi}")
    log(f"gpu: torch {torch.__version__} cuda {torch.version.cuda}; kernels built "
        f"in {lib.build_seconds:.1f} s -> {lib.path.relative_to(ROOT)}")
    for src in lib.build_log.split("== ")[1:]:
        regs = [int(w) for w in re.findall(r"Used (\d+) registers", src)]
        spills = sum(int(w) for w in re.findall(r"(\d+) bytes spill stores", src))
        if regs:
            log(f"gpu: ptxas {src.splitlines()[0]}: {len(regs)} instantiations, "
                f"<= {max(regs)} registers, {spills} bytes spilled")
    RESULTS["gpu"] = {"nvidia_smi": smi, "build_s": lib.build_seconds,
                      "build_log": lib.build_log}
    return smi


def compress_case(name, x, keep):
    q, s = fc.compress_plane(x, keep)
    qr, sr = reference.compress_plane(x, keep)
    torch.cuda.synchronize()
    dq = (q.int() - qr.int()).abs()
    n_mis = int((dq != 0).sum())
    share = n_mis / q.numel()
    max_dq = int(dq.max())
    rel_s = float(((s - sr).abs() / sr.abs()).max())
    r, c = x.shape
    nbytes = r * c * x.element_size() + r * c * keep * keep / 64 + 4 * r * c / 64
    flops = (r * c / 64) * 2 * (8 * 8 * keep + keep * keep * 8)
    bms, by = bound(nbytes, flops)
    ms = time_ms(lambda: fc.compress_plane(x, keep))
    plain_ms = time_ms(lambda: reference.compress_plane(x, keep))
    log(f"kernels: fused_compress {name} {tuple(x.shape)} {str(x.dtype)[6:]} keep={keep}: "
        f"int8 mismatches {n_mis}/{q.numel()} (share {share:.2e}, max |d| {max_dq}), "
        f"scale max rel err {rel_s:.2e}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {bms:.4f} ms ({by})")
    if max_dq > 1 or share >= 1e-3 or rel_s > 1e-6:
        raise AssertionError(f"fused_compress {name} keep={keep} disagrees with its plain version")
    return {"case": name, "shape": list(x.shape), "keep": keep, "mismatches": n_mis,
            "share": share, "max_abs_err": max_dq, "scale_rel_err": rel_s,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by}


def attend_case():
    """B=8 slots at depths 0, 7, 8, 1000, 2047 (and three more) over a
    scrambled block table; yi_6b head geometry, keep 4, bf16 q and tails."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    b, hkv, n_rep, hd, keep, width = 8, 4, 8, 128, 4, 512
    nh = hd // 8
    depths = [0, 7, 8, 1000, 2047, 513, 1535, 64]
    need = [d // 8 for d in depths]
    n_pages = sum(need) + 13
    dev = "cuda"
    packed_k = torch.randint(-127, 128, (n_pages, hkv, nh, keep, keep), generator=gen,
                             device=dev, dtype=torch.int8)
    packed_v = torch.randint(-127, 128, packed_k.shape, generator=gen, device=dev,
                             dtype=torch.int8)
    scale_k = torch.rand((n_pages, hkv, nh), generator=gen, device=dev) * 0.02 + 1e-3
    scale_v = torch.rand((n_pages, hkv, nh), generator=gen, device=dev) * 0.02 + 1e-3
    q = torch.randn((b, hkv, n_rep, hd), generator=gen, device=dev).to(torch.bfloat16)
    tail_k = torch.randn((b, 8, hkv, hd), generator=gen, device=dev).to(torch.bfloat16)
    tail_v = torch.randn((b, 8, hkv, hd), generator=gen, device=dev).to(torch.bfloat16)
    perm = torch.randperm(n_pages, generator=gen, device=dev).cpu().numpy()
    table = np.zeros((b, width), np.int32)
    k = 0
    for i, nb in enumerate(need):
        table[i, :nb] = perm[k:k + nb]
        k += nb
    table = torch.from_numpy(table).to(dev)
    pos = torch.tensor(depths, dtype=torch.int32, device=dev)
    args = (packed_k, scale_k, packed_v, scale_v, q, pos, table, tail_k, tail_v)
    out = fa.attend_paged(*args)
    ref = fa_ref.attend_paged(*args)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    ms = time_ms(lambda: fa.attend_paged(*args))
    plain_ms = time_ms(lambda: fa_ref.attend_paged(*args), iters=5, warmup=1)

    # yardstick: SDPA over the already-decompressed K/V (not used by the port)
    s_max = max(depths) + 1
    kd = torch.zeros((b, hkv, s_max, hd), device=dev, dtype=torch.bfloat16)
    vd = torch.zeros_like(kd)
    lc = dict(packed_k=packed_k, scale_k=scale_k, packed_v=packed_v, scale_v=scale_v)
    for i, d in enumerate(depths):
        nb = need[i]
        if nb:
            pages = table[i, :nb].long()
            for plane, dst in (("k", kd), ("v", vd)):
                blocks = lc["packed_" + plane][pages].transpose(0, 1)   # (Hkv, nb, nh, k, k)
                sc = lc["scale_" + plane][pages].transpose(0, 1)
                dst[i, :, :nb * 8] = codec_api.decompress_blocks(blocks, sc, torch.bfloat16)
        tl = d - (d // 8) * 8 + 1
        kd[i, :, nb * 8:nb * 8 + tl] = tail_k[i, :tl].transpose(0, 1)
        vd[i, :, nb * 8:nb * 8 + tl] = tail_v[i, :tl].transpose(0, 1)
    mask = (torch.arange(s_max, device=dev)[None, :] <= pos[:, None].long())[:, None, None]
    qh = q.reshape(b, hkv * n_rep, 1, hd)
    kh = kd.repeat_interleave(n_rep, dim=1)
    vh = vd.repeat_interleave(n_rep, dim=1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_out = sdpa(qh, kh, vh, attn_mask=mask).float().reshape(b, hkv, n_rep, hd)
    lib_err = float((lib_out - ref).abs().max())
    library_ms = time_ms(lambda: sdpa(qh, kh, vh, attn_mask=mask))

    pages_read = sum(need)  # data-dependent: only pages below the watermarks
    nbytes = (pages_read * hkv * 2 * nh * (keep * keep + 4)
              + 2 * tail_k.numel() * tail_k.element_size()
              + q.numel() * q.element_size() + out.numel() * 4
              + 4 * b + 4 * pages_read)
    per_tile_flops = 2 * 8 * hd * (keep + 8) + 4 * 8 * n_rep * hd
    flops = (pages_read + b) * hkv * per_tile_flops
    bms, by = bound(nbytes, flops)
    log(f"kernels: fused_attend_paged B={b} depths={depths} keep={keep}: max |d| vs plain "
        f"{err:.2e} (sdpa yardstick {lib_err:.2e}); kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, library (sdpa) {library_ms:.4f} ms, bound {bms:.4f} ms ({by}); "
        f"grid {b * hkv} blocks on {torch.cuda.get_device_properties(0).multi_processor_count} SMs")
    if not err < 1e-3:
        raise AssertionError(f"fused_attend_paged disagrees with its plain version: {err}")
    return {"depths": depths, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "library_max_abs_err": lib_err,
            "bound_ms": bms, "bound_by": by}


def phase_kernels():
    gen = torch.Generator(device="cuda").manual_seed(0)
    prefill = torch.randn((8 * 4 * 1024, 128), generator=gen, device="cuda").to(torch.bfloat16)
    flush = torch.randn((2 * 8 * 4 * 8, 128), generator=gen, device="cuda").to(torch.bfloat16)
    comp = [compress_case(name, x, keep)
            for name, x in (("prefill", prefill), ("flush", flush))
            for keep in (4, 8)]
    RESULTS["kernels"] = {"fused_compress": comp, "fused_attend_paged": attend_case()}


def _small_requests(Request):
    plens, max_news = [5, 9, 12, 16, 3, 21, 8, 14], [3, 7, 5, 9, 4, 6, 8, 5]
    rng = np.random.default_rng(42)
    return [Request(uid=i, prompt=rng.integers(0, 200, plens[i]).astype(np.int32),
                    max_new=max_news[i]) for i in range(8)]


def phase_small():
    """The whole path at reduced size in f32: kernels on the card vs plain
    versions on the CPU, same weights, same traffic."""
    api = model_api.build_reduced("yi_6b")
    params = api.init(torch.Generator(device="cpu").manual_seed(0), dtype=torch.float32,
                      device="cpu")
    out = {}
    for plan in (4, "0-1:keep=8,2-:keep=4"):
        toks = {}
        for dev in ("cuda", "cpu"):
            sc = E.ServeConfig(max_seq=64, plan=plan, pool_pages=32)
            eng = E.Engine(api, params, sc, batch=4, device=dev)
            toks[dev] = [r.out_tokens for r in eng.generate(_small_requests(E.Request))]
        agree = toks["cuda"] == toks["cpu"]
        log(f"small: yi_6b reduced f32 plan={plan}: card (kernels) tokens == cpu (plain) "
            f"tokens: {agree}")
        if not agree:
            raise AssertionError(f"small run diverged: {toks}")
        out[str(plan)] = toks["cuda"]
    RESULTS["small"] = out


class CapturingEngine(E.Engine):
    """Engine that snapshots its decode inputs once, mid-run: at the first
    step from `CAPTURE_AFTER` on in which some row flushes a page."""

    CAPTURE_AFTER = 24
    captured = None

    def _dispatch(self, cache, live):
        if self.captured is None and self.stats["steps"] >= self.CAPTURE_AFTER:
            fp, bucket = self._decode_args(live)
            if (fp < self._n_pages).any():
                self.captured = dict(
                    token=self._tok_dev.clone(), pos=self._pos_dev.clone(),
                    cache=cache.clone(), flush_page=torch.from_numpy(fp),
                    attend_blocks=bucket // 8, live=list(live))
        return super()._dispatch(cache, live)


def phase_serve():
    cfg = get_config("yi_6b")
    api = model_api.build("yi_6b", cfg)
    t0 = time.perf_counter()
    params = api.init(torch.Generator(device="cuda").manual_seed(0), dtype=torch.bfloat16,
                      device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"serve: yi_6b full width: {n_params / 1e9:.2f} B params bf16 "
        f"({torch.cuda.memory_allocated() / 1e9:.1f} GB) in {time.perf_counter() - t0:.1f} s")
    batch, max_seq = 8, 4096
    sc = E.ServeConfig(max_seq=max_seq, plan=4, pool_pages=batch * max_seq // 8)
    eng = CapturingEngine(api, params, sc, batch, device="cuda")
    rng = np.random.default_rng(0)
    reqs = [E.Request(uid=i,
                      prompt=rng.integers(0, cfg.vocab_size,
                                          int(rng.integers(128, 2049))).astype(np.int32),
                      max_new=int(rng.integers(32, 65))) for i in range(24)]
    torch.cuda.reset_peak_memory_stats()
    fc.counter.reset()
    fa.counter.reset()
    done = eng.generate(reqs)
    torch.cuda.synchronize()
    launches = {"fused_compress": fc.counter.count, "fused_attend_paged": fa.counter.count}
    st = eng.stats
    lat = eng.latency_stats()
    pool = eng.kv_pool_stats()
    dec_tok = st["tokens_out"] - st["requests"]
    tps = dec_tok / st["decode_s"]
    log(f"serve: {st['requests']} requests, {st['steps']} decode steps, {st['tokens_out']} "
        f"tokens; decode {tps:.1f} tok/s; prefill_s {st['prefill_s']:.2f} decode_s "
        f"{st['decode_s']:.2f} host_s {st['host_s']:.2f}")
    log(f"serve: ttft p50 {lat['ttft_p50_s'] * 1e3:.1f} ms p99 {lat['ttft_p99_s'] * 1e3:.1f} ms; "
        f"itl p50 {lat['itl_p50_s'] * 1e3:.2f} ms p99 {lat['itl_p99_s'] * 1e3:.2f} ms; "
        f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.1f} GB")
    log(f"serve: kv_pool_stats {json.dumps(pool)}")
    log(f"serve: launches on this path {json.dumps(launches)} "
        f"(decode steps {st['steps']}, layers {cfg.n_layers})")
    bad = [r.uid for r in done if not r.done or len(r.out_tokens) != r.max_new]
    if bad:
        raise AssertionError(f"requests did not finish: {bad}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel never launched on the serve path: {launches}")
    eng.check_page_invariants()
    if pool["pages_in_use"] != 0:
        raise AssertionError(f"pages leaked: {pool['pages_in_use']}")
    RESULTS["serve"] = {"stats": st, "latency": lat, "kv_pool_stats": pool,
                        "launches": launches, "decode_tok_s": tps,
                        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    return eng, params, cfg, launches


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _captured_step(params, cfg, cap, cache):
    logits, _ = E.decode_step_compressed(
        params, cap["token"], cache, cap["pos"], cfg, flush_page=cap["flush_page"],
        attend_blocks=cap["attend_blocks"])
    return logits


@contextlib.contextmanager
def plain_versions():
    """Bind both kernel wrappers to their plain PyTorch versions for the
    duration: the path looks the wrappers up at call time, so a step run
    inside computes on the card without launching a kernel.  The oracle of
    the crosscheck; the port itself has no such switch."""
    saved = fc.compress_plane, fa.attend_paged
    fc.compress_plane, fa.attend_paged = reference.compress_plane, fa_ref.attend_paged
    try:
        yield
    finally:
        fc.compress_plane, fa.attend_paged = saved


def phase_crosscheck(eng, params, cfg):
    """The captured step through the kernels and through the plain versions,
    with the bf16 weights served and with the same weights in f32.  Logits
    may differ by rounding; every row whose top-2 logit margin exceeds twice
    the largest |delta| must pick the same greedy token."""
    cap = eng.captured
    if cap is None:
        raise AssertionError("no mid-run decode step with a flush was captured")
    live = cap["live"]
    n_flush = int((cap["flush_page"] < eng._n_pages).sum())
    out = {}
    limits = {"bf16": 0.25, "f32": 1e-2}  # max logit |delta| (logit scale ~5)
    for label in ("bf16", "f32"):
        p = params if label == "bf16" else _cast(params, torch.float32)
        fc.counter.reset()
        fa.counter.reset()
        a = _captured_step(p, cfg, cap, cap["cache"].clone())[live]
        kernel_launches = (fc.counter.count, fa.counter.count)
        with plain_versions():
            b = _captured_step(p, cfg, cap, cap["cache"].clone())[live]
        if min(kernel_launches) <= 0 or (fc.counter.count, fa.counter.count) != kernel_launches:
            raise AssertionError(f"{label} crosscheck: kernel step launched {kernel_launches}, "
                                 f"plain step must launch none")
        del p
        torch.cuda.synchronize()
        if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
            raise AssertionError(f"non-finite logits in the {label} crosscheck")
        diff = float((a - b).abs().max())
        same = a.argmax(-1) == b.argmax(-1)
        top2 = b.topk(2, dim=-1).values
        decided = (top2[:, 0] - top2[:, 1]) > 2 * diff
        log(f"crosscheck {label}: one decode step ({len(live)} live slots, {n_flush} "
            f"flushing, positions {cap['pos'][live].tolist()}): kernels vs plain max logit "
            f"|d| {diff:.3g} (logit scale {float(b.abs().max()):.2f}), greedy agreement "
            f"{int(same.sum())}/{len(live)}, rows decided by a margin > 2|d|: "
            f"{int(decided.sum())}, all agree: {bool(same[decided].all())}")
        if diff > limits[label] or not bool(same[decided].all()):
            raise AssertionError(f"{label} kernel step disagrees with the plain step")
        out[label] = {"max_logit_abs_diff": diff, "greedy_agreement": float(same.float().mean()),
                      "decided_rows": int(decided.sum())}
    RESULTS["crosscheck"] = dict(out, flushing_rows=n_flush)


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    return tree.to(dtype)


KERNEL_CLASSES = (("fused_attend_paged", ("attend_paged_kernel",)),
                  ("fused_compress", ("compress_kernel",)),
                  ("matmul", ("gemm", "gemv", "xmma", "cutlass", "cublas", "nvjet")))


def device_breakdown(kernels):
    """[(name, start_us, end_us)] -> (busy us: the union of the intervals,
    {kernel class: summed us}, {kernel name: summed us}), largest first."""
    busy, end = 0.0, float("-inf")
    for s, t in sorted((s, t) for _, s, t in kernels):
        busy += max(0.0, t - max(s, end))
        end = max(end, t)
    by_class: dict[str, float] = {}
    by_name: dict[str, float] = {}
    for name, s, t in kernels:
        low = name.lower()
        cls = next((c for c, keys in KERNEL_CLASSES if any(k in low for k in keys)), "other")
        by_class[cls] = by_class.get(cls, 0.0) + (t - s)
        by_name[name] = by_name.get(name, 0.0) + (t - s)
    largest = lambda d: dict(sorted(d.items(), key=lambda x: -x[1]))
    return busy, largest(by_class), largest(by_name)


def phase_profile(eng, params, cfg, steps: int = 3):
    """Where one full-width decode step's time goes: host-clock step time,
    then torch.profiler's device kernels of the same steps grouped by class,
    and the device's idle share."""
    from torch.profiler import ProfilerActivity, profile

    cap = eng.captured

    def fresh():  # each step decodes into its own copy of the captured pool
        return [cap["cache"].clone() for _ in range(steps)]

    def run(caches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for c in caches:
            _captured_step(params, cfg, cap, c)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / steps * 1e3

    run(fresh())  # warm
    step_ms = run(fresh())
    caches = fresh()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run(caches)
    kernels = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        log(f"profile: decode step {step_ms:.2f} ms (host clock); torch.profiler "
            "recorded no device kernels: device breakdown not measured")
        RESULTS["profile"] = {"step_ms": step_ms, "device_busy_ms": None}
        return
    busy_us, by_class, by_name = device_breakdown(kernels)
    busy_ms = busy_us / steps / 1e3
    shares = {c: t / steps / 1e3 for c, t in by_class.items()}
    top = {n[:120]: t / steps / 1e3 for n, t in list(by_name.items())[:8]}
    log(f"profile: decode step {step_ms:.2f} ms (host clock, B={len(cap['live'])} live, "
        f"positions up to {int(cap['pos'].max())}); device busy {busy_ms:.2f} ms, idle share "
        f"{max(0.0, 1 - busy_ms / step_ms):.3f}; device ms per step by kernel class "
        + ", ".join(f"{c} {t:.2f}" for c, t in shares.items()))
    log(f"profile: {len(kernels) // steps} device kernels per step; largest (ms per step): "
        + "; ".join(f"{n[:60]} {t:.2f}" for n, t in top.items()))
    RESULTS["profile"] = {"step_ms": step_ms, "device_busy_ms": busy_ms,
                          "device_ms_by_class": shares, "device_ms_by_kernel": top,
                          "n_kernels": len(kernels) // steps}


def kernels_line(launches) -> dict:
    comp = RESULTS["kernels"]["fused_compress"]
    main = next(c for c in comp if c["case"] == "prefill" and c["keep"] == 4)
    att = RESULTS["kernels"]["fused_attend_paged"]
    return {"kernels": [
        {"name": "fused_compress", "route": "cuda",
         "source": "src/repro_torch/csrc/fused_compress.cu",
         "replaces": "src/repro/kernels/fused_compress/kernel.py:89",
         "launches": launches["fused_compress"],
         "max_abs_err": max(c["max_abs_err"] for c in comp),
         "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
         "bound_by": main["bound_by"], "library_ms": None},
        {"name": "fused_attend_paged", "route": "cuda",
         "source": "src/repro_torch/csrc/fused_attend_paged.cu",
         "replaces": "src/repro/kernels/fused_attend/kernel.py:348",
         "launches": launches["fused_attend_paged"],
         "max_abs_err": att["max_abs_err"], "ms": att["ms"], "plain_ms": att["plain_ms"],
         "bound_ms": att["bound_ms"], "bound_by": att["bound_by"],
         "library_ms": att["library_ms"]},
    ]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    smi = phase_gpu()
    phase_kernels()
    phase_small()
    eng, params, cfg, launches = phase_serve()
    phase_crosscheck(eng, params, cfg)
    phase_profile(eng, params, cfg)
    line = kernels_line(launches)
    RESULTS["kernels_line"] = line
    RESULTS["seconds"] = time.perf_counter() - t0
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(RESULTS, indent=1, default=str))
    log(f"done in {RESULTS['seconds']:.1f} s")
    log(json.dumps(line))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
