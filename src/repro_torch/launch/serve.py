"""Serving CLI for the port: continuous batching over the paged
compressed KV pool, on the card by default.

    python -m repro_torch.launch.serve --arch yi_6b --requests 16 \\
        --batch 8 --max-seq 4096 --kv-pool-pages 4096

    # small plain-PyTorch run on the CPU
    python -m repro_torch.launch.serve --arch yi_6b --reduced --device cpu \\
        --requests 4 --batch 2 --max-seq 64 --kv-pool-pages 16 --vary-lengths

Weights are random, drawn from a torch.Generator seeded with --seed.
Reports decode tokens/s, TTFT/ITL percentiles, the pool footprint and how
many times each kernel launched.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.codec import plan as plan_lib
from repro_torch.configs.base import ARCH_IDS, get_config
from repro_torch.kernels.fused_attend import kernel as fa_kernel
from repro_torch.kernels.fused_compress import kernel as fc_kernel
from repro_torch.models import api as model_api
from repro_torch.serve import engine as E

_DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def _ints(text):
    return tuple(int(b) for b in text.split(",")) if text else None


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi_6b", choices=ARCH_IDS)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="bf16", choices=sorted(_DTYPES))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--kv-keep", type=int, default=4)
    ap.add_argument("--kv-plan", default=None,
                    help="per-layer plan spec, e.g. '0-3:keep=6,4-:keep=3'")
    ap.add_argument("--kv-pool-pages", type=int, default=None)
    ap.add_argument("--kv-page-budget-mb", type=float, default=None)
    ap.add_argument("--prefill-buckets", default=None)
    ap.add_argument("--decode-buckets", default=None,
                    help="comma-separated context buckets, or 'off'")
    ap.add_argument("--vary-lengths", action="store_true")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    api = model_api.build(args.arch, cfg)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = api.init(gen, dtype=_DTYPES[args.dtype], device=device)
    plan = plan_lib.as_plan(args.kv_plan, keep=args.kv_keep)
    pool_pages = args.kv_pool_pages
    if pool_pages is None and args.kv_page_budget_mb is None:
        # room for every slot's worst-case horizon
        pool_pages = args.batch * (args.max_seq // 8)
    dec = False if args.decode_buckets == "off" else _ints(args.decode_buckets)
    sc = E.ServeConfig(
        max_seq=args.max_seq, plan=plan,
        pool_pages=pool_pages, page_budget_mb=args.kv_page_budget_mb,
        prefill_buckets=_ints(args.prefill_buckets), decode_buckets=dec)
    eng = E.Engine(api, params, sc, batch=args.batch, device=device)

    rng = np.random.default_rng(args.seed)
    requests = []
    for i in range(args.requests):
        plen, max_new = args.prompt_len, args.max_new
        if args.vary_lengths:
            plen = int(rng.integers(max(1, plen // 4), plen + 1))
            max_new = int(rng.integers(max(1, max_new // 4), max_new + 1))
        requests.append(E.Request(
            uid=i, prompt=rng.integers(0, cfg.vocab_size, plen).astype(np.int32),
            max_new=max_new))
    fc_kernel.counter.reset()
    fa_kernel.counter.reset()
    done = eng.generate(requests)

    st = eng.stats
    dec_tok = st["tokens_out"] - st["requests"]
    dec_tps = dec_tok / st["decode_s"] if st["steps"] else 0.0
    lat = eng.latency_stats()
    ps = eng.kv_pool_stats()
    print(f"arch={cfg.name} device={device} plan={plan.to_spec()}")
    print(f"requests={st['requests']} decode_steps={st['steps']} "
          f"tokens_out={st['tokens_out']} decode_tok/s={dec_tps:.1f} "
          f"slot_util={eng.slot_utilization():.2f}")
    print(f"time split: prefill_s={st['prefill_s']:.2f} "
          f"decode_s={st['decode_s']:.2f} host_s={st['host_s']:.2f}")
    print(f"latency: ttft p50={lat['ttft_p50_s']*1e3:.1f}ms "
          f"p99={lat['ttft_p99_s']*1e3:.1f}ms | itl p50={lat['itl_p50_s']*1e3:.1f}ms "
          f"p99={lat['itl_p99_s']*1e3:.1f}ms")
    print(f"paged pool: {ps['pool_pages']} pages x {ps['page_bytes']} B "
          f"(peak in use {ps['peak_pages_in_use']}), peak live slots "
          f"{st['peak_live_slots']}, admissions blocked on pages "
          f"{st['admit_blocked_on_pages']}")
    print(f"kernel launches: fused_compress={fc_kernel.counter.count} "
          f"fused_attend_paged={fa_kernel.counter.count}")
    for r in done[:4]:
        print(f"  req {r.uid}: {r.out_tokens[:12]}{'...' if len(r.out_tokens) > 12 else ''}")
    return done


if __name__ == "__main__":
    main()
