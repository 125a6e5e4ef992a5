"""Decoder-only dense LM: parameters, embedding, prefill, unembedding.

Parameters are a nested dict of tensors in the JAX package's tree and
layouts (stacked layer axis first), so `models.convert` carries a JAX tree
across unchanged and `layer_params` slices one layer as views.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import layers as L

Params = dict


def _normal(shape, std, g, dtype, device):
    x = torch.randn(shape, generator=g, dtype=torch.float32, device=device)
    return (x * std).to(dtype)


def _stacked_normal(n, shape, std, g, dtype, device):
    # one layer at a time: the f32 draw never holds more than one layer
    out = torch.empty((n, *shape), dtype=dtype, device=device)
    for i in range(n):
        out[i] = _normal(shape, std, g, dtype, device)
    return out


def init_lm(cfg, generator: torch.Generator, dtype=torch.bfloat16,
            device=None) -> Params:
    """Random weights from `generator` with the JAX package's distributions:
    embed N(0, 0.02), dense weights N(0, 1/d_in), zero biases, unit norms,
    lm_head N(0, 1/d_model).  The generator must live on `device`."""
    if cfg.family != "dense" or cfg.attn_type != "gqa":
        raise NotImplementedError(f"{cfg.family}/{cfg.attn_type}: later slice")
    d, n, hd = cfg.d_model, cfg.n_layers, cfg.head_dim
    g = generator

    def dense_stack(d_in, d_out, bias=False):
        p = {"w": _stacked_normal(n, (d_in, d_out), 1.0 / np.sqrt(d_in), g,
                                  dtype, device)}
        if bias:
            p["b"] = torch.zeros((n, d_out), dtype=dtype, device=device)
        return p

    ones = lambda: {"g": torch.ones((n, d), dtype=dtype, device=device)}
    params: Params = {
        "embed": _normal((cfg.vocab_size, d), 0.02, g, dtype, device),
        "final_norm": {"g": torch.ones((d,), dtype=dtype, device=device)},
        "layers": {
            "ln1": ones(),
            "attn": {
                "wq": dense_stack(d, cfg.n_heads * hd, cfg.qkv_bias),
                "wk": dense_stack(d, cfg.n_kv_heads * hd, cfg.qkv_bias),
                "wv": dense_stack(d, cfg.n_kv_heads * hd, cfg.qkv_bias),
                "wo": dense_stack(cfg.n_heads * hd, d),
            },
            "ln2": ones(),
            "mlp": {
                "wg": dense_stack(d, cfg.d_ff),
                "wu": dense_stack(d, cfg.d_ff),
                "wd": dense_stack(cfg.d_ff, d),
            },
        },
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = _normal((d, cfg.vocab_size), 1.0 / np.sqrt(d), g,
                                    dtype, device)
    return params


def layer_params(params: Params, i: int) -> Params:
    """Views of layer i's weights (the stacked axis indexed away)."""
    def pick(t):
        return {k: pick(v) for k, v in t.items()} if isinstance(t, dict) else t[i]

    return pick(params["layers"])


def embed_tokens(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens]


def unembed(params: Params, x: torch.Tensor, cfg) -> torch.Tensor:
    """Final norm + vocabulary projection -> f32 logits.

    Low-precision weights on the card go through one GEMM of the weight's
    own dtype with f32 accumulation and f32 output (the JAX package's
    `preferred_element_type=float32`): the vocabulary matrix is never cast.
    """
    h = L.rmsnorm(params["final_norm"], x)
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    if w.is_cuda and w.dtype != torch.float32:
        out = torch.mm(h.reshape(-1, h.shape[-1]).to(w.dtype), w,
                       out_dtype=torch.float32)
        return out.reshape(*h.shape[:-1], w.shape[-1])
    return h.float() @ w.float()


def prefill_hidden(params: Params, tokens: torch.Tensor, cfg):
    """Full-prompt forward: (final hidden (B, S, D), K and V of every layer
    stacked (L, B, S, Hkv, hd) in the model dtype)."""
    x = embed_tokens(params, tokens)
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)[None, :]
    ks, vs = [], []
    for i in range(cfg.n_layers):
        p = layer_params(params, i)
        hn = L.rmsnorm(p["ln1"], x)
        k, v = L.gqa_project_kv(p["attn"], hn, positions, cfg)
        x = x + L.gqa_attention(p["attn"], hn, positions, cfg, k=k, v=v)
        x = x + L.mlp(p["mlp"], L.rmsnorm(p["ln2"], x), cfg)
        ks.append(k)
        vs.append(v)
    return x, torch.stack(ks), torch.stack(vs)


def prefill(params: Params, tokens: torch.Tensor, cfg, max_seq: int, *,
            cache_dtype=torch.bfloat16):
    """Full-prompt forward that also fills a raw KV cache of size max_seq:
    (logits (B, S, V) f32, {"k", "v": (L, B, max_seq, Hkv, hd)})."""
    x, k, v = prefill_hidden(params, tokens, cfg)
    pad = max_seq - tokens.shape[1]
    assert pad >= 0, (max_seq, tokens.shape[1])
    padk = lambda a: torch.nn.functional.pad(a, (0, 0, 0, 0, 0, pad)).to(cache_dtype)
    return unembed(params, x, cfg), {"k": padk(k), "v": padk(v)}
