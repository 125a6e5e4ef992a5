"""Transformer building blocks of the dense GQA path, in plain PyTorch.

Conventions follow the JAX package so the two compare like with like:
dense weights are (d_in, d_out) and layer-stacked weights carry a leading
L axis; products accumulate in f32 and cast to the input dtype; norms,
softmax and the MLP activation run in f32; rope is half-split.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

DEFAULT_KV_BLOCK = 1024


def dense(p, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"]  # f32 accumulation inside the GEMM
    if "b" in p:
        y = y.float() + p["b"].float()
    return y.to(x.dtype)


def rmsnorm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * p["g"].float()).to(x.dtype)


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 1e4) -> torch.Tensor:
    """x (..., S, H, hd); positions (..., S).  Half-split rotation: the
    first and second halves of hd are the (real, imaginary) pair."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)
    angles = positions[..., None].float() * freqs  # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def chunked_attention(q, k, v, *, causal: bool = True, q_offset: int = 0,
                      kv_block: int = DEFAULT_KV_BLOCK, scale=None) -> torch.Tensor:
    """Flash-style attention in plain PyTorch: loop over KV blocks with a
    running (max, sum, acc), GQA-aware (K/V heads are never repeated in
    memory).  q (B, Sq, H, hd), k/v (B, Sk, Hkv, hd) -> (B, Sq, H, hd_v).
    Never materializes (Sq, Sk): the working set is (Sq, kv_block)."""
    b, sq, h, hd = q.shape
    _, sk, hkv, _ = k.shape
    hd_v = v.shape[-1]
    n_rep = h // hkv
    scale = scale if scale is not None else 1.0 / np.sqrt(hd)
    kv_block = min(kv_block, sk)
    nblocks = (sk + kv_block - 1) // kv_block
    dev = q.device
    qf = (q.float() * scale).reshape(b, sq, hkv, n_rep, hd)
    q_pos = torch.arange(sq, device=dev) + q_offset
    m = torch.full((b, hkv, n_rep, sq), -torch.inf, device=dev)
    l = torch.zeros((b, hkv, n_rep, sq), device=dev)
    acc = torch.zeros((b, hkv, n_rep, sq, hd_v), device=dev)
    for blk in range(nblocks):
        k0 = blk * kv_block
        kb = k[:, k0:k0 + kv_block].float()
        vb = v[:, k0:k0 + kv_block].float()
        kv_pos = k0 + torch.arange(kb.shape[1], device=dev)
        s = torch.einsum("bqgrd,bkgd->bgrqk", qf, kb)
        if causal:
            mask = kv_pos[None, :] <= q_pos[:, None]
            s = torch.where(mask, s, -torch.inf)
        m_new = torch.maximum(m, s.amax(dim=-1))
        # fully-masked rows (m_new == -inf): exp(-inf - -inf) -> use 0
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.exp(s - m_safe[..., None])
        if causal:
            p = torch.where(mask, p, 0.0)
        alpha = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bgrqk,bkgd->bgrqd", p, vb)
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)  # (B, Hkv, rep, Sq, hd_v)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd_v).to(q.dtype)


def gqa_project_kv(p, x, positions, cfg):
    b, s, _ = x.shape
    hd = cfg.head_dim
    k = dense(p["wk"], x).reshape(b, s, cfg.n_kv_heads, hd)
    v = dense(p["wv"], x).reshape(b, s, cfg.n_kv_heads, hd)
    k = apply_rope(k, positions, cfg.rope_theta)
    return k, v


def gqa_attention(p, x, positions, cfg, *, k=None, v=None, q_offset: int = 0,
                  kv_block: int | None = None):
    """Self-attention; pass (k, v) to attend against precomputed K/V."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    q = dense(p["wq"], x).reshape(b, s, cfg.n_heads, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    if k is None:
        k, v = gqa_project_kv(p, x, positions, cfg)
    out = chunked_attention(q, k, v, causal=True, q_offset=q_offset,
                            kv_block=kv_block or DEFAULT_KV_BLOCK)
    return dense(p["wo"], out.reshape(b, s, cfg.n_heads * hd))


def mlp(p, x, cfg):
    if cfg.mlp_type != "gated_silu":
        raise NotImplementedError(f"mlp_type {cfg.mlp_type!r}: later slice")
    g = dense(p["wg"], x)
    u = dense(p["wu"], x)
    return dense(p["wd"], F.silu(g.float()).to(x.dtype) * u)
