"""Parity of the port's truncated codec, plans and configs with the JAX
package (reference backend, CPU).

Packed int8 may differ from the JAX reference only by rounding-tie flips:
the two frameworks sum the 8x8 transform in different orders, so a
coefficient that lands within float noise of a .5 boundary can round
either way.  Every flip must be |delta| == 1 and their share stays under
1e-3; the count is asserted per case and printed.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import codec as jcodec
from repro import configs as _jconfigs  # noqa: F401  (registers the package)
from repro.codec import plan as jplan
from repro.configs.base import get_config as jget_config
from repro_torch.codec import api as tapi
from repro_torch.codec import plan as tplan
from repro_torch.configs import get_config as tget_config

# the 8-aligned shapes of tests/test_codec_backends.py's SHAPES grid, then
# KV-shaped planes (rows, Hkv, S, hd)
ALIGNED = [(16, 16), (24, 16), (40, 264), (3, 24, 16), (2, 5, 16, 32)]
KV = [(2, 2, 24, 16), (1, 4, 64, 128), (3, 2, 40, 64)]
MAX_FLIP_SHARE = 1e-3


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _flips(q_port, q_jax):
    d = np.abs(q_port.astype(np.int32) - q_jax.astype(np.int32))
    return int((d != 0).sum()), int(d.max())


@pytest.mark.parametrize("shape", ALIGNED + KV, ids=str)
@pytest.mark.parametrize("keep", [2, 4, 8])
def test_compress_blocks_matches_jax(shape, keep):
    x = _x(shape, seed=sum(shape) + keep)
    qj, sj = jcodec.compress_blocks(jnp.asarray(x), keep, backend="reference")
    qt, st = tapi.compress_blocks(torch.from_numpy(x), keep)
    qj, sj = np.asarray(qj), np.asarray(sj)
    assert qt.dtype == torch.int8 and tuple(qt.shape) == qj.shape
    assert tuple(st.shape) == sj.shape
    np.testing.assert_allclose(st.numpy(), sj, rtol=1e-6)
    n, worst = _flips(qt.numpy(), qj)
    print(f"int8 tie flips {shape} keep={keep}: {n}/{qj.size}")
    assert worst <= 1, worst
    assert n <= MAX_FLIP_SHARE * qj.size, (n, qj.size)


@pytest.mark.parametrize("shape", ALIGNED + KV, ids=str)
@pytest.mark.parametrize("keep", [2, 4, 8])
def test_decompress_blocks_matches_jax(shape, keep):
    x = _x(shape, seed=sum(shape) + keep + 1)
    qj, sj = jcodec.compress_blocks(jnp.asarray(x), keep, backend="reference")
    yj = np.asarray(jcodec.decompress_blocks(qj, sj, backend="reference"))
    yt = tapi.decompress_blocks(torch.from_numpy(np.array(qj)),
                                torch.from_numpy(np.array(sj)))
    assert tuple(yt.shape) == x.shape
    np.testing.assert_allclose(yt.numpy(), yj, atol=1e-5)
    # the port's own roundtrip: int8 quantization error only at keep 8
    rt = tapi.decompress_blocks(*tapi.compress_blocks(torch.from_numpy(x), keep))
    if keep == 8:
        assert float((rt - torch.from_numpy(x)).abs().max()) < 0.35


def test_compress_blocks_rejects_unaligned():
    with pytest.raises(ValueError, match="multiples of 8"):
        tapi.compress_blocks(torch.zeros(13, 21), 4)


@pytest.mark.parametrize("keep", range(1, 9))
def test_tile_bytes_match(keep):
    assert tapi.tile_bytes(keep) == jcodec.api.tile_bytes(keep)
    assert tapi.TILE_HEADER_BYTES == jcodec.api.TILE_HEADER_BYTES


SPECS = ["0-3:keep=6,4-:keep=3", "0-1:keep=8,2-:keep=4", "0:keep=2+off,1-:keep=5",
         "2-5:keep=7+bits=6,0-:keep=4"]


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("arch", ["yi_6b", "qwen2_0_5b"])
def test_plan_spec_segments_and_bytes_match(spec, arch):
    jp, tp = jplan.CompressionPlan.from_spec(spec), tplan.CompressionPlan.from_spec(spec)
    assert tp.to_spec() == jp.to_spec()
    assert tplan.CompressionPlan.from_spec(tp.to_spec()) == tp
    for cfg_j, cfg_t in ((jget_config(arch), tget_config(arch)),
                         (jget_config(arch).reduced(), tget_config(arch).reduced())):
        segs_j = [(a, b, p.keep, p.bits, p.enabled, p.codec)
                  for a, b, p in jp.segments(cfg_j.n_layers)]
        segs_t = [(a, b, p.keep, p.bits, p.enabled, p.codec)
                  for a, b, p in tp.segments(cfg_t.n_layers)]
        assert segs_t == segs_j
        assert tp.page_bytes(cfg_t) == jp.page_bytes(cfg_j)
        assert tp.kv_bytes_per_token(cfg_t) == jp.kv_bytes_per_token(cfg_j)


@pytest.mark.parametrize("keep", [1, 4, 8])
def test_uniform_plan_and_as_plan_match(keep):
    cfg_j, cfg_t = jget_config("yi_6b"), tget_config("yi_6b")
    assert tplan.as_plan(keep).to_spec() == jplan.as_plan(keep).to_spec()
    assert tplan.as_plan(None, keep=keep).page_bytes(cfg_t) == \
        jplan.as_plan(None, keep=keep).page_bytes(cfg_j)


def test_plan_rejects_unported_codecs():
    with pytest.raises(NotImplementedError, match="later slice"):
        tplan.CompressionPlan.from_spec("0-:keep=4+codec=bitplane")
    with pytest.raises(ValueError, match="unknown codec family"):
        tplan.LayerPolicy(codec="nope")


@pytest.mark.parametrize("arch", ["yi_6b", "qwen2_0_5b"])
@pytest.mark.parametrize("reduced", [False, True])
def test_config_copies_match(arch, reduced):
    cj, ct = jget_config(arch), tget_config(arch)
    if reduced:
        cj, ct = cj.reduced(), ct.reduced()
    fj = {f.name: getattr(cj, f.name) for f in dataclasses.fields(cj)}
    ft = {f.name: getattr(ct, f.name) for f in dataclasses.fields(ct)}
    assert ft == fj
    assert ct.resolved_head_dim == cj.resolved_head_dim
    assert ct.vec_pos_decode == cj.vec_pos_decode
