"""The port stands alone and never hides the device or the kernel.

  * no module of `repro_torch`, and not `chip_smoke.py`, imports `jax` or
    the JAX package `repro`, or reads an environment override;
  * a kernel wrapper given CPU tensors takes its plain version and its
    launch counter stays 0;
  * entry points default to the card: with no CUDA device they raise
    `RuntimeError` instead of carrying on on the CPU, and so does the
    kernel build.
"""
import ast
import collections
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import resolve_device
from repro_torch.codec import dispatch, reference
from repro_torch.core import kv_cache as TKV
from repro_torch.kernels import build
from repro_torch.kernels.fused_attend import kernel as fa_kernel
from repro_torch.kernels.fused_attend import ref as fa_ref
from repro_torch.kernels.fused_compress import kernel as fc_kernel
from repro_torch.launch import serve as serve_cli
from repro_torch.models import api as tapi
from repro_torch.serve import engine as TE

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_jax_package(path):
    for mod in _imports(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path.name} imports {mod}"


def test_port_reads_no_environment_override():
    for path in PORT_FILES:
        for node in ast.walk(ast.parse(path.read_text())):
            name = node.attr if isinstance(node, ast.Attribute) else \
                node.id if isinstance(node, ast.Name) else None
            assert name not in ("environ", "getenv", "environb"), \
                f"{path.name}:{node.lineno} reads the environment"


def test_port_package_and_csrc_are_found():
    names = {p.name for p in PORT_FILES}
    assert {"engine.py", "kv_cache.py", "build.py", "chip_smoke.py"} <= names
    assert {p.name for p in build._sources()} == {"fused_attend_paged.cu",
                                                  "fused_compress.cu"}


def test_compress_wrapper_on_cpu_takes_plain_path():
    fc_kernel.counter.reset()
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((32, 24)).astype(np.float32))
    q, s = fc_kernel.compress_plane(x, 4)
    qr, sr = reference.compress_plane(x, 4)
    assert torch.equal(q, qr) and torch.equal(s, sr)
    assert fc_kernel.counter.count == 0


def test_attend_wrapper_on_cpu_takes_plain_path():
    fa_kernel.counter.reset()
    rng = np.random.default_rng(0)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    pk = t(rng.integers(-8, 8, (5, 2, 2, 4, 4), dtype=np.int8))
    sk = t(rng.uniform(0.5, 1, (5, 2, 2)).astype(np.float32))
    q = t(rng.standard_normal((2, 2, 2, 16)).astype(np.float32))
    tails = t(rng.standard_normal((2, 8, 2, 16)).astype(np.float32))
    pos = torch.tensor([17, 3], dtype=torch.int32)
    table = torch.tensor([[4, 1, 0, 0], [0, 0, 0, 0]], dtype=torch.int32)
    args = (pk, sk, pk, sk, q, pos, table, tails, tails)
    assert torch.equal(fa_kernel.attend_paged(*args), fa_ref.attend_paged(*args))
    assert fa_kernel.counter.count == 0


def test_crosscheck_oracle_bypasses_both_wrappers(monkeypatch):
    """`chip_smoke.plain_versions` rebinds the two wrappers that the decode
    path looks up at call time: a step inside it reaches neither, and the
    wrappers are bound back afterwards."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    calls = collections.Counter()

    def spy(name, fn):
        def wrapped(*args):
            calls[name] += 1
            return fn(*args)
        return wrapped

    monkeypatch.setattr(fc_kernel, "compress_plane", spy("compress", fc_kernel.compress_plane))
    monkeypatch.setattr(fa_kernel, "attend_paged", spy("attend", fa_kernel.attend_paged))
    wrappers = (fc_kernel.compress_plane, fa_kernel.attend_paged)
    api = tapi.build_reduced("yi_6b")
    params = api.init(torch.Generator().manual_seed(0), dtype=torch.float32, device="cpu")
    prefill_fn, decode_fn, cache_init = TE.make_steps(
        api, TE.ServeConfig(max_seq=32, plan=4, pool_pages=4))
    i32 = lambda v: torch.tensor(v, dtype=torch.int32)

    def step():  # a 7-token prompt, then the decode step that flushes page 1
        cache = cache_init(1, "cpu")
        toks = (torch.arange(8, dtype=torch.int32)[None] * 7) % 200
        _, upd = prefill_fn(params, toks, lengths=i32([7]))
        TKV.paged_write_rows(cache, upd, [0], [[4]], [[0, 0, 0, 0]])
        logits, _ = decode_fn(params, i32([3]), cache, i32([7]), i32([1]), attend_blocks=1)
        return logits

    want = step()
    n_layers = api.cfg.n_layers
    assert calls == {"compress": 1 + n_layers, "attend": n_layers}
    calls.clear()
    with smoke.plain_versions():
        got = step()
    assert not calls
    assert (fc_kernel.compress_plane, fa_kernel.attend_paged) == wrappers
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_dispatch_follows_the_device_and_nothing_else():
    assert dispatch.on_kernel(torch.zeros(1)) is False
    with pytest.raises(RuntimeError, match="no kernel or plain path"):
        dispatch.on_kernel(torch.zeros(1, device="meta"))


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(build, "_LIB", None)


def test_resolve_device_defaults_to_the_card(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_engine_without_a_device_raises(no_cuda):
    api = tapi.build_reduced("yi_6b")
    params = api.init(torch.Generator().manual_seed(0), dtype=torch.float32, device="cpu")
    sc = TE.ServeConfig(max_seq=32, plan=4, pool_pages=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        TE.Engine(api, params, sc, batch=2)
    TE.Engine(api, params, sc, batch=2, device="cpu")  # explicit CPU is fine


def test_serve_cli_without_a_device_raises(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_cli.main(["--arch", "yi_6b", "--reduced", "--requests", "1"])


def test_kernel_build_without_a_device_raises(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA device"):
        build.library()


def test_serve_cli_runs_on_cpu_when_asked(capsys):
    done = serve_cli.main(["--arch", "yi_6b", "--reduced", "--device", "cpu",
                           "--dtype", "f32", "--requests", "3", "--batch", "2",
                           "--prompt-len", "12", "--max-new", "6", "--max-seq", "32",
                           "--vary-lengths"])
    out = capsys.readouterr().out
    assert all(r.done for r in done)
    assert "kernel launches: fused_compress=0 fused_attend_paged=0" in out
