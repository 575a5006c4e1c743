"""The one engine choice (ops/engines.py): format x platform -> engine."""

import numpy as np
import pytest

from sextans_tpu.format.coo import COOMatrix
from sextans_tpu.format.pack import pack
from sextans_tpu.format.pack_edge import pack_edge
from sextans_tpu.format.pack_ell import pack_ell
from sextans_tpu.format.pack_mxu import pack_mxu
from sextans_tpu.ops.engines import (
    AUTO_ENGINES,
    BACKEND_ENV,
    ENGINES,
    device_arrays,
    format_of,
    resolve_backend,
)
from sextans_tpu.utils.config import SpmmConfig

EXPECTED = {
    ("gpu", "vpu"): "xla", ("gpu", "mxu"): "mxu", ("gpu", "edge"): "edge",
    ("gpu", "ell"): "ell_triton",
    ("cpu", "vpu"): "xla", ("cpu", "mxu"): "mxu", ("cpu", "edge"): "edge",
    ("cpu", "ell"): "ell",
}


@pytest.mark.parametrize("platform,fmt", sorted(EXPECTED))
def test_auto_engine_per_platform(platform, fmt, monkeypatch):
    monkeypatch.delenv(BACKEND_ENV, raising=False)
    got = resolve_backend(fmt, "auto", platform=platform)
    assert got == EXPECTED[(platform, fmt)]
    assert got in ENGINES[fmt]
    assert not got.endswith("_interpret")


def test_auto_table_covers_every_format():
    for platform, table in AUTO_ENGINES.items():
        assert set(table) == set(ENGINES), platform


def test_unknown_platform_is_an_error(monkeypatch):
    monkeypatch.delenv(BACKEND_ENV, raising=False)
    with pytest.raises(ValueError, match="platform"):
        resolve_backend("vpu", "auto", platform="metal")
    with pytest.raises(ValueError, match="format"):
        resolve_backend("csr", "auto", platform="gpu")


def test_named_backend_is_checked_against_the_format():
    assert resolve_backend("ell", "ell") == "ell"
    for fmt, bad in (("vpu", "mxu"), ("mxu", "xla"), ("edge", "ell"),
                     ("ell", "edge"), ("vpu", "ell_triton"),
                     ("vpu", "pallas_interpret")):
        with pytest.raises(ValueError, match="does not match"):
            resolve_backend(fmt, bad)


def test_triton_engine_needs_a_gpu_and_float32(monkeypatch):
    """``ell_triton`` is compiled for the GPU only and accumulates in
    float32: auto gives a precise ELL pack the XLA engine, and naming the
    kernel off the GPU or for a precise pack is an error."""
    monkeypatch.delenv(BACKEND_ENV, raising=False)
    assert resolve_backend("ell", "ell_triton", platform="gpu") == "ell_triton"
    assert resolve_backend("ell", "auto", platform="gpu", precise=True) == "ell"
    assert resolve_backend("vpu", "auto", platform="gpu", precise=True) == "xla"
    with pytest.raises(ValueError, match="needs a GPU"):
        resolve_backend("ell", "ell_triton", platform="cpu")
    with pytest.raises(ValueError, match="float32 only"):
        resolve_backend("ell", "ell_triton", platform="gpu", precise=True)


def test_env_override_goes_through_the_same_check(monkeypatch):
    monkeypatch.setenv(BACKEND_ENV, "xla")
    assert resolve_backend("vpu", "auto", platform="gpu") == "xla"
    monkeypatch.setenv(BACKEND_ENV, "mxu")
    with pytest.raises(ValueError, match="does not match"):
        resolve_backend("vpu", "auto", platform="gpu")
    # an explicit name wins over the environment
    assert resolve_backend("vpu", "xla") == "xla"


def test_format_of_and_device_arrays_memo():
    coo = COOMatrix.random(300, 260, 2000, seed=3)
    packs = {
        "vpu": pack(coo, SpmmConfig(tile_m=64, window_k=128, group_blocks=16)),
        "mxu": pack_mxu(coo, SpmmConfig(tile_m=128, window_k=128,
                                        group_blocks=8)),
        "edge": pack_edge(coo, SpmmConfig(tile_m=64, window_k=128,
                                          edge_chunk=64)),
        "ell": pack_ell(coo, SpmmConfig(tile_m=64)),
    }
    for fmt, p in packs.items():
        assert format_of(p) == fmt
        dev = device_arrays(p)
        assert len(dev) == 5
        assert device_arrays(p) is dev  # uploaded once
        np.testing.assert_array_equal(np.asarray(dev[0]), p.vals)


@pytest.mark.gpu
def test_auto_engines_on_the_gpu(gpu_device):
    """Every format through SpmmPlan(backend="auto") as compiled for the
    card, against the float64 oracle."""
    from sextans_tpu.format.csr import CSRMatrix
    from sextans_tpu.ops.golden import golden_spmm_exact
    from sextans_tpu.ops.plan import SpmmPlan
    from sextans_tpu.utils.verify import verify

    coo = COOMatrix.random(3000, 2500, 40000, seed=11)
    rng = np.random.default_rng(12)
    b = rng.standard_normal((2500, 96)).astype(np.float32)
    c = rng.standard_normal((3000, 96)).astype(np.float32)
    want = golden_spmm_exact(CSRMatrix.from_coo(coo), b, 0.85, -2.06, c)
    for packed in (
        pack(coo, SpmmConfig()),
        pack_mxu(coo, SpmmConfig(block_k=32, group_blocks=16)),
        pack_edge(coo, SpmmConfig(tile_m=4096, window_k=8192)),
        pack_ell(coo, SpmmConfig()),
    ):
        got = np.asarray(SpmmPlan(packed, 96)(b, 0.85, -2.06, c))
        assert verify(want, got).passed, format_of(packed)
