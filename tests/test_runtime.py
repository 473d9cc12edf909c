"""Process set-up: compile-cache placement, the peaks table, and the CLI's
engine names."""

import os

import pytest

from jeicyboodsp_tpu.utils import runtime


def test_cache_dir_defaults_inside_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = runtime.compile_cache_dir()
    assert path == os.path.join(runtime.REPO_ROOT, ".jax_cache")
    assert os.path.exists(os.path.join(runtime.REPO_ROOT, "jeicyboodsp_tpu"))
    with open(os.path.join(runtime.REPO_ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_cache_dir_honours_environment(monkeypatch, tmp_path):
    import jax

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert runtime.setup_compile_cache() == str(tmp_path)
    # the variable is JAX's own: nothing is set in code
    assert jax.config.jax_compilation_cache_dir == before


def test_peaks_known_device_kind():
    from jeicyboodsp_tpu.utils.profiling import enhance_chain_roofline, peaks_for

    p = peaks_for("NVIDIA H100 80GB HBM3")
    assert p["bf16"] == 989e12 and p["hbm_bytes_per_s"] == 3.35e12 and "source" in p
    b = enhance_chain_roofline().bound("NVIDIA H100 80GB HBM3")
    assert b["bottleneck"] in ("compute", "memory")


def test_peaks_unknown_device_kind_raises():
    from jeicyboodsp_tpu.utils.profiling import enhance_chain_roofline, peaks_for

    with pytest.raises(KeyError, match="no published peaks"):
        peaks_for("TPU v9")
    with pytest.raises(KeyError):
        enhance_chain_roofline().bound("cpu")


@pytest.mark.parametrize("engine", ["mxu8", "mxu8f", "mxu8t", "mxu1"])
def test_cli_rejects_removed_engine_names(engine, tmp_path, capsys):
    from jeicyboodsp_tpu.cli import main

    with pytest.raises(SystemExit) as e:
        main(["wiener", str(tmp_path / "i"), str(tmp_path / "o"), "--fast", "--engine", engine])
    assert e.value.code == 2
    assert "invalid choice" in capsys.readouterr().err


@pytest.mark.parametrize(
    "engine,marker",
    [("xla", "stablehlo.fft"),
     ("mxu", "precision = [HIGHEST, HIGHEST]"),
     ("mxu3", "num_primitive_operations = 3")],
)
def test_surviving_engines_lower_to_plain_xla(engine, marker):
    """Each enhance engine lowers to plain StableHLO (no custom kernel
    call) with the transform or dot algorithm its name promises."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from jeicyboodsp_tpu.ops.enhance import enhance_blocks

    blocks = jnp.zeros((8, 512), jnp.int16)
    text = jax.jit(
        lambda b: enhance_blocks(b, mode="wiener", dtype=jnp.float32, use_assoc_scan=True,
                                 real_fft=engine != "xla", resynth="ratio", fft_engine=engine)
    ).lower(blocks).as_text()
    assert "custom_call" not in text
    assert marker in text, engine
    np.testing.assert_array_equal(np.asarray(blocks), 0)
