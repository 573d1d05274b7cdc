"""CPU tests of the chip smoke script's helpers and of its phases at tiny
sizes (the script itself refuses to run anywhere but on a GPU)."""

import json
import os

import jax
import numpy as np
import pytest

import chip_smoke as cs
from eigensolvers_tpu.utils.device import (configure_compile_cache,
                                           format_card, require_gpu)
from eigensolvers_tpu.utils.profiling import CompileClock, union_length


def test_refuses_cpu_backend(capsys):
    """No GPU: exit non-zero, name the platform found, print no result."""
    with pytest.raises(RuntimeError, match="platform 'cpu'"):
        require_gpu()
    assert cs.main([]) != 0
    out, err = capsys.readouterr()
    assert out == ""
    assert "cpu" in err


@pytest.mark.parametrize("env_set", [True, False], ids=["env", "default"])
def test_compile_cache_dir(env_set, tmp_path, monkeypatch):
    """JAX_COMPILATION_CACHE_DIR set: nothing is set in code.  Unset: the
    fixed <root>/.jax_cache."""
    before = jax.config.jax_compilation_cache_dir
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        got = configure_compile_cache(str(tmp_path))
        if env_set:
            assert got == str(tmp_path / "c")
            assert jax.config.jax_compilation_cache_dir == before
        else:
            assert got == os.path.join(str(tmp_path), ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == got
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_final_line_shape():
    rec = json.loads(cs.final_line(jax.devices()[:1]))
    assert rec == {"ok": True,
                   "device": {"platform": "cpu",
                              "kind": jax.devices()[0].device_kind,
                              "count": 1}}


def test_card_line_format():
    """Same text as nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader."""
    assert format_card("NVIDIA H100 80GB HBM3", 700000) == \
        "NVIDIA H100 80GB HBM3, 700.00 W"
    assert format_card("NVIDIA H100 80GB HBM3", 500500) == \
        "NVIDIA H100 80GB HBM3, 500.50 W"


def test_compile_clock_splits_compile_from_run():
    def f(x):
        return jax.jit(lambda y: jax.numpy.sin(y) * 2)(x) + 1
    x = jax.numpy.arange(97.0)
    with CompileClock() as cold:
        jax.block_until_ready(jax.jit(f)(x))
    with CompileClock() as warm:
        jax.block_until_ready(jax.jit(f)(x))
    assert cold.seconds > 0 and len(cold.spans) >= 2
    assert warm.seconds == 0.0
    assert union_length([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == 4.0


def test_run_phase_fails_on_error_over_tolerance(capsys):
    def phase(timer):
        with timer.phase("oracle"):
            pass
        return {"ok": (1e-9, 1e-8), "bad": (float("nan"), 1.0)}, {"n": 3}
    with pytest.raises(AssertionError, match="bad"):
        cs.run_phase("PX", phase, "card")
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["checks"]["ok"] == {"err": 1e-9, "tol": 1e-8}
    assert line["n"] == 3 and line["card"] == "card"
    assert {"compile_s", "run_s", "oracle_s"} <= set(line)


def test_host_sop_apply_matches_dense():
    from eigensolvers_tpu.models.molecules import ch3cn_operator
    op, _, _ = ch3cn_operator(N=4, nModesCut=4)
    x = np.random.RandomState(0).rand(op.shape[0])
    want = np.asarray(op.to_dense()) @ x
    np.testing.assert_allclose(cs.host_sop_apply(op, x), want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())


def test_block_ell_problem_csr_matches_operator():
    from eigensolvers_tpu.ops.sparse import BSROperator
    data, idx, csr = cs.block_ell_problem(512, 64, 3)
    op = BSROperator(data, idx, 512)
    np.testing.assert_array_equal(np.asarray(op.to_dense()), csr.toarray())
    assert csr.nnz == data.size


@pytest.mark.parametrize("phase,kwargs", [
    (cs.p1_dense_window, {"n": 256}),
    (cs.p2_ch3cn_sop, {"N": 4, "cut": 6}),
    (cs.p3_block_ell, {"n": 1024, "B": 128, "nbpr": 3, "m": 4}),
], ids=["P1", "P2", "P3"])
def test_phase_tiny(phase, kwargs, capsys):
    """Each one-card phase end to end at a tiny size on the CPU: every
    check under its tolerance."""
    line = cs.run_phase(phase.__name__, phase, "cpu", **kwargs)
    assert line["checks"]
    for name, c in line["checks"].items():
        assert c["err"] <= c["tol"], name


def test_p4_four_devices(capsys):
    """The --four phase on four virtual CPU devices: sharded results match
    the single-device run of the same problem."""
    line = cs.run_phase("P4", cs.p4_four_cards, "cpu")
    counts = line["collectives_per_step"]
    assert set(counts) == {"dense", "sop", "bsr"}
    assert counts["dense"]["4"]["all-reduce"] > 0
