"""Driver entry points: single-chip compile check and multi-chip dry run
must keep working (regression guard for the external driver contract)."""

import jax
import numpy as np


def test_entry_compiles_and_runs():
    import __graft_entry__ as ge
    fn, args = ge.entry()
    out = fn(*args)
    jax.block_until_ready(out)
    nv = np.asarray(out.new_vectors)
    assert nv.ndim == 2 and np.all(np.isfinite(nv))
    norms = np.linalg.norm(nv, axis=1)
    assert np.all((np.abs(norms - 1) < 1e-3) | (norms < 1e-6))


def test_dryrun_multichip_8():
    import __graft_entry__ as ge
    got = ge.dryrun_multichip(8)
    ge.check_collective_schedule(ge.weak_scaling(8))
    # the same problem on one device (the single-card comparison)
    ref = ge.dryrun_multichip(8, devices=jax.devices()[:1])
    np.testing.assert_allclose(got["new_vectors"], ref["new_vectors"],
                               atol=1e-8)
    np.testing.assert_allclose(got["h_cols"], ref["h_cols"], atol=1e-7)
    np.testing.assert_allclose(got["s_cols"], ref["s_cols"], atol=1e-8)
    assert len(got["feast_ev"]) == 3
    np.testing.assert_allclose(got["feast_ev"], ref["feast_ev"], atol=1e-8)


def test_weak_scaling_constant_collective_schedule():
    """The fused Krylov step's compiled collective count must not grow with
    the mesh, for EVERY operator type (dense row-sharded, CH3CN SoP, BSR);
    the assertions (constancy, per-type static budget, attribution upper
    bound) live in check_collective_schedule and fire on regression."""
    import __graft_entry__ as ge
    report = ge.weak_scaling(4, rows_per_device=128, reps=1)
    ge.check_collective_schedule(report)
    dense = report["dense"]
    assert dense[2]["all-reduce"] == dense[4]["all-reduce"] > 0
    assert dense[2]["all-gather"] == dense[4]["all-gather"]
    # attribution fields recorded from the compiled HLO + iteration count
    assert dense[4]["n_collective_execs"] > 0
    assert dense[4]["attributed_upper_ms"] > 0
    for kind in ("sop", "bsr"):
        rows = report[kind]
        assert set(rows) == {2, 4}
        assert sum(rows[4][k] for k in ge._COLLECTIVE_KINDS) > 0


def test_collective_counts_async_pairs_count_once():
    """GPU HLO splits a collective into -start/-done ops; the audit counts
    the pair once, as the CPU's single op."""
    import __graft_entry__ as ge
    txt = "\n".join([
        "%ar = f32[8] all-reduce(f32[8] %a), replica_groups={}",
        "%ars = f32[8] all-reduce-start(f32[8] %b), replica_groups={}",
        "%ard = f32[8] all-reduce-done(f32[8] %ars)",
        "%ags = (f32[4], f32[8]) all-gather-start(f32[4] %c)",
        "%agd = f32[8] all-gather-done((f32[4], f32[8]) %ags)",
    ])
    counts = ge._collective_counts(txt)
    assert counts["all-reduce"] == 2
    assert counts["all-gather"] == 1
    assert counts["reduce-scatter"] == 0
