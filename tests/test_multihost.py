"""2-process jax.distributed smoke test on CPU.

The reference has NO working distributed path (inert MPI import,
reference: examples/ttns2_ch3cn.py:8-10; SURVEY.md §2.4 item 4).  Here two
OS processes each own 4 virtual CPU devices, `distributed_initialize` wires
them into one 8-device runtime, and one fused Krylov step runs jitted over
the process-spanning (2, 4) mesh.  The result must match the same step run
single-process on this test runner's own 8-device mesh.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
def test_two_process_krylov_step(tmp_path):
    port = _free_port()
    out_npz = str(tmp_path / "mh_out.npz")
    worker = os.path.join(os.path.dirname(__file__), "multihost_worker.py")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(worker)))

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    # the parent conftest's 8-device XLA flag must not leak into the workers
    env["XLA_FLAGS"] = ""
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")

    procs = [subprocess.Popen(
        [sys.executable, worker, str(port), str(pid), out_npz],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for pid in range(2)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out}"
    assert os.path.exists(out_npz + ".npz") or os.path.exists(out_npz), outs

    path = out_npz if os.path.exists(out_npz) else out_npz + ".npz"
    got = np.load(path)

    # reference: the SAME step on this process's local 8-device mesh
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from eigensolvers_tpu.ops.operators import DenseOperator
    from eigensolvers_tpu.parallel import make_mesh
    from eigensolvers_tpu.solvers.step import block_krylov_step

    n = 64
    ev = np.linspace(1.0, 40.0, n)
    rng = np.random.RandomState(7)
    Q = np.linalg.qr(rng.rand(n, n))[0]
    A = (Q.T * ev) @ Q
    M, nBlock = 8, 2
    V = np.zeros((M, n))
    g = rng.rand(nBlock, n)
    g /= np.linalg.norm(g, axis=1, keepdims=True)
    gq = np.linalg.qr(g.T)[0].T
    V[:nBlock] = gq

    mesh = make_mesh(batch=2, shard=4)
    op = DenseOperator(jax.device_put(A, NamedSharding(mesh, P("x", None))))
    Vd = jax.device_put(V, NamedSharding(mesh, P(None, "x")))
    seeds = jax.device_put(V[:nBlock].copy(), NamedSharding(mesh, P("b", "x")))
    ref = block_krylov_step(op, Vd, jnp.asarray(nBlock), seeds,
                            jnp.asarray(20.0), jnp.asarray(1e-6), maxiter=400)

    np.testing.assert_allclose(got["new_vectors"],
                               np.asarray(ref.new_vectors), atol=1e-8)
    np.testing.assert_allclose(got["h_cols"], np.asarray(ref.h_cols),
                               atol=1e-7)
    np.testing.assert_allclose(got["s_cols"], np.asarray(ref.s_cols),
                               atol=1e-8)
