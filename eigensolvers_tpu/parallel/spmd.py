"""Explicit-collective SPMD operator application (``jax.shard_map``).

The sharded backend normally relies on GSPMD: operators/states carry
``NamedSharding``s and XLA inserts the collectives (SURVEY.md §2.4).  This
module provides the same row-partitioned SpMV with the collective schedule
written out BY HAND — the "pick a mesh, annotate, place the collective
yourself" recipe — for the cases where explicit control beats the
partitioner:

* pinning the schedule: ``all_gather`` of x over the mesh's "x" axis,
  then a purely local row-block matmul, result left row-sharded — exactly
  one collective per matvec, guaranteed, regardless of what surrounding
  fusion XLA considers;
* a ``psum``-reduced column-partitioned variant for operators whose natural
  layout is column blocks (each device holds H[:, cols]): local matmul
  first, then one ``psum_scatter`` — the reduce-scatter dual of the
  all-gather schedule, preferable when x is large and rows are few;
* explicit collectives compose with ``jax.lax.ppermute`` ring schedules for
  future halo/banded variants.

Reference counterpart: none — the reference's only distributed trace is an
inert MPI import (reference: examples/ttns2_ch3cn.py:8-10); this module and
``parallel/sharded.py`` are the new-design replacement (SURVEY.md §7 L2').
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def row_matvec(mesh: Mesh, precision=jax.lax.Precision.HIGHEST):
    """Explicit all-gather row-partitioned dense matvec.

    Returns ``mv(H_rows, x)`` where ``H_rows`` is the (n, n) matrix
    row-sharded P("x", None) and ``x`` the state sharded P("x").  Schedule:
    ``all_gather(x, "x")`` (one collective), local
    (n/k, n) @ (n,) matmul on each device, output stays P("x").
    """

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P("x", None), P("x")), out_specs=P("x"))
    def mv(H_blk, x_blk):
        xg = jax.lax.all_gather(x_blk, "x", tiled=True)     # full x
        return jnp.dot(H_blk, xg, precision=precision,
                       preferred_element_type=jnp.result_type(H_blk, xg))

    return mv


def col_matvec(mesh: Mesh, precision=jax.lax.Precision.HIGHEST):
    """Explicit reduce-scatter column-partitioned dense matvec.

    ``mv(H_cols, x)``: ``H_cols`` is (n, n) column-sharded P(None, "x"),
    ``x`` sharded P("x").  Schedule: local (n, n/k) @ (n/k,) partial
    products (no input collective), then ONE ``psum_scatter`` over "x" —
    the communication dual of :func:`row_matvec` (moves y-partials instead
    of x).
    """

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(None, "x"), P("x")), out_specs=P("x"))
    def mv(H_blk, x_blk):
        y_part = jnp.dot(H_blk, x_blk, precision=precision,
                         preferred_element_type=jnp.result_type(H_blk, x_blk))
        return jax.lax.psum_scatter(y_part, "x", tiled=True)

    return mv


def sharded_vdot(mesh: Mesh):
    """Explicit ``psum`` inner product of two P("x")-sharded states —
    the collective under every overlap/norm in the sharded backend, written
    out (local partial dot + one psum over "x")."""

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P("x"), P("x")), out_specs=P())
    def vdot(a_blk, b_blk):
        return jax.lax.psum(jnp.vdot(a_blk, b_blk), "x")

    return vdot


def place_row_sharded(H, mesh: Mesh):
    """Put a dense (n, n) matrix in the P("x", None) layout row_matvec
    expects."""
    return jax.device_put(jnp.asarray(H), NamedSharding(mesh, P("x", None)))


def place_col_sharded(H, mesh: Mesh):
    return jax.device_put(jnp.asarray(H), NamedSharding(mesh, P(None, "x")))
