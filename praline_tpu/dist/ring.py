"""Ring-parallel single alignment (SURVEY.md §3.2 "ring attention analog").

One alignment too big for a single device: the DP lane (x) axis is sharded
over the mesh's ``pairs`` axis — device d owns a contiguous block of
diagonal-wavefront lanes — and boundary lane state crosses to the right
neighbour over ``ppermute`` while terminal
reductions finish with collective reduces.  Scores are produced per-device
with the streamed windowed producer (kernels.scan), so no device ever
materializes more than its own lane block: per-device memory is
O(B * Lx/n * A) state + O(B * (Ly + Lx) * A) replicated y-side reads.

Two exchange schedules (kernels.scan._wavefront):

* ``interval=1``: one ppermute per diagonal, terminals reduced per step.
* ``interval=K>1`` (default 32): SUPERSTEPPED — devices run K diagonals
  per collective, pipelined K diagonals apart, and each superstep ships
  all K boundary stacks in one ppermute; terminal candidates are tracked
  per device and merged once at the end with a lexicographic reduce that
  reproduces the sequential tie-break order.  This amortizes ring latency
  K-fold at the cost of n-1 pipeline fill/drain supersteps (measured 9x
  end-to-end on the simulated 8-device mesh at Lx=2000).

Both are bit-equal to the single-device scan (the DP body is
literally the same code with ring collectives injected; parity-tested in
tests/dist/test_ring.py, traceback bits included).

This is the capacity escape hatch for one enormous problem; batched
per-device dispatch remains faster when many problems are available.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from jax import shard_map

from .allpairs import _register_mesh, _MESHES
from .mesh import PAIR_AXIS
from ..kernels.scan import _wavefront
from ..kernels.scores import HIGHEST


@functools.lru_cache(maxsize=16)
def _build_ring(mesh_key, Lx, Ly, A, gap_series, mode, traceback, interval,
                ckpt_interval=None):
    mesh = _MESHES[mesh_key]
    n = 1
    for dim in mesh.devices.shape:
        n *= dim
    Lp = Lx + 1
    Lpn = -(-Lp // n)  # local lanes per device
    Lp_pad = Lpn * n
    D = Lx + Ly + 1

    # Extra left padding on the reversed-y buffers so the band producer's
    # K-wide window never clamps at the tail chunks (its start is K-1
    # lower than the per-diagonal slice's).
    extra = interval if interval > 1 else 0

    def body(t_pad, invx_pad, cyr_pad, invy_pad, lx, ly):
        base = jax.lax.axis_index(PAIR_AXIS).astype(jnp.int32) * Lpn

        def hrow_fn(d):
            start = (Lx + Ly - d) + base + extra
            w_y = jax.lax.dynamic_slice_in_dim(cyr_pad, start, Lpn, axis=1)
            w_iv = jax.lax.dynamic_slice_in_dim(invy_pad, start, Lpn, axis=1)
            h_int = jnp.einsum("bia,bia->bi", t_pad, w_y, precision=HIGHEST)
            # Rounding pinned by _wavefront's nested-scan materialization.
            return (h_int * invx_pad) * w_iv

        def hband_fn(ds):
            # Whole-superstep production as ONE dot_general: the local H
            # block for the K-diagonal band (instead of K per-diagonal
            # window contractions), then a diagonal
            # gather skews it into score rows.  H is exact-integer f32, so
            # any contraction order is bit-identical to hrow_fn; the
            # (h * invx) * invy multiply order is pinned the same.
            K = ds.shape[0]
            d0 = ds[0]
            start = (Lx + Ly - (d0 + K - 1)) + base + extra  # window start
            w_y = jax.lax.dynamic_slice_in_dim(cyr_pad, start, K + Lpn, axis=1)
            w_iv = jax.lax.dynamic_slice_in_dim(invy_pad, start, K + Lpn, axis=1)
            h_blk = jax.lax.dot_general(
                t_pad, w_y, (((2,), (2,)), ((0,), (0,))),
                precision=HIGHEST,
            )  # (B, Lpn, K + Lpn)
            t_i = jnp.arange(K, dtype=jnp.int32)[:, None]
            lane_i = jnp.arange(Lpn, dtype=jnp.int32)[None, :]
            j_off = (K - 1) - t_i + lane_i  # (K, Lpn), always in window
            h_int = h_blk[:, lane_i, j_off]  # (B, K, Lpn)
            h_int = jnp.transpose(h_int, (1, 0, 2))  # (K, B, Lpn)
            w_ivk = jnp.transpose(w_iv[:, j_off], (1, 0, 2))
            return (h_int * invx_pad[None]) * w_ivk

        B = t_pad.shape[0]
        return _wavefront(
            None, hrow_fn, D, B, Lpn, lx, ly, gap_series, mode, traceback,
            ring_axis=PAIR_AXIS, ring_n=n, lane_base=base,
            ring_interval=interval,
            ckpt_interval=ckpt_interval,
            hband_fn=hband_fn if interval > 1 else None,
        )

    rep = P()
    in_specs = (
        P(None, PAIR_AXIS, None),  # t_pad (B, Lp_pad, A): lanes sharded
        P(None, PAIR_AXIS),  # invx_pad
        rep,  # cyr_pad (replicated y side)
        rep,  # invy_pad
        rep,  # lx
        rep,  # ly
    )
    out_specs = {k: rep for k in ("score", "length", "ti", "tj", "tcode")}
    if ckpt_interval is not None:
        # The blockwise walk runs replicated on every device; only the
        # compact move tape comes back.
        out_specs["moves"] = rep
        out_specs["nmoves"] = rep
    elif traceback:
        # Per-step ring emits (diag, B, lane); superstepped emits
        # (superstep, step-in-chunk, B, lane) — re-skewed on the host.
        nd = 3 if interval <= 1 else 4
        out_specs["tb"] = P(*([None] * (nd - 1)), PAIR_AXIS)
    fn = shard_map(body, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                   check_vma=False)
    return jax.jit(fn), Lp_pad, Lpn, n


def _unskew_tb(raw, D, K, Lpn, n):
    """(superstep, step, B, lane)-layout traceback bits -> (diag, B, lane).

    Device p's bits for global diagonal index t (diag t+2) sit at
    superstep t//K + p, inner step t%K, in its own lane block."""
    import numpy as np

    raw = np.asarray(raw)
    out = np.empty((D - 2, raw.shape[2], raw.shape[3]), dtype=raw.dtype)
    t = np.arange(D - 2)
    for p in range(n):
        blk = slice(p * Lpn, (p + 1) * Lpn)
        out[:, :, blk] = raw[t // K + p, t % K, :, blk]
    return out


def ring_wavefront_dp(mesh, cx, inv_x, cy, inv_y, s, lx, ly,
                      gap_series=(11, 1), mode="global", traceback=False,
                      interval=None, ckpt_interval=None):
    """Run B (usually 1) oversized pairwise DPs with lanes sharded over
    ``mesh``.  Same terminal contract as kernels.scan.wavefront_dp; ``tb``
    comes back lane-sharded and host-concatenated (global layout).

    ``interval``: diagonals per boundary exchange.  ``None`` (default)
    picks a superstep that amortizes ring latency ~32x; ``1`` forces the
    per-diagonal exchange form (one ppermute per diagonal).

    ``ckpt_interval``: with ``traceback=True``, run the CHECKPOINTED ring
    walk instead of materializing the full O(D * Lp) bit tensor — the
    giant-alignment memory bound (O(ckpt_interval * Lp) bits live at
    once); returns ``moves``/``nmoves`` (kernels.replay move-tape
    contract) instead of ``tb``.  Requires a superstepped interval."""
    cx = jnp.asarray(cx)
    inv_x = jnp.asarray(inv_x)
    cy = jnp.asarray(cy)
    inv_y = jnp.asarray(inv_y)
    s = jnp.asarray(s)
    B, Lx, A = cx.shape
    Ly = cy.shape[1]
    if interval is None:
        interval = 32
    key = _register_mesh(mesh)
    fn, Lp_pad, Lpn, n = _build_ring(
        key, Lx, Ly, A, tuple(gap_series), mode, traceback, int(interval),
        int(ckpt_interval) if ckpt_interval is not None else None,
    )

    # Lane layout: global lane i holds x position i-1 (lane 0 = border).
    t = jnp.einsum("bxa,ac->bxc", cx, s, precision=HIGHEST)
    t_pad = jnp.pad(t, ((0, 0), (1, Lp_pad - Lx - 1), (0, 0)))
    invx_pad = jnp.pad(
        inv_x, ((0, 0), (1, Lp_pad - Lx - 1)), constant_values=1.0
    )
    # Reversed-y windows: device base b, diagonal d reads indices
    # [Lx + Ly - d + b (+ extra), ... ); pad so every slice — including the
    # band producer's K-wide superstep window — is in bounds.
    extra = int(interval) if int(interval) > 1 else 0
    cyr_pad = jnp.pad(cy[:, ::-1, :], ((0, 0), (Lx + extra, Lp_pad), (0, 0)))
    invy_pad = jnp.pad(
        inv_y[:, ::-1], ((0, 0), (Lx + extra, Lp_pad)), constant_values=1.0
    )
    out = fn(t_pad, invx_pad, cyr_pad, invy_pad,
             jnp.asarray(lx), jnp.asarray(ly))
    if traceback and ckpt_interval is None and int(interval) > 1:
        out = dict(out)
        out["tb"] = _unskew_tb(
            out["tb"], Lx + Ly + 1, int(interval), Lpn, n
        )
    return out
