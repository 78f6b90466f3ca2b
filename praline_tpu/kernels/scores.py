"""Device-side pair score matrices in diagonal-major (skewed) layout.

The reference scores each DP cell with a Python dict lookup (SURVEY.md §3 C10
[B:5 "scoring (dict lookup -> ...)"]); here the whole L1 x L2 column-pair
score matrix is produced by two matmuls in integer count space —

    H_int = (Cx @ S) @ Cy^T          (exact: see oracle/score.py)
    H     = (H_int * inv_x) * inv_y   (pinned f32 multiply order)

— and then skewed so anti-diagonal d of the DP grid is the contiguous row
``hs[d]``, which the wavefront scan streams sequentially.  ``Precision.HIGHEST``
keeps the products in true float32 (no TF32 or bf16 passes), where integer
counts are exact below 2^24 in any summation order.

Skew layout: ``hs[d, b, i] = H[b, i-1, d-i-1]`` for interior DP cells
(1 <= i, 1 <= d-i), zero elsewhere; the diagonal-major (D, B, Lp) axis order
is what the scan consumes directly, so no transpose is needed later.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

HIGHEST = jax.lax.Precision.HIGHEST


@functools.partial(jax.jit, static_argnames=("out_diags",))
def skewed_pair_scores(
    cx: jax.Array,  # f32[B, Lx, A] integer-valued counts
    inv_x: jax.Array,  # f32[B, Lx]
    cy: jax.Array,  # f32[B, Ly, A]
    inv_y: jax.Array,  # f32[B, Ly]
    s: jax.Array,  # f32[A, A] integer-valued substitution matrix
    out_diags: int | None = None,
) -> jax.Array:
    """Return ``f32[D, B, Lx+1]`` skewed scores, D = Lx + Ly + 1."""
    B, Lx, A = cx.shape
    Ly = cy.shape[1]
    D = out_diags if out_diags is not None else Lx + Ly + 1

    t = jnp.einsum("bxa,ac->bxc", cx, s, precision=HIGHEST)
    h_int = jnp.einsum("bxc,byc->bxy", t, cy, precision=HIGHEST)
    h = (h_int * inv_x[:, :, None]) * inv_y[:, None, :]

    # Skew via one gather: hs[d, b, i] = h[b, i-1, d-i-1].
    d_idx = jnp.arange(D, dtype=jnp.int32)[:, None]  # (D, 1)
    i_idx = jnp.arange(Lx + 1, dtype=jnp.int32)[None, :]  # (1, Lp)
    j_idx = d_idx - i_idx - 1  # (D, Lp)
    valid = (i_idx >= 1) & (j_idx >= 0) & (j_idx <= Ly - 1)
    i_g = jnp.clip(i_idx - 1, 0, Lx - 1)
    j_g = jnp.clip(j_idx, 0, Ly - 1)
    hs = h[:, i_g, j_g]  # (B, D, Lp)
    hs = jnp.where(valid[None], hs, 0.0)
    return jnp.transpose(hs, (1, 0, 2))


def composite_skewed_scores(
    cxs,  # sequence of f32[B, Lx, A_t] per track
    inv_xs,  # sequence of f32[B, Lx]
    cys,  # sequence of f32[B, Ly, A_t]
    inv_ys,  # sequence of f32[B, Ly]
    ss,  # sequence of f32[A_t, A_t]
    weights,
):
    """Multi-track composite skewed scores (SURVEY.md C4, §8.1): the
    weighted sum of per-track skewed score tensors, accumulated IN TRACK
    ORDER with f32 rounding per step — bit-identical to the oracle's
    composite_pair_score_matrix under the skew.

    Deliberately NOT one fused jit: the multiply-then-add accumulation
    must round at every step, and inside a single jit XLA contracts w*hs into
    the following add (FMA) — per-op dispatch pins the rounding at op
    boundaries (same hazard as the streamed producer; see
    kernels.scan._wavefront).
    """
    acc = None
    for cx, inv_x, cy, inv_y, s, w in zip(cxs, inv_xs, cys, inv_ys, ss, weights):
        hs = skewed_pair_scores(cx, inv_x, cy, inv_y, s)
        term = jnp.float32(w) * hs
        acc = term if acc is None else acc + term
    return acc
