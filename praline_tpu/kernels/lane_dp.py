"""Scores-only pairwise DP as a Pallas (Triton) kernel: one problem per lane.

The XLA route (kernels.scores + kernels.scan) materializes the skewed score
tensor and runs one ``lax.scan`` step per anti-diagonal, re-reading and
re-writing every carried (B, Lp) row through device memory at each of the
~Lx+Ly steps.  Here each GPU lane owns ONE problem and sweeps its DP grid
row by row, so nothing crosses lanes: a program of :data:`LANES` problems
keeps the left neighbour's state in registers, the previous row's state in
a per-program scratch laid out ``[state][j][lane]`` (coalesced across
lanes, prefetched one column ahead), and produces each row's scores
in-kernel from ``T = cx @ S`` (computed beforehand by XLA at
``Precision.HIGHEST``) — the (D, B, Lp) score tensor never exists.  Loops
stop at the longest problem of each program, not at the bucket.

Bit-identity with ``wavefront_dp(skewed_pair_scores(...))``: every cell
applies the same float32 operations to the same inputs as the scan (the
traversal order differs, the per-cell arithmetic does not), the k = 2 gap
series runs the same collapsed 3-state form, and the terminal rules are
total orders on (value, i, j), so the order in which candidates are met
does not matter.  The one multiply chain, ``(H_int * inv_x) * inv_y``, is
stored to the row scratch before the DP adds it, so no compiler can
contract it into an FMA with that add; H_int itself is a sum of exact
integer products, exact in any order or contraction.  Each loop iteration
computes one cell from loaded or carried values, so no chain of constant
gap subtractions exists for a compiler to fold.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .scan import NEG, _gap_prefix

LANES = 32  # problems per program: one warp, one problem per thread
_JB = 32  # score-row block of the in-kernel producer


def _priority(vals, codes):
    """Best of ``vals`` in order (M first, then Ix levels, then Iy levels):
    a later state wins only when strictly greater — the scan's
    M > Ix > Iy tie-break.  ``vals`` are (value, length) pairs."""
    (v, ln), c = vals[0], codes[0]
    for (nv, nl), nc in zip(vals[1:], codes[1:]):
        better = nv > v
        v = jnp.where(better, nv, v)
        ln = jnp.where(better, nl, ln)
        c = jnp.where(better, nc, c)
    return v, ln, c


def _gap_step(m, lm, gs, ls, g, k):
    """Gap states of one side at a cell from its predecessor on that side
    (``m``/``lm``: M value/length there; ``gs``/``ls``: its per-level gap
    values/lengths).  Returns (values, lengths, stay) with the scan's
    operations: the collapsed max-of-levels form for k = 2."""
    if k == 2:
        open_, ext = m - g[0], gs[0] - g[1]
        stay = ext > open_
        return ([jnp.where(stay, ext, open_)],
                [jnp.where(stay, ls[0], lm) + 1.0], stay)
    if k == 1:
        stay = gs[0] > m
        return ([jnp.where(stay, gs[0], m) - g[0]],
                [jnp.where(stay, ls[0], lm) + 1.0], stay)
    nv = [m - g[0]] + [gs[l - 1] - g[l] for l in range(1, k - 1)]
    nl = [lm + 1.0] + [ls[l - 1] + 1.0 for l in range(1, k - 1)]
    stay = gs[k - 1] > gs[k - 2]
    nv.append(jnp.where(stay, gs[k - 1], gs[k - 2]) - g[k - 1])
    nl.append(jnp.where(stay, ls[k - 1], ls[k - 2]) + 1.0)
    return nv, nl, stay


def _kernel(cum_ref, t_ref, ivx_ref, cy_ref, ivy_ref, lx_ref, ly_ref,
            score_ref, len_ref, ti_ref, tj_ref, tcode_ref, h_ref, st_ref, *,
            gap_series, mode, A):
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plgpu

    k = len(gap_series)
    kc = 1 if k == 2 else k
    g = [np.float32(x) for x in gap_series]
    local, semi = mode == "local", mode == "semiglobal"
    border_m = np.float32(0.0) if local else NEG
    lanes = pl.ds(pl.program_id(0) * LANES, LANES)
    lx = plgpu.load(lx_ref.at[lanes])
    ly = plgpu.load(ly_ref.at[lanes])
    nrows, ncols = jnp.max(lx), jnp.max(ly)  # this program's longest sides
    zero = jnp.zeros((LANES,), jnp.float32)
    negs = jnp.full((LANES,), NEG, jnp.float32)
    izero = jnp.zeros((LANES,), jnp.int32)

    # Row-state scratch layout: M value, M length, kc gap values, kc gap
    # lengths, then the cell's best (value, length, code).
    S_M, S_LM, S_G, S_LG = 0, 1, 2, 2 + kc
    S_BV, S_BL, S_BC = 2 + 2 * kc, 3 + 2 * kc, 4 + 2 * kc

    def put(j, m, lm, gv, gl, bv, bl, bc):
        for s, v in ((S_M, m), (S_LM, lm), (S_BV, bv), (S_BL, bl),
                     (S_BC, bc.astype(jnp.float32))):
            plgpu.store(st_ref.at[s, j, lanes], v)
        for l in range(kc):
            plgpu.store(st_ref.at[S_G + l, j, lanes], gv[l])
            plgpu.store(st_ref.at[S_LG + l, j, lanes], gl[l])

    def get(j):
        row = [plgpu.load(st_ref.at[s, j, lanes]) for s in range(S_BC + 1)]
        return row[:S_BC] + [row[S_BC].astype(jnp.int32)]

    def border(n):
        """Border cell (0, n) or (n, 0) for n >= 1: a gap run of length n on
        one side (level min(n, k)); returns its (value, level)."""
        lvl = jnp.minimum(n, k)
        val = np.float32(0.0) if semi else -plgpu.load(cum_ref.at[n])
        return val, lvl

    def semi_cand(term, v, ln, c, ci, cj, ok):
        tval, tlen, ti, tj, tcode = term
        tie = (v == tval) & ((ci > ti) | ((ci == ti) & (cj > tj)))
        repl = ok & ((v > tval) | tie)
        return (jnp.where(repl, v, tval), jnp.where(repl, ln, tlen),
                jnp.where(repl, ci, ti), jnp.where(repl, cj, tj),
                jnp.where(repl, c, tcode))

    # ---- row 0: (0, 0) and the y-side border cells (0, j) ----
    put(0, zero + border_m, zero, [negs] * kc, [zero] * kc, zero, zero, izero)

    def row0(j, term):
        m = zero + border_m
        if local:
            put(j, m, zero, [negs] * kc, [zero] * kc, zero, zero, izero)
            return term
        val, lvl = border(j)
        jf = zero + j.astype(jnp.float32)
        code = izero + (k + lvl)
        put(j, m, zero, [negs] * kc, [zero] * kc, zero + val, jf, code)
        if semi:
            term = semi_cand(term, zero + val, jf, code, izero, izero + j,
                             ly == j)
        return term

    term0 = (negs, zero, izero, izero, izero)
    term = jax.lax.fori_loop(1, ncols + 1, row0, term0)

    def row(i, term):
        # In-kernel producer for row i: H_int = T[i-1] . cy[j] (exact
        # integer dot), then the pinned (H_int * inv_x) * inv_y, stored.
        tcol = [plgpu.load(t_ref.at[i - 1, c, lanes]) for c in range(A)]
        ivx = plgpu.load(ivx_ref.at[i - 1, lanes])

        def prod(jb, carry):
            rows = pl.ds(jb * _JB, _JB)
            acc = jnp.zeros((_JB, LANES), jnp.float32)
            for c in range(A):
                acc = acc + tcol[c][None, :] * plgpu.load(cy_ref.at[rows, c, lanes])
            h = (acc * ivx[None, :]) * plgpu.load(ivy_ref.at[rows, lanes])
            plgpu.store(h_ref.at[rows, lanes], h)
            return carry

        jax.lax.fori_loop(0, (ncols + _JB - 1) // _JB, prod, 0)

        # Column 0: the x-side border cell (i, 0).
        old0 = get(0)
        diag = (old0[S_BV], old0[S_BL], old0[S_BC])
        m0 = zero + border_m
        if local:
            gv0, gl0, bv0, bl0, bc0 = [negs] * kc, [zero] * kc, zero, zero, izero
        else:
            val, lvl = border(i)
            i_f = zero + i.astype(jnp.float32)
            if k == 2:
                gv0 = [zero + val]
            else:
                gv0 = [jnp.where(lvl == l + 1, zero + val, negs) for l in range(kc)]
            gl0 = [i_f] * kc
            bv0, bl0, bc0 = zero + val, i_f, izero + lvl
            if semi:
                term = semi_cand(term, bv0, bl0, bc0, izero + i, izero,
                                 lx == i)
        put(0, m0, zero, gv0, gl0, bv0, bl0, bc0)

        def cell(j, c):
            (m_l, lm_l, gy, ly_g, dv, dl, dc, up, hij, term) = c
            # Prefetch row i-1's state and this row's score at column j+1:
            # their latency overlaps this cell's arithmetic.
            jn = jnp.minimum(j + 1, ncols)
            nxt = get(jn)
            h_nxt = plgpu.load(h_ref.at[jn - 1, lanes])
            m_u, lm_u = up[S_M], up[S_LM]
            gx_u = up[S_G:S_G + kc]
            lx_u = up[S_LG:S_LG + kc]
            nix, nlix, sx = _gap_step(m_u, lm_u, gx_u, lx_u, g, k)
            niy, nliy, sy = _gap_step(m_l, lm_l, gy, ly_g, g, k)
            nm = hij + dv
            nlm = dl + 1.0
            if local:
                nm = jnp.where(nm < 0.0, np.float32(0.0), nm)
                nlm = jnp.where(nm <= 0.0, np.float32(0.0), nlm)
            if k == 2:
                cx_codes = [1 + sx.astype(jnp.int32)]
                cy_codes = [1 + k + sy.astype(jnp.int32)]
            else:
                cx_codes = [izero + (1 + l) for l in range(kc)]
                cy_codes = [izero + (1 + k + l) for l in range(kc)]
            bv, bl, bc = _priority(
                [(nm, nlm)] + list(zip(nix, nlix)) + list(zip(niy, nliy)),
                [izero] + cx_codes + cy_codes,
            )
            put(j, nm, nlm, nix, nlix, bv, bl, bc)
            ii, jj = izero + i, izero + j
            if mode == "global":
                tval, tlen, ti, tj, tcode = term
                pick = (lx == i) & (ly == j)
                term = (jnp.where(pick, bv, tval), jnp.where(pick, bl, tlen),
                        jnp.where(pick, ii, ti), jnp.where(pick, jj, tj),
                        jnp.where(pick, bc, tcode))
            elif semi:
                term = semi_cand(term, bv, bl, bc, ii, jj,
                                 ((ly == j) & (lx >= i)) | ((lx == i) & (ly >= j)))
            else:
                tval, tlen, ti, tj, tcode = term
                ok = (lx >= i) & (ly >= j)
                tie = (nm == tval) & ((ii < ti) | ((ii == ti) & (jj < tj)))
                repl = ok & ((nm > tval) | tie)
                term = (jnp.where(repl, nm, tval), jnp.where(repl, nlm, tlen),
                        jnp.where(repl, ii, ti), jnp.where(repl, jj, tj), tcode)
            d_next = (up[S_BV], up[S_BL], up[S_BC])
            return (nm, nlm, niy, nliy) + d_next + (nxt, h_nxt, term)

        carry = ((m0, zero, [negs] * kc, [zero] * kc) + diag
                 + (get(1), plgpu.load(h_ref.at[0, lanes]), term))
        return jax.lax.fori_loop(1, ncols + 1, cell, carry)[-1]

    tval, tlen, ti, tj, tcode = jax.lax.fori_loop(1, nrows + 1, row, term)
    plgpu.store(score_ref.at[lanes], tval)
    plgpu.store(len_ref.at[lanes], tlen)
    plgpu.store(ti_ref.at[lanes], ti)
    plgpu.store(tj_ref.at[lanes], tj)
    plgpu.store(tcode_ref.at[lanes], tcode)


@functools.partial(
    jax.jit, static_argnames=("gap_series", "mode", "interpret")
)
def lane_dp_scores(cx, inv_x, cy, inv_y, s, lx, ly, *, gap_series=(11, 1),
                   mode="global", interpret=False):
    """Scores-only batched DP, field for field equal to
    ``wavefront_dp(skewed_pair_scores(cx, inv_x, cy, inv_y, s), lx, ly)``:
    ``score``, ``length``, ``ti``, ``tj`` and ``tcode`` per problem.

    ``cx`` f32[B, Lx, A] and ``cy`` f32[B, Ly, A] are integer-valued
    counts, ``inv_*`` their column inverses, ``s`` f32[A, A].  The batch
    pads to a multiple of :data:`LANES` and Ly to the producer block; padded
    problems and columns are never read back.  ``interpret`` runs the
    kernel on the CPU (tests); on a GPU it compiles through Triton.
    """
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plgpu

    from .scores import HIGHEST

    k = len(gap_series)
    if not 1 <= k <= 15:
        raise ValueError("gap series must have 1..15 levels")
    if mode not in ("global", "semiglobal", "local"):
        raise ValueError(f"unknown mode {mode!r}")
    B, Lx, A = cx.shape
    Ly = cy.shape[1]
    Bp = -(-B // LANES) * LANES
    Lyp = -(-Ly // _JB) * _JB
    pb, py_ = Bp - B, Lyp - Ly

    t = jnp.einsum("bxa,ac->bxc", cx, s, precision=HIGHEST)
    t = jnp.pad(t, ((0, pb), (0, 0), (0, 0))).transpose(1, 2, 0)
    cyt = jnp.pad(cy, ((0, pb), (0, py_), (0, 0))).transpose(1, 2, 0)
    ivx = jnp.pad(inv_x, ((0, pb), (0, 0)), constant_values=1.0).T
    ivy = jnp.pad(inv_y, ((0, pb), (0, py_)), constant_values=1.0).T
    lxp = jnp.pad(lx.astype(jnp.int32), (0, pb), constant_values=1)
    lyp = jnp.pad(ly.astype(jnp.int32), (0, pb), constant_values=1)
    cum = jnp.asarray(_gap_prefix(tuple(gap_series), max(Lx, Ly)))

    kc = 1 if k == 2 else k
    f32, i32 = jnp.float32, jnp.int32
    out_shape = (
        jax.ShapeDtypeStruct((Bp,), f32), jax.ShapeDtypeStruct((Bp,), f32),
        jax.ShapeDtypeStruct((Bp,), i32), jax.ShapeDtypeStruct((Bp,), i32),
        jax.ShapeDtypeStruct((Bp,), i32),
        jax.ShapeDtypeStruct((Lyp, Bp), f32),  # score-row scratch
        jax.ShapeDtypeStruct((5 + 2 * kc, Ly + 1, Bp), f32),  # row state
    )
    kern = functools.partial(_kernel, gap_series=tuple(gap_series), mode=mode,
                             A=A)
    score, length, ti, tj, tcode, _, _ = pl.pallas_call(
        kern,
        grid=(Bp // LANES,),
        out_shape=out_shape,
        compiler_params=plgpu.CompilerParams(num_warps=1, num_stages=1),
        interpret=interpret,
        name="lane_dp_scores",
    )(cum, t, ivx, cyt, ivy, lxp, lyp)
    return {"score": score[:B], "length": length[:B], "ti": ti[:B],
            "tj": tj[:B], "tcode": tcode[:B]}
