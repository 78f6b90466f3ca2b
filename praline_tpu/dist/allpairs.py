"""Pair-space sharded batched DP (SURVEY.md §3.2 "DP" row, §9 P4).

Shards a padded batch of pairwise problems over the mesh's ``pairs`` axis
with ``shard_map``: every device runs score-skew + wavefront on its shard,
then scalar terminals (score/length/terminal cell) are combined with an
``all_gather`` so every device — and the host — sees the full distance
tile.  Traceback bits stay sharded (they are O(L^2) per problem;
only the host slices them per pair).

This is the device replacement for the reference's serial all-pairs loop
(SURVEY.md C15) at the multi-chip level; kernels.batch handles the
single-chip batching underneath.
"""

from __future__ import annotations

import functools

import jax
from jax.sharding import PartitionSpec as P

from jax import shard_map

from .mesh import PAIR_AXIS
from ..kernels.scan import wavefront_dp
from ..kernels.scores import skewed_pair_scores


@functools.lru_cache(maxsize=32)
def _build(mesh_hash_key, gap_series: tuple[int, ...], mode: str, traceback: bool):
    mesh = _MESHES[mesh_hash_key]

    in_specs = (
        P(PAIR_AXIS, None, None),  # cx
        P(PAIR_AXIS, None),  # inv_x
        P(PAIR_AXIS, None, None),  # cy
        P(PAIR_AXIS, None),  # inv_y
        P(None, None),  # substitution matrix (replicated)
        P(PAIR_AXIS),  # lx
        P(PAIR_AXIS),  # ly
    )
    out_specs = {
        "score": P(),
        "length": P(),
        "ti": P(),
        "tj": P(),
        "tcode": P(),
    }
    if traceback:
        out_specs["tb"] = P(None, PAIR_AXIS, None)

    def run(cx, inv_x, cy, inv_y, s, lx, ly):
        hs = skewed_pair_scores(cx, inv_x, cy, inv_y, s)
        out = wavefront_dp(hs, lx, ly, gap_series=gap_series, mode=mode, traceback=traceback)
        res = {
            k: jax.lax.all_gather(out[k], PAIR_AXIS, axis=0, tiled=True)
            for k in ("score", "length", "ti", "tj", "tcode")
        }
        if traceback:
            res["tb"] = out["tb"]
        return res

    # check_vma=False: the scan's carry init mixes replicated constants with
    # shard-varying inputs; the computation is per-shard pure either way.
    fn = shard_map(run, mesh=mesh, in_specs=in_specs, out_specs=out_specs, check_vma=False)
    return jax.jit(fn)


# Bounded mesh registry: keys mirror _build's lru_cache so evicting the
# oldest entry past the cache capacity keeps the two in step (the cached
# jitted fn holds its own mesh reference; this dict only feeds _build).
_MESHES: dict = {}
_MESHES_MAX = 32


def sharded_wavefront_dp(mesh, cx, inv_x, cy, inv_y, s, lx, ly, gap_series, mode, traceback=False):
    """Run the batched DP with the batch axis sharded over ``mesh``.

    The batch size must be divisible by the mesh's pair-axis size (the
    caller pads with dummy problems; kernels.batch does this).
    """
    key = _register_mesh(mesh)
    fn = _build(key, tuple(gap_series), mode, traceback)
    return fn(cx, inv_x, cy, inv_y, s, lx, ly)


def _register_mesh(mesh):
    key = (tuple(mesh.devices.flat), mesh.axis_names)
    _MESHES.pop(key, None)  # move-to-end so hot meshes never age out
    _MESHES[key] = mesh
    while len(_MESHES) > _MESHES_MAX:
        _MESHES.pop(next(iter(_MESHES)))
    return key


@functools.lru_cache(maxsize=64)
def _build_indexed(mesh_key, gap_series, mode, traceback, backend,
                   replay, onehot_x, onehot_y, A):
    """Sharded production dispatch: the SAME indexed gather + producer +
    wavefront(+replay) body as the single-device path
    (kernels.batch.indexed_dispatch_body), with only the pair axis sharded.

    Profile stacks and the substitution matrix are replicated (O(N)
    payload); each device gathers its pair shard's operands locally and
    runs the full dispatch — on-device traceback replay included — then
    scalar terminals and move tapes are all-gathered (SURVEY.md §3.2 DP
    row)."""
    mesh = _MESHES[mesh_key]
    from ..kernels.batch import indexed_dispatch_body

    rep = P()  # replicated
    in_specs = (rep, rep, rep, rep, rep, rep, P(PAIR_AXIS), P(PAIR_AXIS), rep)
    out_specs = {k: rep for k in ("score", "length", "ti", "tj", "tcode")}
    if replay:
        out_specs["moves"] = rep
        out_specs["nmoves"] = rep
    elif traceback:
        # O(L^2) per problem: stays sharded, host slices per pair.
        out_specs["tb"] = P(None, PAIR_AXIS, None)

    def run(sx, ivx, lensx, sy, ivy, lensy, ix, iy, s):
        out = indexed_dispatch_body(
            sx, ivx, lensx, sy, ivy, lensy, ix, iy, s,
            gap_series=gap_series, mode=mode, traceback=traceback,
            backend=backend, replay=replay,
            onehot_x=onehot_x, onehot_y=onehot_y, A=A,
        )
        res = {
            k: jax.lax.all_gather(v, PAIR_AXIS, axis=0, tiled=True)
            for k, v in out.items()
            if k != "tb"
        }
        if "tb" in out:
            res["tb"] = out["tb"]
        return res

    fn = shard_map(run, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                   check_vma=False)
    return jax.jit(fn)


def sharded_indexed_dispatch(mesh, sx, ivx, lensx, sy, ivy, lensy, ix, iy, s,
                             *, gap_series, mode, traceback, backend,
                             replay, onehot_x, onehot_y, A):
    """Indexed batched DP with the pair axis sharded over ``mesh`` (batch
    must be a multiple of the mesh's pair-axis size; kernels.batch pads)."""
    key = _register_mesh(mesh)
    fn = _build_indexed(key, tuple(gap_series), mode, traceback, backend,
                        replay, onehot_x, onehot_y, A)
    return fn(sx, ivx, lensx, sy, ivy, lensy, ix, iy, s)


@functools.lru_cache(maxsize=64)
def _build_indexed_multi(mesh_key, gap_series, mode, traceback, backend,
                         replay, onehot_x, onehot_y, A):
    """Sharded SUPER-DISPATCH: lax.scan over n_sub sub-batches of the
    indexed body inside one shard_map jit — the per-dispatch round trip is
    paid once per group on every host, and each iteration's transient hs
    stays per-shard (kernels.batch._indexed_multi_jit, mesh form)."""
    mesh = _MESHES[mesh_key]
    from ..kernels.batch import indexed_dispatch_body

    rep = P()
    in_specs = (rep, rep, rep, rep, rep, rep,
                P(None, PAIR_AXIS), P(None, PAIR_AXIS), rep)
    out_specs = {k: rep for k in ("score", "length", "ti", "tj", "tcode")}
    if replay:
        out_specs["moves"] = rep
        out_specs["nmoves"] = rep
    elif traceback:
        out_specs["tb"] = P(None, None, PAIR_AXIS, None)

    def run(sx, ivx, lensx, sy, ivy, lensy, ix2, iy2, s):
        def body(_, xs):
            ix, iy = xs
            out = indexed_dispatch_body(
                sx, ivx, lensx, sy, ivy, lensy, ix, iy, s,
                gap_series=gap_series, mode=mode, traceback=traceback,
                backend=backend, replay=replay,
                onehot_x=onehot_x, onehot_y=onehot_y, A=A,
            )
            res = {
                k: jax.lax.all_gather(v, PAIR_AXIS, axis=0, tiled=True)
                for k, v in out.items()
                if k != "tb"
            }
            if "tb" in out:
                res["tb"] = out["tb"]
            return 0, res

        _, outs = jax.lax.scan(body, 0, (ix2, iy2))
        return outs

    fn = shard_map(run, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                   check_vma=False)
    return jax.jit(fn)


def sharded_indexed_multi_dispatch(mesh, sx, ivx, lensx, sy, ivy, lensy,
                                   ix2, iy2, s, *, gap_series, mode,
                                   traceback, backend, replay, onehot_x,
                                   onehot_y, A):
    """n_sub stacked sub-batches (``ix2``/``iy2`` of shape (n_sub, B)) with
    the pair axis sharded; outputs gain a leading (n_sub,) axis."""
    key = _register_mesh(mesh)
    fn = _build_indexed_multi(key, tuple(gap_series), mode, traceback,
                              backend, replay, onehot_x, onehot_y, A)
    return fn(sx, ivx, lensx, sy, ivy, lensy, ix2, iy2, s)


@functools.lru_cache(maxsize=32)
def _build_streamed(mesh_key, gap_series, mode, traceback, replay):
    """Sharded STREAMED dispatch (VERDICT r2 weak #4): oversized problems —
    past the materialized producer's budget — run the streamed scan (no hs
    tensor, any Lx/Ly) inside shard_map with the pair axis sharded, device
    replay included, so a long-skewed workload keeps every device busy."""
    mesh = _MESHES[mesh_key]
    from ..kernels.replay import replay_moves
    from ..kernels.scan import wavefront_dp_streamed

    in_specs = (
        P(PAIR_AXIS, None, None),  # cx
        P(PAIR_AXIS, None),  # inv_x
        P(PAIR_AXIS, None, None),  # cy
        P(PAIR_AXIS, None),  # inv_y
        P(None, None),  # substitution matrix (replicated)
        P(PAIR_AXIS),  # lx
        P(PAIR_AXIS),  # ly
    )
    out_specs = {k: P() for k in ("score", "length", "ti", "tj", "tcode")}
    if replay:
        out_specs["moves"] = P()
        out_specs["nmoves"] = P()
    elif traceback:
        out_specs["tb"] = P(None, PAIR_AXIS, None)

    def run(cx, inv_x, cy, inv_y, s, lx, ly):
        out = wavefront_dp_streamed(
            cx, inv_x, cy, inv_y, s, lx, ly,
            gap_series=gap_series, mode=mode, traceback=traceback,
        )
        if replay:
            moves, nmoves = replay_moves(
                out["tb"], out["ti"], out["tj"], out["tcode"],
                gap_series=gap_series, mode=mode,
                steps=cx.shape[1] + cy.shape[1],
            )
            out = {k: v for k, v in out.items() if k != "tb"}
            out["moves"] = moves
            out["nmoves"] = nmoves
        res = {
            k: jax.lax.all_gather(v, PAIR_AXIS, axis=0, tiled=True)
            for k, v in out.items()
            if k != "tb"
        }
        if "tb" in out:
            res["tb"] = out["tb"]
        return res

    fn = shard_map(run, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                   check_vma=False)
    return jax.jit(fn)


def sharded_streamed_dispatch(mesh, cx, inv_x, cy, inv_y, s, lx, ly, *,
                              gap_series, mode, traceback, replay):
    """Streamed-producer batched DP with the pair axis sharded over
    ``mesh`` (batch must be a multiple of the pair-axis size)."""
    key = _register_mesh(mesh)
    fn = _build_streamed(key, tuple(gap_series), mode, traceback, replay)
    return fn(cx, inv_x, cy, inv_y, s, lx, ly)


@functools.lru_cache(maxsize=32)
def _build_ckpt(mesh_key, gap_series, mode, interval):
    """Sharded CHECKPOINTED giant-traceback dispatch: the O(L^1.5)-memory
    walk (kernels.scan.wavefront_dp_checkpointed) runs per shard with the
    pair axis sharded; only compact move tapes gather back."""
    mesh = _MESHES[mesh_key]
    from ..kernels.scan import wavefront_dp_checkpointed

    in_specs = (
        P(PAIR_AXIS, None, None), P(PAIR_AXIS, None),
        P(PAIR_AXIS, None, None), P(PAIR_AXIS, None),
        P(None, None), P(PAIR_AXIS), P(PAIR_AXIS),
    )
    out_specs = {k: P() for k in ("score", "length", "ti", "tj", "tcode",
                                  "moves", "nmoves")}

    def run(cx, inv_x, cy, inv_y, s, lx, ly):
        out = wavefront_dp_checkpointed(
            cx, inv_x, cy, inv_y, s, lx, ly,
            gap_series=gap_series, mode=mode, interval=interval,
        )
        return {
            k: jax.lax.all_gather(v, PAIR_AXIS, axis=0, tiled=True)
            for k, v in out.items()
        }

    fn = shard_map(run, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                   check_vma=False)
    return jax.jit(fn)


def sharded_ckpt_dispatch(mesh, cx, inv_x, cy, inv_y, s, lx, ly, *,
                          gap_series, mode, interval):
    """Checkpointed-traceback batched DP with the pair axis sharded."""
    key = _register_mesh(mesh)
    fn = _build_ckpt(key, tuple(gap_series), mode, int(interval))
    return fn(cx, inv_x, cy, inv_y, s, lx, ly)


@functools.lru_cache(maxsize=32)
def _build_tracks(mesh_key, gap_series, mode, traceback, weights, steps, T):
    """Sharded MULTI-TRACK dispatch: the composite indexed body
    (kernels.batch.composite_dispatch_body) inside shard_map with the pair
    axis sharded; per-track stacks replicate, index vectors shard, and
    terminals + move tapes gather back."""
    mesh = _MESHES[mesh_key]
    from ..kernels.batch import composite_dispatch_body

    rep = P()
    reps = tuple(rep for _ in range(T))
    in_specs = (reps, reps, rep, reps, reps, rep,
                P(PAIR_AXIS), P(PAIR_AXIS), reps)
    out_specs = {k: rep for k in ("score", "length", "ti", "tj", "tcode")}
    if traceback:
        out_specs["moves"] = rep
        out_specs["nmoves"] = rep

    def run(sxs, ivxs, lensx, sys_, ivys, lensy, ix, iy, ss):
        out = composite_dispatch_body(
            sxs, ivxs, lensx, sys_, ivys, lensy, ix, iy, ss,
            gap_series=gap_series, mode=mode, traceback=traceback,
            weights=weights, steps=steps,
        )
        return {
            k: jax.lax.all_gather(v, PAIR_AXIS, axis=0, tiled=True)
            for k, v in out.items()
        }

    fn = shard_map(run, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                   check_vma=False)
    return jax.jit(fn)


def sharded_tracks_dispatch(mesh, sxs, ivxs, lensx, sys_, ivys, lensy,
                            ix, iy, ss, *, gap_series, mode, traceback,
                            weights, steps):
    """Multi-track composite batched DP with the pair axis sharded."""
    key = _register_mesh(mesh)
    fn = _build_tracks(key, tuple(gap_series), mode, traceback,
                       tuple(weights), int(steps), len(ss))
    return fn(sxs, ivxs, lensx, sys_, ivys, lensy, ix, iy, ss)
