"""Worker for the 2-process jax.distributed test (run via subprocess).

Usage: mp_worker.py <process_id> <coordinator_port> <out_npz_for_rank0>
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"

import jax

jax.config.update("jax_platforms", "cpu")

pid = int(sys.argv[1])
port = sys.argv[2]
out_path = sys.argv[3]

jax.distributed.initialize(
    coordinator_address=f"localhost:{port}", num_processes=2, process_id=pid
)

import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from praline_tpu.dist.allpairs import sharded_wavefront_dp
from praline_tpu.io import builtin_score_matrix
from praline_tpu.types import ALPHABET_AA  # noqa: F401  (import sanity)

B = 8
rng = np.random.default_rng(0)
A = 23
cx = rng.integers(0, 2, size=(B, 15, A)).astype(np.float32)
cx[:, :, 0] += 1
cy = rng.integers(0, 2, size=(B, 13, A)).astype(np.float32)
cy[:, :, 0] += 1
inv_x = (np.float32(1.0) / np.maximum(cx.sum(-1), 1.0)).astype(np.float32)
inv_y = (np.float32(1.0) / np.maximum(cy.sum(-1), 1.0)).astype(np.float32)
lx = np.full((B,), 15, np.int32)
ly = np.full((B,), 13, np.int32)
s = builtin_score_matrix("blosum62").as_f32()

mesh = Mesh(np.array(jax.devices()), ("pairs",))
half = B // 2
args = []
for arr, spec in (
    (cx, P("pairs")),
    (inv_x, P("pairs")),
    (cy, P("pairs")),
    (inv_y, P("pairs")),
    (s, P()),
    (lx, P("pairs")),
    (ly, P("pairs")),
):
    sharding = NamedSharding(mesh, spec)
    local = arr if spec == P() else arr[pid * half : (pid + 1) * half]
    args.append(jax.make_array_from_process_local_data(sharding, local, arr.shape))

out = sharded_wavefront_dp(mesh, *args, gap_series=(11, 1), mode="global")
scores = np.asarray(out["score"].addressable_shards[0].data).ravel()
lengths = np.asarray(out["length"].addressable_shards[0].data).ravel()

# Production path cross-process: indexed sharded dispatch (replicated
# one-hot token stacks, sharded index vectors, Gloo all_gather).
from praline_tpu.dist.allpairs import sharded_indexed_dispatch

NPROF = 6
toks = rng.integers(0, 20, size=(NPROF, 15)).astype(np.int8)
lens = np.full(NPROF, 15, np.int32)
ix = (np.arange(B) % NPROF).astype(np.int32)
iy = ((np.arange(B) * 3 + 1) % NPROF).astype(np.int32)
import jax.numpy as jnp


def _repl(a):
    return jax.make_array_from_process_local_data(
        NamedSharding(mesh, P()), a, a.shape
    )


def _shard(a):
    return jax.make_array_from_process_local_data(
        NamedSharding(mesh, P("pairs")), a[pid * half : (pid + 1) * half], a.shape
    )


iout = sharded_indexed_dispatch(
    mesh,
    _repl(toks), _repl(np.zeros((1, 1), np.float32)), _repl(lens),
    _repl(toks), _repl(np.zeros((1, 1), np.float32)), _repl(lens),
    _shard(ix), _shard(iy), _repl(np.asarray(s)),
    gap_series=(11, 1), mode="global", traceback=False, backend="xla",
    replay=False, onehot_x=True, onehot_y=True, A=A,
)
iscores = np.asarray(iout["score"].addressable_shards[0].data).ravel()
ilengths = np.asarray(iout["length"].addressable_shards[0].data).ravel()

# Multi-track trackset driver cross-process (ADVICE r3): the FULL
# align_tracksets_batched driver with mesh= spanning both processes — the
# per-track stacks and index vectors must assemble into global jax.Arrays
# host-locally (kernels.batch globalize path for tracksets).
from praline_tpu.kernels import align_tracksets_batched
from praline_tpu.types import Profile

B62m = builtin_score_matrix("blosum62")
PAMm = builtin_score_matrix("pam250")
trng = np.random.default_rng(12)
tpairs = []
for _ in range(6):
    Lx, Ly = int(trng.integers(4, 14)), int(trng.integers(4, 14))
    mk = lambda L: Profile.from_tokens(
        trng.integers(0, 20, size=L).astype(np.int32), ALPHABET_AA
    )
    tpairs.append(((mk(Lx), mk(Lx)), (mk(Ly), mk(Ly))))
tres = align_tracksets_batched(
    tpairs, [B62m, PAMm], (1.0, 0.5), (11, 1), "global",
    traceback=True, bucket_sizes=(15,), mesh=mesh,
)
tscores = np.array([r.score for r in tres], np.float32)
tcols = np.concatenate([np.asarray(r.cols_x, np.int32) for r in tres])

# Oversized-Ly problems (exact-size buckets past the ceiling) cross-process:
# the sharded indexed dispatch on the multi-process mesh, scores and
# traceback with device replay.
from praline_tpu.kernels import align_pairs_batched

crng = np.random.default_rng(5)


def _mkp(L):
    return Profile.from_tokens(
        crng.integers(0, 20, size=L).astype(np.int32), ALPHABET_AA
    )


cpairs = [
    (_mkp(int(crng.integers(8, 15))), _mkp(int(crng.integers(30, 45))))
    for _ in range(5)
]
cres = align_pairs_batched(
    cpairs, B62m, (11, 1), "global", bucket_sizes=(15,), mesh=mesh,
)
cscores = np.array([r.score for r in cres], np.float32)
clengths = np.array([r.length for r in cres], np.float32)

# Traceback-mode oversized-y dispatch, cross-process: full path equality
# is asserted by the parent against the single-process run.
ctres = align_pairs_batched(
    cpairs, B62m, (11, 1), "semiglobal", traceback=True,
    bucket_sizes=(15,), mesh=mesh,
)
ctscores = np.array([r.score for r in ctres], np.float32)
ctcols = np.concatenate(
    [np.asarray(r.cols_x, np.int32) for r in ctres]
    + [np.asarray(r.cols_y, np.int32) for r in ctres]
)

if pid == 0:
    np.savez(
        out_path, scores=scores, lengths=lengths,
        iscores=iscores, ilengths=ilengths, toks=toks, ix=ix, iy=iy,
        tscores=tscores, tcols=tcols, cscores=cscores, clengths=clengths,
        ctscores=ctscores, ctcols=ctcols,
    )
print(f"[{pid}] OK", flush=True)
