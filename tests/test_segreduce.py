"""_SegReduce (exec/fragment.py), the engine's grouped-aggregate core: exact
int64 per-segment sums in each strategy against NumPy, with negative
values, values beyond 2^32 and excluded rows (segment id == seg)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from monetdb_tpu.exec.fragment import _ONEHOT_MAX, _SegReduce


def _reduce(mode, sid, vals, seg):
    n = len(sid)
    if mode == "sorted":
        perm = np.argsort(sid, kind="stable")
        ctx = (jnp.asarray(sid[perm]), jnp.asarray(perm))
    else:
        ctx = None

    @jax.jit
    def run(s, v):
        red = _SegReduce(s, seg, n, sorted_ctx=ctx)
        assert red.mode == mode
        return red.sum(v)

    return np.asarray(run(jnp.asarray(sid), jnp.asarray(vals)))


@pytest.mark.parametrize("mode,seg,n", [
    ("onehot", 4, 4096),
    ("onehot", _ONEHOT_MAX, 3000),
    ("scatter", _ONEHOT_MAX + 1, 5000),
    ("scatter", 1000, 4096),
    ("sorted", 7, 4096),
    ("sorted", 300, 2048),
])
def test_segreduce_sum_exact(mode, seg, n):
    rng = np.random.default_rng(seg * 7919 + n)
    sid = rng.integers(0, seg + 1, n).astype(np.int64)   # seg = excluded
    vals = rng.integers(-(1 << 45), 1 << 45, n).astype(np.int64)
    got = _reduce(mode, sid, vals, seg)
    want = np.zeros(seg, np.int64)
    np.add.at(want, sid[sid < seg], vals[sid < seg])
    assert got.dtype == np.int64
    assert (got == want).all()


@pytest.mark.parametrize("n,domain", [(70000, 4), (50001, 32), (16384, 1)])
def test_seg_sum_kernel_interpret(n, domain):
    """The GPU grouped-sum kernel (ops/pallas_kernels.py, Triton route),
    run by the Pallas interpreter: exact against NumPy, including rows
    past the last full tile and excluded rows."""
    from monetdb_tpu.ops.pallas_kernels import seg_sum
    rng = np.random.default_rng(n + domain)
    sid = rng.integers(0, domain + 1, n).astype(np.int64)
    vals = rng.integers(-(1 << 45), 1 << 45, n).astype(np.int64)
    got = np.asarray(seg_sum(jnp.asarray(sid), jnp.asarray(vals),
                             domain=domain, interpret=True))
    want = np.zeros(domain, np.int64)
    np.add.at(want, sid[sid < domain], vals[sid < domain])
    assert (got == want).all()


def test_seg_sum_kernel_under_shard_map():
    """The kernel inside the engine's SPMD form: shard_map (check_vma off,
    as exec/fragment.py builds it) + psum of the per-shard sums."""
    import functools
    from jax.sharding import Mesh, PartitionSpec as P
    from monetdb_tpu.ops.pallas_kernels import seg_sum
    mesh = Mesh(np.asarray(jax.devices()[:4]), ("rows",))

    @jax.jit
    @functools.partial(jax.shard_map, mesh=mesh,
                       in_specs=(P("rows"), P("rows")), out_specs=P(),
                       check_vma=False)
    def run(s, v):
        return jax.lax.psum(seg_sum(s, v, domain=6, interpret=True), "rows")

    rng = np.random.default_rng(5)
    sid = rng.integers(0, 7, 4 * 9000).astype(np.int64)
    vals = rng.integers(-(1 << 40), 1 << 40, 4 * 9000).astype(np.int64)
    got = np.asarray(run(jnp.asarray(sid), jnp.asarray(vals)))
    want = np.zeros(6, np.int64)
    np.add.at(want, sid[sid < 6], vals[sid < 6])
    assert (got == want).all()
