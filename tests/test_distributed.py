"""Two-process ``jax.distributed`` smoke test on CPU.

Simulates multi-host on one box (SURVEY.md §5.8 DCN story): two
processes each owning 2 virtual CPU devices form one 4-device global
mesh via ``jax.distributed.initialize``; the sharded interp kernel runs
with a psum diagnostic and every process checks the global result
against a locally computed oracle.

Marker-gated (``-m distributed`` deselects with ``-m 'not
distributed'``) so constrained CI can skip; the workers are real
subprocesses with their own coordinator rendezvous.
"""

import os
import socket
import subprocess
import sys

import pytest

pytestmark = pytest.mark.distributed

_WORKER = """
import sys
import os
import jax
jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(coordinator_address=sys.argv[1],
                           num_processes=2, process_id=int(sys.argv[2]))
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from iv_engine.ops.interp import masked_interp

assert jax.process_count() == 2, jax.process_count()
assert jax.device_count() == 4, jax.device_count()
assert jax.local_device_count() == 2

mesh = Mesh(np.asarray(jax.devices()).reshape(4, 1), ("data", "slice"))

# deterministic global input, built identically in both processes
B, L = 8, 64
rng = np.random.default_rng(0)
vals = np.where(rng.uniform(size=(B, L)) < 0.5,
                rng.normal(size=(B, L)), np.nan).astype(np.float32)
mask = np.ones((B, L), bool)

sharding = NamedSharding(mesh, P("data", None))
garr = jax.make_array_from_callback(
    (B, L), sharding, lambda idx: vals[idx])
gmask = jax.make_array_from_callback(
    (B, L), sharding, lambda idx: mask[idx])


@jax.jit
def step(v, m):
    filled = masked_interp(v, m)
    n_filled = jnp.sum(jnp.isfinite(filled))  # global psum via GSPMD
    return filled, n_filled


filled, n_filled = step(garr, gmask)
jax.block_until_ready((filled, n_filled))

# oracle: same kernel, process-local, unsharded
ref_filled = masked_interp(jnp.asarray(vals), jnp.asarray(mask))
ref_n = int(jnp.sum(jnp.isfinite(ref_filled)))
assert int(n_filled) == ref_n, (int(n_filled), ref_n)

# check the local shards against the oracle rows
for shard in filled.addressable_shards:
    rows = shard.index[0]
    np.testing.assert_allclose(np.asarray(shard.data),
                               np.asarray(ref_filled[rows]),
                               rtol=1e-6, equal_nan=True)
print(f"process {jax.process_index()} ok: n_filled={int(n_filled)}")
jax.distributed.shutdown()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.slow
def test_two_process_cpu_mesh(tmp_path):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = tmp_path / "dist_worker.py"
    script.write_text(_WORKER)
    addr = f"127.0.0.1:{_free_port()}"
    procs = []
    for pid in range(2):
        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"
        flags = [f for f in env.get("XLA_FLAGS", "").split()
                 if "xla_force_host_platform_device_count" not in f]
        flags.append("--xla_force_host_platform_device_count=2")
        env["XLA_FLAGS"] = " ".join(flags)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (repo, env.get("PYTHONPATH", "")) if p)
        procs.append(subprocess.Popen(
            [sys.executable, str(script), addr, str(pid)],
            env=env, cwd=repo, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=300)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out[-3000:]}"
        assert f"process {i} ok" in out
