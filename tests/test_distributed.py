"""Multi-process distributed initialization (the ani_mpi replacement).

Spawns TWO actual processes that call ``initialize_distributed`` against a
local coordinator, form one global mesh spanning both (2 CPU devices
each -> 4 global), and run a psum'd data-parallel gradient step — the
multi-host capability the reference implemented with mpi4py/mpi4jax
(``scripts/ani_mpi/run_mpi.py:9-13,91-95``), minus its params-as-grads bug.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

_WORKER = r"""
import os, sys
import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.environ["SAKE_REPO"])
from sake_tpu.parallel import initialize_distributed, make_mesh
from sake_tpu.parallel.data_parallel import make_dp_step, replicate_state, shard_batch
from sake_tpu.train import TrainState
import optax

pid = int(sys.argv[1])
initialize_distributed(
    coordinator_address=os.environ["COORD"], num_processes=2, process_id=pid
)
assert jax.process_count() == 2, jax.process_count()
assert jax.device_count() == 4, jax.device_count()
assert jax.local_device_count() == 2

mesh = make_mesh()  # data axis over all 4 global devices

# per-shard quadratic loss whose exact full-batch gradient is known
def loss_fn(w, batch):
    return ((batch["x"] @ w - batch["y"]) ** 2).mean()

rng = np.random.RandomState(0)
x = jnp.asarray(rng.randn(8, 3), jnp.float32)   # global batch 8
y = jnp.asarray(rng.randn(8), jnp.float32)
w0 = jnp.asarray(rng.randn(3), jnp.float32)

state = TrainState.create(apply_fn=None, params=w0, tx=optax.sgd(0.1))
state = replicate_state(state, mesh)
# multi-process feed: each process contributes its local shard of the
# global batch via make_array_from_process_local_data semantics; for this
# test every process holds the full host array and device_put shards it.
batch = shard_batch({"x": x, "y": y}, mesh)
step = jax.jit(make_dp_step(loss_fn, mesh))
state, loss = step(state, batch)

# analytic check: one SGD step on the full batch
g = 2.0 * (x.T @ (x @ w0 - y)) / len(y)
w_expect = w0 - 0.1 * g
w_got = jax.device_get(state.params)
np.testing.assert_allclose(w_got, np.asarray(w_expect), rtol=1e-5)
print(f"proc {pid} OK loss={float(loss):.4f}")
"""


_SAKE_WORKER = r"""
import os, sys
import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.environ["SAKE_REPO"])
from sake_tpu.parallel import initialize_distributed, make_mesh
from sake_tpu.parallel.data_parallel import (
    make_dp_step, replicate_state, shard_batch,
)
from sake_tpu.train import TrainState
from sake_tpu.models import SAKEModel
import optax

pid = int(sys.argv[1])
initialize_distributed(
    coordinator_address=os.environ["COORD"], num_processes=2, process_id=pid
)
assert jax.process_count() == 2 and jax.device_count() == 4

rng = np.random.RandomState(0)
B, N, F = 8, 6, 4
h = jnp.asarray(rng.randn(B, N, F), jnp.float32)
x = jnp.asarray(rng.randn(B, N, 3), jnp.float32)
f_t = jnp.asarray(rng.randn(B, N, 3), jnp.float32)
e_t = jnp.asarray(rng.randn(B), jnp.float32)

model = SAKEModel(hidden_features=8, out_features=1, depth=2, update=False)
params0 = jax.jit(model.init)(jax.random.PRNGKey(0), h[0], x[0])


def loss_fn(params, batch):
    # the MD17 training structure: F = -dE/dx inside the loss, so the
    # DP gradient is a second-order quantity — the real cross-process
    # SAKE step (not a toy quadratic)
    def e_sum(x_):
        out, _, _ = model.apply(params, batch["h"], x_)
        e_b = out.sum(axis=(-2, -1))
        return e_b.sum(), e_b

    (_, e_b), neg_f = jax.value_and_grad(e_sum, has_aux=True)(batch["x"])
    f_pred = -neg_f
    return (
        jnp.mean((f_pred - batch["f"]) ** 2)
        + 1e-3 * jnp.mean((e_b - batch["e"]) ** 2)
    )


# single-process full-batch oracle (local devices only, no mesh)
full = {"h": h, "x": x, "f": f_t, "e": e_t}
loss0, g0 = jax.jit(jax.value_and_grad(loss_fn))(params0, full)
flat0 = jax.tree_util.tree_leaves(jax.tree.map(
    lambda w, g: w - 0.1 * g, params0, g0))

mesh = make_mesh()
state = TrainState.create(apply_fn=None, params=params0, tx=optax.sgd(0.1))
state = replicate_state(state, mesh)
batch = shard_batch(full, mesh)
step = jax.jit(make_dp_step(loss_fn, mesh))
state, loss = step(state, batch)

np.testing.assert_allclose(float(loss), float(loss0), rtol=1e-5)
got = [np.asarray(l) for l in jax.tree_util.tree_leaves(
    jax.device_get(state.params))]
for a, b in zip(got, flat0):
    np.testing.assert_allclose(a, np.asarray(b), rtol=2e-4, atol=1e-6)
print(f"proc {pid} SAKE-DP OK loss={float(loss):.6f}")
"""


def _run_two_process(tmp_path, worker_src: str, ok_marker: str,
                     timeout: float = 240):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    worker = tmp_path / "worker.py"
    worker.write_text(worker_src)
    env = dict(os.environ)
    env.update(
        COORD=f"127.0.0.1:{port}",
        SAKE_REPO=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=2",
    )
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(pid)],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        for pid in range(2)
    ]
    outs = [p.communicate(timeout=timeout)[0] for p in procs]
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out}"
        assert f"proc {pid} {ok_marker}" in out


@pytest.mark.slow
def test_two_process_distributed_dp_step(tmp_path):
    _run_two_process(tmp_path, _WORKER, "OK")


@pytest.mark.slow
def test_two_process_sake_energy_force_dp_step(tmp_path):
    """One SAKE energy+force (second-order) DP step across TWO processes
    must reproduce the single-process full-batch SGD step exactly
    (the mesh machinery tested on the real model, not a quadratic)."""
    _run_two_process(tmp_path, _SAKE_WORKER, "SAKE-DP OK", timeout=360)
