"""The port's mesh collectives against the JAX package's.

The reference runs each collective on its virtual CPU mesh
(``make_mesh(4)``, four of the conftest's eight devices); the port runs
the same inputs on a mesh of four CPU shards in one process, and once
over two gloo processes of two shards each.  The results are exact
(sums of small integers in f32), so they must be equal.
"""

import jax
import numpy as np
import pytest
import torch

from predictionio_tpu.parallel import make_mesh as jax_make_mesh
from predictionio_tpu.parallel import collectives as J
from predictionio_tpu.parallel.mesh import data_sharding
from predictionio_tpu_torch.parallel import collectives as C
from predictionio_tpu_torch.parallel import make_mesh
from predictionio_tpu_torch.parallel.mesh import shard_put

from torch_dist_worker import spawn

D = 4


@pytest.fixture(scope="module")
def meshes():
    return jax_make_mesh(D), make_mesh(devices=["cpu"] * D)


def _jax(mesh, arr):
    return jax.device_put(arr, data_sharding(mesh, arr.ndim))


X = np.arange(D * D * 3, dtype=np.float32)
PARTS = np.stack([np.full((16,), s, np.float32) for s in range(D)])

# input, and how the port's per-shard result makes the reference's
# global one (a replicated value: any shard's copy; a sharded one: the
# shards in order)
CASES = {
    "all_reduce_sum": (X, lambda p: p[0]),
    "all_gather_blocks": (X, lambda p: p[0]),
    "all_to_all_blocks": (X, torch.cat),
    "reduce_scatter_sum": (PARTS, torch.cat),
    "ring_shift": (X, torch.cat),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_collective_matches_jax(meshes, name):
    jm, tm = meshes
    x, whole = CASES[name]
    want = np.asarray(getattr(J, name)(_jax(jm, x), jm))
    got = whole(getattr(C, name)(shard_put(x, tm), tm)).numpy()
    np.testing.assert_array_equal(got.reshape(want.shape), want)


@pytest.mark.parametrize("name,x,match", [
    ("reduce_scatter_sum", np.zeros((D * 2, 8), np.float32),
     "one partial per device"),
    ("all_to_all_blocks", np.zeros(D * (D + 1), np.float32),
     "mesh_size\\^2"),
])
def test_shape_errors_match_jax(meshes, name, x, match):
    jm, tm = meshes
    with pytest.raises(ValueError, match=match):
        getattr(J, name)(_jax(jm, x), jm)
    with pytest.raises(ValueError, match=match):
        getattr(C, name)(shard_put(x, tm), tm)


def test_mesh_shape_and_no_host_fallback():
    """make_mesh raises on a shape its devices do not give, as the
    reference, and never falls back to the host without a card."""
    with pytest.raises(ValueError, match="mesh shape"):
        make_mesh(4, devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="equal shards"):
        shard_put(np.zeros(6), make_mesh(devices=["cpu"] * 4))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()


def test_two_gloo_processes_of_two_shards(meshes, tmp_path):
    """The same five collectives over two processes (gloo, two CPU
    shards each) give the reference's results on every process."""
    jm, _ = meshes
    outs = spawn(tmp_path, [{"kind": "collectives", "shards_per_proc": 2}]
                 * 2)
    want = {name: np.asarray(getattr(J, name)(_jax(jm, x), jm))
            for name, (x, _) in CASES.items()}
    for rank, out in enumerate(outs):
        assert int(out["size"]) == D and int(out["lo"]) == 2 * rank
        for name in ("all_reduce_sum", "all_gather_blocks"):
            np.testing.assert_array_equal(out[name].reshape(want[name].shape),
                                          want[name])
        for name in ("all_to_all_blocks", "reduce_scatter_sum",
                     "ring_shift"):
            # each process holds its own two shards of the result
            w = want[name].reshape(D, -1)[2 * rank:2 * rank + 2]
            np.testing.assert_array_equal(out[name].reshape(w.shape), w)
