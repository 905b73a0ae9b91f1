"""The DSEKL engine with its support set sharded over a mesh
(``repro_torch/serving/dsekl_engine.py``, ``mesh=``) against the JAX
package's sharded engine.

One local world of 4 gloo ranks on the CPU (``launch.mesh.spawn_world``,
rank program ``torch_mesh_ranks.engine_mesh_cases``) serves on the (4, 1)
and (2, 2) meshes: ``predict``, ``flush``, ``flush_async``, the kernel-map
cache's miss and hit paths and ``update_alpha`` on a keep-all engine each
equal the dense f = K(xq, X) @ alpha (JAX's kernel, JAX's sharded-engine
test's data and tolerance, rtol 1e-5, atol 1e-5:
``tests/test_prediction_engine.py::test_sharded_engine_matches_single_device``).
``stats()`` equals JAX's sharded engine's on the same meshes, from a JAX
subprocess on 8 forced host devices, as that test runs; each rank holds
``sv_rows_per_shard`` support rows.
"""
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_mesh_ranks as ranks
from repro.core import kernels_fn
from repro_torch.launch.mesh import spawn_world

GAMMA, QB, SVB = 0.6, 32, 32
SHAPES = [(4, 1), (2, 2)]
STATIC = ("n_train", "n_sv", "n_sv_padded", "support_fraction", "sv_block",
          "query_block", "n_shards", "sv_rows_per_shard", "kernel", "impl")

JAX_STATS = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp
    import numpy as np
    from repro.core.dsekl import DSEKLConfig
    from repro.serving import DSEKLPredictionEngine, EngineConfig
    z = np.load(sys.argv[1])
    cfg = DSEKLConfig(kernel="rbf", kernel_params=(("gamma", 0.6),),
                      impl="ref")
    out = {}
    for shape in ((4, 1), (2, 2)):
        devs = np.array(jax.devices()[:shape[0] * shape[1]])
        mesh = jax.sharding.Mesh(devs.reshape(shape), ("data", "model"))
        for tag, tol in (("sparse", 1e-8), ("keep_all", -1.0)):
            eng = DSEKLPredictionEngine(
                cfg, jnp.asarray(z["a"]), jnp.asarray(z["x"]),
                engine_cfg=EngineConfig(query_block=32, sv_block=32,
                                        truncate_tol=tol), mesh=mesh)
            st = eng.stats()
            out[f"{shape}-{tag}"] = {k: st[k] for k in sys.argv[2:]}
    print("STATS" + json.dumps(out))
""")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("engine_mesh")
    ks = jax.random.split(jax.random.PRNGKey(2), 5)
    x = np.asarray(jax.random.normal(ks[0], (403, 5)), np.float32)
    a = np.asarray(jax.random.normal(ks[1], (403,)), np.float32)
    a = a * (np.asarray(jax.random.uniform(ks[2], (403,))) > 0.3)
    xq = np.asarray(jax.random.normal(ks[3], (71, 5)), np.float32)
    a2 = np.asarray(jax.random.normal(ks[4], (403,)), np.float32)
    npz = str(tmp / "data.npz")
    np.savez(npz, x=x, a=a)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.abspath(
        os.path.join(os.path.dirname(__file__), "..", "src"))
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen([sys.executable, "-c", JAX_STATS, npz, *STATIC],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    kern = kernels_fn.get_kernel("rbf", gamma=GAMMA)
    dense = np.asarray(kern(jnp.asarray(xq), jnp.asarray(x))
                       @ jnp.asarray(a))
    dense2 = np.asarray(kern(jnp.asarray(xq), jnp.asarray(x))
                        @ jnp.asarray(a2))
    res = spawn_world(ranks.engine_mesh_cases, 4,
                      (x, a, xq, a2, GAMMA, QB, SVB), workdir=str(tmp))
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-3000:]
    jstats = json.loads(next(ln for ln in out.splitlines()
                             if ln.startswith("STATS"))[len("STATS"):])
    return dense, dense2, res, jstats


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.distributed
@pytest.mark.parametrize("shape", SHAPES, ids=["4x1", "2x2"])
@pytest.mark.parametrize("path", ["predict", "flush", "flush_async"])
def test_sharded_engine_serves_the_dense_f(world, shape, path):
    dense, _, res, _ = world
    for r in range(4):
        got = res[r][shape][path]
        if path != "predict":
            got = np.concatenate(got)
        _close(got, dense)


@pytest.mark.distributed
@pytest.mark.parametrize("shape", SHAPES, ids=["4x1", "2x2"])
def test_sharded_cache_and_update_alpha(world, shape):
    """The miss path materialises the local K tile, the hit path sums its
    product with alpha over data, and after ``update_alpha`` the cached
    tiles serve the new model."""
    dense, dense2, res, _ = world
    for r in range(4):
        c = res[r][shape]
        _close(c["miss"], dense)
        _close(c["hit"], dense)
        _close(c["updated"], dense2)
        assert c["cache"] == {"hits": 6, "misses": 3, "size": 3}


@pytest.mark.distributed
@pytest.mark.parametrize("shape", SHAPES, ids=["4x1", "2x2"])
def test_stats_equal_jaxs_sharded_engine(world, shape):
    _, _, res, jstats = world
    for r in range(4):
        got = res[r][shape]
        assert {k: got["stats"][k] for k in STATIC} == \
            jstats[f"{shape}-sparse"]
        assert {k: got["keep_all_stats"][k] for k in STATIC} == \
            jstats[f"{shape}-keep_all"]
        assert got["stats"]["n_shards"] == shape[0]
        assert got["local_rows"] == got["stats"]["sv_rows_per_shard"]
