"""The port's collectives (``repro_torch/distributed/collectives.py``) on
a local world of 4 gloo ranks on the CPU (``launch.mesh.spawn_world``; the
rank program is ``torch_mesh_ranks.collective_cases``), one world for the
file, on the (2, 2), (1, 4) and (4, 1) meshes.

* ``ring_psum_matmul`` and ``allgather_matmul_overlapped`` equal ``x @
  w`` within the JAX suite's tolerance for them, rtol 2e-5, atol 2e-5
  (``tests/test_distributed_tricks.py``);
* the two gather methods (gloo's ``all_gather`` and the slot stack, the
  only gather gloo has for a CUDA tensor) give the same bits, float32 and
  bfloat16, along dims 0 and 1, in coordinate order;
* ``psum_scatter`` of integer-valued floats (exact in any order) equals
  the numpy sum's slice bit for bit, and the psum's slice;
* the ring shift by both methods is the lower neighbour's tensor;
* ``psum_product`` of bfloat16 operands is the whole product's float32
  accumulator rounded once (within one bfloat16 ulp), as one device's
  bf16 GEMM; bfloat16 partials psummed are not;
* on a (2, 2, 1) mesh named (pod, data, model) a gather over the
  multi-pod data axes runs on one group spanning both;
* the autograd forms (training on the mesh), each inside a float64
  objective on a second world (``torch_mesh_ranks.
  collective_grad_cases``) on (1, 4) and (2, 2) over the model axis and
  (2, 2) and (4, 1) over the data axis: ``psum`` (identity backward, and
  ``grad="psum"`` in a norm over a split width and in per-shard
  statistics), ``to_split``, ``all_gather`` (slice and scatter
  backward) and ``psum_scatter``.  Each rank's backward gradient equals
  the central difference (step 1e-6) of the objective every rank holds
  (replicated ones) or of the ranks' objectives summed (each rank's own),
  taken by perturbing one entry on one rank, at rtol 1e-6, atol 1e-8.
"""
import numpy as np
import pytest
import torch

import torch_mesh_ranks as ranks
from repro_torch.launch.mesh import spawn_world

KEYS = ["(2, 2)-model", "(2, 2)-data", "(1, 4)-model", "(4, 1)-data"]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((16, 24)).astype(np.float32)
    w = rng.standard_normal((24, 12)).astype(np.float32)
    ints = rng.integers(-50, 50, (4, 6, 8)).astype(np.float32)
    out = spawn_world(ranks.collective_cases, 4, (x, w, ints),
                      workdir=str(tmp_path_factory.mktemp("world")))
    return x, w, ints, out


def _members(out, key, rank):
    """The ranks in ``rank``'s group on the key's axis, by index."""
    axis = key.split("-")[1]
    me = out[rank][key]["coord"]
    other = 1 if axis == "data" else 0
    return {r[key]["index"]: q for q, r in out.items()
            if r[key]["coord"][other] == me[other]}


@pytest.mark.distributed
@pytest.mark.parametrize("key", KEYS)
def test_ring_matmuls_equal_the_gathered_product(world, key):
    x, w, _, out = world
    want = x @ w
    for r in range(4):
        np.testing.assert_allclose(out[r][key]["ring"], want, rtol=2e-5,
                                   atol=2e-5)
        # The row-sharded form: every rank's shard's rows, in place.
        np.testing.assert_allclose(out[r][key]["agm"], want, rtol=2e-5,
                                   atol=2e-5)


@pytest.mark.distributed
@pytest.mark.parametrize("key", KEYS)
def test_psum_product_rounds_once(world, key):
    x, w, _, out = world
    xb = torch.from_numpy(x).bfloat16().float()
    wb = torch.from_numpy(w).bfloat16().float()
    want = (xb @ wb).bfloat16().float().numpy()
    # One bfloat16 ulp at each element: 8 significant bits.
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    for r in range(4):
        assert np.all(np.abs(out[r][key]["product"] - want) <= ulp), key
    # The bf16 partials' own roundings move the sum by more.
    worst = max(float(np.max(np.abs(out[r][key]["bf16_sum"] - want) / ulp))
                for r in range(4))
    assert worst > 1.0, worst


@pytest.mark.distributed
@pytest.mark.parametrize("key", KEYS)
def test_gathers_are_bit_for_bit_in_coordinate_order(world, key):
    _, _, ints, out = world
    for r in range(4):
        members = _members(out, key, r)
        order = [members[i] for i in range(len(members))]
        for tag, (native, slots) in out[r][key]["gathers"].items():
            np.testing.assert_array_equal(native, slots)
            dim = int(tag[-1])
            np.testing.assert_array_equal(
                native, np.concatenate([ints[q] for q in order], axis=dim))


@pytest.mark.distributed
@pytest.mark.parametrize("key", KEYS)
def test_psum_scatter_and_ring_shift_bit_for_bit(world, key):
    _, _, ints, out = world
    for r in range(4):
        res = out[r][key]
        members = _members(out, key, r)
        total = sum(ints[q] for q in members.values())
        np.testing.assert_array_equal(res["psum"], total)
        step = total.shape[1] // res["n"]
        i = res["index"]
        np.testing.assert_array_equal(res["scatter"],
                                      total[:, i * step:(i + 1) * step])
        lower = members[(i - 1) % res["n"]]
        for shifted in res["shifts"]:
            np.testing.assert_array_equal(shifted, ints[lower])


@pytest.mark.distributed
def test_gather_over_the_multi_pod_data_axes(world):
    """(pod, data) is one group of 4: the rules are the multi-pod ones,
    and the gather is in (pod, data) coordinate order, pod major."""
    _, _, ints, out = world
    for r in range(4):
        res = out[r]["pod"]
        assert res["dp"] == ("pod", "data") and res["n"] == 4
        assert res["rules"]["batch"] == ("pod", "data")
        # Ranks of a (2, 2, 1) mesh: rank = 2 pod + data = the index.
        assert res["index"] == r
        np.testing.assert_array_equal(res["gather"],
                                      np.concatenate(list(ints), axis=0))


GRAD_FNS = ["psum", "to_split", "psum_psum", "gather_slice",
            "gather_scatter", "psum_scatter", "psum_sum"]


@pytest.fixture(scope="module")
def grad_world(tmp_path_factory):
    return spawn_world(ranks.collective_grad_cases, 4, (3,),
                       workdir=str(tmp_path_factory.mktemp("grad_world")))


@pytest.mark.distributed
@pytest.mark.parametrize("key", KEYS)
@pytest.mark.parametrize("fn", GRAD_FNS)
def test_autograd_forms_match_central_differences(grad_world, key, fn):
    checked = 0
    for r in range(4):
        numeric, analytic = grad_world[r][key][fn]
        assert numeric and len(numeric) == len(analytic)
        np.testing.assert_allclose(analytic, numeric, rtol=1e-6, atol=1e-8,
                                   err_msg=f"{fn} on {key}, rank {r}")
        # The gradient is not zero where it is checked.
        assert max(abs(a) for a in analytic) > 1e-3, (fn, key, r)
        checked += len(numeric)
    assert checked >= 16
