"""The production dry-run (``repro_torch/launch/dryrun.py``) and the
kernels made traceable (``repro_torch/kernels/library.py``).

* Argument bytes: for every applicable cell on both production meshes
  (and every variant for mamba2-780m), a rank's ``argument_size_in_bytes``
  equals the bytes of JAX's own specs for that cell: the parameters
  (``LanguageModel.abstract()`` over ``pspecs``), AdamW's state (bf16
  moments over the parameters' specs, an int32 count), the batch's shard
  (``("batch", "seq")``, the frontend's ``("batch", "frontend_seq")``),
  the decode cache (``init_cache`` over ``stack_cache_pspecs``) and the
  int32 position; the DSEKL cells' data, state and key over
  ``build_dsekl_cell``'s shardings.  No compile, no world: the port builds
  each cell on the ``meta`` device over a static mesh (shapes and
  coordinates only).  Two differences of layout are the port's own and
  are counted as such (``_conv_delta``): mamba-2's conv weights hold B
  and C's channels whole (JAX splits every conv channel), and its decode
  cache's conv window holds the rank's heads' channels (JAX's spec
  replicates the window over the model axis); and the DSEKL step takes
  the mesh's sampled indices where JAX's takes a PRNG key.
* The kernel ops: each op's meta output equals its plain version's in
  shape and dtype, and its FLOP formula equals ``FlopCounterMode``'s count
  of the plain version; on CPU tensors the op refuses as the CUDA wrapper
  always did.
* The collectives' byte counter on known shapes, on a fake world.
* The trace's memory and byte accounting on a step of known sizes.
* One reduced-depth cell of each kind through the CLI, each in a
  subprocess of its own (so no fake default group outlives it here).
"""
import json
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.configs.shapes import rules_kind as jax_rules_kind
from repro.distributed.sharding import make_rules as jax_make_rules
from repro.models import blocks as jax_blocks
from repro.models.model import LanguageModel as JaxLM
from repro.nn.module import logical_to_pspec as jax_logical_to_pspec
from repro.optim import make_optimizer as jax_make_optimizer
from repro.optim import make_schedule as jax_make_schedule
from repro_torch.distributed import collectives
from repro_torch.kernels.dsekl import block, ops as kops
from repro_torch.kernels.flash_attn import kernel as fk, ops as fops
from repro_torch.kernels.ssd import kernel as sk, ops as sops
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import LocalMesh, production_shape

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


# ---------------------------------------------------------------------------
# Argument bytes against JAX's specs.
# ---------------------------------------------------------------------------

def _is_p(x):
    return isinstance(x, P)


def _local_bytes(shape, dtype, spec, sizes):
    n = 1
    for i, dim in enumerate(shape):
        entry = spec[i] if i < len(spec) else None
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        parts = math.prod(sizes[a] for a in axes)
        assert dim % parts == 0
        n *= dim // parts
    return n * np.dtype(dtype).itemsize


def _tree_local_bytes(abstract, specs, sizes):
    leaves = jax.tree.leaves(abstract)
    ps = jax.tree.leaves(specs, is_leaf=_is_p)
    assert len(leaves) == len(ps)
    return sum(_local_bytes(a.shape, a.dtype, p, sizes)
               for a, p in zip(leaves, ps))


def _axes_size(entry, sizes):
    if entry is None:
        return 1
    axes = (entry,) if isinstance(entry, str) else tuple(entry)
    return math.prod(sizes[a] for a in axes)


def _parts(names, shape, rules, sizes):
    """Per dim, the number of parts JAX's spec splits it into."""
    spec = jax_logical_to_pspec(names, rules, shape, sizes)
    return [_axes_size(spec[i] if i < len(spec) else None, sizes)
            for i in range(len(shape))]


def _mamba_layers(cfg):
    return sum(cfg.layer_pattern[i % cfg.period] == "mamba"
               for i in range(cfg.n_layers))


def _conv_delta(cfg, rules, sizes, b, kind, f8):
    """The port's bytes less JAX's over the two mamba-2 layouts that
    differ (0 for an arch without mamba layers):

    * the conv weights ``conv_w`` (W, conv_ch) and ``conv_b`` (conv_ch,):
      JAX splits all conv_ch channels over "mlp"; the port splits the
      d_inner channels and holds B and C's 2 g n whole (``Param.tail``),
      in the parameters and in AdamW's two bf16 moments;
    * the decode cache's conv window (B, W - 1, conv_ch): JAX's spec
      (batch, None, None) holds every channel; the port its heads'
      (nh / |ssm_heads|) x hd and B and C."""
    layers = _mamba_layers(cfg)
    if not layers:
        return 0
    di, gn = cfg.d_inner, 2 * cfg.ssm_ngroups * cfg.ssm_state
    conv_ch, w = di + gn, cfg.ssm_conv_width
    jax_ch = conv_ch // _parts(("mlp",), (conv_ch,), rules, sizes)[0]
    port_ch = di // _parts(("mlp",), (di,), rules, sizes)[0] + gn
    pitem = 1 if f8 else np.dtype(cfg.pdtype).itemsize
    delta = layers * (w + 1) * (port_ch - jax_ch) * pitem
    if kind == "train":
        delta += 2 * layers * (w + 1) * (port_ch - jax_ch) * 2
    if kind in ("decode", "long_decode"):
        nh = cfg.ssm_heads
        nh_loc = nh // _parts(("ssm_heads",), (nh,), rules, sizes)[0]
        b_loc = b // _parts(("batch",), (b,), rules, sizes)[0]
        item = np.dtype(cfg.cdtype).itemsize
        delta += layers * b_loc * (w - 1) * (
            nh_loc * cfg.ssm_head_dim + gn - conv_ch) * item
    return delta


def jax_argument_bytes(arch, shape_name, multi_pod, variant=None):
    """A rank's argument bytes of JAX's dry-run cell (its ``build_cell``'s
    abstract arguments over their specs), and the port's layout's
    difference from them (``_conv_delta``)."""
    shape_dims, names = production_shape(multi_pod)
    sizes = dict(zip(names, shape_dims))
    cfg = jax_get_config(arch)
    var = dryrun.VARIANTS.get(variant or "", {})
    if var.get("cfg"):
        cfg = cfg.replace(**var["cfg"])
    shape = JAX_SHAPES[shape_name]
    kind = jax_rules_kind(shape)
    rules = jax_make_rules(kind, multi_pod)
    rules.update(dryrun.cell_rules(arch, shape_name, variant))
    model = JaxLM(cfg)
    params_abs = model.abstract(
        jnp.float8_e4m3fn if var.get("weights_f8") else None)
    params_ps = model.pspecs(rules, sizes)
    total = _tree_local_bytes(params_abs, params_ps, sizes)
    b, s = shape.global_batch, shape.seq_len

    def one(shape_, dtype, *names_):
        return _local_bytes(shape_, dtype, jax_logical_to_pspec(
            names_, rules, shape_, sizes), sizes)

    fe = (one((b, cfg.n_frontend_tokens, cfg.d_model), jnp.bfloat16,
              "batch", "frontend_seq", None)
          if cfg.n_frontend_tokens else 0)
    delta = _conv_delta(cfg, rules, sizes, b, kind,
                        bool(var.get("weights_f8")))
    if kind == "train":
        opt = jax_make_optimizer("adamw", jax_make_schedule(
            "cosine", 3e-4, warmup_steps=100, total_steps=10_000),
            moment_dtype=jnp.bfloat16)
        opt_abs = jax.eval_shape(opt.init, params_abs)
        opt_ps = {"count": P(), "m": params_ps, "v": params_ps}
        total += _tree_local_bytes(opt_abs, opt_ps, sizes)
        total += 2 * one((b, s), jnp.int32, "batch", "seq") + fe
    elif kind == "prefill":
        total += one((b, s), jnp.int32, "batch", "seq") + fe
    else:
        cache_abs = jax.eval_shape(lambda: model.init_cache(b, s))
        cache_ps = jax_blocks.stack_cache_pspecs(
            cfg, rules, b, s, cfg.n_frontend_tokens, sizes)
        total += _tree_local_bytes(cache_abs, cache_ps, sizes)
        total += one((b,), jnp.int32, "batch") + 4          # token, pos
    return total, delta


def _static_mesh(shape, names):
    return LocalMesh.static(shape, names)


def port_argument_bytes(arch, shape_name, multi_pod, variant=None):
    cell = dryrun.build_cell(arch, shape_name,
                             _static_mesh(*production_shape(multi_pod)),
                             multi_pod=multi_pod, variant=variant)
    return cell.arg_bytes


LM_CELLS = [(a, s) for a, s in dryrun.all_cells() if a != "dsekl"]


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16",
                                                          "2x16x16"])
@pytest.mark.parametrize("arch,shape", LM_CELLS,
                         ids=[f"{a}-{s}" for a, s in LM_CELLS])
def test_argument_bytes_equal_jax_specs(arch, shape, multi_pod):
    want, delta = jax_argument_bytes(arch, shape, multi_pod)
    got = port_argument_bytes(arch, shape, multi_pod)
    assert sum(got.values()) == want + delta, got


VARIANT_CELLS = [(v, s) for v in dryrun.VARIANTS for s in JAX_SHAPES]


@pytest.mark.parametrize("variant,shape", VARIANT_CELLS,
                         ids=[f"{v}-{s}" for v, s in VARIANT_CELLS])
def test_variant_argument_bytes_equal_jax_specs(variant, shape):
    for multi_pod in (False, True):
        want, delta = jax_argument_bytes("mamba2-780m", shape, multi_pod,
                                         variant)
        got = port_argument_bytes("mamba2-780m", shape, multi_pod, variant)
        assert sum(got.values()) == want + delta, (multi_pod, got)


@pytest.mark.parametrize("shape", ["dsekl_covtype", "dsekl_prod"])
@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16",
                                                          "2x16x16"])
def test_dsekl_argument_bytes_equal_jax_specs(shape, multi_pod):
    """JAX: x_grad (N, D) over data, y_grad (N,) over data, x_exp (N, D)
    over model, alpha / accum (N,) over model, step (), key (2,) uint32;
    the port: the same, and the plan's int64 indices for the key."""
    n_data = 32 if multi_pod else 16
    if shape == "dsekl_prod":
        n, d, per = 1 << 27, 128, 8192
    else:
        n, d = 581_012 // (n_data * 16) * (n_data * 16), 54
        per = max(10_000 // n_data, 64)
    jax_bytes = 4 * (n // n_data * d + n // n_data + n // 16 * d
                     + 2 * (n // 16) + 1) + 8
    plan = 8 * per * (n_data + 16)
    cell = dryrun.build_dsekl_cell(
        shape, _static_mesh(dryrun.dsekl_mesh_shape(multi_pod),
                            ("data", "model")), multi_pod=multi_pod)
    assert cell.arg_bytes["plan"] == plan
    assert sum(cell.arg_bytes.values()) == jax_bytes - 8 + plan


# ---------------------------------------------------------------------------
# The kernel ops.
# ---------------------------------------------------------------------------

def _flops(fn):
    with FlopCounterMode(display=False) as m:
        fn()
    return m.get_total_flops()


def _meta(*ts):
    return [t.to("meta") for t in ts]


FLASH_CASES = [  # (B, S, T, H, Kv, D, dtype, causal)
    (2, 5, 5, 4, 2, 8, torch.float32, True),
    (1, 7, 3, 2, 1, 64, torch.bfloat16, False),
    (2, 4, 6, 4, 4, 128, torch.bfloat16, True),
]


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_op_meta_and_flops_equal_plain(case):
    b, s, t, h, kv, d, dtype, causal = case
    g = torch.Generator().manual_seed(0)
    q = torch.randn(b, s, h, d, generator=g).to(dtype)
    k = torch.randn(b, t, kv, d, generator=g).to(dtype)
    v = torch.randn(b, t, kv, d, generator=g).to(dtype)
    plain = fops.flash_attention(q, k, v, causal=causal, impl="ref")
    qm, km, vm = _meta(q, k, v)
    out = fk.flash_attention_cuda(qm, km, vm, causal=causal)
    assert out.device.type == "meta"
    assert out.shape == plain.shape and out.dtype == plain.dtype
    assert _flops(lambda: fk.flash_attention_cuda(qm, km, vm,
                                                  causal=causal)) == \
        _flops(lambda: fops.flash_attention(q, k, v, causal=causal,
                                            impl="ref"))
    # The meta path launches nothing.
    assert fk.flash_attention_cuda.launches == 0
    with pytest.raises(ValueError, match="CUDA tensors only"):
        fk.flash_attention_cuda(q, k, v)


SSD_CASES = [  # (B, S, nh, hd, g, n, dtype, chunk)
    (2, 9, 4, 8, 2, 16, torch.float32, 4),
    (1, 12, 2, 64, 1, 32, torch.bfloat16, 64),
]


@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_op_meta_and_flops_equal_plain(case):
    b, s, nh, hd, g, n, dtype, chunk = case
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(b, s, nh, hd, generator=gen).to(dtype)
    dt = torch.rand(b, s, nh, generator=gen).to(dtype)
    a = -torch.rand(nh, generator=gen)
    bm = torch.randn(b, s, g, n, generator=gen).to(dtype)
    cm = torch.randn(b, s, g, n, generator=gen).to(dtype)
    y, final = sops.ssd_chunked(x, dt, a, bm, cm, chunk=chunk, impl="ref")
    my, mfinal = sk.ssd_cuda(*_meta(x, dt, a, bm, cm), chunk=chunk)
    assert my.shape == y.shape and mfinal.shape == final.shape
    # The plain version's y is the recurrence's float32; the kernel's is in
    # x's dtype (as JAX's kernel and plain version too).
    assert my.dtype == x.dtype and y.dtype == torch.float32
    assert mfinal.dtype == final.dtype == torch.float32
    assert _flops(lambda: sk.ssd_cuda(*_meta(x, dt, a, bm, cm),
                                      chunk=chunk)) == \
        _flops(lambda: sops.ssd_chunked(x, dt, a, bm, cm, chunk=chunk,
                                        impl="ref"))
    assert sk.ssd_cuda.launches == 0
    with pytest.raises(ValueError, match="CUDA tensors only"):
        sk.ssd_cuda(x, dt, a, bm, cm, chunk=chunk)


@pytest.mark.parametrize("kernel_name,d", [
    ("rbf", 54), ("laplacian", 54), ("polynomial", 8), ("linear", 128),
    ("sigmoid", 7), ("matern32", 3), ("matern52", 65)])
def test_matvec_ops_meta_and_flops_equal_plain(kernel_name, d):
    g = torch.Generator().manual_seed(2)
    x, z = torch.randn(13, d, generator=g), torch.randn(7, d, generator=g)
    a, v = torch.randn(7, generator=g), torch.randn(13, generator=g)
    for cuda_fn, op_fn, vec in ((block.kernel_matvec_cuda, kops.kernel_matvec,
                                 a),
                                (block.kernel_vecmat_cuda, kops.kernel_vecmat,
                                 v)):
        plain = op_fn(x, z, vec, kernel_name=kernel_name, kernel_params=(),
                      impl="ref")
        out = cuda_fn(*_meta(x, z, vec), kernel_name=kernel_name)
        assert out.shape == plain.shape and out.dtype == plain.dtype
        assert _flops(lambda: cuda_fn(*_meta(x, z, vec),
                                      kernel_name=kernel_name)) == \
            _flops(lambda: op_fn(x, z, vec, kernel_name=kernel_name,
                                 kernel_params=(), impl="ref"))
        assert cuda_fn.launches == 0
        with pytest.raises(ValueError, match="CUDA tensors only"):
            cuda_fn(x, z, vec, kernel_name=kernel_name)


def test_op_routes_follow_the_route_tables():
    from repro_torch.kernels import library
    q = torch.empty(1, 4, 2, 64, dtype=torch.bfloat16, device="meta")
    assert library.ROUTE["flash_attention"](q, q, q, True, 1) == "sm90"
    assert library.ROUTE["flash_attention"](q.float(), q.float(), q.float(),
                                            True, 1) == "fp32"
    x = torch.empty(3, 54, device="meta")
    assert library.ROUTE["kernel_matvec"](x, x, x[:, 0], "rbf") == "sm90"
    assert library.ROUTE["kernel_vecmat"](x, x, x[:, 0],
                                          "laplacian") == "fp32"


# ---------------------------------------------------------------------------
# The collectives' bytes and the trace's accounting.
# ---------------------------------------------------------------------------

def test_collective_bytes_on_known_shapes():
    """On a fake (2, 4) world: each collective's count and result bytes
    under its own key, a composite counted once."""
    import torch.distributed as dist
    from repro_torch.distributed.sharding import MeshCtx
    from repro_torch.launch.mesh import make_fake_mesh
    mesh = make_fake_mesh((2, 4), ("data", "model"))
    try:
        ctx = MeshCtx.for_mesh(mesh, "decode")
        c0, b0 = dict(collectives.COUNTS), dict(collectives.BYTES)
        x = torch.zeros(3, 5)
        collectives.psum(x, ctx, "model")
        collectives.pmax(x, ctx, "data")
        collectives.all_gather(x, ctx, "model", dim=0)
        collectives.all_gather(x, ctx, "model", dim=1, method="slots")
        collectives.psum_scatter(torch.zeros(8, 5), ctx, "model", dim=0)
        collectives.ring_shift(x, ctx, "model", method="slots")
        gloo = MeshCtx(mesh=dataclass_replace(mesh, backend="gloo"),
                       rules=ctx.rules)
        collectives.psum_scatter(torch.zeros(8, 5), gloo, "model", dim=0)
        counts = {k: v - c0.get(k, 0) for k, v in collectives.COUNTS.items()
                  if v - c0.get(k, 0)}
        nbytes = {k: v - b0.get(k, 0) for k, v in collectives.BYTES.items()
                  if v - b0.get(k, 0)}
    finally:
        mesh.close()
    assert not dist.is_initialized()
    assert counts == {"psum:all_reduce": 1, "pmax:all_reduce": 1,
                      "all_gather:native": 1, "all_gather:slots": 1,
                      "psum_scatter:reduce_scatter": 1,
                      "ring_shift:slots": 1, "psum_scatter:all_reduce": 1}
    assert nbytes == {"psum:all_reduce": 60, "pmax:all_reduce": 60,
                      "all_gather:native": 240, "all_gather:slots": 240,
                      "psum_scatter:reduce_scatter": 40,
                      "ring_shift:slots": 60, "psum_scatter:all_reduce": 40}
    rec = dryrun._collective_record(counts, nbytes)
    assert rec["all-reduce"] == {"count": 2, "bytes": 120}
    assert rec["all-gather"] == {"count": 2, "bytes": 480}
    assert rec["reduce-scatter"] == {"count": 2, "bytes": 80}
    assert rec["collective-permute"] == {"count": 1, "bytes": 60}
    assert rec["total_bytes"] == 740


def dataclass_replace(obj, **kw):
    import dataclasses
    return dataclasses.replace(obj, **kw)


def test_trace_counts_memory_bytes_and_aliases():
    """A step of known sizes: arguments not counted, a freed temporary's
    bytes released (the peak holds both while both live), an in-place
    update of a donated argument counted as its alias."""
    a = torch.zeros(1000, device="meta")             # 4,000 bytes

    def step(a, b):
        t1 = a * 2                                   # 4,000
        t2 = t1 + 1                                  # 4,000: peak 8,000
        del t1                                       # 4,000 live
        t3 = t2.sum()                                # 4,004 live
        b.add_(1.0)                                  # in place
        return t3, b

    b = torch.zeros(10, device="meta")
    cell = dryrun.Cell(step, (a, b), {"a": 4000, "b": 40}, (1,), {})
    rec = dryrun.trace_cell(cell)
    mem = rec["memory_analysis"]
    assert mem["argument_size_in_bytes"] == 4040
    assert mem["temp_size_in_bytes"] == 8000
    assert mem["output_size_in_bytes"] == 44
    assert mem["alias_size_in_bytes"] == 40
    # mul 4000 + 4000, add 4000 + 4000, sum 4000 + 4, add_ 40 + 40.
    assert rec["cost_analysis"]["bytes_accessed"] == 20084
    assert rec["kernels"] == {}


# ---------------------------------------------------------------------------
# The CLI: one reduced-depth cell of each kind, a subprocess each.
# ---------------------------------------------------------------------------

CLI_CELLS = [  # arch, shape, n_layers, kernels by op and route
    ("granite-20b", "train_4k", 1, {}),
    ("jamba-v0.1-52b", "prefill_32k", 8,
     {"flash_attention": {"sm90": 1}, "ssd": {"sm90": 7}}),
    ("granite-20b", "decode_32k", 2, {}),
    ("gemma3-27b", "long_500k", 6,
     {}),
    ("dsekl", "dsekl_covtype", None,
     {"kernel_matvec": {"sm90": 1}, "kernel_vecmat": {"sm90": 1}}),
]


@pytest.fixture(scope="module")
def cli_records(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dryrun"))
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    procs = []
    for arch, shape, n_layers, _ in CLI_CELLS:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--out", out]
        if n_layers is not None:
            cmd += ["--n-layers", str(n_layers)]
        procs.append(subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    recs = {}
    for (arch, shape, _, _), proc in zip(CLI_CELLS, procs):
        stdout, stderr = proc.communicate(timeout=300)
        assert proc.returncode == 0, stderr[-3000:]
        assert f"[dryrun] OK {arch} x {shape}" in stdout
        with open(dryrun.cell_path(out, arch, shape, False)) as f:
            recs[(arch, shape)] = json.load(f)
    return recs


@pytest.mark.parametrize("arch,shape,n_layers,kernels", CLI_CELLS,
                         ids=[c[1] for c in CLI_CELLS])
def test_cli_cell_record(cli_records, arch, shape, n_layers, kernels):
    rec = cli_records[(arch, shape)]
    assert rec["ok"] is True
    assert rec["mesh"] == "16x16"
    assert rec["kernels"] == kernels
    assert rec["roofline_inputs"]["method"] == "direct (eager trace)"
    assert rec["cost_analysis"]["flops"] > 0
    assert rec["cost_analysis"]["bytes_accessed"] > 0
    mem = rec["memory_analysis"]
    assert set(mem) == {"argument_size_in_bytes", "output_size_in_bytes",
                        "temp_size_in_bytes", "alias_size_in_bytes"}
    assert mem["argument_size_in_bytes"] == sum(
        rec["argument_breakdown"].values())
    coll = rec["collectives"]
    assert coll["total_bytes"] == sum(coll[op]["bytes"]
                                      for op in dryrun.XLA_OPS) > 0
    if shape in ("decode_32k", "long_500k"):
        assert 0 < mem["alias_size_in_bytes"] <= rec["argument_breakdown"][
            "cache"]
    if shape == "train_4k":
        assert mem["alias_size_in_bytes"] == rec["argument_breakdown"][
            "params"]
    if arch == "granite-20b" and shape == "decode_32k":
        # kv_seq over the model axis: the softmax's max and sums combined
        # over it, and q gathered over it.
        assert rec["rules"]["kv_seq"] == "model"
        assert coll["all-reduce"]["count"] > 0
