"""``repro_torch.launch.hlo_analysis``: the cost counter of the dry run,
on the CPU and the meta device, and its FLOPs against the reference's
``repro.launch.hlo_analysis.analyze_text`` of the compiled step.

The reference's half runs once, in a subprocess: each config's
``reduced_config`` train step, prefill and decode step (B = 2, S = 64)
jitted, compiled on one CPU device and analyzed.  The port's steps run on
the meta device under ``analyze_step``.  What is held:

  * prefill and decode: equal FLOPs, all ten configs;
  * the train step: the reference's FLOPs plus
      - 2 B S D V everywhere: ``forward_train`` recomputes each loss
        chunk's logits in the backward pass (the reference's compiled
        step keeps them);
      - the recompute of the tail layers (Gemma-3's two sliding-window
        layers, Zamba2's two Mamba-2 layers): the port's ``remat="block"``
        recomputes each tail layer in the backward pass, the reference
        checkpoints only its scanned blocks.  The test counts that
        recompute itself (a layer's forward less the trailing products
        the backward pass does not need);
      - Falcon-Mamba, + 2 B S d_inner d_state (262,144): the backward of
        the Mamba-1 chunk scan's y = C h contraction takes a K = 1
        product (an outer product) for dC, which torch runs as a ``bmm``
        and XLA rewrites into an elementwise multiply, outside the
        reference's dot rule;
      - Zamba2, - 1,146,880 (5 products of 2 B nh K P N = 32,768 FLOPs
        a Mamba-2 layer): the SSD chunk step's three-operand einsums
        split into pairwise products differently under the two
        autodiffs; forward and decode counts are equal, and with
        ``remat="none"`` the whole difference is this term plus
        2 B S D V (measured).
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.configs as tconfigs  # noqa: E402
from repro_torch.core.distributed import ShardMesh  # noqa: E402
from repro_torch.launch import hlo_analysis as H  # noqa: E402
from repro_torch.models import ParallelConfig, init_caches  # noqa: E402
from repro_torch.models.transformer import (  # noqa: E402
    _layers, _positions)
from repro_torch.serve.engine import (make_serve_prefill,  # noqa: E402
                                      make_serve_step)
from repro_torch.train import init_state, make_train_step  # noqa: E402

_SRC = os.path.join(os.path.dirname(__file__), "..", "src")
META = torch.device("meta")
B, S = 2, 64

_REF_SCRIPT = r"""
import json, sys
import jax, jax.numpy as jnp
from repro.configs import ARCH_NAMES, get_config, reduced_config
from repro.launch import hlo_analysis
from repro.models import init_caches
from repro.models.parallel import ParallelConfig
from repro.serve.engine import make_serve_prefill, make_serve_step
from repro.train.step import TrainConfig, init_state, make_train_step

B, S = int(sys.argv[2]), int(sys.argv[3])
sds = jax.ShapeDtypeStruct
out = {}
for arch in ARCH_NAMES:
    cfg = reduced_config(get_config(arch))
    par = ParallelConfig()

    def batch(labels):
        d = {"tokens": sds((B, S), jnp.int32)}
        if labels:
            d["labels"] = sds((B, S), jnp.int32)
        if cfg.encoder_layers:
            d["frames"] = sds((B, cfg.encoder_seq, cfg.d_model), jnp.bfloat16)
        if cfg.num_image_tokens:
            d["image_embeds"] = sds((B, cfg.num_image_tokens, cfg.d_model),
                                    jnp.bfloat16)
        return d

    def flops(fn, *args):
        txt = jax.jit(fn).lower(*args).compile().as_text()
        return hlo_analysis.analyze_text(txt).flops

    st = jax.eval_shape(lambda: init_state(cfg, jax.random.PRNGKey(0),
                                           TrainConfig()))
    ca = jax.eval_shape(lambda: init_caches(
        cfg, B, S, par, memory_len=cfg.encoder_seq or cfg.num_image_tokens))
    tok = sds((B,), jnp.int32)
    out[arch] = {
        "train": flops(make_train_step(cfg, par, TrainConfig()), st,
                       batch(True)),
        "prefill": flops(make_serve_prefill(cfg, par, S), st["params"],
                         batch(False)),
        "decode": flops(make_serve_step(cfg, par), st["params"], ca, tok,
                        tok)}
with open(sys.argv[1], "w") as f:
    json.dump(out, f)
print("RESULT ok")
"""


@pytest.fixture(scope="module")
def ref_flops(tmp_path_factory):
    """Each reduced config's train / prefill / decode FLOPs from the
    reference's compiled steps (one subprocess)."""
    path = tmp_path_factory.mktemp("hlo") / "flops.json"
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=_SRC)
    out = subprocess.run([sys.executable, "-c", _REF_SCRIPT, str(path),
                          str(B), str(S)], env=env, capture_output=True,
                         text=True, timeout=900)
    assert out.returncode == 0, f"STDOUT:\n{out.stdout}\nERR:\n{out.stderr}"
    assert "RESULT ok" in out.stdout
    return json.loads(path.read_text())


def _meta(*shape, dtype=torch.int32):
    return torch.empty(shape, dtype=dtype, device=META)


def _batch(cfg, labels: bool):
    d = {"tokens": _meta(B, S)}
    if labels:
        d["labels"] = _meta(B, S)
    if cfg.encoder_layers:
        d["frames"] = _meta(B, cfg.encoder_seq, cfg.d_model,
                            dtype=torch.bfloat16)
    if cfg.num_image_tokens:
        d["image_embeds"] = _meta(B, cfg.num_image_tokens, cfg.d_model,
                                  dtype=torch.bfloat16)
    return d


def _port_flops(cfg, kind: str, par=None) -> float:
    par = par or ParallelConfig()
    st = init_state(cfg, 0, device=META)
    if kind == "train":
        return H.analyze_step(make_train_step(cfg, par), st,
                              _batch(cfg, True)).flops
    with torch.inference_mode():
        if kind == "prefill":
            return H.analyze_step(make_serve_prefill(cfg, par, S),
                                  st["params"], _batch(cfg, False)).flops
        ca = init_caches(cfg, B, S, device=META,
                         memory_len=cfg.encoder_seq or cfg.num_image_tokens)
        return H.analyze_step(make_serve_step(cfg, par), st["params"], ca,
                              _meta(B), _meta(B)).flops


def _tail_recompute_flops(cfg) -> float:
    """What ``remat="block"`` recomputes of the config's tail layers in
    the backward pass (each on (B, S, D) activations): a tail layer's
    forward and backward counted under ``checkpoint`` less without it.
    The non-reentrant checkpoint stops recomputing once it has what the
    backward pass needs, so this is less than the layers' forward."""
    from torch.utils.checkpoint import checkpoint
    params = init_state(cfg, 0, device=META)["params"]
    n = len(cfg.pattern) * cfg.n_repeats
    pos = _positions(B, S, META)
    out = 0.0
    for lp in params.blocks[n:]:
        for sign, remat in ((1.0, True), (-1.0, False)):
            h = _meta(B, S, cfg.d_model, dtype=cfg.param_dtype)
            h.requires_grad_(True)
            args = ([lp], h, pos, cfg, ParallelConfig(), None, params.shared)
            with H.CostCounter() as c:
                y, _ = (checkpoint(_layers, *args, use_reentrant=False)
                        if remat else _layers(*args))
                y.float().sum().backward()
            out += sign * c.costs.flops
    return out


# the scan terms of the train step (module docstring)
SCAN_TERM = {"falcon-mamba-7b": 2 * B * S * 128 * 8,
             "zamba2-1.2b": -1_146_880}


# ------------------------------------------------------------ the rules
def test_matmul_counts_2mnk_and_a_loop_counts_each_pass():
    a, b = torch.randn(5, 7), torch.randn(7, 3)
    with H.CostCounter() as c:
        a @ b
    assert c.costs.flops == 2 * 5 * 7 * 3
    x, y = torch.randn(4, 5, 6), torch.randn(4, 6, 2)
    forms = [(lambda: torch.bmm(x, y), 2 * 4 * 5 * 6 * 2),
             (lambda: x @ y, 2 * 4 * 5 * 6 * 2),
             (lambda: torch.einsum("bij,bjk->bik", x, y), 2 * 4 * 5 * 6 * 2),
             (lambda: torch.baddbmm(torch.zeros(4, 5, 2), x, y),
              2 * 4 * 5 * 6 * 2),
             (lambda: torch.addmm(torch.zeros(5, 3), a, b), 2 * 5 * 7 * 3),
             (lambda: torch.nn.functional.linear(a, b.t()), 2 * 5 * 7 * 3),
             (lambda: a @ b[:, 0], 2 * 5 * 7),
             (lambda: a[0] @ a[1], 2 * 7)]
    for form, want in forms:
        # inference_mode hands the counter composite ops (einsum, matmul)
        for mode in (torch.no_grad, torch.inference_mode):
            with mode(), H.CostCounter() as c:
                form()
            assert c.costs.flops == want
    with H.CostCounter() as c:
        for _ in range(7):
            a @ b
    assert c.costs.flops == 7 * 2 * 5 * 7 * 3
    # elementwise work is no FLOPs (the reference's dot-only rule)
    with H.CostCounter() as c:
        torch.exp(a) * a + 1
    assert c.costs.flops == 0 and c.costs.bytes > 0


def _prefill_by_depth(counter_cls, depths=(1, 2, 3)):
    cfg = tconfigs.reduced_config(tconfigs.get_config("yi-6b"))
    out = []
    for r in depths:
        c_r = dataclasses.replace(cfg, repeats=r, n_layers=r)
        params = init_state(c_r, 0, device=META)["params"]
        with torch.inference_mode(), counter_cls() as c:
            make_serve_prefill(c_r, ParallelConfig(), S)(
                params, {"tokens": _meta(B, S)})
        out.append(c.costs.flops)
    return out


def _grows_linearly(f) -> bool:
    return f[1] - f[0] > 0 and f[2] - f[1] == f[1] - f[0]


class _CountsEachShapeOnce(H.CostCounter):
    """A planted fault: a repeated product (the same op on the same
    shapes, as in a repeated block) counted once."""

    def __init__(self):
        super().__init__()
        self._shapes = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        key = (func, tuple(tuple(a.shape) for a in args
                           if isinstance(a, torch.Tensor)))
        if func.overloadpacket in H._MATMUL and key in self._shapes:
            return func(*args, **(kwargs or {}))
        self._shapes.add(key)
        return super().__torch_dispatch__(func, types, args, kwargs)


def test_flops_grow_linearly_with_depth():
    f = _prefill_by_depth(H.CostCounter)
    assert _grows_linearly(f), f
    # one layer's products: q/k/v/o projections, the MLP, attention
    cfg = tconfigs.reduced_config(tconfigs.get_config("yi-6b"))
    d, hd = cfg.d_model, cfg.hd
    proj = 2 * B * S * d * hd * (2 * cfg.n_heads + 2 * cfg.n_kv_heads)
    mlp = 2 * B * S * d * cfg.d_ff * 3
    attn = 2 * 2 * B * cfg.n_heads * S * S * hd
    assert f[1] - f[0] == proj + mlp + attn
    planted = _prefill_by_depth(_CountsEachShapeOnce)
    assert not _grows_linearly(planted), planted


def test_views_count_nothing_and_a_slice_update_its_payload():
    x = torch.randn(64, 32)
    with H.CostCounter() as c:
        x.view(32, 64), x.t(), x[3:9], x.reshape(2048), x.transpose(0, 1)
        x.unsqueeze(0).expand(4, 64, 32), x.detach(), x.split(16)
        torch.empty(10, 10)
    assert c.costs.bytes == 0 and c.costs.by_op == {}
    buf = torch.zeros(1000, 64)
    idx = torch.arange(10)
    src = torch.randn(10, 64)
    with H.CostCounter() as c:
        buf.index_copy_(0, idx, src)
    assert c.costs.bytes == 10 * 8 + 10 * 64 * 4
    assert c.costs.by_op == {"inplace-update": 10 * 8 + 10 * 64 * 4}
    with H.CostCounter() as c:
        buf[5:15].copy_(src)
        buf[idx] = src                       # index_put_
    assert c.costs.bytes == 10 * 64 * 4 + (10 * 8 + 10 * 64 * 4)
    # an elementwise op reads its operands and writes its result
    with H.CostCounter() as c:
        buf + buf
    assert c.costs.bytes == 3 * 1000 * 64 * 4
    assert c.costs.by_op == {"add": 3 * 1000 * 64 * 4}


def test_collectives_report_wire_bytes_per_shard():
    s, q = 8, 37
    mesh = ShardMesh(["cpu"] * s, ("data", "model"), (4, 2))
    t = [torch.randn(q) for _ in range(s)]
    with H.CostCounter() as c:
        mesh.psum(t)
    assert c.costs.wire["all-reduce"] == 2 * 4 * q
    assert c.costs.coll_counts["all-reduce"] == 1
    with H.CostCounter() as c:
        mesh.pmax(t, "model"), mesh.pmin(t, "data")
        g = mesh.all_gather(t, "data")
        mesh.ppermute(t, "data", [(0, 1), (1, 2)])
    assert c.costs.wire["all-reduce"] == 2 * (2 * 4 * q)
    assert g[0].shape == (4, q)
    assert c.costs.wire["all-gather"] == 1 * 4 * 4 * q
    assert c.costs.wire["collective-permute"] == 4 * q
    assert c.costs.coll_counts == {"all-reduce": 2, "all-gather": 1,
                                   "reduce-scatter": 0, "all-to-all": 0,
                                   "collective-permute": 1}
    # no counter, no report; a counter ended reports nothing more
    mesh.psum(t)
    assert c.costs.wire["all-reduce"] == 2 * (2 * 4 * q)


def test_live_bytes_peak_on_a_toy_and_no_tensor_kept():
    with H.CostCounter() as c:
        a = torch.ones(1000)                 # 4,000 live
        b = a * 2                            # 8,000
        del a                                # 4,000
        d = b + 1                            # 8,000
        e = torch.ones(3000)                 # 20,000: the peak
        del b, d, e                          # 0
        f = torch.ones(4000)                 # 16,000
        v = f.view(40, 100)                  # a view: no new storage
        assert c._live == 16_000
        del f, v
        assert c._live == 0
    assert c.costs.peak_live_bytes == 20_000
    # the counter keeps nothing alive, and a step's arguments count
    import weakref
    x = torch.ones(500)
    with H.CostCounter() as c:
        c.track({"x": x})
        ref = weakref.ref(x.untyped_storage())
        y = x * 3
        del x
        del y
    assert ref() is None
    assert c.costs.peak_live_bytes == 4_000


# ---------------------------------------------- against the reference
@pytest.mark.parametrize("arch", tconfigs.ARCH_NAMES)
def test_flops_match_reference(arch, ref_flops):
    cfg = tconfigs.reduced_config(tconfigs.get_config(arch))
    ref = ref_flops[arch]
    assert _port_flops(cfg, "prefill") == ref["prefill"]
    assert _port_flops(cfg, "decode") == ref["decode"]
    tail = _tail_recompute_flops(cfg)
    assert (tail > 0) == bool(cfg.tail)
    logits = 2 * B * S * cfg.d_model * cfg.vocab
    assert _port_flops(cfg, "train") == \
        ref["train"] + logits + tail + SCAN_TERM.get(arch, 0)
    if arch == "gemma3-27b":
        assert tail == 18_874_368
    if arch == "zamba2-1.2b":
        assert tail == 10_780_672


def test_moe_meta_pass_counts_the_passes_flops():
    """``_combine``'s one pass over every expert on the meta device does
    the FLOPs of the passes it takes on real tensors (here 4 passes of 2
    experts, every pass holding pairs)."""
    from repro_torch.models import moe
    rng = np.random.default_rng(0)
    e, d, f, b, s = 8, 32, 48, 4, 64
    params = {"router": torch.from_numpy(rng.normal(size=(d, e)).astype(
        np.float32)),
        "wi": torch.randn(e, d, f), "wg": torch.randn(e, d, f),
        "wo": torch.randn(e, f, d)}
    x = torch.from_numpy(rng.normal(size=(b, s, d)).astype(np.float32))
    cap = moe.capacity(b * s, 2, e, 4.0)
    old = moe.MAX_BUFFER
    moe.MAX_BUFFER = 2 * cap * max(d, f)          # per = 2 < e
    try:
        with H.CostCounter() as real:
            moe.moe_apply(params, x, top_k=2, capacity_factor=4.0)
        meta = {k: v.to(META) for k, v in params.items()}
        with H.CostCounter() as dry:
            moe.moe_apply(meta, x.to(META), top_k=2, capacity_factor=4.0)
    finally:
        moe.MAX_BUFFER = old
    experts = 3 * 2 * e * cap * d * f
    assert real.costs.flops == dry.costs.flops
    assert real.costs.flops - experts == 2 * b * s * d * e   # the router
