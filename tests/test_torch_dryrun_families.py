"""The port's dry-run against the JAX package's for the MoE, Mamba and
training steps, and the xLSTM recurrence counted once a token.

Reduced configs padded for a 16-wide model axis, on the (16, 16) mesh:
decode B=32 against a 256-token cache, prefill B=32 at S=64, train B=32
at S=64. The reference lowers and compiles its ``build`` on 256 forced
host devices under the rules its ``run_one`` picks for the shape's kind
(the training rules for train); the port runs its step on the fake
process group. One subprocess a side, since each fixes process-global
state (``XLA_FLAGS`` before ``import jax``; the fake group). The
reference cannot shard reduced xlstm-125m (its ``ff_down`` does not
divide by 16), so the xLSTM cases are the port's alone: the step the
dry-run runs once and counts once a token against the full loop.

Then, with no rules installed: the one-hot MoE route against the index
route and the JAX package, and the xLSTM blocks through ``recurrence``
bit-identical to the per-token loop they ran before it."""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
L = 2                      # layers of each reduced config below
SERVE = [("phi3.5-moe-42b-a6.6b", "decode"),
         ("phi3.5-moe-42b-a6.6b", "prefill"),
         ("grok-1-314b", "decode"), ("grok-1-314b", "prefill"),
         ("jamba-1.5-large-398b", "decode"),
         ("jamba-1.5-large-398b", "prefill")]
TRAIN = [("chatglm3-6b", "train"), ("phi3.5-moe-42b-a6.6b", "train"),
         ("whisper-base", "train")]
SHAPE = {"decode": dict(kind="decode", seq=256, batch=32),
         "prefill": dict(kind="prefill", seq=64, batch=32),
         "train": dict(kind="train", seq=64, batch=32)}
XLSTM_S = 8                # the xLSTM cases' sequence

# An Auto-axis mesh: the reference's own jax.make_mesh makes Explicit
# axes on JAX 0.9, which its shard_act refuses (ROADMAP §3)
_REFERENCE = """
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=256"
import jax
from jax.sharding import AxisType
import repro.launch.dryrun as D
from repro.configs import get_reduced
from repro.launch.mesh import make_rules
from repro.models.sharding import use_rules
pairs, shapes = (json.loads(a) for a in sys.argv[1:3])
D.get_config = get_reduced
mesh = jax.make_mesh((16, 16), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
out = {}
for arch, kind in pairs:
    D.SHAPES["_reduced"] = shapes[kind]
    rules = make_rules("train" if kind == "train" else "serve")
    with mesh, use_rules(rules, mesh):
        cfg, jitted, args = D.build(arch, "_reduced", mesh, rules)
        comp = jitted.lower(*args).compile()
    mem = comp.memory_analysis()
    out[arch + "/" + kind] = {
        "argument_bytes": mem.argument_size_in_bytes,
        "output_bytes": mem.output_size_in_bytes,
        "output_leaves": len(jax.tree.leaves(
            jax.eval_shape(jitted, *args))),
        "collectives": D.collective_bytes(comp.as_text())}
print(json.dumps(out))
"""

_PORT = """
import json, sys
from repro_torch.configs import get_reduced
from repro_torch.launch import dryrun as D
from repro_torch.models.config import pad_for_tp
pairs, shapes, S = (json.loads(a) for a in sys.argv[1:4])


def run(arch, kind, meta):
    r = D.run_one(arch, kind, "single", "", write=False, meta=meta,
                  cfg=pad_for_tp(get_reduced(arch), 16))
    return {k: r[k] for k in ("collectives", "flops", "memory")}


out = {a + "/" + k: run(a, k, shapes[k]) for a, k in pairs}
r = D.run_one("whisper-base", "train_4k", "single", "", write=False)
out["whisper-base/train_4k"] = {"collectives": r["collectives"]}
for kind in ("prefill", "train"):
    meta = dict(kind=kind, seq=S, batch=32)
    for scan in ("loop", "once"):
        D.DRYRUN_ROUTES["scan"] = scan
        out["/".join(("xlstm-125m", kind, scan))] = run("xlstm-125m", kind,
                                                        meta)
bad = [m for m in sys.modules if m in ("jax", "repro") or
       m.startswith(("jax.", "repro."))]
assert not bad, bad
print(json.dumps(out))
"""


def _run(code, args, env):
    out = subprocess.run(
        [sys.executable, "-c", code, *map(json.dumps, args)],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
                 **env), cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def reference():
    pytest.importorskip("jax")
    return _run(_REFERENCE, (SERVE + TRAIN, SHAPE), {"JAX_PLATFORMS": "cpu"})


@pytest.fixture(scope="module")
def port():
    return _run(_PORT, (SERVE + TRAIN, SHAPE, XLSTM_S), {})


def _counts(rec):
    return {k: v["count"] for k, v in rec["collectives"].items()}


# Per device. MoE (two ATTN_MOE layers): per layer the attention output's
# and the experts' partial sums reduced, and the gates (for the top k) and
# the f32 dispatched tokens gathered over data; one all-reduce for the
# vocab-sharded embedding lookup. jamba (one MAMBA_MOE and one ATTN
# layer): the Mamba block's dt/B/C products and its output projection,
# the MoE's experts, the attention and the MLP outputs, the embedding;
# in_proj's two halves moved onto the inner dim's shards by four
# collective-permutes; the MoE's two gathers.
SERVE_COUNTS = {
    "phi3.5-moe-42b-a6.6b": {"all-reduce": 2 * L + 1, "all-gather": 2 * L},
    "grok-1-314b": {"all-reduce": 2 * L + 1, "all-gather": 2 * L},
    "jamba-1.5-large-398b": {"all-reduce": 6, "collective-permute": 4,
                             "all-gather": 2},
}


@pytest.mark.parametrize("pair", SERVE, ids="/".join)
def test_serve_pairs_match_the_reference(pair, reference, port):
    key = "/".join(pair)
    ref, got = reference[key], port[key]
    mem = got["memory"]
    assert mem["argument_bytes"] == ref["argument_bytes"]
    # XLA's output size also counts 8 bytes a result leaf
    assert mem["output_bytes"] + 8 * ref["output_leaves"] == \
        ref["output_bytes"]
    assert _counts(got) == _counts(ref) == SERVE_COUNTS[pair[0]]
    coll, rcoll = got["collectives"], ref["collectives"]
    # the gathered gates and tokens are f32 on both sides
    assert coll["all-gather"]["bytes"] == rcoll["all-gather"]["bytes"]
    # the same tensors reduced: bf16 in the port, XLA:CPU widens a bf16
    # all-reduce to f32
    assert 2 * coll["all-reduce"]["bytes"] == rcoll["all-reduce"]["bytes"]
    if "collective-permute" in coll:
        # rank 0 receives two pieces of 32 a token in bf16; XLA's four f32
        # buffers hold five (its first carries a whole 64-wide shard)
        assert 5 * coll["collective-permute"]["bytes"] == \
            rcoll["collective-permute"]["bytes"]


# The port's train all-reduces, per device. chatglm3-6b (two ATTN
# layers): forward 4 (attention and MLP outputs), recompute 2 (attention
# outputs), 5 gradients of activations (each layer's MLP and attention
# inputs, the head's), the embedding lookup, the log-softmax's max and sum
# and the label's logit (3), the token count, the gradients in 2 (one a
# set of partial mesh dims), the gradient norm and the loss metric: 20.
# The reference's 21 has the same reductions of activations (forward 4,
# recompute 2, backward 5), moves the lookup and the label's logit with a
# collective-permute, all-to-alls and gathers instead, and packs its
# gradients, norm and loss sums into 8 tuples. phi3.5-moe (two ATTN_MOE
# layers): the experts' outputs in place of the MLP's (forward and
# recompute: +2), each layer's dispatched tokens' gradient (+2, partial
# over the expert products' sharded dim), the aux metric (+1): 25; the
# reference's 29 adds each layer's router logits (forward and recompute:
# XLA keeps the FSDP-sharded router and reduces its product, where the
# port gathers it with the layer's other weights) and aux loss.
# whisper-base (two encoder and two decoder layers): forward 10 (self-
# attention, cross-attention and MLP outputs), 4 in the products'
# backward, 12 LayerNorm output gradients summed whole (2 an encoder
# layer, 3 a decoder layer, the two final norms: ``sharding.whole_grad``),
# then the embedding lookup, the loss's 3, the token count, the gradients
# in 1, the norm and the loss metric: 34; the reference's 42.
TRAIN_AR = {"chatglm3-6b": 20, "phi3.5-moe-42b-a6.6b": 25,
            "whisper-base": 34}


@pytest.mark.parametrize("pair", TRAIN, ids="/".join)
def test_train_pairs_hold_the_reference_rules(pair, reference, port):
    """The all-reduces counted above, no more than the reference's; no
    reduce-scatter (the gradients are reduced whole, as XLA reduces
    them); no more all-gathers than the reference's all-gathers,
    all-to-alls and collective-permutes together (DTensor's CPU mesh
    moves a tensor between sharded dims by all-gather and chunk)."""
    key = "/".join(pair)
    ref, got = reference[key], port[key]
    assert got["memory"]["argument_bytes"] == ref["argument_bytes"]
    have, want = _counts(got), _counts(ref)
    assert set(have) == {"all-gather", "all-reduce"}
    assert have["all-reduce"] == TRAIN_AR[pair[0]] <= want["all-reduce"]
    assert have["all-gather"] <= sum(want.get(k, 0) for k in (
        "all-gather", "all-to-all", "collective-permute"))


@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_xlstm_step_counted_once_equals_the_loop(kind, port):
    """Reduced xlstm-125m (one mLSTM and one sLSTM layer) at S=8: the
    dry-run's recurrence (the first and last steps run, one middle step
    counted six times) gives the record of all eight steps: collectives,
    bytes, FLOPs, memory."""
    once = port[f"xlstm-125m/{kind}/once"]
    assert once == port[f"xlstm-125m/{kind}/loop"]
    if kind == "prefill":
        # no collective inside a step: q, k, v and the gates are reduced
        # onto each rank's heads once a block (5), up_proj's halves moved
        # by permutes (4); the mLSTM's, the sLSTM's and the embedding's
        # outputs reduced (3); the sLSTM's heads gathered for its FFN (1)
        assert _counts(once) == {"all-reduce": 3, "collective-permute": 4,
                                 "reduce-scatter": 5, "all-gather": 1}


def test_whisper_train_record_is_the_same_on_every_torch(port):
    """whisper-base's train step leaves no redistribution to DTensor's
    LayerNorm backward, which torch 2.11 and 2.13 resolve differently
    (an all-reduce against a reduce-scatter and an all-gather): every
    LayerNorm's output gradient is summed whole first. The reduced pair
    issues all-gathers and all-reduces only, the counts torch 2.11 gave
    before that repair; the full-size train_4k record is the one
    chip_smoke.py's dry-run phase holds the chip machine's torch to."""
    assert _counts(port["whisper-base/train"]) == {"all-gather": 90,
                                                   "all-reduce": 34}
    smoke = _chip_smoke()
    assert _counts(port["whisper-base/train_4k"]) == \
        smoke.DRYRUN_TRAIN_EXPECTED["whisper-base", "train_4k"]


def _chip_smoke():
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_chip_smoke_counts_the_reduced_records(port):
    """chip_smoke.py's dry-run phase holds full-size pairs to collectives
    counted a layer (``dryrun_expected``); the same arithmetic gives the
    reduced records here."""
    from repro_torch.configs import get_reduced
    from repro_torch.models.config import pad_for_tp
    smoke = _chip_smoke()
    for key in ["/".join(p) for p in SERVE] + ["xlstm-125m/prefill/once"]:
        cfg = pad_for_tp(get_reduced(key.split("/")[0]), 16)
        assert _counts(port[key]) == smoke.dryrun_expected(cfg), key


# --- the sharded step run for real --------------------------------------

SHARDED = ["chatglm3-6b", "phi3.5-moe-42b-a6.6b", "jamba-1.5-large-398b",
           "xlstm-125m", "whisper-base"]


@pytest.fixture(scope="module")
def sharded():
    out = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "torch_sharded_step.py"),
         *SHARDED], env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_halves_moves_every_piece_on_gloo(sharded):
    """``sharding.halves``'s permutes on four gloo processes: each half
    whole where it belongs, and its gradient back, on a 1-D and a 2-D
    mesh (tests/torch_sharded_step.py)."""
    assert sharded["halves"] is True


@pytest.mark.parametrize("arch", SHARDED)
def test_sharded_train_step_computes_the_plain_gradients(arch, sharded):
    """The dry-run's train step (its routes and the training rules, the
    recurrence run every step) on four gloo processes over a (2, 2)
    mesh: the loss of the plain step within 1e-6 and every parameter's
    gradient within 1e-4 of its largest magnitude (plus 1e-8), in f32 —
    the sharded program the dry-run counts computes the step it claims
    to (tests/torch_sharded_step.py)."""
    (got, want), leaves = sharded[arch]["loss"], sharded[arch]["leaves"]
    assert abs(got - want) <= 1e-6 * abs(want)
    for err, scale in leaves:
        assert err <= 1e-4 * scale + 1e-8


# --- no rules: the routes against each other and the reference ---------

@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("case", ["ragged", "one_group", "forced"])
def test_onehot_dispatch_matches_the_index_route(case, dt):
    """``moe_block(dispatch="onehot")``, the dry-run's route, against the
    serving route and the JAX package's block, on test_torch_moe.py's
    cases and within its tolerances."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from test_torch_moe import _JMOE, ARCH, CASES, TOL, _inputs, _weights
    from torch_parity import both

    from repro import configs as jconfigs
    from repro_torch import configs as tconfigs
    from repro_torch.models import layers as TL
    S, group, forced = CASES[case]
    jc, tc = jconfigs.get_reduced(ARCH), tconfigs.get_reduced(ARCH)
    jw, tw = {}, {}
    for k, a in _weights(jc, forced).items():
        jw[k], tw[k] = both(a, dt)
    jx, tx = both(_inputs(jc, S, forced), dt)
    want, jaux = _JMOE(jx, jw, jc, group_size=group)
    index, iaux = TL.moe_block(tx, tw, tc, group_size=group)
    onehot, oaux = TL.moe_block(tx, tw, tc, group_size=group,
                                dispatch="onehot")
    assert onehot.shape == index.shape and onehot.dtype == index.dtype
    for got in (index, onehot):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   atol=TOL[dt], rtol=0)
    np.testing.assert_allclose(onehot.float().numpy(),
                               index.float().numpy(), atol=TOL[dt], rtol=0)
    # the same routing: the same aux loss, bit for bit
    assert torch.equal(oaux, iaux)
    np.testing.assert_allclose(float(oaux), float(jaux), atol=TOL[dt])


def _old_mlstm_block(x, p, cfg, cache=None):
    """``mlstm_block`` as it ran before ``recurrence``: a Python step per
    token."""
    from repro_torch.models.xlstm import _mlstm_step
    B, S, D = x.shape
    H = cfg.num_heads
    DI = int(cfg.xlstm_proj_factor * D)
    hd = DI // H
    up = x @ p["up_proj"]
    xin, z = up[..., :DI], up[..., DI:]

    def heads(w, b):
        return (xin @ w + b).reshape(B, S, H, hd).to(torch.float32)

    q = heads(p["wq"], p["bq"])
    k = heads(p["wk"], p["bk"]) / math.sqrt(hd)
    v = heads(p["wv"], p["bv"])
    ig = (xin @ p["wi_g"] + p["bi_g"]).to(torch.float32)
    fg = (xin @ p["wf_g"] + p["bf_g"]).to(torch.float32)
    if cache is not None:
        state = tuple(cache[s].to(torch.float32) for s in ("C", "n", "m"))
    else:
        state = (torch.zeros((B, H, hd, hd)), torch.zeros((B, H, hd)),
                 torch.full((B, H), -1e30))
    hs = []
    for t in range(S):
        state, h = _mlstm_step(state, q[:, t], k[:, t], v[:, t], ig[:, t],
                               fg[:, t])
        hs.append(h)
    h = torch.stack(hs, dim=1).reshape(B, S, DI).to(x.dtype)
    h = h * F.silu(z)
    return h @ p["down_proj"], {"C": state[0], "n": state[1], "m": state[2]}


def _old_slstm_block(x, p, cfg, cache=None):
    """``slstm_block`` as it ran before ``recurrence``."""
    B, S, D = x.shape
    H = cfg.num_heads
    hd = D // H
    xh = x.reshape(B, S, H, hd)

    def gate_x(w, b):
        return (torch.einsum("bshd,hde->bshe", xh, w) + b).to(torch.float32)

    zx, ix, fx, ox = (gate_x(p["W" + g], p["b" + g]) for g in "zifo")
    R = torch.cat([p["R" + g].to(torch.float32) for g in "zifo"], dim=-1)
    if cache is not None:
        c, n, m, h = (cache[s].to(torch.float32) for s in ("c", "n", "m", "h"))
    else:
        c, n, m, h = (f((B, H, hd)) for f in
                      (torch.zeros, torch.ones, torch.zeros, torch.zeros))
    hs = []
    for t in range(S):
        rz, ri, rf, ro = torch.einsum("bhd,hde->bhe", h, R).split(hd, dim=-1)
        zt = torch.tanh(zx[:, t] + rz)
        it = ix[:, t] + ri
        ft = fx[:, t] + rf
        ot = torch.sigmoid(ox[:, t] + ro)
        log_f = -F.softplus(-ft)
        m_new = torch.maximum(log_f + m, it)
        i_act = torch.exp(it - m_new)
        f_act = torch.exp(log_f + m - m_new)
        c = f_act * c + i_act * zt
        n = f_act * n + i_act
        m = m_new
        h = ot * c / torch.clamp(n, min=1e-6)
        hs.append(h)
    y = torch.stack(hs, dim=1).reshape(B, S, D).to(x.dtype)
    g = F.gelu(y @ p["ff_up"], approximate="tanh")
    y = (g * (y @ p["ff_gate"])) @ p["ff_down"]
    return y, {"c": c, "n": n, "m": m, "h": h}


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_xlstm_blocks_through_recurrence_are_unchanged(dt):
    """Serving's mLSTM and sLSTM blocks (``scan="loop"``, no rules) give
    the bits of the per-token loop they replaced: a 7-token prefill, then
    a decode step from its state."""
    from torch_parity import TORCH_DT

    from repro_torch.configs import get_reduced
    from repro_torch.models import transformer as T
    from repro_torch.models import xlstm as X
    from repro_torch.models.params import init_params, tree_map
    cfg = get_reduced("xlstm-125m")
    params = init_params(T.model_decls(cfg), torch.Generator().manual_seed(3))
    stage = tree_map(lambda a: a[0].to(TORCH_DT[dt]), params["stages"][0],
                     is_leaf=torch.is_tensor)
    g = torch.Generator().manual_seed(4)
    for bi, (new, old) in enumerate(((X.mlstm_block, _old_mlstm_block),
                                     (X.slstm_block, _old_slstm_block))):
        p = stage[f"b{bi}"]["core"]
        cache = {}
        for S in (7, 1):
            x = torch.randn(2, S, cfg.d_model, generator=g).to(TORCH_DT[dt])
            got, got_state = new(x, p, cfg, cache=cache or None)
            want, want_state = old(x, p, cfg, cache=cache or None)
            assert torch.equal(got, want), (bi, S)
            assert got_state.keys() == want_state.keys()
            for k in want_state:
                assert torch.equal(got_state[k], want_state[k]), (bi, S, k)
            cache = want_state
