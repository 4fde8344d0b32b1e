"""The port's dry-run against the JAX package's on reduced pairs.

Reduced chatglm3-6b and qwen2-vl-2b (padded for a 16-wide model axis),
decode (B=32 against a 256-token cache) and prefill (B=32, S=64), on the
(16, 16) mesh under the serving rules, and reduced qwen2-vl-2b's decode
(B=64) on the (2, 16, 16) multi-pod mesh. The reference lowers and
compiles its ``build`` on 512 forced host devices; the port runs its
step on the fake process group. Each side runs in its own subprocess, since each
fixes process-global state (``XLA_FLAGS`` before ``import jax``; the
fake group). Held equal: per-device argument and output bytes, and the
collectives' kinds and counts; their bytes up to the one dtype factor
named below. The port's counted per-device FLOPs are held within 10% of
the analytic model's per-device share."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
# (arch, shape, mesh); the multi-pod pair first, so that the port's fake
# group is made with all 512 ranks
PAIRS = [("qwen2-vl-2b", "decode", "multi"),
         ("chatglm3-6b", "decode", "single"),
         ("chatglm3-6b", "prefill", "single"),
         ("qwen2-vl-2b", "decode", "single"),
         ("qwen2-vl-2b", "prefill", "single")]
# long-context decode (B=1, the cache's sequence dim over data): run with
# the others, held to the reference's collective counts only
LONG = ("qwen2-vl-2b", "long", "single")
SHAPE = {"decode": dict(kind="decode", seq=256, batch=32),
         "prefill": dict(kind="prefill", seq=64, batch=32),
         "long": dict(kind="decode", seq=1024, batch=1, long=True)}

# The reference's own mesh, jax.make_mesh, makes Explicit axes on JAX 0.9,
# and its shard_act (with_sharding_constraint) then refuses them; a mesh
# built here with Auto axes is what the reference's dry-run was written
# for.
_REFERENCE = """
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import jax
from jax.sharding import AxisType
import repro.launch.dryrun as D
from repro.configs import get_reduced
from repro.launch.mesh import make_rules
from repro.models.sharding import use_rules
pairs, shapes = (json.loads(a) for a in sys.argv[1:3])
D.get_config = get_reduced
meshes = {
    "single": jax.make_mesh((16, 16), ("data", "model"),
                            devices=jax.devices()[:256],
                            axis_types=(AxisType.Auto,) * 2),
    "multi": jax.make_mesh((2, 16, 16), ("pod", "data", "model"),
                           axis_types=(AxisType.Auto,) * 3)}
out = {}
for arch, kind, m in pairs:
    meta = shapes[kind]
    D.SHAPES["_reduced"] = dict(meta, batch=meta["batch"] * (1 + (m == "multi")))
    mode = "long_ctx" if meta.get("long") else "serve"
    mesh, rules = meshes[m], make_rules(mode, multi_pod=m == "multi")
    with mesh, use_rules(rules, mesh):
        cfg, jitted, args = D.build(arch, "_reduced", mesh, rules)
        comp = jitted.lower(*args).compile()
    mem = comp.memory_analysis()
    out["/".join((arch, kind, m))] = {
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
pairs, shapes = (json.loads(a) for a in sys.argv[1:3])
out = {}
for arch, kind, m in pairs:
    meta = shapes[kind]
    meta = dict(meta, batch=meta["batch"] * (1 + (m == "multi")))
    r = D.run_one(arch, kind, m, "", cfg=pad_for_tp(get_reduced(arch), 16),
                  meta=meta, write=False)
    out["/".join((arch, kind, m))] = r
bad = [m for m in sys.modules if m in ("jax", "repro") or
       m.startswith(("jax.", "repro."))]
assert not bad, bad
print(json.dumps(out))
"""


def _run(code, env):
    out = subprocess.run(
        [sys.executable, "-c", code, json.dumps(PAIRS + [LONG]),
         json.dumps(SHAPE)],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
                 **env), cwd=ROOT, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def reference():
    pytest.importorskip("jax")
    return _run(_REFERENCE, {"JAX_PLATFORMS": "cpu"})


@pytest.fixture(scope="module")
def port():
    return _run(_PORT, {})


# the reference's record keys (src/repro/launch/dryrun.py, run_one)
KEYS = {"arch", "shape", "mesh", "devices", "mode", "opts", "params",
        "padded_heads", "orig_heads", "padded_kv", "orig_kv", "lower_s",
        "compile_s", "flops", "bytes_accessed", "memory", "collectives",
        "analytic", "roofline"}
MEMORY = {"argument_bytes", "output_bytes", "temp_bytes",
          "generated_code_bytes"}
ROOFLINE = {"compute_s", "memory_s", "collective_s", "dominant",
            "useful_flops_ratio"}


@pytest.mark.parametrize("pair", PAIRS, ids="/".join)
def test_bytes_and_collectives_match_the_reference(pair, reference, port):
    key = "/".join(pair)
    ref, got = reference[key], port[key]
    mem = got["memory"]
    assert mem["argument_bytes"] == ref["argument_bytes"]
    # XLA's output size also counts the result tuple's table of buffer
    # pointers, 8 bytes a leaf (logits, each stacked K and V, idx)
    assert mem["output_bytes"] + 8 * ref["output_leaves"] == \
        ref["output_bytes"]
    assert {k: v["count"] for k, v in got["collectives"].items()} == \
        {k: v["count"] for k, v in ref["collectives"].items()}
    # 2 a layer (attention and MLP outputs) + 1 for the vocab-sharded
    # embedding lookup
    assert got["collectives"]["all-reduce"]["count"] == 5
    # the same tensors are reduced: bf16 in the port, while XLA:CPU widens
    # a bf16 all-reduce to f32 (twice the bytes)
    for kind, rec in got["collectives"].items():
        assert 2 * rec["bytes"] == ref["collectives"][kind]["bytes"], kind


@pytest.mark.parametrize("pair", PAIRS, ids="/".join)
def test_record_keys_and_flops(pair, port):
    got = port["/".join(pair)]
    assert set(got) == KEYS
    assert set(got["memory"]) == MEMORY
    assert set(got["roofline"]) == ROOFLINE
    assert got["devices"] == {"single": 256, "multi": 512}[pair[2]]
    assert got["mode"] == "serve"
    assert got["compile_s"] is None and got["memory"]["temp_bytes"] is None
    share = got["analytic"]["flops_global"] / got["devices"]
    assert abs(got["flops"] - share) <= 0.1 * share
    if pair[1] == "decode":
        assert got["flops"] == share
    else:
        # the one term that differs: the analytic model's attention
        # (scores and weighted sum) sees the causal average of S/2 keys a
        # query, while mha computes the whole masked S x S block
        from repro_torch.configs import get_reduced
        from repro_torch.models.config import pad_for_tp
        cfg = pad_for_tp(get_reduced(pair[0]), 16)
        S = SHAPE["prefill"]["seq"]
        B_loc, H_loc = SHAPE["prefill"]["batch"] // 16, cfg.num_heads // 16
        extra = 4 * B_loc * S * (S - S / 2) * H_loc * cfg.hd * cfg.num_layers
        assert got["flops"] == share + extra


def test_context_parallel_decode_counts_match_the_reference(reference, port):
    """Reduced qwen2-vl-2b decoding one token against a 1024-token cache
    sharded over data (the long-context rules): the same collectives, 11
    all-reduces — per layer the softmax's max and sum over the sharded
    keys, the attention output over data and over model, the MLP's; one
    for the embedding. Their bytes part: the port reduces the attention's
    data-axis partial sum after the output projection, XLA before it."""
    key = "/".join(LONG)
    ref, got = reference[key], port[key]
    assert got["mode"] == "long_ctx"
    assert got["memory"]["argument_bytes"] == ref["argument_bytes"]
    assert {k: v["count"] for k, v in got["collectives"].items()} == \
        {k: v["count"] for k, v in ref["collectives"].items()} == \
        {"all-reduce": 11}
