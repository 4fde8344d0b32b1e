"""The port's sharding rules against the JAX package's: ``make_rules`` for
every mode and option, ``param_pspecs`` leaf for leaf for all ten
full-size archs (padded for a 16-wide model axis) in every mode, each
leaf's local shard shape on the (16, 16) mesh against JAX's
``NamedSharding.shard_shape``; ``shard_act`` as the identity without
rules, and the serving forward unchanged by the annotations.

The port's mesh is a fake process group, process-global, so its side of
the shard-shape check runs in a subprocess; the JAX side needs no
devices (an ``AbstractMesh``)."""
import itertools
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch_parity  # noqa: F401  (one intra-op thread)

jax = pytest.importorskip("jax")
from jax.sharding import AbstractMesh, NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as JSpec  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.config import pad_for_tp as jpad  # noqa: E402
from repro.models.params import param_pspecs as jpspecs  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import sharding  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.config import pad_for_tp as tpad  # noqa: E402
from repro_torch.models.params import (PartitionSpec,  # noqa: E402
                                       param_pspecs, tree_leaves)

ROOT = Path(__file__).resolve().parents[1]
MODES = ("train", "serve", "long_ctx")
OPTS = [frozenset(c) for n in range(3) for c in itertools.combinations(
    ("moe_data", "seq_par", "seq_par_repl", "act_model"), n)]
ARCHS = list(jconfigs.ALIASES)


@pytest.mark.parametrize("multi", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_make_rules_matches_jax(mode, multi):
    for opts in OPTS:
        assert tmesh.make_rules(mode, multi_pod=multi, opts=opts) == \
            jmesh.make_rules(mode, multi_pod=multi, opts=opts), (mode, opts)
    with pytest.raises(ValueError):
        tmesh.make_rules("bogus")


def _jax_leaves(arch, rules):
    cfg = jpad(jconfigs.get_config(arch), 16)
    specs = jpspecs(JT.model_decls(cfg), rules)
    shapes = [d.shape for d in jax.tree.leaves(
        JT.model_decls(cfg), is_leaf=lambda x: hasattr(x, "axes"))]
    return shapes, [tuple(s) for s in jax.tree.leaves(
        specs, is_leaf=lambda x: isinstance(x, JSpec))]


def _port_leaves(arch, rules):
    cfg = tpad(tconfigs.get_config(arch), 16)
    decls = TT.model_decls(cfg)
    specs = tree_leaves(param_pspecs(decls, rules),
                        is_leaf=lambda x: isinstance(x, PartitionSpec))
    return [d.shape for d in tree_leaves(decls)], [tuple(s) for s in specs]


@pytest.mark.parametrize("arch", ARCHS)
def test_param_pspecs_match_jax(arch):
    """Every mode, on the single and the multi-pod mesh: the same spec for
    the same leaf (leaves in ``jax.tree`` order on both sides)."""
    for mode, multi in itertools.product(MODES, (False, True)):
        rules = jmesh.make_rules(mode, multi_pod=multi)
        j_shapes, j_specs = _jax_leaves(arch, rules)
        t_shapes, t_specs = _port_leaves(arch, rules)
        assert t_shapes == j_shapes
        assert t_specs == j_specs, (arch, mode, multi)


_SHARD_SHAPES = """
import json, sys
from repro_torch.configs import ALIASES, get_config
from repro_torch.launch.mesh import make_production_mesh, make_rules
from repro_torch.models import transformer as T
from repro_torch.models.config import pad_for_tp
from repro_torch.models.params import (abstract_params, distribute_abstract,
                                       param_pspecs, tree_leaves)
mesh = make_production_mesh()
out = {}
for arch in ALIASES:
    decls = T.model_decls(pad_for_tp(get_config(arch), 16))
    for mode in ("train", "serve", "long_ctx"):
        rules = make_rules(mode)
        dt = distribute_abstract(abstract_params(decls),
                                 param_pspecs(decls, rules), mesh)
        out[arch + "/" + mode] = [list(t.to_local().shape)
                                  for t in tree_leaves(dt, is_leaf=lambda x:
                                                       hasattr(x, "to_local"))]
bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")]
assert not bad, bad
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def port_shard_shapes():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", _SHARD_SHAPES], env=env,
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("arch", ARCHS)
def test_local_shard_shapes_match_jax(arch, port_shard_shapes):
    """Rank 0's shard of each parameter on the port's (16, 16) mesh has
    the shape JAX gives the same spec on an abstract (16, 16) mesh."""
    mesh = AbstractMesh((16, 16), ("data", "model"))
    for mode in MODES:
        shapes, specs = _jax_leaves(arch, jmesh.make_rules(mode))
        want = [list(NamedSharding(mesh, JSpec(*s)).shard_shape(shape))
                for shape, s in zip(shapes, specs)]
        assert port_shard_shapes[f"{arch}/{mode}"] == want, (arch, mode)


def test_shard_act_is_the_identity_without_rules():
    assert sharding.current_rules() is None
    x = torch.randn(2, 3, 4)
    assert sharding.shard_act(x, "batch", "seq", "embed_act") is x
    assert sharding.replicate(x) is x
    assert sharding.act_pspec("batch", "seq") == PartitionSpec()
    # rules on a plain tensor: still the object itself
    with sharding.use_rules(tmesh.make_rules("serve"), object()):
        assert sharding.current_rules() is not None
        assert sharding.shard_act(x, "batch", "seq", "embed_act") is x
        assert sharding.act_pspec("batch", "seq", "embed_act") == \
            PartitionSpec("data", None, None)
    assert sharding.current_rules() is None


# ---------------- serving is what it was without rules ---------------------

PAGE, PPL = 4, 20
BT = np.array([[0, 1, 2, 3, 4, PPL - 1, PPL - 1, PPL - 1],
               [5, 6, 7, 8, PPL - 1, PPL - 1, PPL - 1, PPL - 1]], np.int32)


def _serve_once():
    """A reduced qwen2-vl cache-less forward with stub image embeddings,
    then a ragged paged prefill and a paged decode through the kernels'
    route: (logits, calls of each ``kernels.ops`` entry point, the
    wrappers' launch counters)."""
    from repro_torch.cache.paged import PagedStackStore
    from repro_torch.kernels import ops as kops
    from repro_torch.models.params import init_params
    cfg = tconfigs.get_reduced("qwen2-vl-2b")
    params = TT.cast_params(init_params(
        TT.model_decls(cfg), torch.Generator().manual_seed(0)), cfg.dtype)
    layers = TT.layer_params(params, cfg)
    assert "wqkv" in layers[0]["b0"][0]        # the fused serving weights
    calls = {}
    g = np.random.default_rng(2)
    toks = torch.from_numpy(g.integers(1, cfg.vocab_size, (2, 8)))
    mm = torch.from_numpy(g.standard_normal((2, 3, cfg.d_model)).astype(
        np.float32)).to(cfg.dtype)
    out = []
    names = ("paged_attention", "paged_prefill_attention",
             "prefill_attention")
    orig = {n: getattr(kops, n) for n in names}

    def counted(n):
        def f(*a, **k):
            calls[n] = calls.get(n, 0) + 1
            return orig[n](*a, **k)
        return f
    try:
        for n in names:
            setattr(kops, n, counted(n))
        with torch.no_grad():
            out.append(TT.forward(params, cfg, toks, mm_embeds=mm,
                                  layers=layers)[0])
            stores = [{f"b{i}": PagedStackStore.build(
                r, PPL, PAGE, cfg.num_kv_heads, cfg.hd)
                for i, _ in enumerate(p)} for p, r in cfg.stages()]
            steps = [(toks, np.zeros(2, np.int32), np.array([8, 5])),
                     (toks[:, :1], np.array([8, 5]), np.ones(2, np.int32))]
            for t, lengths, new_lens in steps:
                S = t.shape[1]
                pos = torch.from_numpy(lengths[:, None] + np.arange(S))
                cache = {"stages": stores, "block_table": torch.from_numpy(BT),
                         "lengths": torch.from_numpy(lengths.astype(np.int32)),
                         "new_lens": torch.from_numpy(
                             new_lens.astype(np.int32))}
                out.append(TT.forward(
                    params, cfg, t, positions=pos, cache=cache,
                    last_pos=torch.from_numpy(np.maximum(new_lens - 1, 0)),
                    attn_impl="kernel", layers=layers)[0])
    finally:
        for n in names:
            setattr(kops, n, orig[n])
    launches = {n: kops.KERNELS[n].launches for n in names}
    return out, calls, launches


def test_serving_is_unchanged_without_rules(monkeypatch):
    """With no rules installed the annotations change nothing: the serving
    forward (dense with stub embeddings, paged prefill and decode through
    the kernel route) gives bit-identical logits, the same kernel-route
    calls and the same launch counts as with every annotation and lift
    replaced by a bare identity."""
    got, calls, launches = _serve_once()
    assert calls == {"prefill_attention": 2, "paged_prefill_attention": 2,
                     "paged_attention": 2}
    import repro_torch.models.layers as L
    import repro_torch.models.rope as R
    for mod in (L, TT, R, sharding):
        for name in ("shard_act", "replicate"):
            if hasattr(mod, name):
                monkeypatch.setattr(mod, name, lambda x, *a: x)
    want, calls2, launches2 = _serve_once()
    assert calls2 == calls and launches2 == launches
    for g, w in zip(got, want):
        assert torch.equal(g, w)
