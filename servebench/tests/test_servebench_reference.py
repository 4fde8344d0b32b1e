"""The plain reference computes what the port computes: one float32
forward of the port's own cache-less path against
``reference/dense_decoder.logits`` on the same weights, at reduced sizes
of both configurations (M-RoPE and tied head; half-dim RoPE and qkv
bias)."""
import json
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(REPO), str(REPO / "src"), str(Path(__file__).parent)]

import servebench_tiny  # noqa: E402
from servebench import harness, weights  # noqa: E402
from servebench.reference import dense_decoder  # noqa: E402


@pytest.mark.parametrize("name", ["qwen2-vl-2b", "chatglm3-6b"])
def test_reference_matches_the_ports_forward(name):
    from repro_torch.models import transformer
    from repro_torch.models.config import ModelConfig
    cfg_file = servebench_tiny.tiny_config(name, 0.03)
    rcfg = harness.reference_config(cfg_file)
    flat = weights.make(dense_decoder.layout(rcfg), 2 ** 31 + 5, "cpu",
                        dtype=torch.float32)
    cfg = ModelConfig(**cfg_file["model"], dtype=torch.float32)
    assert [tuple(d.shape) for d in _leaves(transformer.model_decls(cfg))] \
        == [tuple(t.shape) for t in _leaves(weights.tree(flat))]
    tokens = torch.randint(1, cfg.vocab_size, (77,),
                           generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        want, _, _ = transformer.forward(weights.tree(flat), cfg,
                                         tokens[None], causal_impl="mha")
    rows = torch.arange(77)
    got = dense_decoder.logits(flat, rcfg, tokens, rows)
    torch.testing.assert_close(got, want[0], rtol=0, atol=2e-4)
    ctl = dense_decoder.logits(flat, rcfg, tokens, rows, precision="fp8")
    assert (ctl - got).abs().max() > 100 * (want[0] - got).abs().max()


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def test_config_files_name_the_published_sizes():
    for name, keys in (("qwen2-vl-2b", {
            "num_hidden_layers": "num_layers", "hidden_size": "d_model",
            "num_attention_heads": "num_heads",
            "num_key_value_heads": "num_kv_heads",
            "intermediate_size": "d_ff", "vocab_size": "vocab_size",
            "rope_theta": "rope_theta", "rms_norm_eps": "norm_eps",
            "tie_word_embeddings": "tie_embeddings"}),
            ("chatglm3-6b", {
                "num_layers": "num_layers", "hidden_size": "d_model",
                "num_attention_heads": "num_heads",
                "multi_query_group_num": "num_kv_heads",
                "ffn_hidden_size": "d_ff", "padded_vocab_size": "vocab_size",
                "layernorm_epsilon": "norm_eps",
                "add_qkv_bias": "qkv_bias"})):
        f = json.loads((REPO / "servebench" / "configs" /
                        f"{name}.json").read_text())
        for pub, run in keys.items():
            assert f["published"][pub] == f["model"][run], (name, pub)
