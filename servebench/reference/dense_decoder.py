"""Plain reference of a dense pre-norm decoder with grouped-query attention
(Qwen2-VL's language model, ChatGLM3), in float32, for the benchmark's
correctness check.

It imports nothing of the program and takes nothing the program made: the
weights come from ``servebench.weights`` (made again from the run's seed),
the prompt tokens from ``servebench.prompts``. The served tokens are read
only to judge them.

One forward over a whole sequence (prompt and served tokens, teacher
forced), no cache, no batching, no kernels: RMSNorm, q/k/v projections
with bias, rotary positions, causal softmax attention over all keys, the
SwiGLU MLP, the final norm and the LM head (the embedding's transpose when
tied). Attention runs in blocks of queries, so a 14k-token sequence never
holds a whole score matrix.

Departures from the published models, all of them the program's own
conventions, which the same weights must meet on both sides:
  * RMSNorm scales by ``1 + w`` (the weight stored as an offset from 1).
  * The rotary pairs are (i, i + rot/2) ("rotate half"). ChatGLM3 pairs
    (2i, 2i + 1) over its rotated half; the two differ by a fixed
    permutation of the q/k projection columns, which random weights do not
    see. Qwen2-VL rotates half, as here.
  * M-RoPE (Qwen2-VL) takes its three position streams (temporal, height,
    width) in the published sections [16, 24, 24] of the 64 frequencies,
    but the program has no vision tower: image and video units enter as
    token ids at sequential positions, the same in all three streams. The
    reference builds the three streams and gives them those positions.

``precision="fp8"`` is the check's control: every product's inputs are
rounded to float8 e4m3 first (activations per token, weights per output
column, q/k/v per token and head), as an fp8 serving path would compute,
with norms, softmax and accumulation in float32.
"""
from __future__ import annotations

import math

import torch

#: rows of queries a block of the attention holds at once
Q_BLOCK = 1024


def layout(cfg: dict) -> list[tuple[str, tuple, str, float]]:
    """The weights as ``(path, shape, kind, scale)``, in the order they are
    drawn: the program's parameter tree for an attention-only decoder
    (one stage, each leaf stacked over the layers). ``kind`` is "matrix"
    (N(0, scale^2)), "offset" (a norm's ``w`` or a bias, N(0, scale^2))."""
    L, D, H, KV = (cfg["num_layers"], cfg["d_model"], cfg["num_heads"],
                   cfg["num_kv_heads"])
    hd = cfg.get("head_dim") or D // H
    F, V = cfg["d_ff"], cfg["vocab_size"]
    b = "stages.0.b0."
    out = [("embed", (V, D), "matrix", 0.02),
           (b + "ln1", (L, D), "offset", 0.1),
           (b + "attn.wq", (L, D, H, hd), "matrix", D ** -0.5),
           (b + "attn.wk", (L, D, KV, hd), "matrix", D ** -0.5),
           (b + "attn.wv", (L, D, KV, hd), "matrix", D ** -0.5),
           (b + "attn.wo", (L, H, hd, D), "matrix", (H * hd) ** -0.5)]
    if cfg.get("qkv_bias"):
        out += [(b + "attn.bq", (L, H, hd), "offset", 0.1),
                (b + "attn.bk", (L, KV, hd), "offset", 0.1),
                (b + "attn.bv", (L, KV, hd), "offset", 0.1)]
    out += [(b + "ln2", (L, D), "offset", 0.1),
            (b + "mlp.wi", (L, D, F), "matrix", D ** -0.5),
            (b + "mlp.wg", (L, D, F), "matrix", D ** -0.5),
            (b + "mlp.wo", (L, F, D), "matrix", F ** -0.5),
            ("final_norm", (D,), "offset", 0.1)]
    if not cfg.get("tie_embeddings"):
        out.append(("lm_head", (D, V), "matrix", 0.02))
    return out


def _fp8(x, dim):
    """Round ``x`` to float8 e4m3 with one scale per slice along ``dim``
    (the largest magnitude maps to the format's 448), back in float32."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12)
    scale = 448.0 / amax
    return (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


def _matmul(x, w, precision):
    """x (S, K) @ w (K, N) in float32; fp8 rounds the inputs first."""
    if precision == "fp8":
        return _fp8(x, -1) @ _fp8(w, 0)
    return x @ w


def _rms_norm(x, w, eps):
    x = x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps)
    return x * (1.0 + w.float())


def _rope_angles(cfg, positions):
    """cos, sin (S, rot) for the rotated width ``rot`` of a head."""
    D, H = cfg["d_model"], cfg["num_heads"]
    hd = cfg.get("head_dim") or D // H
    theta = cfg.get("rope_theta", 10000.0)
    style = cfg["rope_style"]
    if style == "half":          # ChatGLM: the first half of each head
        rot = hd // 2
    elif style in ("llama", "mrope"):
        rot = hd
    else:
        raise ValueError(f"rope style {style!r} has no reference here")
    inv = 1.0 / theta ** (torch.arange(0, rot, 2, dtype=torch.float64,
                                       device=positions.device) / rot)
    if style == "mrope":
        # frequency j takes its angle from the stream of its section
        sections = cfg.get("mrope_section", [16, 24, 24])
        if sum(sections) != rot // 2:
            raise ValueError(f"mrope sections {sections} do not cover "
                             f"{rot // 2} frequencies")
        streams = torch.stack([positions] * 3)          # (3, S): t, h, w
        which = torch.repeat_interleave(
            torch.arange(3, device=positions.device),
            torch.tensor(sections, device=positions.device))
        pos = streams[which].T.to(torch.float64)        # (S, rot/2)
        ang = pos * inv[None, :]
    else:
        ang = positions.to(torch.float64)[:, None] * inv[None, :]
    ang = torch.cat([ang, ang], dim=-1)
    return ang.cos().float(), ang.sin().float()


def _rotate(x, cos, sin):
    """Rotate the leading ``rot`` dims of x (S, heads, hd), pairs (i, i +
    rot/2)."""
    rot = cos.shape[-1]
    xr, rest = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., :rot // 2], xr[..., rot // 2:]
    turned = torch.cat([-x2, x1], dim=-1)
    out = xr * cos[:, None, :] + turned * sin[:, None, :]
    return torch.cat([out, rest], dim=-1)


def _attention(q, k, v, precision):
    """Causal attention, q (S, H, hd), k/v (S, KV, hd) -> (S, H*hd)."""
    S, H, hd = q.shape
    KV = k.shape[1]
    G = H // KV
    if precision == "fp8":
        q, k, v = _fp8(q, -1), _fp8(k, -1), _fp8(v, -1)
    kt = k.permute(1, 2, 0)                 # (KV, hd, S)
    vt = v.permute(1, 0, 2)                 # (KV, S, hd)
    out = torch.empty(S, H, hd, dtype=torch.float32, device=q.device)
    keys = torch.arange(S, device=q.device)
    for lo in range(0, S, Q_BLOCK):
        hi = min(S, lo + Q_BLOCK)
        qb = q[lo:hi].reshape(hi - lo, KV, G, hd).permute(1, 2, 0, 3)
        s = (qb.reshape(KV, G * (hi - lo), hd) @ kt[:, :, :hi])
        s = s.reshape(KV, G, hi - lo, hi) / math.sqrt(hd)
        mask = keys[None, :hi] <= torch.arange(lo, hi,
                                               device=q.device)[:, None]
        s = s.masked_fill(~mask, float("-inf"))
        p = torch.softmax(s, dim=-1)
        ob = p.reshape(KV, G * (hi - lo), hi) @ vt[:, :hi]
        out[lo:hi] = ob.reshape(KV, G, hi - lo, hd).permute(2, 0, 1, 3) \
            .reshape(hi - lo, H, hd)
    return out.reshape(S, H * hd)


@torch.no_grad()
def logits(weights: dict, cfg: dict, tokens, rows, *,
           precision: str = "f32"):
    """Float32 logits (len(rows), V) at sequence positions ``rows`` of one
    forward over ``tokens`` (S,) int64 at positions 0..S-1. ``weights``
    maps each ``layout`` path to its tensor (any dtype; each layer is
    taken to float32 as it is used)."""
    if precision not in ("f32", "fp8"):
        raise ValueError(f"precision {precision!r}")
    L, D, H, KV = (cfg["num_layers"], cfg["d_model"], cfg["num_heads"],
                   cfg["num_kv_heads"])
    hd = cfg.get("head_dim") or D // H
    eps = cfg["norm_eps"]
    dev = weights["embed"].device
    tokens = tokens.to(dev)
    S = tokens.shape[0]
    x = weights["embed"][tokens].float()
    cos, sin = _rope_angles(cfg, torch.arange(S, device=dev))
    b = "stages.0.b0."

    def w(name, li):
        return weights[b + name][li].float()

    for li in range(L):
        h = _rms_norm(x, w("ln1", li), eps)
        q = _matmul(h, w("attn.wq", li).reshape(D, H * hd), precision)
        k = _matmul(h, w("attn.wk", li).reshape(D, KV * hd), precision)
        v = _matmul(h, w("attn.wv", li).reshape(D, KV * hd), precision)
        if cfg.get("qkv_bias"):
            q = q + w("attn.bq", li).reshape(-1)
            k = k + w("attn.bk", li).reshape(-1)
            v = v + w("attn.bv", li).reshape(-1)
        q = _rotate(q.view(S, H, hd), cos, sin)
        k = _rotate(k.view(S, KV, hd), cos, sin)
        a = _attention(q, k, v.view(S, KV, hd), precision)
        x = x + _matmul(a, w("attn.wo", li).reshape(H * hd, D), precision)
        h = _rms_norm(x, w("ln2", li), eps)
        g = _matmul(h, w("mlp.wi", li), precision)
        u = _matmul(h, w("mlp.wg", li), precision)
        x = x + _matmul(torch.nn.functional.silu(g) * u, w("mlp.wo", li),
                        precision)
    x = _rms_norm(x[rows], weights["final_norm"], eps)
    head = (weights["embed"].T if cfg.get("tie_embeddings")
            else weights["lm_head"])
    return _matmul(x, head.float(), precision)
