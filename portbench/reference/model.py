"""The plain reference: the target model's forward pass in float32 over a
whole sequence, from the k-quant bytes the benchmark made.

It imports nothing of the program. Two architectures, as published:

- MPT (mosaicml/mpt-7b): LayerNorm without bias, fused QKV, multi-head
  attention with ALiBi (slope of head h: 2^(-max_bias * (h + 1) / H) for a
  power-of-two head count), exact-erf GELU FFN of up and down, pre-norm
  residuals, a final LayerNorm and an untied head.
- Mistral (mistralai/Mistral-7B-v0.1): RMSNorm, RoPE with base theta on
  (q, k), grouped-query attention (query head h reads KV head
  h // (H / KVH)), SwiGLU FFN. The weights are drawn in llama.cpp's GGUF
  row order, whose Q and K rows are permuted so that RoPE rotates adjacent
  pairs (2i, 2i + 1); the reference rotates the same pairs, which is the
  published rotation of halves on the un-permuted rows.

Computed in float32 with TF32 off, at the precision the configuration
states for its products (its ``precision`` group): with ``stated`` on, a
Q4_K weight is regridded as the served layout states it (4 bits on a
min/max affine grid per 128 input rows and output column, refined by two
least-squares rounds of step and minimum given the rounded values) and a
Q6_K weight to 8 bits on an absmax grid per 512 input rows and column; the
input of each product is rounded to ``act_bits`` (8 as stated) on a
symmetric absmax grid per row and group of 128 (Q4_K) or 512 (Q6_K) input
columns. The program shares each activation scale among the rows of one
call, which the reference cannot know; per row is the finer grid. With
``stated`` off, the plain dequantized weights and f32 products.
``with_bits(4)`` is the control: int4 activations in the same reference;
``draft()`` is the draft model (the lower layers and the draft's head) on
the same weights.
"""

from __future__ import annotations

import math

import torch

from .dequant import DECODERS


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def fake_quant(x: torch.Tensor, bits: int, group: int = 128) -> torch.Tensor:
    """x [T, K] rounded onto a symmetric grid of 2^(bits-1) - 1 levels per
    (row, group of columns); K is zero-padded to a whole group."""
    t, k = x.shape
    pad = (-k) % group
    xp = torch.nn.functional.pad(x, (0, pad)) if pad else x
    qmax = 2 ** (bits - 1) - 1
    xg = xp.reshape(t, -1, group)
    s = xg.abs().amax(dim=2, keepdim=True).clamp_min(1e-20) / qmax
    return (torch.round(xg / s).clamp(-qmax, qmax) * s).reshape(t, -1)[:, :k]


def _blocks_t(w: torch.Tensor, rows: int, pad_to: int) -> torch.Tensor:
    """W [N, K] -> W^T zero-padded to a multiple of pad_to input rows, cut
    into blocks [K' / rows, rows, N]."""
    wt = w.T
    pad = (-wt.shape[0]) % pad_to
    if pad:
        wt = torch.nn.functional.pad(wt, (0, 0, 0, pad))
    return wt.reshape(-1, rows, wt.shape[1])


def regrid_4bit(w: torch.Tensor, rows: int = 128, pad_to: int = 256) -> torch.Tensor:
    """W [N, K] on 16 levels wmin + step * u per (rows input rows, column):
    start from the block's min and max, then twice fit (step, wmin) by
    least squares to the rounded levels and round again."""
    n, k = w.shape
    b = _blocks_t(w, rows, pad_to)
    lo = b.amin(dim=1)
    step = (b.amax(dim=1) - lo).clamp_min(1e-9) / 15.0
    for _ in range(2):
        u = torch.round((b - lo[:, None]) / step[:, None]).clamp(0, 15)
        su, suu = u.sum(dim=1), (u * u).sum(dim=1)
        sw, swu = b.sum(dim=1), (b * u).sum(dim=1)
        det = rows * suu - su * su
        ok = det.abs() > 1e-9
        step = torch.where(ok, (rows * swu - su * sw) / torch.where(ok, det, 1.0), step)
        step = step.abs().clamp_min(1e-9)
        lo = (sw - step * su) / rows
    u = torch.round((b - lo[:, None]) / step[:, None]).clamp(0, 15)
    return (lo[:, None] + step[:, None] * u).reshape(-1, n)[:k].T.contiguous()


def regrid_8bit(w: torch.Tensor, rows: int = 512) -> torch.Tensor:
    """W [N, K] on a symmetric absmax grid of 127 levels per (rows input
    rows, column)."""
    n, k = w.shape
    b = _blocks_t(w, rows, rows)
    s = b.abs().amax(dim=1).clamp_min(1e-20) / 127.0
    return (torch.round(b / s[:, None]) * s[:, None]).reshape(-1, n)[:k].T.contiguous()


# the served products by weight format: (weight regrid, activation group)
STATED = {"Q4_K": (regrid_4bit, 128), "Q6_K": (regrid_8bit, 512)}


class Reference:
    """The target of a ModelBytes-like description (``arch``, widths,
    ``tensors`` name -> (qtype, (N, K), bytes), ``layers``) with its unique
    tensors dequantized once on `device`."""

    def __init__(self, mb, device, stated: bool = True, act_bits: int = 8, draft: bool = False):
        no_tf32()
        self.mb = mb
        self.device = torch.device(device)
        self.act_bits = act_bits if stated else 0
        self.layers, self.head = mb.layers, "output"
        self.w, self.group = {}, {}
        for name, (qtype, (n, k), raw) in mb.tensors.items():
            w = DECODERS[qtype](raw.to(self.device), n, k)
            if stated and name != "tok_embd":  # the embedding is a row gather, exact
                regrid, self.group[name] = STATED[qtype]
                w = regrid(w)
            self.w[name] = w
        if draft:
            self.layers, self.head = mb.layers[: mb.draft_layers], "output_draft"

    def draft(self, n_layers: int | None = None) -> "Reference":
        """The draft model on the same weights: the lower ``draft_layers``
        layers (or the lower `n_layers`, for a fault) and the draft's head."""
        n = self.mb.draft_layers if n_layers is None else n_layers
        other = object.__new__(Reference)
        other.__dict__.update(self.__dict__, head="output_draft", layers=self.mb.layers[:n])
        return other

    def with_bits(self, act_bits: int) -> "Reference":
        """The same weights at another activation precision (the control)."""
        other = object.__new__(Reference)
        other.__dict__.update(self.__dict__, act_bits=act_bits)
        return other

    def _mm(self, x: torch.Tensor, name: str) -> torch.Tensor:
        if self.act_bits:
            x = fake_quant(x, self.act_bits, self.group.get(name, 128))
        return x @ self.w[name].T

    def _norm(self, x: torch.Tensor) -> torch.Tensor:
        eps = self.mb.norm_eps
        if self.mb.arch == "mpt":
            mu = x.mean(dim=-1, keepdim=True)
            var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
            return (x - mu) * torch.rsqrt(var + eps)
        return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)

    def _rope(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """x [T, H, D] rotated by position on adjacent pairs."""
        d = x.shape[-1]
        inv = self.mb.rope_base ** (-torch.arange(0, d, 2, device=x.device, dtype=torch.float64) / d)
        ang = pos.double()[:, None] * inv[None, :]
        cos, sin = ang.cos().float()[:, None, :], ang.sin().float()[:, None, :]
        x0, x1 = x[..., 0::2], x[..., 1::2]
        return torch.stack([x0 * cos - x1 * sin, x0 * sin + x1 * cos], dim=-1).reshape(x.shape)

    def _slopes(self) -> torch.Tensor:
        h = self.mb.n_heads
        return torch.tensor([2.0 ** (-self.mb.max_alibi_bias * (i + 1) / h) for i in range(h)],
                            dtype=torch.float32, device=self.device)

    def _attention(self, q, k, v, q_block: int = 512) -> torch.Tensor:
        """Causal attention of q [T, H, D] over k, v [T, KVH, D]."""
        t, h, d = q.shape
        kvh = k.shape[1]
        rep = h // kvh
        kx = k.repeat_interleave(rep, dim=1).transpose(0, 1)  # [H, T, D]
        vx = v.repeat_interleave(rep, dim=1).transpose(0, 1)
        pos = torch.arange(t, device=q.device)
        slopes = self._slopes() if self.mb.arch == "mpt" else None
        out = torch.empty(t, h, d, dtype=torch.float32, device=q.device)
        for s0 in range(0, t, q_block):
            s1 = min(t, s0 + q_block)
            qb = q[s0:s1].transpose(0, 1)  # [H, B, D]
            sc = (qb @ kx[:, :s1].transpose(1, 2)) / math.sqrt(d)  # [H, B, s1]
            if slopes is not None:
                sc = sc + slopes[:, None, None] * pos[:s1].float()[None, None, :]
            causal = pos[:s1][None, :] <= pos[s0:s1][:, None]
            sc = sc.masked_fill(~causal[None], float("-inf"))
            out[s0:s1] = (torch.softmax(sc, dim=-1) @ vx[:, :s1]).transpose(0, 1)
        return out

    def _layer(self, h: torch.Tensor, tmpl: str) -> torch.Tensor:
        mb = self.mb
        t, hd, kvh = h.shape[0], mb.head_dim, mb.n_kv_heads
        x = self._norm(h)
        if mb.arch == "mpt":
            qkv = self._mm(x, f"{tmpl}.attn_qkv")
            e = mb.n_embd
            q, k, v = qkv[:, :e], qkv[:, e:2 * e], qkv[:, 2 * e:]
        else:
            q, k, v = (self._mm(x, f"{tmpl}.attn_{s}") for s in "qkv")
        q = q.reshape(t, mb.n_heads, hd)
        k = k.reshape(t, kvh, hd)
        v = v.reshape(t, kvh, hd)
        if mb.arch != "mpt":
            pos = torch.arange(t, device=h.device)
            q, k = self._rope(q, pos), self._rope(k, pos)
        a = self._attention(q, k, v).reshape(t, mb.n_heads * hd)
        h = h + self._mm(a, f"{tmpl}.attn_output")
        x = self._norm(h)
        if mb.arch == "mpt":
            mid = torch.nn.functional.gelu(self._mm(x, f"{tmpl}.ffn_up"), approximate="none")
        else:
            g = self._mm(x, f"{tmpl}.ffn_gate")
            mid = g * torch.sigmoid(g) * self._mm(x, f"{tmpl}.ffn_up")
        return h + self._mm(mid, f"{tmpl}.ffn_down")

    def logits(self, tokens: list, rows: list | None = None) -> torch.Tensor:
        """Logits f32 [len(rows), n_vocab] of the sequence `tokens` at
        positions `rows` (default: every position)."""
        ids = torch.tensor(tokens, dtype=torch.long, device=self.device)
        h = self.w["tok_embd"][ids]
        for tmpl in self.layers:
            h = self._layer(h, tmpl)
        if rows is not None:
            h = h[torch.tensor(rows, dtype=torch.long, device=self.device)]
        return self._mm(self._norm(h), self.head)

    def hidden_trace(self, tokens: list) -> list[torch.Tensor]:
        """The residual after the embedding and after each layer (for the
        weight design's checks)."""
        ids = torch.tensor(tokens, dtype=torch.long, device=self.device)
        h = self.w["tok_embd"][ids]
        out = [h]
        for tmpl in self.layers:
            h = self._layer(h, tmpl)
            out.append(h)
        return out
