"""CLIP ViT vision encoder + LLaVA multimodal projector
(ref: examples/llava/clip.cpp).

Torch counterpart of pipeinfer_tpu.models.clip. Reads the reference's
mmproj GGUF layout — `clip.vision.*` hparams, `v.patch_embd/class_embd/
position_embd`, `v.blk.{i}.{attn_q,attn_k,attn_v,attn_out,ln1,ln2,ffn_down,
ffn_up}`, `v.pre_ln`, and the `mm.0`/`mm.2` projector — and runs the LLaVA
path in f32 on the params' device: patch unfold (channel-major, as the
ggml conv reads its [hidden, 3, ps, ps] weight) and one matmul, class token
+ learned positions, pre-LN, n_layer-1 pre-LN transformer blocks (the
reference skips the final block for LLaVA, clip.cpp:343), then the class
row dropped and the projection to the language model's embedding width
(mm.0 → GELU → mm.2, clip.cpp:420-442).

The JAX package runs the tower as plain XLA (no Pallas kernel); here it is
plain torch: matmul, softmax, layer_norm and gelu. Images are decoded and
resized by PIL exactly as the JAX package does it, so the pixels are the
same bytes. The block's matmul, its activation, the block count and the
class-row drop are module functions, so tools/live_check.py can run the
tower with one of them replaced (another f32 order, a fault).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve


@dataclasses.dataclass(frozen=True)
class ClipConfig:
    image_size: int
    patch_size: int
    hidden: int
    n_heads: int
    n_ff: int
    n_layers: int
    proj_dim: int
    eps: float
    use_gelu: bool  # exact gelu vs gelu_quick (clip.cpp use_gelu key)
    image_mean: tuple
    image_std: tuple

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


_LAYER_TENSORS = [
    ("q_w", "attn_q.weight"), ("q_b", "attn_q.bias"),
    ("k_w", "attn_k.weight"), ("k_b", "attn_k.bias"),
    ("v_w", "attn_v.weight"), ("v_b", "attn_v.bias"),
    ("o_w", "attn_out.weight"), ("o_b", "attn_out.bias"),
    ("ln1_w", "ln1.weight"), ("ln1_b", "ln1.bias"),
    ("ln2_w", "ln2.weight"), ("ln2_b", "ln2.bias"),
    ("ff_i_w", "ffn_down.weight"), ("ff_i_b", "ffn_down.bias"),
    ("ff_o_w", "ffn_up.weight"), ("ff_o_b", "ffn_up.bias"),
]


def load_mmproj(path: str | Path, device=None):
    """mmproj GGUF → (params dict of f32 tensors on `device`, ClipConfig).
    `device` defaults to ``cuda`` (raises without it unless ``"cpu"``)."""
    from ..gguf.reader import GGUFReader
    from .convert import clip_params_from_numpy

    device = resolve(device)
    with GGUFReader(path) as r:
        md = r.metadata
        if not md.get("clip.has_vision_encoder", True):
            raise ValueError(f"{path}: no vision encoder")

        def t(name):
            return np.asarray(r.tensor(name), np.float32)

        cfg = ClipConfig(
            image_size=int(md["clip.vision.image_size"]),
            patch_size=int(md["clip.vision.patch_size"]),
            hidden=int(md["clip.vision.embedding_length"]),
            n_heads=int(md["clip.vision.attention.head_count"]),
            n_ff=int(md["clip.vision.feed_forward_length"]),
            n_layers=int(md["clip.vision.block_count"]),
            proj_dim=int(md["clip.vision.projection_dim"]),
            eps=float(md["clip.vision.attention.layer_norm_epsilon"]),
            use_gelu=bool(md.get("clip.use_gelu", False)),
            image_mean=tuple(md.get("clip.vision.image_mean", (0.48145466, 0.4578275, 0.40821073))),
            image_std=tuple(md.get("clip.vision.image_std", (0.26862954, 0.26130258, 0.27577711))),
        )
        p = {
            "patch_embd": t("v.patch_embd.weight"),  # [hidden, 3, ps, ps]
            "class_embd": t("v.class_embd"),
            "pos_embd": t("v.position_embd.weight"),  # [n_patches+1, hidden]
            "pre_ln_w": t("v.pre_ln.weight"),
            "pre_ln_b": t("v.pre_ln.bias"),
            "mm0_w": t("mm.0.weight"),
            "mm0_b": t("mm.0.bias"),
            "mm2_w": t("mm.2.weight"),
            "mm2_b": t("mm.2.bias"),
            "layers": [{k: t(f"v.blk.{i}.{n}") for k, n in _LAYER_TENSORS}
                       for i in range(cfg.n_layers)],
        }
    return clip_params_from_numpy(p, device), cfg


def open_image(src):
    """A PIL image from a file path or the bytes of an encoded image (the
    CLI's --image, the server's base64-decoded image_data). Raises OSError
    for data PIL cannot decode."""
    import io

    from PIL import Image

    return Image.open(io.BytesIO(src) if isinstance(src, (bytes, bytearray)) else src)


def preprocess_image(img, cfg: ClipConfig) -> np.ndarray:
    """PIL image / HWC uint8 array → normalized f32 [S, S, 3]
    (ref: clip_image_preprocess clip.cpp:726-800 — pad to square with the
    LLaVA background color, bilinear resize, mean/std normalize)."""
    from PIL import Image

    if not isinstance(img, Image.Image):
        img = Image.fromarray(np.asarray(img, np.uint8))
    img = img.convert("RGB")
    nx, ny = img.size
    if nx != ny:
        side = max(nx, ny)
        canvas = Image.new("RGB", (side, side), (122, 116, 104))
        canvas.paste(img, (0, 0))
        img = canvas
    img = img.resize((cfg.image_size, cfg.image_size), Image.BILINEAR)
    x = np.asarray(img, np.float32) / 255.0
    mean = np.asarray(cfg.image_mean, np.float32)
    std = np.asarray(cfg.image_std, np.float32)
    return (x - mean) / std


# -- the tower's parts that tools/live_check.py replaces ----------------------


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [T, K] @ w[N, K]^T in f32."""
    return x @ w.T


def _act(x: torch.Tensor, cfg: ClipConfig) -> torch.Tensor:
    """The blocks' activation: tanh-approximate GELU (ggml_gelu) when the
    file sets use_gelu, else gelu_quick (== HF quick_gelu)."""
    if cfg.use_gelu:
        return F.gelu(x, approximate="tanh")
    return x * torch.sigmoid(1.702 * x)


def _n_blocks(cfg: ClipConfig) -> int:
    """Blocks LLaVA runs: all but the last (clip.cpp:343)."""
    return cfg.n_layers - 1


def _drop_class(x: torch.Tensor) -> torch.Tensor:
    """The patch rows: the class row dropped."""
    return x[1:]


def _ln(x, w, b, eps):
    return F.layer_norm(x, (x.shape[-1],), w, b, eps)


def encode_image(params, cfg: ClipConfig, pixels) -> torch.Tensor:
    """Normalized pixels [S, S, 3] (numpy or a tensor) → image embeddings
    [n_patches, n_embd] f32 on the params' device."""
    dev = params["mm2_w"].device
    ps, hid, nh = cfg.patch_size, cfg.hidden, cfg.n_heads
    dh = hid // nh
    g = cfg.image_size // ps
    x = torch.as_tensor(pixels, dtype=torch.float32).to(dev)
    # unfold into patches [g*g, 3*ps*ps] matching conv2d stride=ps:
    # channel-major like the ggml conv (weight [hid, 3, ps, ps])
    x = x.permute(2, 0, 1).reshape(3, g, ps, g, ps).permute(1, 3, 0, 2, 4).reshape(g * g, -1)
    x = _mm(x, params["patch_embd"].reshape(hid, 3 * ps * ps))
    x = torch.cat([params["class_embd"][None, :], x], dim=0) + params["pos_embd"]
    x = _ln(x, params["pre_ln_w"], params["pre_ln_b"], cfg.eps)
    t = x.shape[0]
    for lp in params["layers"][: _n_blocks(cfg)]:
        h = _ln(x, lp["ln1_w"], lp["ln1_b"], cfg.eps)
        q = (_mm(h, lp["q_w"]) + lp["q_b"]) * (dh ** -0.5)
        k = _mm(h, lp["k_w"]) + lp["k_b"]
        v = _mm(h, lp["v_w"]) + lp["v_b"]
        q, k, v = (a.reshape(t, nh, dh).transpose(0, 1) for a in (q, k, v))
        att = torch.softmax(q @ k.transpose(1, 2), dim=-1)
        h = (att @ v).transpose(0, 1).reshape(t, hid)
        x = x + (_mm(h, lp["o_w"]) + lp["o_b"])
        h = _ln(x, lp["ln2_w"], lp["ln2_b"], cfg.eps)
        h = _act(_mm(h, lp["ff_i_w"]) + lp["ff_i_b"], cfg)
        x = x + (_mm(h, lp["ff_o_w"]) + lp["ff_o_b"])
    # llava projector: drop the class row, mm.0 → GELU(exact) → mm.2
    x = _drop_class(x)
    x = F.gelu(_mm(x, params["mm0_w"]) + params["mm0_b"])
    return _mm(x, params["mm2_w"]) + params["mm2_b"]


def encode_flops(cfg: ClipConfig, n_embd: int) -> float:
    """Floating-point operations of one encode_image (the matmuls and the
    attention products; the norms and activations are a rounding error)."""
    t = cfg.n_patches + 1
    per_block = 2 * t * (4 * cfg.hidden ** 2 + 2 * cfg.hidden * cfg.n_ff) + 4 * t * t * cfg.hidden
    ps2 = 3 * cfg.patch_size ** 2
    return (2 * cfg.n_patches * ps2 * cfg.hidden + _n_blocks(cfg) * per_block
            + 2 * cfg.n_patches * (cfg.hidden * n_embd + n_embd * n_embd))
