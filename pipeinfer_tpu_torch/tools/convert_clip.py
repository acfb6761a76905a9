"""`python -m pipeinfer_tpu_torch.tools.convert_clip` — HF CLIP vision
tower (+ LLaVA projector) → mmproj GGUF in the reference's clip.cpp layout
(ref: examples/llava/convert-image-encoder-to-gguf.py +
examples/llava/llava-surgery.py: the projector tensors are extracted from
the LLaVA checkpoint, the vision tower from CLIP). Note the reference's
ffn naming quirk: HF `mlp.fc1` is written as `ffn_down` and `fc2` as
`ffn_up` (clip.cpp:647-648 loads them back the same way) — we match it.

A copy of pipeinfer_tpu.tools.convert_clip (which imports no JAX): the same
file for the same tensors. `main` reads the HF checkpoint through
`transformers`, imported only there; `write_mmproj` needs neither it nor a
device."""

from __future__ import annotations

import argparse
import sys

import numpy as np


def write_mmproj(
    out_path,
    *,
    cfg,  # HF CLIPVisionConfig
    state: dict,  # HF vision_model state_dict (numpy arrays)
    mm0_w, mm0_b, mm2_w, mm2_b,  # projector (to the LM embd width)
    image_mean=(0.48145466, 0.4578275, 0.40821073),
    image_std=(0.26862954, 0.26130258, 0.27577711),
):
    from ..gguf.constants import GGUFValueType
    from ..gguf.writer import GGUFWriter

    w = GGUFWriter(out_path, arch="clip")
    w.add_kv("clip.has_text_encoder", False)
    w.add_kv("clip.has_vision_encoder", True)
    w.add_kv("clip.has_llava_projector", True)
    w.add_kv("clip.use_gelu", cfg.hidden_act in ("gelu", "gelu_pytorch_tanh"))
    w.add_kv("clip.vision.image_size", int(cfg.image_size))
    w.add_kv("clip.vision.patch_size", int(cfg.patch_size))
    w.add_kv("clip.vision.embedding_length", int(cfg.hidden_size))
    w.add_kv("clip.vision.feed_forward_length", int(cfg.intermediate_size))
    w.add_kv("clip.vision.block_count", int(cfg.num_hidden_layers))
    w.add_kv("clip.vision.attention.head_count", int(cfg.num_attention_heads))
    w.add_kv("clip.vision.attention.layer_norm_epsilon", float(cfg.layer_norm_eps),
             GGUFValueType.FLOAT32)
    w.add_kv("clip.vision.projection_dim", int(getattr(cfg, "projection_dim", 768)))
    w.add_kv("clip.vision.image_mean", [float(x) for x in image_mean])
    w.add_kv("clip.vision.image_std", [float(x) for x in image_std])

    def add(name, arr):
        w.add_tensor(name, np.asarray(arr, np.float32))

    add("v.patch_embd.weight", state["embeddings.patch_embedding.weight"])
    add("v.class_embd", state["embeddings.class_embedding"])
    add("v.position_embd.weight", state["embeddings.position_embedding.weight"])
    add("v.pre_ln.weight", state["pre_layrnorm.weight"])
    add("v.pre_ln.bias", state["pre_layrnorm.bias"])
    if "post_layernorm.weight" in state:
        add("v.post_ln.weight", state["post_layernorm.weight"])
        add("v.post_ln.bias", state["post_layernorm.bias"])
    for i in range(cfg.num_hidden_layers):
        src = f"encoder.layers.{i}."
        dst = f"v.blk.{i}."
        for hf, gg in [
            ("self_attn.q_proj", "attn_q"), ("self_attn.k_proj", "attn_k"),
            ("self_attn.v_proj", "attn_v"), ("self_attn.out_proj", "attn_out"),
            ("layer_norm1", "ln1"), ("layer_norm2", "ln2"),
            ("mlp.fc1", "ffn_down"), ("mlp.fc2", "ffn_up"),
        ]:
            add(dst + gg + ".weight", state[src + hf + ".weight"])
            add(dst + gg + ".bias", state[src + hf + ".bias"])
    add("mm.0.weight", mm0_w)
    add("mm.0.bias", mm0_b)
    add("mm.2.weight", mm2_w)
    add("mm.2.bias", mm2_b)
    w.write()


def main(argv=None):
    p = argparse.ArgumentParser("pipeinfer-convert-clip", description=__doc__)
    p.add_argument("model_dir", help="HF LLaVA or CLIP model directory")
    p.add_argument("-o", "--out", required=True, help="output mmproj GGUF")
    args = p.parse_args(argv)

    import torch
    from transformers import AutoConfig, AutoModel

    cfg = AutoConfig.from_pretrained(args.model_dir)
    model = AutoModel.from_pretrained(args.model_dir, torch_dtype=torch.float32)
    if hasattr(model, "vision_tower"):  # LlavaForConditionalGeneration
        vision = model.vision_tower.vision_model
        proj = model.multi_modal_projector
        mm0_w, mm0_b = proj.linear_1.weight, proj.linear_1.bias
        mm2_w, mm2_b = proj.linear_2.weight, proj.linear_2.bias
        vcfg = cfg.vision_config
    elif hasattr(model, "vision_model"):  # plain CLIP: identity projector
        vision = model.vision_model
        vcfg = getattr(cfg, "vision_config", cfg)
        h = vcfg.hidden_size
        mm0_w, mm0_b = torch.eye(h), torch.zeros(h)
        mm2_w, mm2_b = torch.eye(h), torch.zeros(h)
        print("warning: no LLaVA projector found; writing identity mm layers",
              file=sys.stderr)
    else:
        raise SystemExit(f"error: {args.model_dir} has no vision tower")

    state = {k: v.detach().numpy() for k, v in vision.state_dict().items()}
    write_mmproj(
        args.out, cfg=vcfg, state=state,
        mm0_w=mm0_w.detach().numpy(), mm0_b=mm0_b.detach().numpy(),
        mm2_w=mm2_w.detach().numpy(), mm2_b=mm2_b.detach().numpy(),
    )
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
