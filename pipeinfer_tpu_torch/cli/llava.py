"""`python -m pipeinfer_tpu_torch.cli.llava` — multimodal (image + text)
generation (ref: examples/llava/llava-cli.cpp): the CLIP tower encodes the
image to patch embeddings, the LLaVA projector maps them into the language
model's embedding space, and they enter the decode pipeline as an
embedding batch between the prompt segments (llava.cpp:70-90). Prompt
layout mirrors llava-cli: `<system>\\nUSER:<image>\\n<prompt>\\nASSISTANT:`.

Port of pipeinfer_tpu.cli.llava: the tower, the projector and the language
model run on --device (cuda unless asked otherwise).
"""

from __future__ import annotations

import argparse
import sys

from ..models import clip as clip_mod
from ..runtime.context import Batch
from ..sampling.samplers import SamplerState
from .args import add_gen_args, add_model_args, add_sampling_args, read_prompt, sampling_from_args
from .main import build_context

DEFAULT_SYSTEM = (
    "A chat between a curious human and an artificial intelligence assistant. "
    "The assistant gives helpful, detailed, and polite answers to the human's "
    "questions."
)


def eval_tokens(ctx, ids, pos0, want_last_logits=False):
    b = Batch()
    for i, t in enumerate(ids):
        b.add(t, pos0 + i, 0, want_logits=(want_last_logits and i == len(ids) - 1))
    logits = ctx.decode(b)
    return logits[-1] if want_last_logits else None


def prefill_image(ctx, tok, img_embd, system: str, prompt: str):
    """llava-cli's prompt on sequence 0 from position 0: BOS +
    `<system>\nUSER:` as tokens, the image's embeddings through
    decode_embd, then `\n<prompt>\nASSISTANT:`. Returns (the last row's
    logits, positions filled, the prompt's token ids)."""
    pre_ids = tok.encode(f"{system}\nUSER:", add_bos=True)
    post_ids = tok.encode(f"\n{prompt}\nASSISTANT:", add_bos=False)

    n_past = 0
    eval_tokens(ctx, pre_ids, n_past)
    n_past += len(pre_ids)
    ctx.decode_embd(img_embd, n_past)  # image enters as embeddings
    n_past += img_embd.shape[0]
    logits = eval_tokens(ctx, post_ids, n_past, want_last_logits=True)
    n_past += len(post_ids)
    return logits, n_past, pre_ids + post_ids


def main(argv=None):
    p = argparse.ArgumentParser("pipeinfer-llava", description=__doc__.split("\n\n")[0])
    add_model_args(p)
    add_gen_args(p)
    add_sampling_args(p)
    p.add_argument("--mmproj", required=True, help="CLIP+projector GGUF")
    p.add_argument("--image", required=True, help="image file")
    p.add_argument("--system", default=DEFAULT_SYSTEM)
    args = p.parse_args(argv)

    ctx, tok = build_context(args.model, args.ctx_size, args.cache_dtype, device=args.device)
    cparams, ccfg = clip_mod.load_mmproj(args.mmproj, device=args.device)

    pixels = clip_mod.preprocess_image(clip_mod.open_image(args.image), ccfg)
    img_embd = clip_mod.encode_image(cparams, ccfg, pixels)
    if img_embd.shape[1] != ctx.cfg.n_embd:
        raise SystemExit(
            f"error: projector width {img_embd.shape[1]} != model embedding "
            f"{ctx.cfg.n_embd} — wrong --mmproj for this model?"
        )
    print(f"encoded {img_embd.shape[0]} image tokens", file=sys.stderr)

    prompt = read_prompt(args) or "describe the image in detail."
    logits, n_past, prompt_ids = prefill_image(ctx, tok, img_embd, args.system, prompt)

    sampler = SamplerState(params=sampling_from_args(args))
    for t in prompt_ids:
        sampler.accept(t, apply_grammar=False)
    from ..sampling.samplers import sample
    from ..tokenizer.stream import StreamDecoder

    sdec = StreamDecoder(tok)
    b = Batch()
    for _ in range(args.n_predict):
        t = sample(sampler, logits)
        sampler.accept(t)
        if not args.ignore_eos and t == tok.vocab.eos_id:
            break
        sys.stdout.write(sdec.feed(t))
        sys.stdout.flush()
        b.clear()
        b.add(t, n_past, 0)
        logits = ctx.decode(b)[0]
        n_past += 1
    sys.stdout.write("\n")
    ctx.print_timings(lambda s: print(s, file=sys.stderr))
    return 0


if __name__ == "__main__":
    sys.exit(main())
