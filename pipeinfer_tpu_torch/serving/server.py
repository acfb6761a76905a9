"""`python -m pipeinfer_tpu_torch.serving.server` — HTTP inference server
(ref: examples/server/server.cpp): /completion (+ streaming SSE),
OpenAI-style /v1/completions, /health and /props, on top of the
continuous-batching scheduler. Stdlib http.server; an engine thread runs
the scheduler loop while handler threads enqueue requests.

Port of pipeinfer_tpu.serving.server; the models (and, with --mmproj, the
CLIP tower and projector) run on --device (cuda unless asked otherwise).
"""

from __future__ import annotations

import argparse
import json
import queue
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..cli.args import add_model_args
from ..cli.main import build_context
from ..sampling.samplers import SamplingParams
from .batching import BatchScheduler, Request


class EngineState:
    def __init__(self, scheduler: BatchScheduler, tok, clip=None):
        self.scheduler = scheduler
        self.tok = tok
        self.clip = clip  # (params, ClipConfig) when serving multimodal
        self.stop = threading.Event()
        self.thread = threading.Thread(target=scheduler.serve_forever, args=(self.stop,), daemon=True)

    def start(self):
        self.thread.start()

    def shutdown(self):
        self.stop.set()
        self.thread.join(timeout=5)


def _sampling_from_body(body: dict) -> SamplingParams:
    """Per-request sampler parameters, full parity with the reference
    server's request schema (ref: examples/server/server.cpp:721-760)."""
    logit_bias: dict[int, float] = {}
    lb = body.get("logit_bias") or []
    pairs = lb.items() if isinstance(lb, dict) else lb
    for tid, bias in pairs:
        # JSON `false` means "never sample this token" (server.cpp:756)
        logit_bias[int(tid)] = float("-inf") if bias is False else float(bias)
    return SamplingParams(
        temp=float(body.get("temperature", 0.8)),
        top_k=int(body.get("top_k", 40)),
        top_p=float(body.get("top_p", 0.95)),
        min_p=float(body.get("min_p", 0.05)),
        tfs_z=float(body.get("tfs_z", 1.0)),
        typical_p=float(body.get("typical_p", 1.0)),
        penalty_last_n=int(body.get("repeat_last_n", 64)),
        penalty_repeat=float(body.get("repeat_penalty", 1.1)),
        penalty_present=float(body.get("presence_penalty", 0.0)),
        penalty_freq=float(body.get("frequency_penalty", 0.0)),
        mirostat=int(body.get("mirostat", 0)),
        mirostat_tau=float(body.get("mirostat_tau", 5.0)),
        mirostat_eta=float(body.get("mirostat_eta", 0.1)),
        penalize_nl=bool(body.get("penalize_nl", True)),
        logit_bias=logit_bias,
        seed=int(body.get("seed", -1)),
    )


def _request_from_body(body: dict, tok, ids, segments) -> Request:
    """Build the serving Request: sampler params + grammar + n_probs +
    ignore_eos (server.cpp:721-760 request schema)."""
    grammar = None
    if body.get("grammar"):
        from ..sampling.grammar import grammar_state_from_gbnf

        grammar = grammar_state_from_gbnf(str(body["grammar"]), tok)
    return Request(
        prompt_ids=ids,
        n_predict=int(body.get("n_predict", body.get("max_tokens", 64))),
        sampling=_sampling_from_body(body),
        grammar=grammar,
        n_probs=int(body.get("n_probs", 0)),
        ignore_eos=bool(body.get("ignore_eos", False)),
        segments=segments,
    )


def _stop_list(body: dict) -> list[str]:
    stops = body.get("stop") or []
    if isinstance(stops, str):
        stops = [stops]
    return [s for s in stops if s]


def _truncate_at_stop(text: str, stops: list[str]) -> tuple[str, str | None]:
    """Cut `text` at the EARLIEST stop-sequence occurrence (the reference's
    find_stopping_strings FULL_STOP behavior, server.cpp:1043-1086)."""
    best = None
    word = None
    for s in stops:
        i = text.find(s)
        if i >= 0 and (best is None or i < best):
            best, word = i, s
    if best is None:
        return text, None
    return text[:best], word


def make_handler(engine: EngineState):
    tok = engine.tok

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _json(self, code: int, obj):
            data = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            if self.path == "/health":
                self._json(200, {"status": "ok"})
            elif self.path == "/props":
                cfg = engine.scheduler.ctx.cfg
                self._json(
                    200,
                    {
                        "arch": cfg.arch,
                        "n_vocab": cfg.n_vocab,
                        "n_embd": cfg.n_embd,
                        "n_layers": cfg.n_layers,
                        "n_cells": engine.scheduler.ctx.n_cells,
                        "slots": engine.scheduler.max_slots,
                    },
                )
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            length = int(self.headers.get("Content-Length", 0))
            try:
                body = json.loads(self.rfile.read(length) or b"{}")
            except json.JSONDecodeError:
                self._json(400, {"error": "invalid JSON"})
                return
            if self.path in ("/completion", "/v1/completions"):
                self._completion(body, openai=self.path.startswith("/v1"))
            else:
                self._json(404, {"error": "not found"})

        def _segments_from_images(self, prompt: str, image_data: list):
            """Split the prompt on [img-ID] placeholders and CLIP-encode
            each image (ref: server.cpp slot_image handling + the
            image_data request field)."""
            import base64
            import re

            from ..models import clip as clip_mod

            cparams, ccfg = engine.clip
            embeds = {}
            for item in image_data:
                img = clip_mod.open_image(base64.b64decode(item["data"]))
                pixels = clip_mod.preprocess_image(img, ccfg)
                embeds[int(item.get("id", 0))] = clip_mod.encode_image(cparams, ccfg, pixels)
            segments = []
            pos = 0
            first = True
            for m in re.finditer(r"\[img-(\d+)\]", prompt):
                txt = prompt[pos: m.start()]
                if txt or first:
                    segments.append(("tok", tok.encode(txt, add_bos=first)))
                    first = False
                img_id = int(m.group(1))
                if img_id not in embeds:
                    raise ValueError(f"no image_data with id {img_id}")
                segments.append(("img", embeds[img_id]))
                pos = m.end()
            tail = prompt[pos:]
            segments.append(("tok", tok.encode(tail, add_bos=first)))
            return segments

        def _completion(self, body: dict, openai: bool):
            prompt = body.get("prompt", "")
            if not isinstance(prompt, str):
                self._json(400, {"error": "prompt must be a string"})
                return
            stream = bool(body.get("stream", False))
            segments = None
            if body.get("image_data"):
                if engine.clip is None:
                    self._json(400, {"error": "server started without --mmproj"})
                    return
                try:
                    segments = self._segments_from_images(prompt, body["image_data"])
                except (ValueError, KeyError, OSError) as e:
                    self._json(400, {"error": f"bad image_data: {e}"})
                    return
            ids = tok.encode(prompt, add_bos=True)
            try:
                req = _request_from_body(body, tok, ids, segments)
            except Exception as e:  # bad GBNF etc.
                self._json(400, {"error": f"bad request: {e}"})
                return
            stops = _stop_list(body)

            def probs_payload():
                # per-token top-n candidates (ref server's
                # completion_probabilities, server.cpp:1106-1123)
                return [
                    {
                        "content": tok.decode([t]),
                        "probs": [
                            {"tok_str": tok.decode([pid]), "prob": p}
                            for pid, p in row
                        ],
                    }
                    for t, row in zip(req.generated, req.probs)
                ]

            if stream:
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.end_headers()
                q: queue.Queue = queue.Queue()
                req.stream = q.put
                engine.scheduler.submit(req)
                from ..tokenizer.stream import StreamDecoder

                sdec = StreamDecoder(tok)
                sent = 0
                # hold back a tail that could still begin a stop sequence
                hold = max((len(s) for s in stops), default=1) - 1
                acc = ""
                stopped_word = None

                def emit(piece: str):
                    payload = json.dumps({"content": piece, "stop": False})
                    self.wfile.write(f"data: {payload}\n\n".encode())
                    self.wfile.flush()

                while True:
                    try:
                        t = q.get(timeout=0.1)
                    except queue.Empty:
                        if req.done:
                            break
                        continue
                    piece = sdec.feed(t)  # buffers partial UTF-8 sequences
                    sent += 1
                    if not piece:
                        continue
                    acc += piece
                    cut, stopped_word = _truncate_at_stop(acc, stops)
                    if stopped_word is not None:
                        if cut:
                            emit(cut)
                        acc = ""
                        engine.scheduler.cancel(req)
                        break
                    if hold:
                        safe, acc = acc[: len(acc) - hold], acc[len(acc) - hold:]
                    else:
                        safe, acc = acc, ""
                    if safe:
                        emit(safe)
                if stopped_word is None:
                    acc += sdec.flush()
                    cut, stopped_word = _truncate_at_stop(acc, stops)
                else:
                    cut = ""
                final = {"content": cut, "stop": True, "tokens_predicted": sent,
                         "stopped_word": stopped_word is not None,
                         "stopping_word": stopped_word or ""}
                if req.n_probs:
                    final["completion_probabilities"] = probs_payload()
                if req.error:
                    final["error"] = req.error
                self.wfile.write(f"data: {json.dumps(final)}\n\n".encode())
                return

            if stops:
                # best-effort early cancel: watch committed tokens and stop
                # the engine as soon as a stop sequence lands (the final
                # text is truncated either way)
                from ..tokenizer.stream import StreamDecoder

                wdec = StreamDecoder(tok)
                seen = {"text": ""}

                def watch(t, _r=req):
                    seen["text"] += wdec.feed(t)
                    if any(s in seen["text"] for s in stops):
                        engine.scheduler.cancel(_r)

                req.stream = watch
            engine.scheduler.submit(req)
            req.done_event.wait()
            if req.error:
                self._json(503, {"error": req.error})
                return
            text = tok.decode(req.generated)
            text, stopped_word = _truncate_at_stop(text, stops)
            if openai:
                self._json(
                    200,
                    {
                        "object": "text_completion",
                        "choices": [{"text": text, "index": 0, "finish_reason": "stop"}],
                        "usage": {
                            "prompt_tokens": len(ids),
                            "completion_tokens": len(req.generated),
                        },
                    },
                )
            else:
                out = {
                    "content": text,
                    "tokens_predicted": len(req.generated),
                    "tokens_evaluated": len(ids),
                    "stopped_word": stopped_word is not None,
                    "stopping_word": stopped_word or "",
                }
                if req.n_probs:
                    out["completion_probabilities"] = probs_payload()
                self._json(200, out)

    return Handler


def serve(
    model_path: str,
    host: str,
    port: int,
    *,
    n_cells=2048,
    max_slots=8,
    draft_path: str | None = None,
    spec_params=None,
    mmproj_path: str | None = None,
    device_lanes: int = 4,
    device="cuda",
):
    """Load the model (and the draft) on `device`, start the engine
    thread, and return (httpd, engine); the caller runs
    httpd.serve_forever() and, at the end, httpd.shutdown() and
    engine.shutdown()."""
    ctx, tok = build_context(model_path, n_cells, device=device)
    clip = None
    if mmproj_path:
        from ..models import clip as clip_mod

        clip = clip_mod.load_mmproj(mmproj_path, device=device)
        if clip[0]["mm2_w"].shape[0] != ctx.cfg.n_embd:
            raise SystemExit(
                f"error: projector width {clip[0]['mm2_w'].shape[0]} != model "
                f"embedding {ctx.cfg.n_embd} — wrong --mmproj for this model?"
            )
        if draft_path:
            raise SystemExit("error: --mmproj and --draft cannot be combined yet")
    if draft_path:
        from .batching import SpecBatchScheduler

        ctx_dft, _ = build_context(draft_path, n_cells, need_tokenizer=False, device=device)
        sched = SpecBatchScheduler(
            ctx, ctx_dft, spec_params=spec_params, max_slots=max_slots,
            eos_id=tok.vocab.eos_id, device_lanes=device_lanes,
        )
    else:
        sched = BatchScheduler(ctx, max_slots=max_slots, eos_id=tok.vocab.eos_id)
    engine = EngineState(sched, tok, clip=clip)
    engine.start()
    httpd = ThreadingHTTPServer((host, port), make_handler(engine))
    return httpd, engine


def main(argv=None):
    p = argparse.ArgumentParser("pipeinfer-server", description=__doc__.split("\n\n")[0])
    add_model_args(p)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--slots", type=int, default=8)
    p.add_argument("--mmproj", default=None, metavar="GGUF",
                   help="CLIP+projector GGUF: accept image_data in requests "
                   "(LLaVA serving, [img-N] prompt placeholders)")
    p.add_argument("--draft", default=None, metavar="GGUF",
                   help="draft model: serve with asynchronous speculation "
                   "(each slot becomes a PipeInfer stream)")
    p.add_argument("--n-draft", type=int, default=8, help="draft tree depth (with --draft)")
    p.add_argument("--max-inflight", type=int, default=3,
                   help="speculative runs in flight per slot (with --draft)")
    p.add_argument("--device-lanes", type=int, default=4,
                   help="sequence slots served by the batched device loop "
                   "(greedy/pure-chain requests; 0 disables, with --draft)")
    args = p.parse_args(argv)
    spec = None
    if args.draft:
        from ..spec.params import SpecParams

        spec = SpecParams(n_draft=args.n_draft, n_parallel=1, p_accept=0.0,
                          max_inflight=args.max_inflight)
    httpd, engine = serve(args.model, args.host, args.port, n_cells=args.ctx_size,
                          max_slots=args.slots, draft_path=args.draft, spec_params=spec,
                          mmproj_path=args.mmproj, device_lanes=args.device_lanes,
                          device=args.device)
    print(f"listening on http://{args.host}:{args.port}", file=sys.stderr)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        engine.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
