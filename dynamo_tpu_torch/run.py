"""`python -m dynamo_tpu_torch.run` — the port's serving CLI.

The port of `python -m dynamo_tpu.run` (reference: launch/dynamo-run/src/
{main,lib,opt,flags}.rs): wire an input to an output.

    in=http       OpenAI HTTP server
    in=text       interactive chat REPL
    in=stdin      one prompt from stdin, completion to stdout
    in=batch:F    JSONL prompts file -> outputs + TTFT stats

    out=torch     TorchEngine on the GPU (requires --model-path; --device
                  cpu runs the plain PyTorch versions of the kernels)
    out=echo_core / out=echo_full   CPU fake backends

It has the JAX run's flags, names and defaults, plus `--device` (default
cuda: with no GPU the engine's own error, never a fallback). With
out=torch, `/metrics` also renders the engine's gauges and request
histograms (`EngineMetrics`), and per-tenant SLO attainment (`SloTracker`)
when `--slo-targets FILE` (or the DYN_SLO_TARGETS inline JSON) names
targets, whose breaches dump the engine's flight-recorder artifact;
`--admission` (or DYN_ADMISSION=1) arms the front-door admission gate
(llm/http/admission.py) on the engine's waiting depth and the tracker's
worst attainment, with tenant priority classes from the same targets file;
the process-global health counters (utils/counters.py) ride the same scrape,
and `/debug/trace`, `/debug/snapshot`, `/debug/kv` and `/debug/profile`
serve the trace ring, the flight recorder, the KV ledger and the profiler.
Not ported, and refused with the ROADMAP item that brings them:
`in=dyn://...` and `out=dyn://...` (M17; with them the admission gate's
fleet signals), `--tp/--pp/--sp` above 1 and `--num-nodes` above 1 (M13),
and any value but the default of `--hub`, `--router-mode` (M17), `--disagg-mode`,
`--max-local-prefill-length` (the disagg plane, which waits for the
runtime of M17), `--node-rank` and `--coordinator` (M13). The engine
flags go to the port's `EngineConfig`: `--host-kv-pages` serves the host
offload tier, `--quantization int8` W8A8 weights.

Examples:
    python -m dynamo_tpu_torch.run in=http out=torch --model-path /models/llama
    curl -N localhost:8080/v1/chat/completions -d '{"model": "llama",
        "messages": [{"role": "user", "content": "hi"}], "stream": true}'
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import sys
import time
from typing import Optional

from dynamo_tpu_torch.utils.logging import configure_logging, get_logger

log = get_logger("dynamo_tpu_torch.run")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dynamo_tpu_torch.run", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("io", nargs="+", help="in=... out=... (any order)")
    p.add_argument("--model-path", help="local HF-style model dir")
    p.add_argument("--model-name", help="public model name (default: dir name)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the engine (default cuda; cpu runs the "
                        "kernels' plain PyTorch versions)")
    p.add_argument("--hub", help="hub address host:port (distributed modes, not ported)")
    p.add_argument("--http-host", default="0.0.0.0")
    p.add_argument("--http-port", type=int, default=8080)
    p.add_argument("--router-mode", default="round_robin",
                   choices=["random", "round_robin", "kv"])
    p.add_argument("--tensor-parallel-size", "--tp", type=int, default=1, dest="tp")
    p.add_argument("--pipeline-parallel-size", "--pp", type=int, default=1, dest="pp")
    p.add_argument("--sequence-parallel-size", "--sp", type=int, default=1, dest="sp")
    p.add_argument("--max-batch-size", type=int, default=8)
    p.add_argument("--max-model-len", type=int, default=2048)
    p.add_argument("--page-size", type=int, default=16)
    p.add_argument("--num-pages", type=int, default=None)
    p.add_argument("--prefill-chunk", type=int, default=512)
    p.add_argument("--decode-steps", type=int, default=8)
    p.add_argument("--attn-backend", default="auto",
                   choices=["auto", "pallas", "gather"],
                   help="auto only: the port has one attention path, its CUDA kernels")
    p.add_argument("--quantization", default=None, choices=["int8"],
                   help="W8A8 int8 weights (int8 codes, per-channel scales; the "
                        "checkpoint is quantized as it loads)")
    p.add_argument("--kv-quantization", default=None, choices=["int8", "int4"],
                   help="int8 or int4 KV cache pages")
    p.add_argument("--host-kv-pages", type=int, default=0,
                   help="HBM->host KV offload pool size (0 disables)")
    p.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--extra-engine-args", help="JSON file of EngineConfig overrides")
    p.add_argument("--request-template",
                   help="JSON file of request defaults (model/temperature/"
                        "max_completion_tokens)")
    p.add_argument("--request-timeout", type=float, default=None,
                   help="default end-to-end deadline per request, seconds "
                        "(per-request x-request-timeout header overrides)")
    p.add_argument("--slo-targets",
                   help="JSON file of per-tenant SLO targets ({tenant: {ttft_s|itl_s|"
                        "queue_wait_s: seconds}}) rendered as attainment on /metrics")
    p.add_argument("--admission", action="store_true",
                   help="arm the front-door admission gate (DYN_ADMISSION=1 too): shed "
                        "the lowest tenant priority classes (the 'priority' of "
                        "--slo-targets) with 429/503 + Retry-After under overload")
    p.add_argument("--disagg-mode", choices=["agg", "decode", "prefill"],
                   default="agg", help="worker role in a disaggregated graph (refused: the "
                        "disagg plane waits for the runtime, ROADMAP M17)")
    p.add_argument("--max-local-prefill-length", type=int, default=128)
    p.add_argument("--max-tokens", type=int, default=256,
                   help="default generation budget for text/stdin/batch inputs")
    p.add_argument("--num-nodes", type=int, default=1)
    p.add_argument("--node-rank", type=int, default=0)
    p.add_argument("--coordinator", help="host:port of node 0 (multi-node, not ported)")
    return p


def parse_io(tokens: list[str]) -> tuple[str, str]:
    inp, out = "http", "echo_full"
    for t in tokens:
        if t.startswith("in="):
            inp = t[3:]
        elif t.startswith("out="):
            out = t[4:]
        else:
            raise SystemExit(f"unrecognized positional {t!r} (want in=/out=)")
    return inp, out


def refuse_unported(args, out: str, inp: str = "") -> None:
    """Raise NotImplementedError, naming its ROADMAP item, for what the
    port does not serve yet. `main` checks before it dispatches, and
    `build_output` again, for callers that start a mode directly."""
    if inp.startswith("dyn://") or out.startswith("dyn://"):
        raise NotImplementedError(
            f"{'in' if inp.startswith('dyn://') else 'out'}=dyn://...: the distributed "
            "runtime is not ported to dynamo_tpu_torch yet (ROADMAP M17)")
    for flag, n in (("--tp", args.tp), ("--pp", args.pp), ("--sp", args.sp),
                    ("--num-nodes", args.num_nodes)):
        if n > 1:
            raise NotImplementedError(
                f"{flag} {n}: parallelism is not ported to dynamo_tpu_torch yet "
                "(ROADMAP M13)")
    if args.hub or args.router_mode != "round_robin":
        raise NotImplementedError(
            "--hub/--router-mode: the hub and the KV router serve the dyn:// modes, "
            "which are not ported to dynamo_tpu_torch yet (ROADMAP M17)")
    if args.disagg_mode != "agg" or args.max_local_prefill_length != 128:
        raise NotImplementedError(
            "--disagg-mode/--max-local-prefill-length: M11's disaggregated serving "
            "plane (the prefill queue, the DisaggRouter, the remote-prefill endpoint) "
            "runs on the distributed runtime, which is not ported to dynamo_tpu_torch "
            "yet (ROADMAP M17); TorchEngine.prefill_only and generate_remote are its "
            "engine side")
    if args.node_rank != 0 or args.coordinator:
        raise NotImplementedError(
            "--node-rank/--coordinator: multi-node serving is not ported to "
            "dynamo_tpu_torch yet (ROADMAP M13)")
    if args.attn_backend != "auto":
        raise NotImplementedError(
            f"--attn-backend {args.attn_backend}: the port has one attention path, its "
            "CUDA kernels (and their plain versions on the CPU); use auto")


def load_slo_targets(args):
    """Per-tenant SLO targets: the --slo-targets file, else the
    DYN_SLO_TARGETS inline JSON, else None (no tracker)."""
    if getattr(args, "slo_targets", None):
        with open(args.slo_targets) as f:
            return json.load(f)
    inline = os.environ.get("DYN_SLO_TARGETS")
    if inline:
        return json.loads(inline)
    return None


def build_slo_tracker(args):
    from dynamo_tpu_torch.llm.http.metrics import SloTracker

    targets = load_slo_targets(args)
    return SloTracker(targets) if targets else None


def build_admission(args):
    """The front-door admission gate, armed by --admission or DYN_ADMISSION=1,
    with tenant priority classes from the --slo-targets file ("priority":
    int per tenant); None when unarmed. Its signals are bound once the
    engine exists (`serve_http`)."""
    if not (getattr(args, "admission", False)
            or os.environ.get("DYN_ADMISSION", "") not in ("", "0")):
        return None
    from dynamo_tpu_torch.llm.http.admission import (
        AdmissionConfig,
        AdmissionController,
        priorities_from_targets,
    )

    cfg = AdmissionConfig()
    if os.environ.get("DYN_ADMISSION_QUEUE_HIGH"):
        cfg.queue_high_watermark = float(os.environ["DYN_ADMISSION_QUEUE_HIGH"])
    if os.environ.get("DYN_ADMISSION_ATTAIN_FLOOR"):
        cfg.attainment_floor = float(os.environ["DYN_ADMISSION_ATTAIN_FLOOR"])
    return AdmissionController(
        priorities=priorities_from_targets(load_slo_targets(args)), cfg=cfg
    )


def build_engine_config_kwargs(args) -> dict:
    kw = dict(
        dtype=args.dtype,
        page_size=args.page_size,
        num_pages=args.num_pages,
        max_batch_size=args.max_batch_size,
        max_model_len=args.max_model_len,
        prefill_chunk=args.prefill_chunk,
        decode_steps=args.decode_steps,
        quantization=args.quantization,
        kv_quantization=args.kv_quantization,
        host_kv_pages=args.host_kv_pages,
    )
    if args.extra_engine_args:
        with open(args.extra_engine_args) as f:
            kw.update(json.load(f))
    return kw


async def build_output(args, out: str):
    """Returns (pipeline_engine, card|None, torch_engine|None): something
    with .generate(Context) serving OpenAI-shaped requests."""
    from dynamo_tpu_torch.llm.engines import EchoEngineCore, EchoEngineFull

    refuse_unported(args, out)
    if out == "echo_full":
        return EchoEngineFull(), None, None
    if out not in ("echo_core", "torch"):
        raise SystemExit(f"unknown out={out!r}")
    from dynamo_tpu_torch.llm.backend import Backend
    from dynamo_tpu_torch.llm.local_model import LocalModel
    from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor
    from dynamo_tpu_torch.runtime.pipeline.engine import link

    if not args.model_path:
        raise SystemExit(f"out={out} needs --model-path"
                         + (" (tokenizer)" if out == "echo_core" else ""))
    lm = LocalModel.prepare(args.model_path, name=args.model_name)
    if out == "echo_core":
        engine, terminal = None, EchoEngineCore()
    else:
        # "cuda" goes to the engine as its default, which checks for a GPU
        device = None if args.device == "cuda" else args.device
        engine = terminal = lm.build_engine(device=device, **build_engine_config_kwargs(args))
    pipeline = link(OpenAIPreprocessor(lm.card), Backend.from_card(lm.card), terminal)
    return pipeline, lm.card, engine


# ---------------------------------------------------------------- in= modes


async def serve_http(args, out: str):
    """Build the output, start the OpenAI HTTP service on it and return
    (service, torch_engine|None) once it listens (`service.port`); the
    caller owns the wait and `await service.stop()`/`engine.close()`."""
    from dynamo_tpu_torch.llm.http.service import HttpService
    from dynamo_tpu_torch.utils import tracing
    from dynamo_tpu_torch.utils.counters import PromCounters

    # the frontend's label in a merged trace (DYN_TRACE_PROCESS and earlier
    # callers win)
    tracing.set_process_default("frontend")
    template = None
    if args.request_template:
        from dynamo_tpu_torch.llm.request_template import RequestTemplate

        template = RequestTemplate.load(args.request_template)
    admission = build_admission(args)
    svc = HttpService(request_template=template, request_timeout_s=args.request_timeout,
                      admission=admission)
    # the process-global health counters (injected faults, profiler
    # captures) ride the same scrape as the service and engine series
    svc.metrics.extra.append(PromCounters())
    pipeline, card, engine = await build_output(args, out)
    name = args.model_name or (card.display_name if card else "echo")
    svc.manager.add_chat_model(name, pipeline)
    svc.manager.add_completion_model(name, pipeline)
    if engine is not None:
        # one scrape covers the service and the engine: its metrics()
        # gauges and the TTFT/ITL/queue-wait/tokens histograms, labelled
        # with the instance id, feeding the SLO tracker when targets are set
        from dynamo_tpu_torch.llm.http.metrics import EngineMetrics
        from dynamo_tpu_torch.utils import instance

        slo = build_slo_tracker(args)
        if slo is not None and engine.flight is not None:
            # an SLO breach dumps the flight recorder's correlated artifact
            # (digest window and the breaching request's trace slice) as it
            # lands, rate-limited by the recorder
            slo.on_breach = engine.flight.on_slo_breach
        svc.metrics.extra.append(EngineMetrics(
            engine, slo=slo, worker_id=instance.worker_id()))
        if admission is not None:
            # local signals: the engine's waiting depth and the tracker's
            # worst rolling fraction
            def local_attainment():
                snap = slo.snapshot() if slo is not None else {}
                return min(snap.values()) if snap else None

            admission.bind(
                queue_depth_fn=lambda: float(engine.metrics().get("num_requests_waiting", 0)),
                attainment_fn=local_attainment,
            )
    await svc.start(args.http_host, args.http_port)
    log.info("serving OpenAI HTTP on %s:%d", args.http_host, svc.port)
    return svc, engine


async def run_http(args, out: str) -> None:
    svc, engine = await serve_http(args, out)
    try:
        await asyncio.Event().wait()
    finally:
        await svc.stop()
        if engine is not None:
            await engine.close()


async def _chat_once(pipeline, model: str, messages: list, max_tokens: int):
    from dynamo_tpu_torch.llm.protocols.openai import ChatCompletionRequest
    from dynamo_tpu_torch.runtime.pipeline.context import Context

    req = ChatCompletionRequest.from_body(
        {"model": model, "messages": messages, "max_tokens": max_tokens}
    )
    t0 = time.perf_counter()
    ttft = None
    text = ""
    async for chunk in await pipeline.generate(Context(req)):
        if chunk.get("__annotation__"):
            continue
        for choice in chunk.get("choices") or []:
            piece = (choice.get("delta") or {}).get("content")
            if piece:
                if ttft is None:
                    ttft = time.perf_counter() - t0
                text += piece
                print(piece, end="", flush=True)
    print()
    return text, ttft, time.perf_counter() - t0


async def _close(engine) -> None:
    if engine is not None:
        await engine.close()


async def run_text(args, out: str) -> None:
    pipeline, card, engine = await build_output(args, out)
    model = args.model_name or (card.display_name if card else "echo")
    messages: list = []
    print(f"chat with {model} — empty line or ^D to quit")
    try:
        while True:
            try:
                line = await asyncio.to_thread(input, "> ")
            except EOFError:
                return
            if not line.strip():
                return
            messages.append({"role": "user", "content": line})
            text, _, _ = await _chat_once(pipeline, model, messages, args.max_tokens)
            messages.append({"role": "assistant", "content": text})
    finally:
        await _close(engine)


async def run_stdin(args, out: str) -> None:
    pipeline, card, engine = await build_output(args, out)
    model = args.model_name or (card.display_name if card else "echo")
    prompt = sys.stdin.read().strip()
    try:
        await _chat_once(pipeline, model, [{"role": "user", "content": prompt}],
                         args.max_tokens)
    finally:
        await _close(engine)


async def run_batch(args, out: str, path: str) -> None:
    """JSONL file of {"text": ...} prompts; writes outputs + latency stats
    (reference: launch/dynamo-run/src/input/batch.rs:44-280)."""
    pipeline, card, engine = await build_output(args, out)
    model = args.model_name or (card.display_name if card else "echo")
    ttfts, totals = [], []
    out_path = path + ".out.jsonl"
    try:
        with open(path) as f, open(out_path, "w") as of:
            for line in f:
                if not line.strip():
                    continue
                item = json.loads(line)
                text, ttft, total = await _chat_once(
                    pipeline, model,
                    [{"role": "user", "content": item["text"]}], args.max_tokens,
                )
                ttfts.append(ttft or 0.0)
                totals.append(total)
                of.write(json.dumps({"input": item["text"], "output": text}) + "\n")
    finally:
        await _close(engine)
    if ttfts:
        import statistics

        print(
            f"batch done: n={len(ttfts)} "
            f"ttft_p50={statistics.median(ttfts) * 1000:.1f}ms "
            f"total_p50={statistics.median(totals) * 1000:.1f}ms "
            f"-> {out_path}"
        )


def main(argv: Optional[list[str]] = None) -> None:
    configure_logging()
    args = build_parser().parse_args(argv)
    inp, out = parse_io(args.io)
    refuse_unported(args, out, inp)

    if inp == "http":
        coro = run_http(args, out)
    elif inp == "text":
        coro = run_text(args, out)
    elif inp == "stdin":
        coro = run_stdin(args, out)
    elif inp.startswith("batch:"):
        coro = run_batch(args, out, inp[len("batch:"):])
    else:
        raise SystemExit(f"unknown in={inp!r}")
    try:
        asyncio.run(coro)
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
