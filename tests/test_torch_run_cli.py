"""`python -m dynamo_tpu_torch.run` against `python -m dynamo_tpu.run`: the
same flags with the same defaults (the port adds `--device`), `in=batch:F`
on the vendored checkpoint writing the same outputs (greedy, float32; the
JAX side on gather attention), and the refusals of what the port does not
serve: `dyn://` modes, parallelism above 1, the hub, router, disagg and
multi-node flags at any value but their default, the admission gate, and no
GPU with the default device (the engine's own error, never a fallback).
`--slo-targets` serves (tests/test_torch_http_service.py renders it), and so
does `--host-kv-pages`."""

from __future__ import annotations

import asyncio
import json
import os

import pytest
import torch

from dynamo_tpu.run import build_parser as jax_parser
from dynamo_tpu.run import run_batch as jax_run_batch
from dynamo_tpu_torch.run import build_parser, main, run_batch, serve_http
from tests import torch_fixtures  # noqa: F401  (caps torch's intra-op threads)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "tests", "data", "tiny-trained-llama")


def _defaults(parser) -> dict:
    return {a.dest: (a.default, tuple(a.option_strings)) for a in parser._actions
            if a.dest != "help"}


def test_flags_and_defaults_match_the_jax_run():
    ours, theirs = _defaults(build_parser()), _defaults(jax_parser())
    assert ours.pop("device") == ("cuda", ("--device",))
    assert ours == theirs


def test_batch_outputs_equal(tmp_path, capsys):
    prompts = ["the capital of france is", "berlin is the capital of", "the"]
    outs = {}
    for impl in ("jax", "torch"):
        path = tmp_path / f"{impl}.jsonl"
        path.write_text("".join(json.dumps({"text": p}) + "\n" for p in prompts))
        common = ["in=batch:" + str(path), "out=" + impl, "--model-path", CKPT,
                  "--dtype", "float32", "--num-pages", "64", "--max-tokens", "10"]
        if impl == "jax":
            args = jax_parser().parse_args(common + ["--attn-backend", "gather"])
            asyncio.run(jax_run_batch(args, "jax", str(path)))
        else:
            args = build_parser().parse_args(common + ["--device", "cpu"])
            asyncio.run(run_batch(args, "torch", str(path)))
        outs[impl] = [json.loads(line) for line in open(str(path) + ".out.jsonl")]
    assert outs["torch"] == outs["jax"]
    assert [o["input"] for o in outs["torch"]] == prompts
    assert all(o["output"] for o in outs["torch"])
    assert "batch done: n=3" in capsys.readouterr().out


@pytest.mark.parametrize("argv, named", [
    (["in=dyn://demo.backend.generate", "out=torch"], "M17"),
    (["in=http", "out=dyn://demo.backend.generate"], "M17"),
    (["in=http", "out=torch", "--tp", "2"], "M13"),
    (["in=http", "out=torch", "--pp", "2"], "M13"),
    (["in=http", "out=torch", "--num-nodes", "2"], "M13"),
    (["in=http", "out=torch", "--admission"], "M17"),
    (["in=http", "out=torch", "--attn-backend", "gather"], "attn-backend"),
    (["in=http", "out=torch", "--hub", "127.0.0.1:2379"], "M17"),
    (["in=http", "out=torch", "--router-mode", "kv"], "M17"),
    (["in=http", "out=torch", "--disagg-mode", "prefill"], "M11"),
    (["in=http", "out=torch", "--max-local-prefill-length", "64"], "M11"),
    (["in=http", "out=torch", "--node-rank", "1"], "M13"),
    (["in=http", "out=torch", "--coordinator", "127.0.0.1:9000"], "M13"),
])
def test_unported_modes_raise(argv, named):
    with pytest.raises(NotImplementedError, match=named):
        main(argv + ["--model-path", CKPT])


def test_slo_targets_load_as_the_jax_run_loads_them(tmp_path, monkeypatch):
    """`--slo-targets FILE`, else DYN_SLO_TARGETS, else no tracker, as in
    the JAX run; the flag passes the refusal check."""
    from dynamo_tpu.run import load_slo_targets as jax_load
    from dynamo_tpu_torch.run import build_slo_tracker, load_slo_targets, refuse_unported

    path = tmp_path / "slo.json"
    path.write_text(json.dumps({"default": {"ttft_s": 1.5}, "gold": {"itl_s": 0.05}}))
    monkeypatch.delenv("DYN_SLO_TARGETS", raising=False)
    common = ["in=http", "out=torch", "--model-path", CKPT]
    for extra in (["--slo-targets", str(path)], []):
        args = build_parser().parse_args(common + extra)
        assert load_slo_targets(args) == jax_load(jax_parser().parse_args(common + extra))
        refuse_unported(args, "torch", "http")
    args = build_parser().parse_args(common + ["--slo-targets", str(path)])
    assert build_slo_tracker(args).targets == json.loads(path.read_text())
    assert build_slo_tracker(build_parser().parse_args(common)) is None
    monkeypatch.setenv("DYN_SLO_TARGETS", '{"default": {"queue_wait_s": 2.0}}')
    args = build_parser().parse_args(common)
    assert load_slo_targets(args) == jax_load(jax_parser().parse_args(common))
    assert build_slo_tracker(args).targets == {"default": {"queue_wait_s": 2.0}}


def test_unported_engine_flags_raise():
    """`--host-kv-pages` is served now (the engine gets a host pool of that
    many pages); the disagg flags still raise, naming the runtime (M17)
    their plane waits for."""
    from dynamo_tpu_torch.run import build_engine_config_kwargs, refuse_unported

    args = build_parser().parse_args(["in=http", "out=torch", "--model-path", CKPT,
                                      "--device", "cpu", "--dtype", "float32",
                                      "--num-pages", "64", "--http-host", "127.0.0.1",
                                      "--http-port", "0", "--host-kv-pages", "8"])
    refuse_unported(args, "torch", "http")
    assert build_engine_config_kwargs(args)["host_kv_pages"] == 8

    async def go():
        svc, engine = await serve_http(args, "torch")
        await svc.stop()
        await engine.close()
        return engine

    assert asyncio.run(go()).host_pool.capacity == 8
    args = build_parser().parse_args(["in=http", "out=torch", "--model-path", CKPT,
                                      "--disagg-mode", "decode"])
    with pytest.raises(NotImplementedError, match="M17"):
        refuse_unported(args, "torch", "http")


def test_quantization_int8_serves_a_completion():
    """`--quantization int8` serves W8A8 weights: one /v1/completions
    request on the checkpoint, through the kernels' plain versions."""
    from dynamo_tpu_torch.llm.http import client
    from dynamo_tpu_torch.ops import quant, w8a8

    args = build_parser().parse_args(["in=http", "out=torch", "--model-path", CKPT,
                                      "--device", "cpu", "--dtype", "float32",
                                      "--num-pages", "64", "--http-host", "127.0.0.1",
                                      "--http-port", "0", "--quantization", "int8"])
    body = {"model": "tiny-trained-llama", "prompt": "the capital of france is",
            "max_tokens": 8, "temperature": 0}

    async def go():
        svc, engine = await serve_http(args, "torch")
        try:
            calls = w8a8.w8a8_gemm_plain.calls
            reply = await client.request("127.0.0.1", svc.port, "POST", "/v1/completions", body)
            out = reply.status, await reply.json()
            return out, engine, w8a8.w8a8_gemm_plain.calls - calls
        finally:
            await svc.stop()
            await engine.close()

    (status, resp), engine, gemms = asyncio.run(go())
    assert status == 200, resp
    assert quant.is_quantized(engine.params["layers"][0]["w_down"])
    assert gemms > 0
    assert resp["usage"]["completion_tokens"] == 8
    assert resp["choices"][0]["text"].strip().startswith("paris"), resp


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a GPU")
def test_default_device_without_gpu_is_an_error():
    args = build_parser().parse_args(["in=http", "out=torch", "--model-path", CKPT,
                                      "--http-port", "0"])
    with pytest.raises(RuntimeError, match="CUDA device"):
        asyncio.run(serve_http(args, "torch"))
