"""The port stands alone: no module of dynamo_tpu_torch, and not
chip_smoke.py, imports jax, jaxlib or the JAX package dynamo_tpu, nor the
packages the card's machine does not promise (tokenizers, jinja2, aiohttp,
msgpack, safetensors, xxhash); building a CPU TorchEngine (with
speculative decoding and mixed steps, so the copied n-gram proposer loads
too, and one of the tiny-moe model, so models/moe.py does) loads none of
them but loads the robustness and observability planes (the fault
registry, counters, artifacts, tracing, degrade ladder, KV ledger, flight
recorder, telemetry and profiler), and with all of them made unimportable
the whole `out=torch` HTTP pipeline builds on the CPU from the vendored
checkpoint, serves a streamed chat request with tracing armed, and answers
the four `/debug/*` routes. The test process itself has jax
loaded (tests/conftest.py), so those checks run in a fresh interpreter."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
from tests import torch_fixtures  # noqa: F401  (caps torch's intra-op threads)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "dynamo_tpu", "tokenizers", "jinja2", "aiohttp", "msgpack",
             "safetensors", "xxhash"}


def _port_files():
    pkg = os.path.join(ROOT, "dynamo_tpu_torch")
    for base, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(base, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def _imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_forbidden_imports():
    files = list(_port_files())
    assert len(files) > 15
    bad = [
        (os.path.relpath(p, ROOT), root)
        for p in files for root in _imported_roots(p) if root in FORBIDDEN
    ]
    assert bad == []


PLANES = [f"dynamo_tpu_torch.{m}" for m in (
    "utils.faults", "utils.counters", "utils.artifacts", "utils.tracing", "engine.degrade",
    "engine.kv_ledger", "engine.flight_recorder", "engine.telemetry", "engine.profiler")]


def test_engine_import_loads_no_jax():
    planes = PLANES
    code = f"""
import json, sys
sys.path.insert(0, {ROOT!r})
before = set(sys.modules)
import dynamo_tpu_torch
from dynamo_tpu_torch import EngineConfig, TorchEngine
eng = TorchEngine(EngineConfig(model="tiny", dtype="float32", num_pages=16, spec_decode=True,
                               mixed_batching=True), device="cpu")
moe = TorchEngine(EngineConfig(model="tiny-moe", dtype="float32", num_pages=16), device="cpu")
new = set(sys.modules) - before
print(json.dumps({{
    "dynamo_tpu": sorted(m for m in sys.modules if m.split(".")[0] == "dynamo_tpu"),
    "jax": sorted(m for m in new if m.split(".")[0] in ("jax", "jaxlib")),
    "port": "dynamo_tpu_torch.engine.engine" in new,
    "spec": "dynamo_tpu_torch.engine.spec" in new,
    "moe": "dynamo_tpu_torch.models.moe" in new and "we_gate" in moe.params["layers"][0],
    "planes": sorted(m for m in {planes!r} if m not in new),
}}))
"""
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
        cwd=ROOT,
    )
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"dynamo_tpu": [], "jax": [], "port": True, "spec": True, "moe": True,
                   "planes": []}


def test_http_pipeline_serves_with_the_packages_blocked():
    """A `sys.meta_path` finder makes the six packages (and jax) fail to
    import; the port's `out=torch` entry still serves one streamed chat."""
    ckpt = os.path.join(ROOT, "tests", "data", "tiny-trained-llama")
    code = f"""
import asyncio, json, sys
BLOCKED = {sorted(FORBIDDEN)!r}

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{{name}} is blocked")
        return None

sys.meta_path.insert(0, Block())
import os, tempfile
os.environ["DYN_TRACE"] = "1"
os.environ["DYN_PROFILE_DIR"] = tempfile.mkdtemp()
os.environ["DYN_CRASH_DIR"] = tempfile.mkdtemp()
for m in [m for m in sys.modules if m.split(".")[0] in BLOCKED]:
    del sys.modules[m]
sys.path.insert(0, {ROOT!r})
from dynamo_tpu_torch.llm.http import client
from dynamo_tpu_torch.run import build_parser, serve_http

async def main():
    args = build_parser().parse_args(["in=http", "out=torch", "--model-path", {ckpt!r},
                                      "--device", "cpu", "--num-pages", "32",
                                      "--http-host", "127.0.0.1", "--http-port", "0"])
    svc, eng = await serve_http(args, "torch")
    reply = await client.request("127.0.0.1", svc.port, "POST", "/v1/chat/completions", {{
        "model": "tiny-trained-llama", "stream": True, "max_tokens": 6,
        "messages": [{{"role": "user", "content": "the capital of france is"}}]}})
    msgs = [m async for _, m in reply.sse()]
    debug = {{}}
    for method, path in (("GET", "/debug/trace"), ("GET", "/debug/snapshot"),
                         ("GET", "/debug/kv"), ("POST", "/debug/profile?duration_ms=20")):
        r = await client.request("127.0.0.1", svc.port, method, path,
                                 {{}} if method == "POST" else None)
        debug[path] = (r.status, sorted(json.loads(await r.read())))
    from dynamo_tpu_torch.utils import tracing
    spans = sorted({{e["name"] for e in tracing.export()["traceEvents"]}}
                   & {{"http.request", "preprocess", "request", "prefill", "decode"}})
    await svc.stop()
    await eng.close()
    text = "".join(c["delta"].get("content", "") for m in msgs if m.data
                   for c in m.json()["choices"])
    print(json.dumps({{"status": reply.status, "done": msgs[-1].done, "text": text,
                      "debug": debug, "spans": spans,
                      "blocked_loaded": sorted(m for m in sys.modules
                                               if m.split(".")[0] in BLOCKED)}}))

asyncio.run(main())
"""
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
        cwd=ROOT,
    )
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["status"] == 200 and got["done"] and got["text"]
    assert got["blocked_loaded"] == []
    assert got["debug"] == {
        "/debug/trace": [200, ["displayTimeUnit", "traceEvents"]],
        "/debug/snapshot": [200, ["artifacts", "recorders"]],
        "/debug/kv": [200, ["kv", "ledgers"]],
        "/debug/profile?duration_ms=20": [200, ["dir", "duration_ms"]],
    }
    assert got["spans"] == ["decode", "http.request", "prefill", "preprocess", "request"]
