"""The port's roofline ledger (`dynamo_tpu_torch/scripts/roofline.py`)
against the JAX package's (`scripts/roofline.py`, loaded by its path):
`build_ledger` and `kv_write_bytes_per_token` equal on the same digest
rows, taken from one CPU TorchEngine's flight recorder (prefill, decode,
mixed and verify dispatches: mixed steps and speculative decoding on), at
f32 and bf16 item sizes and for bf16, int8 and int4 KV (one scale group a
head and groups of 8); the H100 peaks chosen by the card's name; on a CUDA
engine's counters the wall read from the dispatches' device spans; and the
`--artifact` CLI on the engine's own flight-recorder dump.
"""

from __future__ import annotations

import asyncio
import importlib.util
import json
import os

import pytest

from dynamo_tpu.models.config import get_config as jax_config
from dynamo_tpu_torch.engine.flight_recorder import FIELDS, KINDS
from dynamo_tpu_torch.models.config import get_config
from dynamo_tpu_torch.scripts import roofline
from tests import torch_fixtures  # noqa: F401  (caps torch's intra-op threads)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PEAKS = dict(peak_flops=989e12, peak_hbm=3.35e12, peak_ici=90e9)


def _reference():
    spec = importlib.util.spec_from_file_location(
        "reference_roofline", os.path.join(ROOT, "scripts", "roofline.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """One CPU engine's digests, phase stats and flight-recorder artifact
    after greedy streams beside a mixed-step admission and n-gram drafts."""
    from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
    from dynamo_tpu_torch.llm.protocols.common import (
        PreprocessedRequest, SamplingOptions, StopConditions)
    from dynamo_tpu_torch.runtime.pipeline.context import Context

    async def serve():
        eng = TorchEngine(EngineConfig(
            model="tiny", dtype="float32", page_size=16, num_pages=64, max_batch_size=4,
            max_model_len=256, prefill_chunk=32, decode_steps=4, mixed_batching=True,
            mixed_step_tokens=48, spec_decode=True), device="cpu")

        decoding = asyncio.Event()

        async def one(prompt, n, after=None):
            if after is not None:
                await after.wait()
            pre = PreprocessedRequest(
                token_ids=prompt, stop_conditions=StopConditions(max_tokens=n, ignore_eos=True),
                sampling_options=SamplingOptions(greedy=True))
            got = 0
            async for f in await eng.generate(Context(pre.to_dict())):
                got += len(f.get("token_ids") or [])
                if got >= 8:
                    decoding.set()

        # a repeating prompt drafts; the long one arrives once the others
        # decode, and prefills beside them in mixed steps
        await asyncio.gather(one([5, 6, 7, 8] * 6, 60), one([9, 3, 1] * 5, 60),
                             one(list(range(1, 90)), 8, after=decoding))
        rows, stats = eng.flight.snapshot_rows(), eng.phase_stats
        path = eng.flight.trigger("manual", force=True,
                                  directory=str(tmp_path_factory.mktemp("artifact")))
        await eng.close()
        return rows, stats, path

    return asyncio.run(serve())


LEDGER_CASES = {
    "f32": (4, None, None),
    "bf16": (2, None, None),
    "int8": (2, "int8", None),
    "int4": (2, "int4", None),
    "int4-g8": (2, "int4", 8),
}


@pytest.mark.parametrize("case", sorted(LEDGER_CASES))
def test_ledger_equal_to_reference(served, case):
    rows, stats, _ = served
    itemsize, kvq, group = LEDGER_CASES[case]
    ref = _reference()
    kinds = {roofline.DISPATCH_KINDS[i] for i in range(4)}
    seen = {KINDS[int(r[FIELDS.index("kind")])] for r in rows}
    assert kinds <= seen
    assert all(stats[f"{k}_device_n"] == 0 for k in kinds)  # CPU: host walls
    stats = dict(stats, prefill_collective_bytes=4096, collective_wall_s=0.25)
    for model in ("tiny", "llama-3.1-8b"):
        got = roofline.build_ledger(rows, list(FIELDS), list(KINDS), stats, get_config(model),
                                    itemsize=itemsize, kv_quant=kvq, kv_quant_group=group,
                                    **PEAKS)
        want = ref.build_ledger(rows, list(FIELDS), list(KINDS), stats, jax_config(model),
                                itemsize=itemsize, kv_quant=kvq, kv_quant_group=group, **PEAKS)
        assert got == want
        assert set(got["kinds"]) == kinds
        assert roofline.kv_write_bytes_per_token(get_config(model), itemsize, kvq, group) == \
            ref.kv_write_bytes_per_token(jax_config(model), itemsize, kvq, group)
        assert roofline.matmul_params(get_config(model)) == ref.matmul_params(jax_config(model))
    with pytest.raises(ValueError):
        roofline.kv_write_bytes_per_token(get_config("tiny"), kv_quant="fp8")


def test_peaks_by_card_name_and_device_walls(served):
    assert roofline.card_peaks("NVIDIA H100 80GB HBM3") == ("SXM", (3.35e12, 989e12))
    assert roofline.card_peaks("NVIDIA H100 PCIe") == ("PCIe", (2.0e12, 756e12))
    assert roofline.card_peaks("NVIDIA H100 NVL") == ("NVL", (3.9e12, 835e12))
    # a CUDA engine's counters: the wall is the mean device span a dispatch
    # over the digests' steps, whatever the host's enqueue walls read
    rows, stats, _ = served
    steps = sum(1 for r in rows if KINDS[int(r[FIELDS.index("kind")])] == "decode")
    cuda = dict(stats, decode_device_s=3.0, decode_device_n=2 * steps)
    led = roofline.build_ledger(rows, list(FIELDS), list(KINDS), cuda, get_config("tiny"))
    dec = led["kinds"]["decode"]
    assert dec["wall_s"] == pytest.approx(1.5)
    assert dec["pct_peak_flops"] == pytest.approx(
        100 * dec["model_flops"] / 1.5 / roofline.PEAK_FLOPS, abs=1e-4)
    assert dec["pct_peak_ici"] == 0.0 and led["peaks"]["ici"] == 0.0
    assert "device spans" in led["note"] and "M13" in led["note"]
    host = roofline.build_ledger(rows, list(FIELDS), list(KINDS), stats, get_config("tiny"))
    assert host["kinds"]["prefill"] == led["kinds"]["prefill"]
    assert host["kinds"]["decode"]["wall_s"] != dec["wall_s"]


def test_artifact_cli(served, capsys):
    rows, stats, path = served
    assert path and os.path.exists(path)
    assert roofline.main(["--artifact", path, "--model", "tiny", "--itemsize", "4",
                          "--json"]) == 0
    got = json.loads(capsys.readouterr().out)
    art = json.load(open(path))
    want = roofline.build_ledger(art["digests"], art["digest_fields"], art["digest_kinds"],
                                 art["context"]["phase_stats"], get_config("tiny"), itemsize=4)
    assert got == json.loads(json.dumps(want))
    assert got["kinds"]["prefill"]["tokens"] > 0
