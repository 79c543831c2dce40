"""The port's probe kernels K8-K10 (dynamo_tpu_torch/scripts/) against the
JAX package's probe scripts (scripts/), whose Pallas kernels run here in
interpret mode, on the same numpy inputs; on the CPU each port wrapper
runs its plain PyTorch version.

- K8, `proto_page_write.pallas_page_write` (its module constants set
  small) against `page_copy`: byte-equal pools.
- K9, the kernels of `probe_bitcast.probe_forward`/`probe_reverse`/
  `probe_roundtrip_inject`, caught as the probes build and call them,
  against `unpack_int8_rows`/`pack_int8_rows`/`inject_int8_row`: byte-equal,
  H2's rows landing where the TPU kernel lands them, the inject at each
  byte lane and the last row. The port's pack and unpack are also held
  against `ops.quant.pack_kv_slots`/`unpack_kv_slots`, and the inject
  against `scatter_packed_kv_rows`.
- K10, `profile_dma.make_bench` against `page_gather`: the [1, 1] output
  byte-equal when finite, NaN in both when a named page's row 0 holds a
  NaN or an infinity (NaN payloads are not compared).
"""

from __future__ import annotations

import importlib.util
import pathlib
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import dynamo_tpu
import dynamo_tpu_torch
from dynamo_tpu.ops import quant as jquant
from dynamo_tpu_torch.scripts import probe_bitcast, profile_dma, proto_page_write
from tests import torch_fixtures  # noqa: F401  (caps torch's intra-op threads)

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _load_jax_script(name):
    """scripts/<name>.py of this checkout, loaded by its path. The script
    puts a path of its own in front of sys.path when it is imported; that
    is undone here, so later imports of this process still resolve in this
    checkout."""
    spec = importlib.util.spec_from_file_location(
        f"jax_probe_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    saved = list(sys.path)
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = saved
    return mod


jax_bitcast = _load_jax_script("probe_bitcast")
jax_dma = _load_jax_script("profile_dma")
jax_page_write = _load_jax_script("proto_page_write")


def _bf16_exact(rng, shape):
    """float32 values that bf16 holds exactly (low 16 bits cleared)."""
    x = rng.randn(*shape).astype(np.float32)
    return (x.view(np.uint32) & np.uint32(0xFFFF0000)).view(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


def _bytes(a):
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            a = a.view(torch.int16)
        a = a.numpy()
    return np.ascontiguousarray(np.asarray(a)).tobytes()


@pytest.fixture(scope="module")
def jax_bitcast_calls():
    """Run the three JAX bitcast probes in interpret mode, catching each
    pallas_call's kernel, inputs and output."""
    real = jax_bitcast.pl.pallas_call
    calls = []

    def spy(*args, **kw):
        f = real(*args, **kw)

        def call(*xs):
            out = f(*xs)
            calls.append((f, [np.asarray(x) for x in xs], np.asarray(out)))
            return out

        return call

    shim = types.ModuleType("pallas_spy")
    shim.__dict__.update(vars(jax_bitcast.pl))
    shim.pallas_call = spy
    saved = jax_bitcast.pl
    jax_bitcast.pl = shim
    try:
        with pltpu.force_tpu_interpret_mode():
            jax_bitcast.probe_forward()
            jax_bitcast.probe_reverse()
            jax_bitcast.probe_roundtrip_inject()
        yield calls
    finally:
        jax_bitcast.pl = saved


def test_page_copy_matches_jax_page_write(monkeypatch):
    page, kw, num_pages = 8, 128, 12
    for name, val in (("PAGE", page), ("KW", kw), ("NUM_PAGES", num_pages),
                      ("NUM_SLOTS", num_pages * page)):
        monkeypatch.setattr(jax_page_write, name, val)
    rng = np.random.RandomState(0)
    kc = _bf16_exact(rng, (num_pages * page, kw))
    vc = _bf16_exact(rng, (num_pages * page, kw))
    tables = np.asarray([3, 1, 7, 11, 5], np.int32)  # distinct, page 0 never named
    nk = _bf16_exact(rng, (len(tables), page, kw))
    nv = _bf16_exact(rng, (len(tables), page, kw))
    bf = jnp.bfloat16
    with pltpu.force_tpu_interpret_mode():
        jk, jv = jax_page_write.pallas_page_write(
            jnp.asarray(kc, bf), jnp.asarray(vc, bf), jnp.asarray(tables),
            jnp.asarray(nk, bf), jnp.asarray(nv, bf))
    tk, tv = _t(kc).to(torch.bfloat16), _t(vc).to(torch.bfloat16)
    rk, rv = proto_page_write.page_copy(
        tk, tv, _t(tables), _t(nk).to(torch.bfloat16), _t(nv).to(torch.bfloat16))
    assert rk is tk and rv is tv  # in place
    assert _bytes(tk) == _bytes(jk) and _bytes(tv) == _bytes(jv)
    assert not np.array_equal(np.asarray(jk, np.float32), kc)  # the write happened
    # page 0 untouched; an id of 0 is skipped, as the trash page is never written
    t0 = tk.clone()
    proto_page_write.page_copy(tk, tv, _t(np.asarray([0], np.int32)),
                               torch.ones((1, page, kw), dtype=torch.bfloat16),
                               torch.ones((1, page, kw), dtype=torch.bfloat16))
    assert torch.equal(tk.view(torch.int16), t0.view(torch.int16))


def test_bitcast_forward_matches_jax_on_h1_and_h2(jax_bitcast_calls):
    fwd = jax_bitcast_calls[:2]  # probe_forward: H1, then H2
    t = fwd[0][1][0].shape[0]
    for (_, (packed,), want), layout in zip(fwd, ("H1", "H2")):
        got = probe_bitcast.unpack_int8_rows(_t(packed))
        assert got.dtype == torch.int8 and _bytes(got) == _bytes(want), layout
    # H2's rows land where the TPU lands them: out row 4i + j is in row jT + i
    x8 = np.random.RandomState(0).randint(-127, 128, size=(4 * t, 128)).astype(np.int8)
    got = probe_bitcast.unpack_int8_rows(_t(probe_bitcast.h2_pack(x8))).numpy()
    assert [int(np.where((x8 == got[r]).all(axis=1))[0][0]) for r in range(8)] == \
        [0, 8, 16, 24, 1, 9, 17, 25]


def test_bitcast_reverse_matches_jax(jax_bitcast_calls):
    _, (rows,), want = jax_bitcast_calls[2]
    got = probe_bitcast.pack_int8_rows(_t(rows))
    assert got.dtype == torch.int32 and _bytes(got) == _bytes(want)
    assert _bytes(probe_bitcast.unpack_int8_rows(got)) == _bytes(rows)


def test_bitcast_inject_matches_jax_at_every_lane(jax_bitcast_calls):
    f, (packed, new_row, off), want = jax_bitcast_calls[3]
    assert int(off[0]) == 13
    t4 = packed.shape[0]
    for o in (12, 13, 14, 15, 4 * t4 - 1):  # byte lanes 0-3, and the last row
        with pltpu.force_tpu_interpret_mode():
            jwant = np.asarray(f(jnp.asarray(packed), jnp.asarray(new_row),
                                 jnp.asarray([o], jnp.int32)))
        got = probe_bitcast.inject_int8_row(_t(packed.copy()), _t(new_row[0]), o)
        assert _bytes(got) == _bytes(jwant), o
        # only int8 row o changed
        rows = probe_bitcast.unpack_int8_rows(got).numpy()
        base = probe_bitcast.unpack_int8_rows(_t(packed)).numpy()
        base[o] = new_row[0]
        assert np.array_equal(rows, base), o


@pytest.mark.parametrize("rows,kw", [(32, 64), (16, 1024)])
def test_bitcast_matches_quant_pack_unpack(rows, kw):
    rng = np.random.RandomState(rows + kw)
    x8 = rng.randint(-128, 128, size=(rows, kw)).astype(np.int8)
    jpacked = np.asarray(jquant.pack_kv_slots(jnp.asarray(x8)))
    packed = probe_bitcast.pack_int8_rows(_t(x8))
    assert _bytes(packed) == _bytes(jpacked)
    assert _bytes(probe_bitcast.unpack_int8_rows(packed)) == \
        _bytes(np.asarray(jquant.unpack_kv_slots(jnp.asarray(jpacked))))
    row = rng.randint(-128, 128, size=(kw,)).astype(np.int8)
    for slot in (4, 5, 6, 7, rows - 1):
        want = jquant.scatter_packed_kv_rows(
            jnp.asarray(jpacked), jnp.asarray([slot], jnp.int32), jnp.asarray(row[None]))
        got = probe_bitcast.inject_int8_row(_t(jpacked.copy()), _t(row), slot)
        assert _bytes(got) == _bytes(want), slot


def test_page_gather_matches_jax_bench():
    total, page, kw, n, nbuf = 64, 16, 128, 32, 4
    with pltpu.force_tpu_interpret_mode():
        bench = jax_dma.make_bench(total, page, kw, n, nbuf, jnp.bfloat16)
    rng = np.random.RandomState(0)
    tables = rng.permutation(total)[:n].astype(np.int32)
    unnamed = int(np.setdiff1d(np.arange(total), tables)[0])
    base = _bf16_exact(rng, (total, page, kw))
    cases = {"finite": (None, None), "named row 0 NaN": (tables[5], 0),
             "named row 0 inf": (tables[9], 0), "named row 1 NaN": (tables[5], 1),
             "unnamed row 0 NaN": (unnamed, 0)}
    for label, (pg, row) in cases.items():
        pool = base.copy()
        if pg is not None:
            pool[pg, row, 3] = np.inf if "inf" in label else np.nan
        with pltpu.force_tpu_interpret_mode():
            want = np.asarray(bench(jnp.asarray(tables), jnp.asarray(pool, jnp.bfloat16)))
        got = profile_dma.page_gather(_t(pool).to(torch.bfloat16), _t(tables), nbuf).numpy()
        assert got.shape == want.shape == (1, 1) and got.dtype == np.float32, label
        poisoned = label.startswith("named row 0")
        assert bool(np.isnan(want[0, 0])) == bool(np.isnan(got[0, 0])) == poisoned, label
        if not poisoned:
            assert _bytes(got) == _bytes(want) and want[0, 0] == 0.0, label


def test_cpu_wrappers_take_the_plain_route():
    x8 = torch.zeros((8, 16), dtype=torch.int8)
    pool = torch.zeros((4, 2, 16), dtype=torch.bfloat16)
    calls = [
        (proto_page_write.page_copy, proto_page_write.page_copy_plain,
         lambda: proto_page_write.page_copy(
             pool.view(8, 16), pool.view(8, 16).clone(), torch.tensor([1], dtype=torch.int32),
             torch.ones((1, 2, 16), dtype=torch.bfloat16),
             torch.ones((1, 2, 16), dtype=torch.bfloat16))),
        (probe_bitcast.unpack_int8_rows, probe_bitcast.unpack_int8_rows_plain,
         lambda: probe_bitcast.unpack_int8_rows(torch.zeros((2, 16), dtype=torch.int32))),
        (probe_bitcast.pack_int8_rows, probe_bitcast.pack_int8_rows_plain,
         lambda: probe_bitcast.pack_int8_rows(x8)),
        (probe_bitcast.inject_int8_row, probe_bitcast.inject_int8_row_plain,
         lambda: probe_bitcast.inject_int8_row(
             torch.zeros((2, 16), dtype=torch.int32), x8[0], 5)),
        (profile_dma.page_gather, profile_dma.page_gather_plain,
         lambda: profile_dma.page_gather(pool, torch.tensor([1, 3], dtype=torch.int32))),
    ]
    for kernel, plain, call in calls:
        launches, plain_calls = kernel.launches, plain.calls
        call()
        assert kernel.launches == launches, kernel.__name__
        assert plain.calls == plain_calls + 1, kernel.__name__


@pytest.mark.parametrize("script", [proto_page_write, probe_bitcast, profile_dma])
def test_probe_main_needs_a_gpu(script, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert script.main() != 0
    assert "no CUDA device" in capsys.readouterr().err


def test_everything_loads_from_this_checkout():
    for mod in (jax_bitcast, jax_dma, jax_page_write, dynamo_tpu, dynamo_tpu_torch,
                probe_bitcast, profile_dma, proto_page_write, jquant):
        assert ROOT in pathlib.Path(mod.__file__).resolve().parents, mod.__name__
