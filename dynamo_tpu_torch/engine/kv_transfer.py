"""The device-path KV transfer between two engines in one process.

Port of `dynamo_tpu/engine/kv_transfer.py` (the reference's NIXL RDMA
block reads, vLLM patch nixl.py): KV pages move from one engine's pools to
another's without touching the host. Both engines live in one process,
each with pools of its own (prefill and decode kept apart for their SLOs);
the second may be built on the first's parameter tree, so a pair costs
one set of weights. Two steps, both on the device:

  1. the source pages are gathered per layer (a torch gather, as
     `export_prefix` gathers; on another device of the process the rows
     then move device to device);
  2. they land in the destination pages through the page-scatter write
     (K1, or K7 in its int8 or int4 form: the hand-written kernel on a
     CUDA device), whole pages: rows past `n_tokens` in the last page are
     positions the destination has not computed yet, which the write's
     contract leaves free.

Page references stay the caller's on both ends. Engines in other
processes need the cross-process planes (the reference's
`engine/xproc_kv.py` and `llm/disagg`), which wait for the port's runtime.
"""

from __future__ import annotations

import torch

from dynamo_tpu_torch.llm.protocols.common import KvQuantMismatchError


def device_transfer_kv(src, dst, src_page_ids: list[int], dst_page_ids: list[int],
                       n_tokens: int) -> None:
    """Move the first `n_tokens` positions of KV held in `src`'s pages
    `src_page_ids` into `dst`'s pages `dst_page_ids`, device to device.
    Page sizes must match (the reference repacks first), and so must the
    KV tiers and the int4 scale grouping: a quantized pool's bytes move as
    they are, never requantized (mixed pairs take the host-staged wire,
    which converts on landing)."""
    if src.page_size != dst.page_size:
        raise ValueError(
            f"page-size mismatch {src.page_size} != {dst.page_size}: repack_pages first")
    src_q, dst_q = src.config.kv_quantization, dst.config.kv_quantization
    if src_q != dst_q:
        raise KvQuantMismatchError(
            f"device-path KV transfer needs matching kv_quantization on both engines "
            f"(src={src_q!r}, dst={dst_q!r}; mixed bf16/quantized pairs go through the "
            "host-staged plane, which converts on injection)")
    if src_q == "int4" and src._kv_int4_groups != dst._kv_int4_groups:
        raise KvQuantMismatchError(
            f"device-path KV transfer needs matching kv_quantization scale grouping "
            f"(src int4 groups={src._kv_int4_groups}, dst={dst._kv_int4_groups})")
    ps = src.page_size
    n = -(-n_tokens // ps)
    if len(src_page_ids) < n or len(dst_page_ids) < n:
        raise ValueError(f"{n_tokens} tokens need {n} pages on each side, got "
                         f"{len(src_page_ids)} and {len(dst_page_ids)}")
    skv, dkv = src.kv, dst.kv
    if len(skv.k) != len(dkv.k) or skv.k[0].shape[1] != dkv.k[0].shape[1] \
            or skv.k[0].dtype != dkv.k[0].dtype:
        raise ValueError("device-path KV transfer needs the same layers, row width and KV "
                         "dtype on both engines")
    with torch.inference_mode():
        idx = torch.tensor(src_page_ids[:n], dtype=torch.int64, device=skv.k[0].device)

        def pages(pools):
            return [x.view(-1, ps, x.shape[1]).index_select(0, idx).to(dst.device)
                    for x in pools]

        def tiles(pools):
            return [x.index_select(0, idx).to(dst.device) for x in pools]

        k, v = pages(skv.k), pages(skv.v)
        ks = vs = None
        if skv.quantized:
            ks, vs = tiles(skv.ks), tiles(skv.vs)
    dst._write_pages(list(dst_page_ids[:n]), k, v, ks, vs)
