"""Model registration + frontend discovery (the port of the JAX package's
`dynamo_tpu/llm/http/discovery.py`).

Equivalent of the reference's ModelEntry/model_watcher machinery (reference:
lib/llm/src/http/service/discovery.rs:53-229, bindings `register_llm`):

- **worker side**: `register_llm` publishes the model deployment card,
  serves the engine on `dyn://{ns}.{comp}.{ep}`, and writes a `ModelEntry`
  under the worker's lease at ``/models/entries/{service}/{worker_id:x}``;
- **frontend side**: `ModelWatcher` watches the entries prefix; on the first
  entry for a model it fetches the card and assembles the serving pipeline —
  preprocessor → backend(detokenizer) → router over the worker endpoint —
  and registers it with the `ModelManager`; when the last entry disappears
  the model is removed.
"""

from __future__ import annotations

import asyncio
import json
from dataclasses import dataclass
from typing import Optional

from dynamo_tpu_torch.llm.backend import Backend
from dynamo_tpu_torch.llm.http.service import ModelManager
from dynamo_tpu_torch.llm.model_card import (
    MODEL_TYPE_BACKEND,
    ModelDeploymentCard,
)
from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor
from dynamo_tpu_torch.runtime.component import EndpointId
from dynamo_tpu_torch.runtime.pipeline.engine import link
from dynamo_tpu_torch.utils.logging import get_logger

log = get_logger("dynamo_tpu_torch.discovery")

ENTRY_ROOT = "/models/entries/"


@dataclass
class ModelEntry:
    """reference: discovery.rs:53-66."""

    name: str  # public model name (what /v1/models shows)
    service_name: str
    endpoint: str  # dyn://ns.comp.ep
    model_type: str = MODEL_TYPE_BACKEND

    def to_json(self) -> bytes:
        return json.dumps(self.__dict__).encode()

    @classmethod
    def from_json(cls, raw: bytes) -> "ModelEntry":
        return cls(**json.loads(raw))


async def register_llm(
    drt,
    engine,
    card: ModelDeploymentCard,
    endpoint_path: str,
    model_name: Optional[str] = None,
    model_type: str = MODEL_TYPE_BACKEND,
    stats_handler=None,
    metadata: Optional[dict] = None,
) -> None:
    """Worker-side registration (reference: bindings register_llm,
    lib/bindings/python/rust/lib.rs:104)."""
    eid = EndpointId.parse(endpoint_path)
    ep = drt.namespace(eid.namespace).component(eid.component).endpoint(eid.name)
    builder = ep.endpoint_builder().engine(engine)
    if stats_handler is not None:
        builder = builder.stats_handler(stats_handler)
    if metadata:
        builder = builder.metadata(metadata)
    await builder.start()
    await card.publish(drt.hub, lease=drt.primary_lease)
    entry = ModelEntry(
        name=model_name or card.display_name,
        service_name=card.service_name,
        endpoint=str(eid),
        model_type=model_type,
    )
    key = f"{ENTRY_ROOT}{card.service_name}/{drt.worker_id:x}"
    await drt.hub.kv_put(key, entry.to_json(), lease=drt.primary_lease)
    log.info("registered model %s at %s", entry.name, entry.endpoint)


class RouterEngine:
    """Engine adapter over a discovery Client (reference: PushRouter used as
    a pipeline sink). Mode may be random/round_robin, or kv when a
    KvPushRouter is installed."""

    def __init__(self, client, mode: str = "round_robin", kv_router=None):
        self.client = client
        self.mode = mode
        self.kv_router = kv_router

    async def generate(self, request):
        if self.kv_router is not None:
            return await self.kv_router.generate(request.payload, context=request)
        return await self.client.generate(
            request.payload, context=request, mode=self.mode
        )


class ModelWatcher:
    """Frontend-side watcher building pipelines for discovered models
    (reference: discovery.rs:100-229 model_watcher)."""

    def __init__(
        self,
        drt,
        manager: ModelManager,
        router_mode: str = "round_robin",
    ):
        self._drt = drt
        self.manager = manager
        self.router_mode = router_mode
        self._task: Optional[asyncio.Task] = None
        self._watch = None
        # service_name -> {worker_key,...} live entries
        self._entries: dict[str, set[str]] = {}
        self._model_names: dict[str, str] = {}  # service_name -> public name
        self._clients: dict[str, object] = {}
        self._kv_routers: dict[str, object] = {}  # service -> KvPushRouter (mode kv)
        self.pipeline_factory = self._default_pipeline

    async def start(self) -> None:
        self._watch = await self._drt.hub.watch_prefix(ENTRY_ROOT)
        for item in self._watch.snapshot:
            await self._on_put(item["key"], item["value"])
        self._task = asyncio.create_task(self._loop())

    async def stop(self) -> None:
        if self._task:
            self._task.cancel()
            self._task = None
        if self._watch:
            await self._watch.cancel()
        for router in self._kv_routers.values():
            await router.router.close()
        for client in self._clients.values():
            await client.close()

    async def _loop(self) -> None:
        async for ev in self._watch:
            try:
                if ev["type"] == "put":
                    await self._on_put(ev["key"], ev["value"])
                else:
                    await self._on_delete(ev["key"])
            except Exception:  # noqa: BLE001
                log.exception("model watcher event failed")

    async def _on_put(self, key: str, value: bytes) -> None:
        entry = ModelEntry.from_json(value)
        service = entry.service_name
        known = self._entries.setdefault(service, set())
        self._model_names[service] = entry.name
        if service in self._clients:
            known.add(key)  # pipeline already built; this is another replica
            return
        card = await ModelDeploymentCard.fetch(self._drt.hub, service)
        if card is None:
            # Don't record the key: the next entry put for this service (a
            # replica, or a re-register) retries the build from scratch.
            log.warning("model %s has no published card yet; skipping", entry.name)
            return
        known.add(key)
        eid = EndpointId.parse(entry.endpoint)
        ep = (
            self._drt.namespace(eid.namespace)
            .component(eid.component)
            .endpoint(eid.name)
        )
        client = await ep.client()
        self._clients[service] = client
        if self.router_mode == "kv":
            import os

            from dynamo_tpu_torch.llm.kv_router import KvPushRouter

            # cross-worker prefix pulls + host-tier weighting
            # (docs/kv_cache.md): DYN_KV_PULL_TOKENS > 0 would let the
            # router move a saturated worker's cached prefix instead of
            # recomputing it (not ported: KvRouter raises, ROADMAP M17);
            # DYN_KV_HOST_WEIGHT discounts host-tier
            # blocks in the selector logit (device reuse is free, a
            # host hit still pays an H2D restore)
            router = await KvPushRouter.create(
                ep.component, client, block_size=card.kv_cache_block_size,
                pull_threshold_tokens=int(
                    os.environ.get("DYN_KV_PULL_TOKENS", "0")
                ),
                host_tier_weight=float(
                    os.environ.get("DYN_KV_HOST_WEIGHT", "0.5")
                ),
            )
            self._kv_routers[service] = router
        pipeline = self._build(entry, card, client)
        self.manager.add_chat_model(entry.name, pipeline)
        self.manager.add_completion_model(entry.name, pipeline)
        self.manager.cards[entry.name] = {"service_name": service}
        log.info("model %s ready (endpoint %s)", entry.name, entry.endpoint)

    def _build(self, entry: ModelEntry, card: ModelDeploymentCard, client):
        if entry.model_type == MODEL_TYPE_BACKEND:
            return self.pipeline_factory(entry, card, client)
        # chat/completion model types: worker does its own pre/post
        return self._router_engine(entry.service_name, client)

    def _router_engine(self, service: str, client):
        # The reference wraps this in llm/http/failover.py's
        # FailoverEngine (the journaled replay of a stream whose worker
        # died), which is not ported yet (ROADMAP M17, later): the port
        # serves the bare RouterEngine, what the reference serves under
        # DYN_FAILOVER=0 (ROADMAP Queue 3).
        return RouterEngine(
            client, self.router_mode, kv_router=self._kv_routers.get(service),
        )

    def _default_pipeline(self, entry, card, client):
        from dynamo_tpu_torch.llm.tokenizer import HuggingFaceTokenizer

        # parse tokenizer.json once; preprocessor and backend share it
        tokenizer = HuggingFaceTokenizer.from_file(card.tokenizer_dir())
        return link(
            OpenAIPreprocessor(card, tokenizer=tokenizer),
            Backend(tokenizer),
            self._router_engine(entry.service_name, client),
        )

    async def _on_delete(self, key: str) -> None:
        service = key[len(ENTRY_ROOT) :].rsplit("/", 1)[0]
        known = self._entries.get(service)
        if known is None:
            return
        known.discard(key)
        if known:
            return
        self._entries.pop(service, None)
        name = self._model_names.pop(service, service)
        self.manager.remove_model(name)
        kv_router = self._kv_routers.pop(service, None)
        if kv_router is not None:
            await kv_router.router.close()
        client = self._clients.pop(service, None)
        if client is not None:
            await client.close()
        log.info("model %s removed (no live workers)", name)
