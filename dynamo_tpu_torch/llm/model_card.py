"""Model deployment cards: everything a frontend needs to serve a model.

Equivalent of the reference's ModelDeploymentCard (reference:
lib/llm/src/model_card/model.rs:100-506): display name, service slug, model
info (architecture, context length), tokenizer artifacts, prompt-template
source, KV block size, and a checksum (`mdcsum`) that lets workers verify a
frontend preprocessed with the same card.

Publishing (reference: model.rs:233-331 move_to_nats/move_from_nats): the
card JSON goes into hub KV under ``/models/cards/{service_name}``; tokenizer
artifacts go into the hub object store bucket ``mdc``; fetchers materialize
them into a local cache dir.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import tempfile
from dataclasses import dataclass, field
from typing import Optional

MODEL_TYPE_CHAT = "chat"
MODEL_TYPE_COMPLETION = "completion"
MODEL_TYPE_BACKEND = "backend"  # token-level worker endpoint

CARD_KV_ROOT = "/models/cards/"
CARD_BUCKET = "mdc"

_SLUG_RE = re.compile(r"[^a-zA-Z0-9_-]+")

# Artifacts shipped to frontends. config.json is included so frontends can
# introspect context length without the weights.
_ARTIFACT_FILES = ("tokenizer.json", "tokenizer_config.json", "config.json")


def slugify(name: str) -> str:
    return _SLUG_RE.sub("-", name).strip("-").lower()


@dataclass
class ModelDeploymentCard:
    display_name: str
    service_name: str
    model_path: Optional[str] = None  # local dir with weights (worker side)
    model_type: str = MODEL_TYPE_BACKEND
    context_length: int = 8192
    kv_cache_block_size: int = 16
    architecture: Optional[str] = None
    artifacts: dict[str, str] = field(default_factory=dict)  # name -> local path
    chat_template: Optional[str] = None  # inline override
    checksum: str = ""

    @classmethod
    def from_local_path(cls, path: str, name: Optional[str] = None) -> "ModelDeploymentCard":
        """Build a card from a HF-style model dir (reference: model.rs:479
        from_local_path)."""
        display = name or os.path.basename(os.path.normpath(path))
        card = cls(display_name=display, service_name=slugify(display), model_path=path)
        cfg_path = os.path.join(path, "config.json")
        if os.path.exists(cfg_path):
            with open(cfg_path) as f:
                cfg = json.load(f)
            card.architecture = (cfg.get("architectures") or [None])[0]
            card.context_length = int(
                cfg.get("max_position_embeddings") or card.context_length
            )
        for fname in _ARTIFACT_FILES:
            fpath = os.path.join(path, fname)
            if os.path.exists(fpath):
                card.artifacts[fname] = fpath
        if "tokenizer.json" not in card.artifacts:
            raise FileNotFoundError(f"{path} has no tokenizer.json")
        card.checksum = card._compute_checksum()
        return card

    def _compute_checksum(self) -> str:
        """mdcsum: hash of the artifacts that affect preprocessing
        (reference: mdcsum concept, preprocessor validation)."""
        h = hashlib.sha256()
        for fname in sorted(self.artifacts):
            with open(self.artifacts[fname], "rb") as f:
                h.update(fname.encode())
                h.update(f.read())
        if self.chat_template:
            h.update(self.chat_template.encode())
        return h.hexdigest()[:16]

    def to_json(self) -> str:
        return json.dumps(
            {
                "display_name": self.display_name,
                "service_name": self.service_name,
                "model_type": self.model_type,
                "context_length": self.context_length,
                "kv_cache_block_size": self.kv_cache_block_size,
                "architecture": self.architecture,
                "artifact_names": sorted(self.artifacts),
                "chat_template": self.chat_template,
                "checksum": self.checksum,
            }
        )

    @classmethod
    def from_json(cls, raw: str | bytes) -> "ModelDeploymentCard":
        d = json.loads(raw)
        card = cls(
            display_name=d["display_name"],
            service_name=d["service_name"],
            model_type=d.get("model_type", MODEL_TYPE_BACKEND),
            context_length=d.get("context_length", 8192),
            kv_cache_block_size=d.get("kv_cache_block_size", 16),
            architecture=d.get("architecture"),
            chat_template=d.get("chat_template"),
            checksum=d.get("checksum", ""),
        )
        card._artifact_names = d.get("artifact_names", [])
        return card

    # ------------------------------------------------------------- transfer

    def kv_key(self) -> str:
        return f"{CARD_KV_ROOT}{self.service_name}"

    async def publish(self, hub, lease=None) -> None:
        """Upload artifacts to the hub object store + card JSON to KV."""
        for fname, fpath in self.artifacts.items():
            with open(fpath, "rb") as f:
                await hub.obj_put(CARD_BUCKET, f"{self.service_name}/{fname}", f.read())
        await hub.kv_put(self.kv_key(), self.to_json().encode(), lease=lease)

    @classmethod
    async def fetch(
        cls, hub, service_name: str, cache_dir: Optional[str] = None
    ) -> Optional["ModelDeploymentCard"]:
        """Materialize a published card + artifacts locally (under the
        system temp dir unless `cache_dir` names one)."""
        entry = await hub.kv_get(f"{CARD_KV_ROOT}{service_name}")
        if entry is None:
            return None
        card = cls.from_json(entry["value"])
        cache_dir = cache_dir or os.path.join(
            tempfile.gettempdir(), "dynamo_tpu_torch_mdc", service_name
        )
        os.makedirs(cache_dir, exist_ok=True)
        for fname in getattr(card, "_artifact_names", []):
            data = await hub.obj_get(CARD_BUCKET, f"{service_name}/{fname}")
            if data is None:
                continue
            fpath = os.path.join(cache_dir, fname)
            # atomic: a crash mid-write must not leave a torn artifact for
            # the next process to trip over
            tmp = f"{fpath}.tmp.{os.getpid()}"
            with open(tmp, "wb") as f:
                f.write(data)
            os.replace(tmp, fpath)
            card.artifacts[fname] = fpath
        card.model_path = cache_dir
        return card

    # ------------------------------------------------------------ accessors

    def tokenizer_dir(self) -> str:
        tok = self.artifacts.get("tokenizer.json")
        if tok is None:
            raise FileNotFoundError(f"card {self.display_name} has no tokenizer")
        return os.path.dirname(tok)

    def load_config(self) -> dict:
        cfg = self.artifacts.get("config.json")
        if cfg is None:
            return {}
        with open(cfg) as f:
            return json.load(f)
