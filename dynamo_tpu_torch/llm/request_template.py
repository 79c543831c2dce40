"""Request template: server-side defaults for incoming OpenAI requests.

Equivalent of the reference's RequestTemplate (reference:
lib/llm/src/request_template.rs: {model, temperature,
max_completion_tokens} loaded from a JSON file, applied by dynamo-run
when a request omits those fields) — so clients can POST minimal bodies
against a deployment-configured default model/sampling.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Optional


@dataclass
class RequestTemplate:
    model: Optional[str] = None
    temperature: Optional[float] = None
    max_completion_tokens: Optional[int] = None

    @classmethod
    def load(cls, path: str) -> "RequestTemplate":
        with open(path) as f:
            data = json.load(f)
        return cls(
            model=data.get("model"),
            temperature=data.get("temperature"),
            max_completion_tokens=data.get("max_completion_tokens"),
        )

    def apply(self, body: dict) -> dict:
        """Fill fields the request body omitted (request wins)."""
        if self.model is not None and not body.get("model"):
            body["model"] = self.model
        if self.temperature is not None and body.get("temperature") is None:
            body["temperature"] = self.temperature
        if self.max_completion_tokens is not None:
            if (
                body.get("max_completion_tokens") is None
                and body.get("max_tokens") is None
            ):
                body["max_tokens"] = self.max_completion_tokens
        return body
