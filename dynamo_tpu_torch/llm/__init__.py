"""LLM-level types shared by the engine: protocols and token blocks."""
