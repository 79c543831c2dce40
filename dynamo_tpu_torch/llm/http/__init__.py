"""The OpenAI HTTP frontend of the port: an asyncio HTTP/1.1 server,
the service on it and its Prometheus metrics."""
