"""LLM-level layers: protocols, token blocks, the tokenizer, the chat
template renderer, the preprocessor and backend operators, the HTTP
frontend."""
