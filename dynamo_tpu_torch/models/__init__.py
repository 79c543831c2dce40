"""Model configs, the Llama-family forward and weight loading."""
