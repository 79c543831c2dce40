"""Tensor ops of the port. Each hand-written kernel (kv_write,
prefill_attention, decode_attention, each in a bf16 and an int8-KV form)
sits beside its plain PyTorch version; the wrapper runs the plain version
for CPU tensors and the CUDA kernel for CUDA tensors. quant.py holds the
int8 KV scheme and scale-pool helpers, plain PyTorch on any device."""
