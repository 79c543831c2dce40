"""Tensor ops of the port. Each hand-written kernel (kv_write,
prefill_attention, decode_attention) sits beside its plain PyTorch version;
the wrapper runs the plain version for CPU tensors and the CUDA kernel for
CUDA tensors."""
