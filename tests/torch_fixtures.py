"""What the port's tests share: torch's thread cap, and the fixture BPE
model dir of tests/fixtures.py built into a directory the caller owns.

Every `tests/test_torch_*.py` imports this module, which caps torch's
intra-op threads at `TORCH_THREADS` for the process: the suite runs in
six xdist workers on one machine, and each worker's torch would otherwise
start a thread per core and contend with the others (the port's tests
run at tiny widths, where more threads buy nothing).

`tests.fixtures.tiny_model_dir()` writes one shared directory under the
system temp dir again in every process that calls it, so test files run in
parallel workers can read it half-written. The port's tests build the same
model dir (the same corpus, trainer settings and chat template; the
trainer is deterministic) into a pytest temp dir of their own instead.
"""

from __future__ import annotations

import json
import os

import torch

from .fixtures import _CORPUS, CHAT_TEMPLATE

TORCH_THREADS = 1
torch.set_num_threads(TORCH_THREADS)


def bpe_model_dir(path: str) -> str:
    """Write tests/fixtures.py's tiny model dir into `path` and return it."""
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers, trainers

    tok = Tokenizer(models.BPE(unk_token=None))
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    trainer = trainers.BpeTrainer(
        vocab_size=512,
        special_tokens=["<|bos|>", "<|eos|>", "<|eot|>", "<|user|>", "<|assistant|>",
                        "<|system|>"],
        show_progress=False,
    )
    tok.train_from_iterator(_CORPUS, trainer)
    tok.save(os.path.join(path, "tokenizer.json"))
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump({"bos_token": "<|bos|>", "eos_token": "<|eos|>",
                   "chat_template": CHAT_TEMPLATE}, f)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"architectures": ["LlamaForCausalLM"], "model_type": "llama",
                   "max_position_embeddings": 2048, "hidden_size": 64,
                   "intermediate_size": 128, "num_attention_heads": 4,
                   "num_key_value_heads": 2, "num_hidden_layers": 2, "vocab_size": 512,
                   "rms_norm_eps": 1e-5, "rope_theta": 10000.0}, f)
    return path
