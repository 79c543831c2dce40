"""The port's block hashing (dynamo_tpu_torch.llm.tokens and its plain-Python
xxh3) against the `xxhash` package and the JAX package's tokens module:
every xxh3 length path bit-equal, and the chained block hashes of token
sequences identical."""

from __future__ import annotations

import numpy as np
import pytest
import xxhash

from dynamo_tpu.llm import tokens as jtokens
from dynamo_tpu_torch.llm import tokens
from dynamo_tpu_torch.llm._xxh3 import xxh3_64_intdigest
from tests import torch_fixtures  # noqa: F401  (caps torch's intra-op threads)

# xxh3_64's code paths by input length: empty, 1-3, 4-8, 9-16, 17-128,
# 129-240 bytes, then the striped long-input loop (64-byte stripes, 1024-byte
# blocks with the default secret, plus the last partial stripe)
LENGTH_PATHS = {
    "empty": [0],
    "1to3": [1, 2, 3],
    "4to8": [4, 5, 7, 8],
    "9to16": [9, 12, 15, 16],
    "17to128": [17, 31, 32, 33, 64, 96, 127, 128],
    "129to240": [129, 130, 143, 144, 200, 239, 240],
    "long": [241, 255, 256, 257, 511, 512, 1023, 1024, 1025, 1088, 2048, 4097, 10000],
}


@pytest.mark.parametrize("path", sorted(LENGTH_PATHS))
def test_xxh3_matches_xxhash(path):
    rng = np.random.RandomState(len(path))
    for n in LENGTH_PATHS[path]:
        for _ in range(3):
            data = rng.randint(0, 256, size=n).astype(np.uint8).tobytes()
            assert xxh3_64_intdigest(data) == xxhash.xxh3_64_intdigest(data), n


@pytest.mark.parametrize("block_size,salt", [(16, None), (64, None), (16, b"tenant-a")])
def test_block_hashes_match_jax(block_size, salt):
    rng = np.random.RandomState(block_size)
    toks = rng.randint(0, 128256, size=5 * block_size + 7).tolist()
    assert tokens.compute_block_hashes(toks, block_size, salt) == jtokens.compute_block_hashes(
        toks, block_size, salt
    )
    # built incrementally: the same blocks, local hashes and partial tail
    ours = tokens.TokenBlockSequence(toks[:3], block_size, salt)
    ref = jtokens.TokenBlockSequence(toks[:3], block_size, salt)
    for i in range(3, len(toks), 11):
        new_o = ours.extend(toks[i:i + 11])
        new_r = ref.extend(toks[i:i + 11])
        assert [b.sequence_hash for b in new_o] == [b.sequence_hash for b in new_r]
    assert [(b.tokens, b.local_hash, b.sequence_hash, b.parent_sequence_hash)
            for b in ours.blocks] == [
        (b.tokens, b.local_hash, b.sequence_hash, b.parent_sequence_hash) for b in ref.blocks
    ]
    assert ours.partial == ref.partial
    assert ours.all_tokens() == toks
    assert ours.total_tokens == len(toks)


def test_with_hashes_chains_like_local_hashing():
    rng = np.random.RandomState(3)
    toks = rng.randint(0, 1000, size=70).tolist()
    full = tokens.TokenBlockSequence(toks, 16)
    re = tokens.TokenBlockSequence.with_hashes(
        toks[:40], 16, full.sequence_hashes()[:2], [b.local_hash for b in full.blocks[:2]]
    )
    re.extend(toks[40:])
    assert re.sequence_hashes() == full.sequence_hashes()
    with pytest.raises(ValueError, match="covers"):
        tokens.TokenBlockSequence.with_hashes(toks[:40], 16, [1], [2])
