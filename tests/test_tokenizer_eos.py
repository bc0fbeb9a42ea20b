"""Real-tokenizer eos semantics.

The air-gapped default is the ByteTokenizer (eos 257); these tests fabricate
an actual HF *fast* tokenizer on disk (tokenizers lib is bundled with
transformers) with llama-style special tokens, load it through the normal
``load_tokenizer`` path, and verify the engine wires real eos ids into the
decode loop and that the loop stops on them.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kvzip_tpu.config import tiny_config
from kvzip_tpu.engine import Engine
from kvzip_tpu.tokenizer import load_tokenizer


@pytest.fixture(scope="module")
def hf_tok_dir(tmp_path_factory):
    """Write a minimal WordLevel fast tokenizer with llama-style specials."""
    tokenizers = pytest.importorskip("tokenizers")
    from tokenizers import Tokenizer, models, pre_tokenizers

    d = tmp_path_factory.mktemp("tok")
    words = ["the", "quick", "brown", "fox", "passcode", "is", "7194",
             "what", "context", "answer", "question", "secret", "."]
    vocab = {w: i for i, w in enumerate(words)}
    vocab["<unk>"] = len(vocab)
    tok = Tokenizer(models.WordLevel(vocab=vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    # llama-3-style specials appended at the end of the vocab
    tok.add_special_tokens(["<|begin_of_text|>", "<|end_of_text|>",
                            "<|start_header_id|>", "<|end_header_id|>",
                            "<|eot_id|>"])
    tok.save(str(d / "tokenizer.json"))
    (d / "tokenizer_config.json").write_text(json.dumps({
        "tokenizer_class": "PreTrainedTokenizerFast",
        "bos_token": "<|begin_of_text|>",
        "eos_token": "<|eot_id|>",
        "model_max_length": 8192,
    }))
    return str(d)


def test_load_real_tokenizer_and_eos_ids(hf_tok_dir):
    tok = load_tokenizer(hf_tok_dir)
    # must be the HF tokenizer, not the byte fallback
    assert tok.__class__.__name__ != "ByteTokenizer"
    eot = tok.convert_tokens_to_ids("<|eot_id|>")
    assert tok.eos_token_id == eot

    cfg = tiny_config("llama", vocab_size=64)
    eng = Engine("llama-tiny-real-tok", kv_type="retain", config=cfg,
                 dtype=jnp.float32, tokenizer=tok, max_new_tokens=4,
                 decode_budget=128, capacity_granularity=128,
                 score_chunk_size=128)
    # the template table adds llama family ids; the tokenizer's own eos
    # must be present regardless
    assert eot in eng.eos_ids

    ids = eng.encode("the quick brown fox")
    assert ids.dtype == np.int32 and len(ids) == 4
    assert eng.decode(ids).replace(" ", "") == "thequickbrownfox"


# real special-token ids per family, as shipped in the HF tokenizer configs
# the reference loads (`model/load.py:5-39`); the fabricated tokenizers below
# place the specials at these EXACT ids so template.eos_ids' hardcoded table
# is checked against a tokenizer that matches production vocab layout
_FAMILIES = {
    "llama3.1-8b": dict(
        specials={"<|begin_of_text|>": 128000, "<|end_of_text|>": 128001,
                  "<|start_header_id|>": 128006, "<|end_header_id|>": 128007,
                  "<|eot_id|>": 128009},
        eos_token="<|eot_id|>", table=[128001, 128009], turn_end=128009),
    "qwen2.5-7b": dict(
        specials={"<|endoftext|>": 151643, "<|im_start|>": 151644,
                  "<|im_end|>": 151645},
        eos_token="<|im_end|>", table=[151645], turn_end=151645),
    "qwen3-8b": dict(
        specials={"<|endoftext|>": 151643, "<|im_start|>": 151644,
                  "<|im_end|>": 151645, "<think>": 151667,
                  "</think>": 151668},
        eos_token="<|im_end|>", table=[151645], turn_end=151645),
    "gemma3-4b": dict(
        specials={"<pad>": 0, "<eos>": 1, "<bos>": 2,
                  "<start_of_turn>": 105, "<end_of_turn>": 106},
        eos_token="<eos>", table=[1, 106], turn_end=106),
}


def _family_tok_dir(tmp_path, fam):
    """Write a fast-tokenizer JSON with the family's specials at their REAL
    ids. The tokenizers lib re-indexes added tokens whose ids are not
    contiguous with the vocab, so the base vocab is filled densely up to the
    highest special id — the same layout real HF tokenizer files use."""
    special_ids = set(fam["specials"].values())
    vocab = {f"tok{i}": i for i in range(max(special_ids) + 1)
             if i not in special_ids}
    vocab["hello"] = vocab.pop("tok42", 42)
    vocab["world"] = vocab.pop("tok43", 43)
    vocab["<unk>"] = max(special_ids) + 1
    # specials live in BOTH model.vocab and added_tokens at the same id —
    # the layout real HF files use; otherwise the lib re-indexes them
    vocab.update(fam["specials"])
    tok_json = {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": [
            {"id": i, "content": c, "single_word": False, "lstrip": False,
             "rstrip": False, "normalized": False, "special": True}
            for c, i in fam["specials"].items()],
        "normalizer": None,
        "pre_tokenizer": {"type": "Whitespace"},
        "post_processor": None, "decoder": None,
        "model": {"type": "WordLevel", "vocab": vocab, "unk_token": "<unk>"},
    }
    (tmp_path / "tokenizer.json").write_text(json.dumps(tok_json))
    (tmp_path / "tokenizer_config.json").write_text(json.dumps({
        "tokenizer_class": "PreTrainedTokenizerFast",
        "eos_token": fam["eos_token"], "model_max_length": 8192}))
    return str(tmp_path)


@pytest.mark.parametrize("model_name", sorted(_FAMILIES))
def test_family_eos_table_matches_tokenizer(model_name, tmp_path):
    """template.eos_ids x real-id tokenizers for all four families:
    every hardcoded table id is a declared special of
    that family's tokenizer, the tokenizer's own eos is always included,
    and the template postfix actually encodes the turn-end token the decode
    loop stops on."""
    from kvzip_tpu import template as template_lib

    fam = _FAMILIES[model_name]
    tok = load_tokenizer(_family_tok_dir(tmp_path, fam))
    assert tok.__class__.__name__ != "ByteTokenizer"
    assert int(tok.eos_token_id) == fam["specials"][fam["eos_token"]]

    got = template_lib.eos_ids(model_name, tok)
    special_ids = set(fam["specials"].values())
    assert set(fam["table"]).issubset(special_ids), \
        "table id not a declared special"
    assert set(fam["table"]).issubset(set(got))
    assert int(tok.eos_token_id) in got

    # template postfix round-trip: the family's turn-end special must
    # survive encode (as ONE token at the real id) and decode back
    _, postfix = template_lib.template(model_name)
    enc = tok.encode(postfix, add_special_tokens=False)
    assert fam["turn_end"] in enc, (postfix, enc)
    dec = tok.decode(enc, skip_special_tokens=False)
    for s in fam["specials"]:
        if s in postfix:
            assert s in dec


def test_unknown_family_without_eos_raises(tmp_path):
    """The (1,) fallback is gone: an unknown family whose tokenizer declares
    no eos fails LOUDLY instead of stopping on an arbitrary token id."""
    class NoEos:
        eos_token_id = None

        def encode(self, text, add_special_tokens=False):
            return [1, 2, 3]

    cfg = tiny_config("llama", vocab_size=64)
    with pytest.raises(ValueError, match="no eos ids"):
        Engine("mystery-model-7b", kv_type="retain", config=cfg,
               dtype=jnp.float32, tokenizer=NoEos(), max_new_tokens=4,
               decode_budget=128, capacity_granularity=128,
               score_chunk_size=128)


def test_decode_loop_stops_on_real_eos(hf_tok_dir):
    tok = load_tokenizer(hf_tok_dir)
    cfg = tiny_config("llama", vocab_size=64)
    eng = Engine("llama-tiny-real-tok", kv_type="retain", config=cfg,
                 dtype=jnp.float32, tokenizer=tok, max_new_tokens=6,
                 decode_budget=128, capacity_granularity=128,
                 score_chunk_size=128)
    st = eng.prefill("the quick brown fox passcode is 7194 .",
                     prefill_chunk_size=64)

    eot = int(tok.eos_token_id)
    run = eng._decode_loop(5, st.cache.capacity, "dense")
    tokens, n, done, cache = run(eng.params, st.cache, jnp.int32(eot))
    # first generated token IS eos: the loop must stop before decoding more
    assert bool(jax.device_get(done))
    assert int(jax.device_get(n)) == 0
    st.cache = cache
    st.restore_snapshot()
