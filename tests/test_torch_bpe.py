"""The port's byte-level BPE tokenizer (GPT-2's split without ``regex``)
against ``seal_tpu.models.tokenizer``'s: training at vocab 400 gives the
same vocab and merge ranks; ``encode``, ``encode_batch``, ``decode`` and
``batch_decode`` give the same ids and strings on ASCII, accents, CJK, an
emoji, runs of whitespace and special tokens inside the text, with
``skip_special_tokens`` both ways, on a vocab missing some bytes (unknown
pieces and cut UTF-8 sequences) too; ``save`` / ``from_dir`` round trips;
``load_tokenizer`` resolves the same files to the same tokenizers."""

import json

import numpy as np
import pytest

from seal_tpu.models import tokenizer as jt
from seal_tpu_torch.models import tokenizer as tt

WORDS = ["soup", "fork", "spoon", "eating", "café", "naïve", "Zürich", "東京", "大学", "🍜",
         "river", "ocean", "don't", "it's", "42", "3.14", "hello,", "world!", "über"]
TEXTS = [
    "eating soup with a fork",
    "  café   naïve\tZürich\n\nnew line",
    "東京大学 と 京都大学",
    "ramen 🍜 is soup 🍜🍜",
    "<s> special </s> tokens <pad> inside <mask> text <unk>",
    "don't we'll they're I've 42 3.14 -- ... ?!",
    "trailing spaces   ",
    "　full width spaces",
    "",
]


def _corpus(seed=0, n=300):
    """Sentences of ``WORDS`` and of random syllables (enough distinct pairs
    for the merges to fill a vocab of 400)."""
    rng = np.random.default_rng(seed)
    syll = ["ka", "to", "ri", "mu", "sé", "dan", "pol", "京", "ü"]
    words = WORDS + ["".join(rng.choice(syll, size=rng.integers(1, 4))) for _ in range(200)]
    return [" ".join(rng.choice(words, size=rng.integers(3, 12))) for _ in range(n)] + TEXTS


@pytest.fixture(scope="module")
def trained():
    corpus = _corpus()
    return (jt.ByteLevelBPETokenizer.train(corpus, vocab_size=400),
            tt.ByteLevelBPETokenizer.train(corpus, vocab_size=400))


def _assert_same(j, t, texts):
    for text in texts:
        for special in (True, False):
            ids = t.encode(text, add_special_tokens=special)
            assert ids == j.encode(text, add_special_tokens=special), text
        assert t.encode_plain(text) == j.encode_plain(text)
    assert t.encode_batch(texts) == j.encode_batch(texts)
    assert t.encode_batch(texts, False) == j.encode_batch(texts, False)
    seqs = j.encode_batch(texts) + [[0, 5, 2, 1, len(j.encoder) - 1, 10_000, 7]]
    for skip in (False, True):
        for ids in seqs:
            assert t.decode(ids, skip) == j.decode(ids, skip)
        assert t.batch_decode(seqs, skip) == j.batch_decode(seqs, skip)


def test_train_matches_jax(trained):
    j, t = trained
    assert t.encoder == j.encoder and len(t.encoder) == 400
    assert t.bpe_ranks == j.bpe_ranks
    assert (t.bos_token_id, t.pad_token_id, t.eos_token_id, t.unk_token_id, t.mask_token_id) == (
        j.bos_token_id, j.pad_token_id, j.eos_token_id, j.unk_token_id, j.mask_token_id)
    assert tt.bytes_to_unicode() == jt.bytes_to_unicode()


def test_encode_decode_match_jax(trained):
    j, t = trained
    _assert_same(j, t, TEXTS + _corpus(seed=1, n=20))
    # a round trip is the identity on text (the byte map is reversible)
    for text in TEXTS:
        assert t.decode(t.encode(text), skip_special_tokens=True) == text


def test_save_from_dir_round_trip(trained, tmp_path):
    j, t = trained
    t.save(str(tmp_path / "t"))
    j.save(str(tmp_path / "j"))
    for name in ("vocab.json", "merges.txt"):
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()
    back = tt.ByteLevelBPETokenizer.from_dir(str(tmp_path / "t"))
    assert back.encoder == t.encoder and back.bpe_ranks == t.bpe_ranks
    _assert_same(j, back, TEXTS)


def test_unknown_bytes_match_jax(trained, tmp_path):
    """A vocab without some bytes (the CJK and emoji lead bytes): their
    pieces encode to ``<unk>``; a decode that cuts a UTF-8 sequence gives
    the replacement character in both."""
    j, t = trained
    be = jt.bytes_to_unicode()
    drop = {be[b] for b in "東🍜".encode("utf-8")[:2]}
    vocab = {}
    for k in j.encoder:
        if k not in drop and not any(c in drop for c in k):
            vocab[k] = len(vocab)
    merges = [m for m in sorted(j.bpe_ranks, key=j.bpe_ranks.get)
              if m[0] in vocab and m[1] in vocab and m[0] + m[1] in vocab]
    (tmp_path / "vocab.json").write_text(json.dumps(vocab))
    (tmp_path / "merges.txt").write_text(
        "#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))
    jj = jt.ByteLevelBPETokenizer.from_dir(str(tmp_path))
    tk = tt.ByteLevelBPETokenizer.from_dir(str(tmp_path))
    assert jj.unk_token_id in jj.encode_plain("東京 🍜")
    _assert_same(jj, tk, TEXTS)
    cut = [j.encoder[be[b]] for b in "x🍜".encode("utf-8")[:3]]  # "x" + half the emoji
    assert t.decode(cut) == j.decode(cut) == "x�"


def test_load_tokenizer_routes_match_jax(trained, tmp_path):
    j, _ = trained
    bpe = tmp_path / "bpe"
    j.save(str(bpe))
    got, want = tt.load_tokenizer(str(bpe)), jt.load_tokenizer(str(bpe))
    assert isinstance(got, tt.ByteLevelBPETokenizer)
    assert got.encoder == want.encoder and got.bpe_ranks == want.bpe_ranks
    word = jt.WordVocabTokenizer.train(_corpus(n=20), max_vocab=100)
    (tmp_path / "word").mkdir()
    word.save(str(tmp_path / "word" / "word_vocab.json"))
    word.save(str(tmp_path / "plain.json"))
    for p in (tmp_path / "word", tmp_path / "plain.json"):
        got = tt.load_tokenizer(str(p))
        assert isinstance(got, tt.WordVocabTokenizer) and got.encoder == word.encoder
    # vocab.json + merges.txt win over a word_vocab.json in the same directory
    word.save(str(bpe / "word_vocab.json"))
    assert isinstance(tt.load_tokenizer(str(bpe)), tt.ByteLevelBPETokenizer)
    assert isinstance(jt.load_tokenizer(str(bpe)), jt.ByteLevelBPETokenizer)
    # JAX's last resort (transformers' hub cache) has no counterpart: the
    # port raises JAX's FileNotFoundError at once
    for missing in (tmp_path / "nothing", tmp_path / "word" / "absent.txt", "facebook/bart-large"):
        with pytest.raises(FileNotFoundError, match="cannot resolve tokenizer"):
            tt.load_tokenizer(str(missing))
