"""The port's ``regex``-free tokenizer against ``seal_tpu.models.tokenizer``:
its letter, number and whitespace classes against ``regex``'s ``\\p{L}``,
``\\p{N}`` and ``\\s`` over every code point, then ``word_tokenize``,
training, ``encode_plain``, ``encode`` and ``decode`` equal on the searcher
test corpus, on the benchmark recipe's texts and on generated mixed-script
strings."""

import json
import re
import unicodedata

import numpy as np
import pytest
import regex
from hypothesis import given, settings
from hypothesis import strategies as st

from seal_tpu.models import tokenizer as jt
from seal_tpu_torch.models import tokenizer as tt

ALL = "".join(chr(c) for c in range(0x110000))


@pytest.mark.parametrize("name,prop", [("L", r"\p{L}"), ("N", r"\p{N}"), ("S", r"\s")])
def test_char_classes_match_regex(name, prop):
    """Every code point.  ``regex`` may carry a newer Unicode database than
    the interpreter's ``unicodedata``; the classes may then differ only on
    code points the older one leaves unassigned (category Cn)."""
    want = set(regex.findall(prop, ALL))
    got = set(re.findall(f"[{tt.char_classes()[name]}]", ALL))
    diff = want ^ got
    assert all(unicodedata.category(c) == "Cn" for c in diff), sorted(diff)[:5]
    if name == "S":
        assert not diff
        assert "\x1c" not in got and "\x1c".isspace()  # where re's \s differs


TEST_CORPUS = [  # tests/test_searcher.py's documents, then harder text
    "Soup @@ You can eat soup with a spoon but eating soup with a fork is hard.",
    "Forks @@ A fork is a utensil with tines used for spearing solid food.",
    "Bicycles @@ A bicycle has two wheels and is propelled by pedals.",
    "Rivers @@ A river is a natural stream of fresh water flowing toward an ocean.",
    "Chess @@ Chess is a board game for two players with sixteen pieces each.",
    "Rivers @@ A river's natural stream of fresh water -- it flows 2,000 km!",
    "Café @@ naïve résumé 東京 ١٢٣ Ⅳ x² "
    "tab\tand　ideographic line",
    "  leading and trailing spaces   ",
    "it's we're they've I'm you'll he'd 'quoted'",
]


def _bench_texts(n=50):
    rng = np.random.default_rng(0)
    words = np.array([f"w{i}" for i in range(3000)])
    probs = 1.0 / np.arange(1, len(words) + 1) ** 0.8
    probs /= probs.sum()
    return [f"Title{i} @@ " + " ".join(rng.choice(words, size=110, p=probs)) for i in range(n)]


@pytest.mark.parametrize("corpus", ["searcher", "bench"])
def test_word_vocab_tokenizer_matches_jax(corpus, tmp_path):
    texts = TEST_CORPUS if corpus == "searcher" else _bench_texts()
    texts = [" " + t for t in texts]
    jtok = jt.WordVocabTokenizer.train(texts, max_vocab=500)
    ttok = tt.WordVocabTokenizer.train(texts, max_vocab=500)
    assert ttok.encoder == jtok.encoder
    for t in texts + [" unseen words über", " eating soup with a fork || body || +"]:
        assert tt.word_tokenize(t) == jt.word_tokenize(t)
        assert ttok.encode_plain(t) == jtok.encode_plain(t)
        assert ttok.encode(t) == jtok.encode(t)
        assert ttok.encode(t, add_special_tokens=False) == jtok.encode(t, False)
        ids = jtok.encode(t)
        for skip in (False, True):
            assert ttok.decode(ids, skip) == jtok.decode(ids, skip)
    assert ttok.batch_decode([ids], True) == jtok.batch_decode([ids], True)
    path = tmp_path / "word_vocab.json"
    ttok.save(str(path))
    assert json.loads(path.read_text()) == jtok.encoder
    for p in (str(path), str(tmp_path)):
        assert tt.load_tokenizer(p).encoder == jt.load_tokenizer(p).encoder
    # merges.txt without vocab.json and no word vocab: nothing to load
    (tmp_path / "merges.txt").write_text("")
    (tmp_path / "word_vocab.json").unlink()
    with pytest.raises(FileNotFoundError, match="cannot resolve tokenizer"):
        tt.load_tokenizer(str(tmp_path))


_mixed = st.lists(
    st.one_of(
        st.sampled_from([" ", "  ", "\t", "\n", "\xa0", "\u3000", "\x1c", "'", "!?", ".", "-",
                         "'s", "'ll", "'re"]),
        # unassigned code points aside (Unicode versions may differ, above)
        st.characters(min_codepoint=0x20, max_codepoint=0x2FFF, exclude_categories=("Cn",)),
        st.characters(whitelist_categories=("Lu", "Ll", "Lo", "Nd", "Nl", "No", "Zs", "Po")),
    ),
    max_size=40,
).map("".join)


@settings(max_examples=200, deadline=None, derandomize=True)
@given(_mixed)
def test_split_matches_jax_on_generated_text(text):
    assert tt.gpt2_split(text) == jt._GPT2_PAT.findall(text)
    assert tt.word_tokenize(text) == jt.word_tokenize(text)
