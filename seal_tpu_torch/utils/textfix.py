"""A copy of ``seal_tpu/utils/textfix.py`` (standard library only), so the
port needs nothing of the JAX package.

Conservative mojibake repair standing in for ``ftfy.fix_text``.

The reference pipeline runs every corpus/dataset text through ftfy
(the reference's ``scripts/build_fm_index.py:51``,
``make_supervised_dpr_dataset.py:125``, ``make_supervised_kilt_dataset.py:128``)
before indexing.  ftfy is unavailable offline; on Wikipedia-style dumps its
load-bearing contribution is undoing **UTF-8-read-as-cp1252/latin-1 double
encoding** ("cafÃ©" -> "café", "donâ€™t" -> "don’t") -- text that, left
unfixed, can never match a clean query at retrieval time.  This module
implements exactly that class, with a strictness ftfy itself uses: a repair
is applied only when the byte round-trip succeeds for the whole string AND
a mojibake-signature count strictly decreases, so clean text (including
legitimate accented text) is provably a no-op.

Divergence from full ftfy is characterized in
``tests/test_text_divergence.py`` and summarized in PARITY.md: lone
surrogates and exotic single-byte codecs (koi8-r etc.) remain out of scope
-- neither survives into the KILT/DPR corpus TSVs the reference pipeline
actually consumes.  HTML entities ARE handled (``unescape_html_entities``,
mirroring ftfy.fix_text's default ``unescape_html='auto'`` behavior).
"""

from __future__ import annotations

import html
import re

# A double-encoded 2- or 3-byte UTF-8 sequence read back as cp1252/latin-1
# always renders as a char in U+00C2..U+00F4 (the lead-byte image) followed
# by a continuation-byte image: U+0080..U+00BF, or one of the cp1252
# remappings of 0x80..0x9F (curly quotes, dashes, dagger, euro, ...).
_CONT = (
    "-¿"
    "€‚ƒ„…†‡ˆ‰Š‹"
    "ŒŽ‘’“”•–—˜™"
    "š›œžŸ"
)
_MOJIBAKE_DIGRAPH = re.compile(f"[Â-ô][{_CONT}]")


def mojibake_signature(text: str) -> int:
    """Count of lead+continuation digraphs -- the double-encoding fingerprint.

    Legitimate accented text almost never places a char from À..ô
    immediately before a continuation-image char ("déjà vu", "À bientôt",
    "naïve" all score 0); every double-encoded multi-byte char scores >=1.
    """
    return len(_MOJIBAKE_DIGRAPH.findall(text))


def _reencode(text: str) -> str | None:
    """utf-8 bytes recovered via cp1252 (latin-1 for cp1252's five holes)."""
    out = bytearray()
    for ch in text:
        try:
            out += ch.encode("cp1252")
        except UnicodeEncodeError:
            cp = ord(ch)
            if cp > 0xFF:  # not representable in any single-byte read
                return None
            out.append(cp)  # latin-1 fallback covers 0x81 0x8D 0x8F 0x90 0x9D
    try:
        return out.decode("utf-8")
    except UnicodeDecodeError:
        return None


def fix_mojibake(text: str, max_rounds: int = 3) -> str:
    """Undo UTF-8-as-cp1252 double (or deeper) encoding, conservatively.

    Each round re-encodes the WHOLE string and keeps the result only when
    decoding succeeds end-to-end and ``mojibake_signature`` strictly
    decreases; otherwise the input is returned untouched.  Strings with no
    mojibake digraphs are returned without any byte work.
    """
    sig = mojibake_signature(text)
    for _ in range(max_rounds):
        if sig == 0:
            break
        fixed = _reencode(text)
        if fixed is None:
            break
        new_sig = mojibake_signature(fixed)
        if new_sig >= sig:
            break
        text, sig = fixed, new_sig
    return text


# A genuine character/numeric entity reference: named (&amp; &eacute; ...)
# or numeric (&#233; &#xE9;).  Bare ampersands ("AT&T", "Tom & Jerry")
# never match, so they take no byte work and cannot be corrupted.
_ENTITY = re.compile(r"&(?:#[0-9]{1,7}|#[xX][0-9a-fA-F]{1,6}|[A-Za-z][A-Za-z0-9]{1,30});")


def unescape_html_entities(text: str) -> str:
    """HTML character-reference unescape with ftfy's ``'auto'`` gating.

    ``ftfy.fix_text`` (the call replaced at reference
    ``scripts/build_fm_index.py:50-54``) defaults to
    ``unescape_html='auto'``: entities are decoded only when the string does
    NOT look like actual HTML markup, i.e. contains no ``<``.  Wikipedia/
    KILT dump artifacts like ``&amp;`` / ``&eacute;`` / ``&#233;`` get
    repaired; real markup and bare ampersands pass through untouched.
    Runs to a fixed point so double-escaped ``&amp;eacute;`` fully decodes,
    matching ftfy's behavior of re-running fixes until stable.
    """
    if "<" in text or "&" not in text:
        return text
    for _ in range(3):
        if not _ENTITY.search(text):
            break
        fixed = html.unescape(text)
        if fixed == text:
            break
        text = fixed
    return text


def fix_text(text: str) -> str:
    """The ftfy.fix_text stand-in used by the corpus/dataset pipelines:
    HTML-entity unescape (auto-gated) followed by mojibake repair -- the
    two repair classes that materially occur in KILT/DPR corpus TSVs."""
    return fix_mojibake(unescape_html_entities(text))
