"""Retrieved-document wrapper: the port's copy of
``seal_tpu/retrieval/document.py`` (parity: the reference's
``SEALDocument``, ``seal/retrieval.py:315-397``).

Text is reconstructed purely from the index (a corpus slice here; the
reference walks the BWT), split into title/body on the delimiter token ids.
"""

from __future__ import annotations

from typing import List, Optional, Tuple


class SEALDocument:
    def __init__(
        self,
        idx: int,
        score: Optional[float],
        fm_index,
        tokenizer,
        delim1: Optional[int] = None,
        delim2: Optional[int] = None,
        keys=None,
        query=None,
    ):
        self.idx = idx
        self.score = score
        self.fm_index = fm_index
        self.tokenizer = tokenizer
        self.delim1 = delim1
        self.delim2 = delim2
        self.keys = keys
        self.query = query
        self._raw_tokens = None
        self._body = None
        self._title = None

    @property
    def docid(self):
        # an index built without labels (supported, persists as None) still
        # serves: fall back to the positional id so writers/serve workers
        # don't die on the first result (reference crashes here too, but
        # our serve CLI promises to survive)
        labels = self.fm_index.labels
        return labels[self.idx] if labels is not None else str(self.idx)

    def id(self):
        return self.idx

    def raw_tokens(self) -> List[int]:
        if self._raw_tokens is None:
            self._raw_tokens = self.fm_index.get_doc(self.idx)
        return self._raw_tokens

    def raw_text(self) -> str:
        return self.tokenizer.decode(self.raw_tokens())

    def text(self) -> Tuple[str, str]:
        if self._body is None or self._title is None:
            title_tokens, body_tokens = self.split_tokens(self.raw_tokens())
            self._title = (
                self.tokenizer.decode(title_tokens, skip_special_tokens=True)
                if title_tokens
                else ""
            )
            self._body = self.tokenizer.decode(body_tokens, skip_special_tokens=True)
        return self._title, self._body

    def split_tokens(self, tokens: List[int]):
        """Split on delim1 (title/body) then drop a leading code segment up to
        delim2 (parity: ``retrieval.py:368-394``)."""
        if self.delim1 is None:
            title_tokens: List[int] = []
            body_tokens = list(tokens)
        else:
            try:
                i = tokens.index(self.delim1)
                title_tokens = tokens[:i]
                body_tokens = tokens[i + 1 :]
            except (IndexError, ValueError):
                title_tokens = []
                body_tokens = list(tokens)
        i = 0
        if self.delim2 is not None:
            try:
                i = body_tokens.index(self.delim2) + 1
            except (IndexError, ValueError):
                i = 0
        return title_tokens, body_tokens[i:]

    def __repr__(self):
        return f'<SEALDocument: {self.idx}, "{self.raw_text()[:30]}[...]">'
