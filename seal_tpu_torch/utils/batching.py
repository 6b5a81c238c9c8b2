"""Input batching helpers shared by the CLIs (a copy of
``seal_tpu/utils/batching.py``)."""

from __future__ import annotations

import os
import select
from typing import Iterable, Iterator, List


def chunks(it: Iterable, n: int) -> Iterator[List]:
    """Fixed-size batches; final partial batch included."""
    buf: List = []
    for x in it:
        buf.append(x)
        if len(buf) == n:
            yield buf
            buf = []
    if buf:
        yield buf


def adaptive_batches(stream, parse, n: int) -> Iterator[List]:
    """Batches of up to ``n`` parsed lines that FLUSH when the stream goes
    idle -- a trickling client on a pipe gets results without having to
    fill a whole batch or close its end.  ``parse(line) -> item | None``
    (None = skip).  Falls back to plain fixed-size batching for streams
    without a selectable fd (StringIO, regular files on some platforms).
    """
    try:
        fd = stream.fileno()
        selectable = True
    except Exception:
        selectable = False

    buf: List = []
    if not selectable:
        for line in stream:
            item = parse(line)
            if item is None:
                continue
            buf.append(item)
            if len(buf) == n:
                yield buf
                buf = []
        if buf:
            yield buf
        return

    # Read raw bytes straight off the fd: mixing select() with buffered
    # stream.readline() would leave lines invisible to select in the
    # user-space buffer, fragmenting bursts into premature 1-line flushes.
    # Our own byte buffer only ever holds a *partial* line when we reach
    # the idle check, so select() reflects all actually-pending input.
    data = bytearray()
    eof = False
    while not eof:
        chunk = os.read(fd, 65536)
        if not chunk:
            eof = True
        else:
            data += chunk
        while True:
            nl = data.find(b"\n")
            if nl < 0:
                break
            line = data[: nl + 1].decode("utf-8", "replace")
            del data[: nl + 1]
            item = parse(line)
            if item is not None:
                buf.append(item)
            if len(buf) >= n:
                yield buf
                buf = []
        if buf and not eof:
            # flush when no further input is immediately available
            ready, _, _ = select.select([fd], [], [], 0)
            if not ready:
                yield buf
                buf = []
    if data:  # trailing line without newline at EOF
        item = parse(data.decode("utf-8", "replace"))
        if item is not None:
            buf.append(item)
    if buf:
        yield buf
