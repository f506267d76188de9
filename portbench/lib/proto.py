"""Messages between the harness and its clients over their stdin and stdout
pipes: a 4-byte length, then a pickle. Only the harness and its own
clients write these pipes."""

from __future__ import annotations

import pickle
import struct


def send(stream, obj) -> None:
    data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    stream.write(struct.pack("<I", len(data)) + data)
    stream.flush()


def _read_exact(stream, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        part = stream.read(n - len(buf))
        if not part:
            raise EOFError("the pipe closed inside a message")
        buf += part
    return buf


def recv(stream):
    """The next message, or None when the other side closed the pipe."""
    head = stream.read(4)
    if not head:
        return None
    if len(head) < 4:
        head += _read_exact(stream, 4 - len(head))
    return pickle.loads(_read_exact(stream, struct.unpack("<I", head)[0]))
