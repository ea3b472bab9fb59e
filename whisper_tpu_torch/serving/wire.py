"""Wire-format helpers of the HTTP server.

A copy of ``whisper_tpu/serving/wire.py``: host-only, free of engine and
device imports.
"""

from __future__ import annotations

import re


def parse_multipart(body: bytes, content_type: str) -> dict:
    """Minimal multipart/form-data parser (cgi module is deprecated).

    File fields (``filename=``) map to raw bytes, plain fields to str —
    mirrors what the reference's Python server pulls out of a form POST
    (python/whisper_svr.py:41-63).
    """
    m = re.search(r'boundary="?([^";]+)"?', content_type)
    if not m:
        raise ValueError("multipart body without boundary")
    boundary = m.group(1).encode()
    parts = body.split(b"--" + boundary)
    out = {}
    for part in parts[1:-1]:
        part = part.lstrip(b"\r\n")
        if not part or part == b"--":
            continue
        head, _, payload = part.partition(b"\r\n\r\n")
        payload = payload.rstrip(b"\r\n")
        nm = re.search(rb'name="([^"]+)"', head)
        if not nm:
            continue
        name = nm.group(1).decode()
        if re.search(rb"filename=", head):
            out[name] = payload
        else:
            out[name] = payload.decode("utf-8", "replace")
    return out
