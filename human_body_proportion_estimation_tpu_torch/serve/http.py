"""Minimal HTTP plumbing: multipart/form-data parsing on the stdlib.

The reference leans on FastAPI/uvicorn for its edge; this framework keeps
the edge dependency-free (stdlib http.server) so the serving stack is fully
self-contained. Only the small slice of multipart needed by the API is
implemented: named fields and a single uploaded file per field.
"""

from __future__ import annotations

import re
from typing import Dict, NamedTuple, Optional


class FormPart(NamedTuple):
    data: bytes
    filename: Optional[str]


_DISPOSITION_RE = re.compile(
    rb'form-data\s*;\s*name="(?P<name>[^"]*)"'
    rb'(?:\s*;\s*filename="(?P<filename>[^"]*)")?',
    re.IGNORECASE,
)


def parse_multipart(body: bytes, content_type: str) -> Dict[str, FormPart]:
    """Parse a multipart/form-data body into {field_name: FormPart}.

    Raises ValueError on malformed input (the server maps this to the
    reference's catch-all "failed" JSON, server.py:114-118).
    """
    m = re.search(r'boundary="?([^";]+)"?', content_type)
    if not m:
        raise ValueError("multipart boundary missing")
    boundary = b"--" + m.group(1).encode()

    parts: Dict[str, FormPart] = {}
    # split on boundary markers; first chunk is preamble, last is epilogue
    for chunk in body.split(boundary)[1:]:
        if chunk.startswith(b"--"):
            break  # closing marker
        chunk = chunk.lstrip(b"\r\n")
        header_end = chunk.find(b"\r\n\r\n")
        if header_end < 0:
            continue
        headers = chunk[:header_end]
        data = chunk[header_end + 4:]
        if data.endswith(b"\r\n"):
            data = data[:-2]
        dm = _DISPOSITION_RE.search(headers)
        if not dm:
            continue
        name = dm.group("name").decode()
        filename = dm.group("filename")
        parts[name] = FormPart(
            data, filename.decode() if filename is not None else None
        )
    if not parts:
        raise ValueError("no multipart fields found")
    return parts
