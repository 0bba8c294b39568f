"""Value <-> bytes codec for queue payloads.

Rebuild of jepsen.codec (jepsen/src/jepsen/codec.clj:9-29): the reference
round-trips EDN with eval disabled; here the wire format is JSON (same
safety property: parsing never executes data). The port's copy of
``jepsen_tpu.codec``."""

from __future__ import annotations

import json
from typing import Any


def encode(value: Any) -> bytes:
    """Value -> bytes (codec.clj:9-15); None encodes to empty."""
    if value is None:
        return b""
    return json.dumps(value).encode("utf-8")


def decode(data: bytes) -> Any:
    """Bytes -> value (codec.clj:17-29); empty decodes to None."""
    if not data:
        return None
    return json.loads(data.decode("utf-8"))
